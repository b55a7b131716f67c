"""Each CUDA kernel of the port against its plain version, on the card.

Marked ``gpu``: run on a machine with an NVIDIA H100 as
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.
Without a CUDA device every test skips (the decision is made inside a
fixture, so every worker collects the same tests).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.fex import FExConfig, FExNormStats
from repro_torch.core.frontend import FrontendState, hardware_state, tree_clone, tree_leaves
from repro_torch.core.gru_delta import DeltaConfig
from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
from repro_torch.core.tdfex import TDFExConfig, TDFExState, draw_chip
from repro_torch.kernels import build
from repro_torch.kernels import gru_sequence, gru_sequence_plain, wkv6, wkv6_plain
from repro_torch.kernels.fex_fused import biquad_stream, biquad_stream_ref, fex_fused, fex_fused_ref
from repro_torch.kernels.fma_rows import fma_rows, fma_rows_ref
from repro_torch.kernels.intgemm import intgemm, intgemm_ref
from repro_torch.kernels.tdc import tdc_counts, tdc_counts_plain
from repro_torch.kernels.tdc.ops import tdc_scale
from repro_torch.kernels.tick_fused import pack_operands, tick_fused, tick_reference
from repro_torch.kernels.tick_fused.gather import make_sparse_step
from repro_torch.serving.cascade import fit_linear_detector
from repro_torch.serving.serve_loop import StreamingKWSServer

pytestmark = pytest.mark.gpu

N = 4096  # the main path's stream count
# (classifier, θ): θ = 64 is above every Q6.8 delta, so no column fires
BACKENDS = [("qat", None), ("integer", None), ("float", None),
            ("delta", 0.0), ("delta", 0.15), ("delta", 64.0),
            ("delta-int", 0.0), ("delta-int", 0.15), ("delta-int", 64.0)]
# the float backend against its plain version: the kernel sums and
# evaluates sigmoid / tanh in its own order (states and scores)
FLOAT_TOL = 1e-5
# bfloat16 output of K6 against its float32 plain version (the reference's
# own bound for its kernel's bf16 output)
BF16_TOL = 3e-2
# K7 against its plain version, max |Δ| / max |y|: the kernel sums the keys
# in its own order with fused multiply-adds and expf; measured 1.6e-7 at
# (8, 4096, 64, 64) on an H100
WKV_REL_TOL = 2e-6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m gpu` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _norm_stats(dev):
    g = torch.Generator().manual_seed(0)
    mu = 300 + 200 * torch.rand(16, generator=g)
    sigma = 50 + 50 * torch.rand(16, generator=g)
    return FExNormStats(mu=mu.to(dev), sigma=sigma.to(dev))


# the 4 x 4 register tiles and the 16-row blocks at their ragged edges:
# rows, depth (zero-padded to 4 k) and columns not multiples of the tile,
# with and without the vector loads and stores
INTGEMM_EDGES = [(m, k, n, "random") for m in (1, 15, 17, 4095) for k in (1, 7, 16, 48)
                 for n in (1, 5, 12, 144)]


@pytest.mark.parametrize(
    "m,k,n,kind",
    [
        (N, 16, 144, "random"), (N, 48, 144, "random"), (N, 48, 12, "random"),
        (77, 48, 144, "saturate"), (1, 1, 1, "random"), (33, 7, 5, "random"),
        (37, 48, 144, "saturate-mixed"),
    ] + INTGEMM_EDGES,
)
def test_intgemm_kernel_equals_plain(dev, m, k, n, kind):
    """Bit-equal to the plain version; "saturate" sums leave the int24
    range at both ends (x = 8191 / -8192 against w = 127, and x = +-8191
    against w = +-127 by column) and clip once, to +-2^23."""
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randint(-8192, 8192, (m, k), generator=g, device=dev, dtype=torch.int32)
    w = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    if kind == "saturate":
        x = torch.where(torch.arange(m, device=dev)[:, None] % 2 == 0, 8191, -8192).expand(m, k).contiguous().to(torch.int32)
        w = torch.full((k, n), 127, device=dev, dtype=torch.int8)
    if kind == "saturate-mixed":
        x = torch.where(torch.arange(m, device=dev)[:, None] % 2 == 0, 8191, -8191).expand(m, k).contiguous().to(torch.int32)
        w = torch.where(torch.arange(n, device=dev) % 2 == 0, 127, -127).expand(k, n).contiguous().to(torch.int8)
    before = build.launches["intgemm"]
    got = intgemm(x, w)
    assert build.launches["intgemm"] == before + 1
    assert torch.equal(got, intgemm_ref(x, w))
    if kind.startswith("saturate"):
        assert int(got.max()) == 2**23 - 1 and int(got.min()) == -(2**23)


def _hw_state(dev, seed=0):
    """A mismatched die drawn from a seed, uncalibrated (nominal beta,
    unit alpha), with norm stats."""
    chip = draw_chip(torch.Generator().manual_seed(seed), TDFExConfig(), dev)
    g = torch.Generator().manual_seed(seed + 1)
    beta = TDFExConfig().beta_nominal + 2 * torch.randn(16, generator=g)
    alpha = 1 + 0.05 * torch.randn(16, generator=g)
    return hardware_state(TDFExConfig(), chip, beta, alpha, _norm_stats(dev), device=dev)


def _pipe(dev, classifier, theta, frontend="software"):
    delta = None if theta is None else DeltaConfig(theta, theta)
    cfg = KWSPipelineConfig(frontend=frontend, classifier=classifier, delta=delta)
    if frontend == "software":
        return KWSPipeline(cfg, norm_stats=_norm_stats(dev))
    return KWSPipeline(cfg, state=_hw_state(dev))


def _tick_cases():
    cases = [(c, t, raw, "software") for c, t in BACKENDS for raw in (True, False)]
    return cases + [(c, t, True, "hardware") for c, t in BACKENDS]


@pytest.mark.parametrize("classifier,theta,raw,frontend", _tick_cases(),
                         ids=[f"{c}-{t}-{'raw' if r else 'fv'}-{f}" for c, t, r, f in _tick_cases()])
@pytest.mark.parametrize("n", [N, 37, 1, 15, 17], ids=["full", "ragged", "1", "15", "17"])
def test_tick_kernel_equals_plain(dev, classifier, theta, raw, frontend, n):
    """Against the plain tick; for the ΔGRU backends its sparse step (K4's
    plain version) at both extremes of the fired-column list; with the
    hardware frontend on a mismatched die, its carry {s1, s2, r, j}. The
    stream counts cut the 4-stream tiles of the classifier phase and the
    16-stream blocks raggedly; the last tick's mask leaves every stream
    tile half submitting."""
    pipe = _pipe(dev, classifier, theta, frontend)
    params = pipe.prepare_params(pipe.init_params(torch.Generator().manual_seed(1), device=dev))
    ops = pack_operands(pipe, params, pipe.state, dev)
    step_fn = make_sparse_step(pipe)
    state = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
             torch.zeros((n, 12), device=dev), None)
    g = torch.Generator(device=dev).manual_seed(2)
    gains = torch.logspace(-2, -0.3, n, device=dev)[:, None]
    flt = classifier == "float"
    for t, frac in enumerate([1.0, 0.7, 0.0, 0.5, None]):
        if raw:
            inp = torch.randn((n, 256), generator=g, device=dev) * gains
        else:
            inp = torch.round(torch.randn((n, 16), generator=g, device=dev) * 512) / 256
        mask = torch.rand(n, generator=g, device=dev) < frac if frac is not None else (
            torch.arange(n, device=dev) % 4 < 2)
        (pg, pc, ps, _), _, ptop = tick_reference(pipe, raw, params, tree_clone(state), inp,
                                                  mask, pipe.state, 0.7, step_fn=step_fn)
        fv = torch.zeros((n, 16), device=dev)
        before = dict(build.launches)
        (kg, kc, ks, _), _, ktop = tick_fused(pipe, raw, params, tree_clone(state), inp, mask,
                                              pipe.state, 0.7, operands=ops, fv_out=fv)
        assert build.launches["tick_fused"] == before.get("tick_fused", 0) + 1
        for a, b in zip(tree_leaves(kg), tree_leaves(pg)):
            if flt:
                assert float((a - b).abs().max()) <= FLOAT_TOL, f"tick {t}"
            else:
                assert torch.equal(a, b), f"tick {t}"
        assert sorted(kc) == sorted(pc)
        for key in pc:
            assert torch.equal(kc[key], pc[key]), key
        assert float((ks - ps).abs().max()) <= (FLOAT_TOL if flt else 1e-6)
        if flt:  # top where the plain tick's two best scores are clearly apart
            best2 = torch.topk(ps, 2, dim=-1).values
            clear = best2[:, 0] - best2[:, 1] > 2 * FLOAT_TOL
            assert torch.equal(ktop[clear], ptop[clear]), f"tick {t}"
        else:
            assert torch.equal(ktop, ptop)
        if raw:
            _, pfv = pipe.streaming_features_apply(tree_clone(state)[1], inp, pipe.state)
            assert torch.equal(fv[mask], pfv[mask])
        state = (kg, kc, ks, None)
    if theta == 64.0:  # nothing fired: every offered column was skipped
        for st in kg:
            assert torch.equal(st["skipped"], st["total"])


def _tick_once(pipe, params, n, dev, inp, mask):
    """One FV tick of the kernel and of the plain tick from fresh state:
    (kernel state, plain state, kernel scores, plain scores)."""
    ops = pack_operands(pipe, params, pipe.state, dev)
    state = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
             torch.zeros((n, 12), device=dev), None)
    (pg, _, ps, _), _, _ = tick_reference(pipe, False, params, tree_clone(state), inp, mask,
                                          pipe.state, 0.7)
    (kg, _, ks, _), _, _ = tick_fused(pipe, False, params, tree_clone(state), inp, mask,
                                      pipe.state, 0.7, operands=ops)
    return kg, pg, ks, ps


def test_integer_tick_with_saturating_gate_accumulators(dev):
    """Layer 1's input product at its extremes: FV codes of +-8189 against
    weight codes of +-127 take 16-term sums to +-1.66e7, past the int24
    accumulator, and biases of -+255 pull them back, so the gate codes
    tell a sum clipped once to int24 before the bias (intgemm's rule,
    the plain tick's) from an unclipped one."""
    pipe = _pipe(dev, "integer", None)
    params = pipe.init_params(torch.Generator().manual_seed(1), device=dev)
    even = torch.arange(144, device=dev) % 2 == 0
    params["gru"][0]["w_i"] = torch.where(even, 127.0, -127.0).expand(16, 144) / 128
    params["gru"][0]["b_i"] = torch.where(even, -255.0, 255.0)
    q = pipe.prepare_params(params)
    n = 37
    rows = torch.arange(n, device=dev)[:, None] % 3 - 1  # -1, 0, +1
    inp = (rows * 8189 / 256).float().expand(n, 16).contiguous()
    codes = torch.round(inp * 256).to(torch.int64).cpu()
    raw_acc = codes @ q.gru[0]["w_i"].to(torch.int64).cpu()
    assert bool((raw_acc.abs() > 2**23).any())  # the accumulators do saturate
    kg, pg, ks, ps = _tick_once(pipe, q, n, dev, inp, torch.ones(n, dtype=torch.bool, device=dev))
    for a, b in zip(tree_leaves(kg), tree_leaves(pg)):
        assert torch.equal(a, b)
    assert float((ks - ps).abs().max()) <= 1e-6


def _ordered_matmul(x, w, fused):
    """x @ w summed over k in ascending order from 0, each term rounded as
    multiply-then-add (fused=False) or as one fused multiply-add."""
    from repro_torch.core.fex import fma_f32

    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for k in range(w.shape[0]):
        term_x, term_w = x[:, k:k + 1].expand_as(acc), w[k].expand_as(acc)
        acc = fma_f32(term_x, term_w, acc) if fused else acc + term_x * term_w
    return acc


def _off_grid_fv(w_i, b_i, n):
    """FV_Norm frames off the Q6.8 grid that split the two roundings of
    layer 1's input product: stream s is (x0, x1, 0, ...) with x0 on the
    grid and x1 a float32 for which acc = x0 w0 + x1 w1 (+ b) rounds to
    another Q6.8 code under a fused multiply-add than under
    multiply-then-add, in an n-gate column (tanh's steep part). Searched
    over x0 and the float32 values of x1 next to a code boundary."""
    from repro_torch.core.fex import fma_f32

    fv = torch.zeros((n, 16), dtype=torch.float32)
    x0 = torch.arange(1, 33, dtype=torch.float32)[:, None] * 0.125
    x0 = torch.cat([x0, -x0])  # on the grid, |x0| <= 4
    steps = 1 + torch.arange(-2000, 2001, dtype=torch.float32) * 2.0**-24
    found = 0
    for s in range(n):
        j = 96 + (7 * s) % 48
        w0, w1, b = w_i[0, j], w_i[1, j], b_i[j]
        if float(w0) == 0.0 or float(w1) == 0.0:
            continue
        acc1 = x0 * w0  # exact: both on their grids
        boundary = (torch.round((acc1 + b) * 256) + 1.5) / 256
        cand = ((boundary - b - acc1) / w1) * steps
        two = ((acc1 + cand * w1) + b) * 256
        one = (fma_f32(cand, w1.expand_as(cand), acc1.expand_as(cand)) + b) * 256
        split = torch.nonzero(torch.round(two) != torch.round(one))
        if len(split):
            i, c = split[0].tolist()
            fv[s, 0], fv[s, 1] = x0[i, 0], cand[i, c]
            found += 1
    assert found >= n // 2
    return fv


def test_qat_fv_tick_off_grid_input_multiplies_then_adds(dev, monkeypatch):
    """Layer 1's input on an FV tick is the caller's float FV_Norm, off the
    Q6.8 grid: its products are inexact, so the kernel multiplies, then
    adds there (the other qat products are exact and fused). The plain
    tick's matmuls run in that stated order (cuBLAS fixes none); the
    inputs are built so that a fused multiply-add gives another state."""
    from repro_torch.core import gru as gru_mod

    pipe = _pipe(dev, "qat", None)
    params = pipe.prepare_params(pipe.init_params(torch.Generator().manual_seed(1), device=dev))
    ops = pack_operands(pipe, params, pipe.state, dev)
    w_i = ops.w[: 16 * 144].view(16, 144).float().cpu() / 128
    b_i = ops.b[:144].float().cpu() * 2.0**-15
    n = 64
    inp = _off_grid_fv(w_i, b_i, n).to(dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    plain = {}
    for fused in (True, False):
        monkeypatch.setattr(gru_mod, "_matmul", lambda x, w, f=fused: _ordered_matmul(x, w, f))
        kg, plain[fused], ks, ps = _tick_once(pipe, params, n, dev, inp, mask)
    assert not all(torch.equal(a, b) for a, b in zip(plain[False], plain[True]))
    for a, b in zip(tree_leaves(kg), tree_leaves(plain[False])):
        assert torch.equal(a, b)
    assert float((ks - ps).abs().max()) <= 1e-6


# ---------------- K4, the ΔGRU branch of the tick ----------------


def _unaligned(states):
    """The same ΔGRU state with every staged leaf one word into a buffer of
    its own: the kernel stages it by cp.async words, not bulk copies."""
    out = []
    for st in states:
        moved = dict(st)
        for key in ("x_ref", "h_ref", "acc_x", "acc_h"):
            buf = torch.zeros(st[key].numel() + 1, dtype=st[key].dtype, device=st[key].device)
            moved[key] = buf[1:].view(st[key].shape)
            moved[key].copy_(st[key])
            assert moved[key].data_ptr() % 16 == 4
        out.append(moved)
    return tuple(out)


def _delta_ticks(pipe, params, n, dev, inputs, masks, raw=False, unaligned=False):
    """Kernel against the plain sparse tick over ``inputs`` / ``masks``,
    each tick from the kernel's state: every leaf array-equal, top equal,
    scores within 1e-6. Returns the (before, after) ΔGRU states a tick."""
    ops = pack_operands(pipe, params, pipe.state, dev)
    step_fn = make_sparse_step(pipe)
    gru = tuple(pipe.streaming_init(n, dev))
    state = (_unaligned(gru) if unaligned else gru, pipe.streaming_features_init(n, dev),
             torch.zeros((n, 12), device=dev), None)
    history = []
    for t, (inp, mask) in enumerate(zip(inputs, masks)):
        before = tree_clone(state[0])
        (pg, pc, ps, _), _, ptop = tick_reference(pipe, raw, params, tree_clone(state), inp,
                                                  mask, pipe.state, 0.7, step_fn=step_fn)
        (kg, kc, ks, _), _, ktop = tick_fused(pipe, raw, params, state, inp, mask, pipe.state,
                                              0.7, operands=ops)
        for a, b in zip(tree_leaves(kg), tree_leaves(pg)):
            assert torch.equal(a, b), f"tick {t}"
        assert torch.equal(ktop, ptop) and float((ks - ps).abs().max()) <= 1e-6
        history.append((before, tree_clone(kg)))
        state = (kg, kc, ks, None)
    return history


def _fv(dev, n, t, scale=512):
    g = torch.Generator(device=dev).manual_seed(40 + t)
    return torch.round(torch.randn((n, 16), generator=g, device=dev) * scale) / 256


@pytest.mark.parametrize("classifier", ["delta", "delta-int"])
@pytest.mark.parametrize("theta", [0.0, 0.15, 64.0])
@pytest.mark.parametrize("case", ["ragged", "unaligned"])
def test_delta_tick_edges_equal_plain(dev, classifier, theta, case):
    """4 099 streams (a last block of 3) with non-submitting streams in
    every tick but the first, raw audio and FV input; and a state whose
    staged arrays are off 16 bytes (staged by words, written back by
    words)."""
    pipe = _pipe(dev, classifier, theta)
    params = pipe.prepare_params(pipe.init_params(torch.Generator().manual_seed(1), device=dev))
    n = 4099 if case == "ragged" else 37
    g = torch.Generator(device=dev).manual_seed(3)
    masks = [torch.ones(n, dtype=torch.bool, device=dev)] + [
        torch.rand(n, generator=g, device=dev) < f for f in (0.7, 0.0, 0.5)]
    unaligned = case == "unaligned"
    _delta_ticks(pipe, params, n, dev, [_fv(dev, n, t) for t in range(4)], masks,
                 unaligned=unaligned)
    audio = [torch.randn((n, 256), generator=g, device=dev) * 0.1 for _ in range(4)]
    _delta_ticks(pipe, params, n, dev, audio, masks, raw=True, unaligned=unaligned)


@pytest.mark.parametrize("classifier", ["delta", "delta-int"])
def test_delta_tick_where_every_column_fires(dev, classifier):
    """θ = 0 and loud FV input swinging each tick: in the first block every
    input and state column of both layers fires for some stream, so the
    tiles walk all 64 and 96 columns."""
    pipe = _pipe(dev, classifier, 0.0)
    params = pipe.prepare_params(pipe.init_params(torch.Generator().manual_seed(1), device=dev))
    n = 64
    inputs = [(-1) ** t * _fv(dev, n, t, scale=2048) for t in range(4)]
    history = _delta_ticks(pipe, params, n, dev, inputs,
                           [torch.ones(n, dtype=torch.bool, device=dev)] * 4)
    before, after = history[-1]
    for old, new in zip(before, after):
        for key in ("x_ref", "h_ref"):
            fired = (new[key][:16] != old[key][:16]).any(dim=0)
            assert bool(fired.all()), key


def test_delta_int_tick_contributions_at_the_int24_clip(dev):
    """Layer 1's input product at its extremes: FV codes swinging between
    +-8189 against weight codes of +-127 give 16-term contributions of
    +-1.66e7 and +-3.3e7, past int24, so the accumulators tell a
    contribution clipped once to int24 (intgemm's rule, gather.py's) from
    an unclipped one."""
    pipe = _pipe(dev, "delta-int", 0.15)
    params = pipe.init_params(torch.Generator().manual_seed(1), device=dev)
    even = torch.arange(144, device=dev) % 2 == 0
    params["gru"][0]["w_i"] = torch.where(even, 127.0, -127.0).expand(16, 144) / 128
    q = pipe.prepare_params(params)
    n = 37
    rows = (torch.arange(n, device=dev)[:, None] % 3 - 1).float()  # -1, 0, +1
    inputs = [((-1) ** t * rows * 8189 / 256).expand(n, 16).contiguous() for t in range(3)]
    codes = torch.round(inputs[1] * 256) - torch.round(inputs[0] * 256)
    raw_contrib = codes.to(torch.int64).cpu() @ q.gru[0]["w_i"].to(torch.int64).cpu()
    assert bool((raw_contrib.abs() > 2**23).any())  # the contributions do clip
    _delta_ticks(pipe, q, n, dev, inputs, [torch.ones(n, dtype=torch.bool, device=dev)] * 3)


SERVERS = [(c, t, "software") for c, t in BACKENDS[:5]] + [
    ("qat", None, "hardware"), ("delta-int", 0.15, "hardware-pallas")]


@pytest.mark.parametrize("classifier,theta,frontend", SERVERS,
                         ids=[f"{c}-{t}-{f}" for c, t, f in SERVERS])
def test_server_launches_one_tick_kernel_per_tick(dev, classifier, theta, frontend):
    pipe = _pipe(dev, classifier, theta, frontend)
    srv = StreamingKWSServer(pipe, pipe.init_params(torch.Generator().manual_seed(3)), max_streams=64)
    for sid in range(40):
        srv.open_stream(sid)
    rng = np.random.default_rng(4)
    build.launches.clear()
    for _ in range(3):
        srv.step_batch((rng.standard_normal((64, 256)) * 0.1).astype(np.float32), rng.random(64) < 0.8)
    srv.run_batch((rng.standard_normal((4, 64, 256)) * 0.1).astype(np.float32), np.ones((4, 64), bool))
    assert dict(build.launches) == {"tick_fused": 7}
    sp = srv.sparsity
    assert sp.shape == (64,) and (sp <= 1).all()
    if theta is None:
        assert (sp == 1).all()
    elif theta > 0:
        assert (sp < 1).any()


def test_integer_pipeline_step_launches_intgemm_five_times(dev):
    pipe = KWSPipeline(KWSPipelineConfig(classifier="integer"))
    params = pipe.init_params(torch.Generator().manual_seed(5), device=dev)
    states = pipe.streaming_init(N, dev)
    fv = torch.round(torch.randn((N, 16), device=dev) * 512) / 256
    build.launches.clear()
    states, logits = pipe.streaming_step(params, states, fv)
    assert build.launches["intgemm"] == 5
    cpu_states, cpu_logits = pipe.streaming_step(
        pipe.prepare_params(params).to("cpu"), pipe.streaming_init(N, "cpu"), fv.cpu()
    )
    assert torch.equal(logits.cpu(), cpu_logits)
    for a, b in zip(states, cpu_states):
        assert torch.equal(a.cpu(), b)


def test_delta_int_pipeline_step_launches_intgemm_five_times(dev):
    pipe = KWSPipeline(KWSPipelineConfig(classifier="delta-int", delta=DeltaConfig(0.15, 0.15)))
    params = pipe.init_params(torch.Generator().manual_seed(6), device=dev)
    fv = torch.round(torch.randn((N, 16), device=dev) * 512) / 256
    states, cpu_states = pipe.streaming_init(N, dev), pipe.streaming_init(N, "cpu")
    q = pipe.prepare_params(params)
    cpu_q = q.to("cpu")
    for _ in range(2):
        build.launches.clear()
        states, logits = pipe.streaming_step(q, states, fv)
        assert build.launches["intgemm"] == 5
        cpu_states, cpu_logits = pipe.streaming_step(cpu_q, cpu_states, fv.cpu())
        assert torch.equal(logits.cpu(), cpu_logits)
    for a, b in zip(tree_leaves(states), tree_leaves(cpu_states)):
        assert torch.equal(a.cpu(), b)


def test_wrappers_reject_other_devices_and_dtypes(dev):
    with pytest.raises(TypeError, match="int32 x and int8 w"):
        intgemm(torch.zeros((2, 3), device=dev, dtype=torch.int64), torch.zeros((3, 2), device=dev, dtype=torch.int8))
    with pytest.raises(ValueError, match="do not chain"):
        intgemm(torch.zeros((2, 3), device=dev, dtype=torch.int32), torch.zeros((4, 2), device=dev, dtype=torch.int8))
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        fex_fused(torch.zeros((2, 1024), device=dev, dtype=torch.float64), _coeffs(dev), 512)
    with pytest.raises(TypeError, match="float32"):
        biquad_stream(torch.zeros((2, 64), device=dev, dtype=torch.bfloat16), _coeffs(dev))
    with pytest.raises(ValueError, match="carry must be float32"):
        biquad_stream(torch.zeros((2, 64), device=dev), _coeffs(dev),
                      (torch.zeros((3, 16), device=dev), torch.zeros((3, 16), device=dev)))
    with pytest.raises(TypeError, match="float32"):
        tdc_counts(torch.zeros((1, 512, 16), device=dev, dtype=torch.float64), TDFExConfig())
    with pytest.raises(ValueError, match="no kernel or plain version"):
        fex_fused(torch.zeros((2, 1024), device="meta"), _coeffs("cpu"), 512)


def test_tick_wrapper_checks_the_hardware_carry(dev):
    pipe = _pipe(dev, "qat", None, "hardware")
    params = pipe.prepare_params(pipe.init_params(torch.Generator().manual_seed(1), device=dev))
    ops = pack_operands(pipe, params, pipe.state, dev)
    n = 8
    state = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
             torch.zeros((n, 12), device=dev), None)
    inp, mask = torch.zeros((n, 256), device=dev), torch.ones(n, dtype=torch.bool, device=dev)
    short = (state[0], {k: state[1][k] for k in ("s1", "s2")}, state[2], None)
    with pytest.raises(ValueError, match="carry must hold"):
        tick_fused(pipe, True, params, short, inp, mask, pipe.state, 0.7, operands=ops)
    bad = (state[0], dict(state[1], r=state[1]["r"][:4]), state[2], None)
    with pytest.raises(ValueError, match="carry\\['r'\\]"):
        tick_fused(pipe, True, params, bad, inp, mask, pipe.state, 0.7, operands=ops)
    soft = _pipe(dev, "qat", None)
    with pytest.raises(ValueError, match="another frontend"):
        tick_fused(soft, True, params, state, inp, mask, soft.state, 0.7, operands=ops)


def _coeffs(dev):
    return FExConfig().filterbank().stacked(device=dev)


# ---------------- the cascade branch of the tick ----------------

CASCADE_BACKENDS = [("qat", None), ("integer", None), ("float", None),
                    ("delta", 0.15), ("delta-int", 0.15)]


def _cascade_cases():
    cases = [(c, t, det, kind, True, "software") for c, t in CASCADE_BACKENDS
             for det in ("energy", "linear") for kind in ("gated", "always_on")]
    cases += [(c, t, det, "gated", False, "software") for c, t in CASCADE_BACKENDS
              for det in ("energy", "linear")]
    return cases + [("qat", None, "energy", "gated", True, "hardware"),
                    ("delta-int", 0.15, "linear", "gated", True, "hardware")]


def _inputs(dev, n, raw, t):
    g = torch.Generator(device=dev).manual_seed(20 + t)
    if raw:  # quiet and loud streams: -60 to -6 dB full scale
        return torch.randn((n, 256), generator=g, device=dev) * torch.logspace(
            -3, -0.3, n, device=dev)[:, None]
    return torch.round(torch.randn((n, 16), generator=g, device=dev) * 512) / 256


def _gate_config(pipe, detector, kind, inp, raw):
    """A cascade that gates about half of the streams of ``inp``: the
    threshold at the median score (energy), or the bias at minus the
    median logit (linear, threshold 0.5); hangover 2, decay 0.9."""
    from repro_torch.serving.cascade import CascadeConfig, detector_scores

    fv = inp
    if raw:
        carry = pipe.streaming_features_init(inp.shape[0], inp.device)
        _, fv = pipe.streaming_features_apply(carry, inp, pipe.state)
    if detector == "energy":
        thr = float(detector_scores(fv, CascadeConfig()).median())
        extra = {}
    else:
        w = tuple(float(v) for v in torch.linspace(-0.6, 0.9, 16))
        z = fv @ torch.tensor(w, device=fv.device)
        thr, extra = 0.5, dict(linear_w=w, linear_b=-float(z.median()))
    if kind == "always_on":
        return CascadeConfig.always_on(detector=detector, **extra)
    return CascadeConfig(detector=detector, wake_threshold=thr, release_threshold=0.8 * thr,
                         hangover_frames=2, score_decay=0.9, **extra)


@pytest.mark.parametrize("classifier,theta,detector,kind,raw,frontend", _cascade_cases(),
                         ids=[f"{c}-{t}-{d}-{k}-{'raw' if r else 'fv'}-{f}"
                              for c, t, d, k, r, f in _cascade_cases()])
@pytest.mark.parametrize("n", [N, 37], ids=["full", "ragged"])
def test_cascade_tick_kernel_equals_plain(dev, classifier, theta, detector, kind, raw,
                                          frontend, n):
    """The cascade branch against the plain tick: the detector state, the
    GRU state (the ΔGRU memories and counters under the wake row mask),
    the carry and top array-equal, scores within 1e-6 (float within
    FLOAT_TOL); an always-open gate equals the ungated kernel."""
    import dataclasses

    from repro_torch.serving.cascade import init_state

    base = _pipe(dev, classifier, theta, frontend)
    casc = _gate_config(base, detector, kind, _inputs(dev, n, raw, 0), raw)
    pipe = KWSPipeline(dataclasses.replace(base.config, cascade=casc), state=base.state)
    params = pipe.prepare_params(pipe.init_params(torch.Generator().manual_seed(1), device=dev))
    ops = pack_operands(pipe, params, pipe.state, dev)
    step_fn = make_sparse_step(pipe)
    flt = classifier == "float"
    state = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
             torch.zeros((n, 12), device=dev), init_state(n, dev))
    plain_state = (tree_clone(state[0]), tree_clone(state[1]), state[2].clone(), None)
    g = torch.Generator(device=dev).manual_seed(2)
    for t, frac in enumerate([1.0, 0.8, 0.0, 0.9, 0.6]):
        inp = _inputs(dev, n, raw, t)
        mask = torch.rand(n, generator=g, device=dev) < frac
        (pg, pc, ps, pd), _, ptop = tick_reference(pipe, raw, params, tree_clone(state), inp,
                                                   mask, pipe.state, 0.7, step_fn=step_fn)
        before = build.launches["tick_fused"]
        (kg, kc, ks, kd), _, ktop = tick_fused(pipe, raw, params, tree_clone(state), inp, mask,
                                               pipe.state, 0.7, operands=ops)
        assert build.launches["tick_fused"] == before + 1
        for key in pd:
            assert torch.equal(kd[key], pd[key]), (t, key)
        for a, b in zip(tree_leaves(kg), tree_leaves(pg)):
            if flt:
                assert float((a - b).abs().max()) <= FLOAT_TOL, f"tick {t}"
            else:
                assert torch.equal(a, b), f"tick {t}"
        for key in pc:
            assert torch.equal(kc[key], pc[key]), key
        assert float((ks - ps).abs().max()) <= (FLOAT_TOL if flt else 1e-6)
        if not flt:
            assert torch.equal(ktop, ptop)
        if kind == "always_on":  # the ungated kernel, bit for bit
            ungated = KWSPipeline(base.config, state=base.state)
            (ug, uc, us, _), _, utop = tick_fused(
                ungated, raw, params, plain_state, inp, mask, pipe.state, 0.7,
                operands=pack_operands(ungated, params, pipe.state, dev))
            plain_state = (ug, uc, us, None)
            for a, b in zip(tree_leaves(ug), tree_leaves(kg)):
                assert torch.equal(a, b)
            assert torch.equal(us, ks) and torch.equal(utop, ktop)
        state = (kg, kc, ks, kd)
    woken, ticks = state[3]["woken"], state[3]["ticks"]
    if kind == "always_on":
        assert torch.equal(woken, ticks)
    else:
        assert bool((woken < ticks).any()) and bool((woken > 0).any())


def test_cascade_wrapper_checks_the_detector_state(dev):
    from repro_torch.serving.cascade import CascadeConfig, init_state

    pipe = KWSPipeline(KWSPipelineConfig(cascade=CascadeConfig(wake_threshold=0.1)),
                       norm_stats=_norm_stats(dev))
    params = pipe.prepare_params(pipe.init_params(torch.Generator().manual_seed(1), device=dev))
    ops = pack_operands(pipe, params, pipe.state, dev)
    n = 8
    base = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
            torch.zeros((n, 12), device=dev))
    inp, mask = torch.zeros((n, 256), device=dev), torch.ones(n, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="det must be given"):
        tick_fused(pipe, True, params, base + (None,), inp, mask, pipe.state, 0.7, operands=ops)
    bad = dict(init_state(n, dev), hang=torch.zeros(n, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match=r"det\['hang'\]"):
        tick_fused(pipe, True, params, base + (bad,), inp, mask, pipe.state, 0.7, operands=ops)


@pytest.mark.parametrize("classifier,theta", [("qat", None), ("delta", 0.15)])
def test_cascaded_server_launches_one_tick_kernel_per_tick(dev, classifier, theta):
    from repro_torch.serving.cascade import CascadeConfig

    base = _pipe(dev, classifier, theta)
    import dataclasses

    pipe = KWSPipeline(dataclasses.replace(
        base.config, cascade=CascadeConfig(wake_threshold=0.15, hangover_frames=1)),
        state=base.state)
    srv = StreamingKWSServer(pipe, pipe.init_params(torch.Generator().manual_seed(3)),
                             max_streams=64)
    for sid in range(40):
        srv.open_stream(sid)
    rng = np.random.default_rng(4)
    gains = np.logspace(-3, -0.3, 64).astype(np.float32)[:, None]
    build.launches.clear()
    for _ in range(3):
        srv.step_batch((rng.standard_normal((64, 256)) * gains).astype(np.float32),
                       rng.random(64) < 0.8)
    srv.run_batch((rng.standard_normal((4, 64, 256)) * gains).astype(np.float32),
                  np.ones((4, 64), bool))
    assert dict(build.launches) == {"tick_fused": 7}
    wr = srv.wake_rate
    assert wr.shape == (64,) and (wr <= 1).all() and (wr[:40] < 1).any()


@pytest.mark.parametrize("window", [1, 3])
def test_pinned_ingress_equals_the_step_batch_sequence(dev, window):
    """PipelinedIngress on the card (pinned staging, async copies, events)
    against step_batch on a twin server, bit for bit, handles fetched
    late; the same for step_batch_async and a coalescer."""
    from repro_torch.serving.ingress import PipelinedIngress, TickCoalescer

    pipe = _pipe(dev, "qat", None)
    params = pipe.init_params(torch.Generator().manual_seed(3))
    a = StreamingKWSServer(pipe, params, max_streams=N)
    b = StreamingKWSServer(pipe, params, max_streams=N)
    for srv in (a, b):
        for sid in range(N):
            srv.open_stream(sid)
    rng = np.random.default_rng(5)
    ticks = [((rng.standard_normal((N, 256)) * 0.1).astype(np.float32), rng.random(N) < 0.85)
             for _ in range(7)]
    ing = PipelinedIngress(a, 256, depth=2, window=window)
    assert ing._slab_t[0].is_pinned() and ing._mask_t[0].is_pinned()
    for slab, mask in ticks:
        s, m = ing.stage()
        s[:] = slab
        m[:] = mask
        ing.commit()
    handles = ing.drain()
    late = [a.step_batch_async(*t) for t in ticks[:2]]
    rows = [r for h in handles for r in (zip(*h.result()) if window > 1 else [h.result()])]
    for (gs, gt), t in zip(rows + [h.result() for h in late], ticks + ticks[:2], strict=True):
        rs, rt = b.step_batch(*t)
        np.testing.assert_array_equal(gs, rs)
        np.testing.assert_array_equal(gt, rt)
    for x, y in zip(a.state.leaves(), b.state.leaves()):
        assert torch.equal(x, y)
    co = TickCoalescer(a)
    frames = {sid: ticks[0][0][sid] for sid in range(N)}
    for sid, f in frames.items():
        co.add(sid, f)
    (h,) = co.drain()
    ref = b.step(frames)
    np.testing.assert_array_equal(h.scores[0], ref[0]["probs"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,c,frame", [(8, 4096, 16, 512), (1, 512, 16, 512), (5, 1100, 8, 256)])
def test_fex_fused_kernel_equals_plain(dev, dtype, b, t, c, frame):
    from repro_torch.core.filters import design_filterbank

    g = torch.Generator(device=dev).manual_seed(b + t)
    x = (torch.randn((b, t), generator=g, device=dev) * 0.2).to(dtype)
    coeffs = design_filterbank(c, 32000.0)
    before = build.launches["fex_fused"]
    got = fex_fused(x, coeffs, frame)
    assert build.launches["fex_fused"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, t // frame, c)
    assert torch.equal(got, fex_fused_ref(x[:, : (t // frame) * frame], coeffs, frame))


@pytest.mark.parametrize("b,t", [(8, 3000), (1, 1), (33, 512)])
def test_scan_entry_equals_plain_with_its_carry(dev, b, t):
    g = torch.Generator(device=dev).manual_seed(b * t)
    x = torch.randn((b, t), generator=g, device=dev) * 0.3
    coeffs = _hw_state(dev).coeffs
    carry = (torch.randn((b, 16), generator=g, device=dev) * 0.01,
             torch.randn((b, 16), generator=g, device=dev) * 0.01)
    before = build.launches["biquad_stream"]
    y, (s1, s2) = biquad_stream(x, coeffs, carry)
    assert build.launches["biquad_stream"] == before + 1
    py, (p1, p2) = biquad_stream_ref(x, coeffs, carry)
    assert torch.equal(y, py) and torch.equal(s1, p1) and torch.equal(s2, p2)


# (b, c): one clip, a partial last block (33 clips at 2 a block, 33 at 32
# a block), 7 channels (4 clips a block, 4 lanes idle), a whole warp of
# channels, and 33 (two channel groups, the writer warp copies y)
FEX_BC = [(1, 16), (33, 16), (33, 1), (5, 7), (3, 32), (2, 33)]
# (frame_len, frames): 512 takes the branch-free body over whole 256-sample
# chunks; 100 and 20 the event loop, with T not a multiple of the chunk and
# (20 x 10) T shorter than one chunk
FEX_FRAMES = [(512, 3), (100, 7), (20, 10)]


def _fex_audio(dev, b, t, seed, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((b, t), generator=g, device=dev) * 0.2).to(dtype)


def _fex_coeffs(c):
    from repro_torch.core.filters import design_filterbank

    return design_filterbank(c, 32000.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("frame,frames", FEX_FRAMES)
@pytest.mark.parametrize("b,c", FEX_BC)
@pytest.mark.parametrize("tail", [False, True], ids=["whole", "tail"])
def test_fex_fused_kernel_edges_equal_plain(dev, dtype, frame, frames, b, c, tail):
    """K1 bit-equal at every edge of its geometry; a tail of frame / 2 + 1
    samples past the last frame leaves rows the kernel reads in place at a
    stride that is not whole 16-byte words (staged by cp.async / plain
    loads)."""
    t = frame * frames
    extra = frame // 2 + 1 if tail else 0
    x = _fex_audio(dev, b, t + extra, seed=b + c + frame + extra, dtype=dtype)
    coeffs = _fex_coeffs(c)
    before = build.launches["fex_fused"]
    got = fex_fused(x, coeffs, frame)
    assert build.launches["fex_fused"] == before + 1
    assert got.shape == (b, frames, c)
    assert torch.equal(got, fex_fused_ref(x[:, :t], coeffs, frame))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fex_fused_kernel_unaligned_input_equals_plain(dev, dtype):
    """Audio whose address is 4 (bfloat16: 2) bytes off 16-byte alignment
    is staged by the producer warp instead of bulk copies."""
    b, t = 3, 1024
    flat = torch.empty(b * t + 1, device=dev, dtype=dtype)
    x = flat[1:].view(b, t)
    x.copy_(_fex_audio(dev, b, t, seed=5, dtype=dtype))
    assert x.data_ptr() % 16 != 0
    coeffs = _fex_coeffs(16)
    assert torch.equal(fex_fused(x, coeffs, 512), fex_fused_ref(x, coeffs, 512))


def test_fex_fused_reads_untrimmed_rows_in_place(dev):
    """(64, 32 000) oversampled clips trimmed to 62 frames: the kernel reads
    the view's rows at their stride, and nothing the size of the audio is
    allocated around the launch."""
    x = _fex_audio(dev, 64, 32000, seed=6)
    coeffs = FExConfig().filterbank()
    fex_fused(x, coeffs, 512)  # the library is built and loaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    got = fex_fused(x, coeffs, 512)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base < x.numel() * x.element_size() // 8
    assert got.shape == (64, 62, 16)
    assert torch.equal(got, fex_fused_ref(x[:, :31744], coeffs, 512))


def _carry(dev, b, c, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((b, c), generator=g, device=dev) * 0.01,
            torch.randn((b, c), generator=g, device=dev) * 0.01)


# T = 1, T not a multiple of 4 (3, 1001), shorter than a chunk (200), and
# whole and partial chunks (768, 1001, 3000)
@pytest.mark.parametrize("t", [1, 3, 200, 768, 1001, 3000])
@pytest.mark.parametrize("b,c", FEX_BC)
def test_scan_entry_edges_equal_plain(dev, t, b, c):
    x = _fex_audio(dev, b, t, seed=b * t + c) * 1.5
    coeffs = _fex_coeffs(c)
    carry = _carry(dev, b, c, seed=t + c)
    before = build.launches["biquad_stream"]
    y, (s1, s2) = biquad_stream(x, coeffs, carry)
    assert build.launches["biquad_stream"] == before + 1
    py, (p1, p2) = biquad_stream_ref(x, coeffs, carry)
    assert y.shape == (b, t, c)
    assert torch.equal(y, py) and torch.equal(s1, p1) and torch.equal(s2, p2)


def test_scan_entry_unaligned_and_strided_input_equals_plain(dev):
    """Audio 4 bytes off 16-byte alignment, and a view of every other
    row's first 700 samples (read in place at its stride)."""
    coeffs = _fex_coeffs(16)
    flat = torch.empty(3 * 1000 + 1, device=dev)
    x = flat[1:].view(3, 1000)
    x.copy_(_fex_audio(dev, 3, 1000, seed=8))
    assert x.data_ptr() % 16 != 0
    y, (s1, s2) = biquad_stream(x, coeffs)
    py, (p1, p2) = biquad_stream_ref(x, coeffs)
    assert torch.equal(y, py) and torch.equal(s1, p1) and torch.equal(s2, p2)
    wide = _fex_audio(dev, 6, 1024, seed=9)
    view = wide[::2, :700]
    y, (s1, s2) = biquad_stream(view, coeffs)
    py, (p1, p2) = biquad_stream_ref(view.contiguous(), coeffs)
    assert torch.equal(y, py) and torch.equal(s1, p1) and torch.equal(s2, p2)


@pytest.mark.parametrize("split", [1, 256, 777])
@pytest.mark.parametrize("c", [16, 33])
def test_scan_entry_carries_across_calls(dev, split, c):
    """Two calls that hand (s1, s2) on equal one call on the joined input."""
    b, t = 5, 2000
    x = _fex_audio(dev, b, t, seed=split + c)
    coeffs = _fex_coeffs(c)
    carry = _carry(dev, b, c, seed=split)
    y_a, state = biquad_stream(x[:, :split], coeffs, carry)
    y_b, (s1, s2) = biquad_stream(x[:, split:], coeffs, state)
    y, (w1, w2) = biquad_stream(x, coeffs, carry)
    assert torch.equal(torch.cat([y_a, y_b], dim=1), y)
    assert torch.equal(s1, w1) and torch.equal(s2, w2)
    py, (p1, p2) = biquad_stream_ref(x, coeffs, carry)
    assert torch.equal(y, py) and torch.equal(w1, p1) and torch.equal(w2, p2)


@pytest.mark.parametrize("b,frames,c", [(8, 4, 16), (1, 1, 1), (3, 2, 5)])
@pytest.mark.parametrize("mismatch", [False, True], ids=["ideal", "chip"])
def test_tdc_kernel_equals_plain(dev, b, frames, c, mismatch):
    cfg = TDFExConfig()
    g = torch.Generator(device=dev).manual_seed(b + frames + c)
    u = torch.randn((b, 512 * frames + 7, c), generator=g, device=dev).abs() * 0.2
    chip = None
    gain = torch.ones(c, device=dev)
    if mismatch:
        chip = TDFExState(torch.randn(c, generator=g, device=dev) * 0.15, torch.zeros(c, device=dev))
        gain = 1.0 + chip.gain_mismatch
    before = build.launches["tdc"]
    got = tdc_counts(u, cfg, chip)
    assert build.launches["tdc"] == before + 1
    want = tdc_counts_plain(u[:, : 512 * frames], cfg.f_free_hz * gain, cfg.k_sro_hz * gain,
                            512, cfg.tdc_oversample, tdc_scale(cfg))
    assert got.shape == (b, frames, c) and torch.equal(got, want)


def _tdc_case(dev, cfg, b, frames, c, seed, tail=7):
    """(B, T, C) input with a ragged tail of ``tail`` samples past the last
    whole frame, and the samples a frame."""
    spf = cfg.decimation // cfg.tdc_oversample
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randn((b, spf * frames + tail, c), generator=g, device=dev).abs() * 0.2
    return u, spf


def _tdc_plain(u, cfg, spf, frames):
    c = u.shape[-1]
    f0 = torch.full((c,), cfg.f_free_hz, device=u.device)
    k = torch.full((c,), cfg.k_sro_hz, device=u.device)
    return tdc_counts_plain(u[:, : spf * frames].contiguous(), f0, k, spf, cfg.tdc_oversample,
                            tdc_scale(cfg))


# os = 1, 2, 3 (512 = 4 chunks a frame at os = 2 takes the fast loop; os
# = 1 takes the generic one, and 341 samples at os = 3 leave frames that
# end inside a chunk and T not a multiple of it), one to 64 clips, C = 16
# (bulk copies, the vector helper), 1 and 5 (the 7-sample tail leaves
# their runs unaligned: plain loads) and 33 (two channel groups, plain
# loads), 1, 2 and 62 frames; b = frames = c = 1 stays pinned (R4)
TDC_EDGES = [(1, 1, 1), (3, 1, 5), (64, 1, 16), (1, 62, 16), (3, 2, 33), (64, 2, 1),
             (3, 2, 16), (1, 1, 33)]


@pytest.mark.parametrize("os_", [1, 2, 3])
@pytest.mark.parametrize("b,frames,c", TDC_EDGES)
def test_tdc_kernel_geometries_equal_plain(dev, os_, b, frames, c):
    cfg = TDFExConfig(tdc_oversample=os_)
    u, spf = _tdc_case(dev, cfg, b, frames, c, seed=b + frames + c + os_)
    before = build.launches["tdc"]
    got = tdc_counts(u, cfg)
    assert build.launches["tdc"] == before + 1
    assert got.shape == (b, frames, c) and torch.equal(got, _tdc_plain(u, cfg, spf, frames))


def test_tdc_kernel_unaligned_input_equals_plain(dev):
    """An input whose address is not 16-byte aligned is staged by plain
    loads instead of bulk copies."""
    cfg = TDFExConfig()
    u, spf = _tdc_case(dev, cfg, 3, 2, 16, seed=11, tail=0)
    flat = torch.empty(u.numel() + 1, device=dev)
    shifted = flat[1:].view(u.shape)
    shifted.copy_(u)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    assert torch.equal(tdc_counts(shifted, cfg), _tdc_plain(u, cfg, spf, 2))


def _tdc_d(u, cfg):
    """d = scale * max(fma(k, u, f0), 0) in float32 as the kernel rounds it
    (the float64 product and sum are exact, then one rounding: a fused
    multiply-add)."""
    u = np.asarray(u, dtype=np.float32).astype(np.float64)
    fma = np.float32(np.float64(cfg.k_sro_hz) * u + np.float64(cfg.f_free_hz))
    return np.float32(tdc_scale(cfg)) * np.maximum(fma, np.float32(0.0))


@pytest.mark.parametrize("b,c", [(3, 16), (2, 5), (4, 1)])
@pytest.mark.parametrize("level", ["below-2^23", "odd-past-2^23"])
def test_tdc_kernel_d_above_the_magic_floors_limit_equals_plain(dev, b, c, level):
    """Samples that drive d past 2^22 (the 2^23 add is exact only for
    r + d < 2^23): their chunk takes floorf, the others the add.
    below-2^23: one sample a clip with d below 2^23, so a frame's count sum
    stays exact (< 2^24) in the plain version too. odd-past-2^23: 16
    consecutive float32 u with d from 2^23 up, odd integers among them;
    there the add would floor s = r + d one low, so a chunk flagged wrongly
    differs from the plain version (bit-equality needs no exact sum: both
    add a frame's counts tick by tick). No tail: C = 5 and 1 are staged by bulk copies
    here and turned into d by the scalar helper loop."""
    cfg = TDFExConfig()
    u, spf = _tdc_case(dev, cfg, b, 2, c, seed=12, tail=0)
    if level == "below-2^23":
        hi = np.array([2.2e5], dtype=np.float32)
        d = _tdc_d(hi, cfg)
        assert ((d >= 2.0**22) & (d < 2.0**23)).all()
    else:
        hi = np.float32(298262.0) + np.arange(16, dtype=np.float32) * np.float32(2.0**-5)
        d = _tdc_d(hi, cfg)
        assert (d >= 2.0**23).all() and (d < 2.0**24).all() and (d % 2 == 1).sum() >= 4
    u[:, 700:700 + hi.size, :] = torch.from_numpy(hi).to(dev)[None, :, None]
    want = _tdc_plain(u, cfg, spf, 2)
    assert float(want.max()) >= 2.0**23 and torch.equal(tdc_counts(u, cfg), want)


@pytest.mark.parametrize("frontend", ["software", "hardware", "hardware-pallas"])
def test_features_run_their_kernels_and_equal_the_cpu(dev, frontend):
    state = FrontendState() if frontend == "software" else _hw_state(dev)
    pipe = KWSPipeline(KWSPipelineConfig(frontend=frontend), state=state)
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal((6, 2000)) * np.logspace(-2, -0.3, 6)[:, None]).astype(np.float32)
    build.launches.clear()
    got = pipe.record_features(audio, batch_size=4)
    want = {"software": {"fex_fused": 2}, "hardware": {"biquad_stream": 2},
            "hardware-pallas": {"biquad_stream": 2, "tdc": 2}}[frontend]
    assert dict(build.launches) == want
    cpu_state = FrontendState() if frontend == "software" else hardware_state(
        TDFExConfig(), TDFExState(state.chip.gain_mismatch.cpu(), state.chip.cf_mismatch.cpu()),
        state.beta.cpu(), state.alpha.cpu(), device="cpu")
    cpu = KWSPipeline(pipe.config, state=cpu_state).record_features(audio, batch_size=4,
                                                                    device="cpu")
    np.testing.assert_array_equal(got, cpu)


# ---------------- K6: gru_sequence ----------------

def _gru_operands(dev, b, t, i, h, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    return (rn(b, t, i), rn(i, 3 * h) * 0.2, rn(h, 3 * h) * 0.2, rn(3 * h) * 0.1,
            rn(3 * h) * 0.1, rn(b, h))


# the paper's two layers at the main path's 4096 streams, a ragged last
# tile, the reference's non-square sweep shapes, T = 1; then the edges of
# the 16-row, 4 x 2 tiles: ragged batches, I off the 4-wide x loads (words
# or, in bf16, elements staged), an odd H (a last unit pair half masked),
# xs a contiguous view ``off`` elements past a 16-byte boundary (4 or 8
# bytes in float32; 2 or 4 in bf16), T = 1 at full width (h0 is nonzero
# in every case)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,i,h,off", [
    (N, 62, 16, 48, 0), (N, 62, 48, 48, 0), (37, 62, 16, 48, 0), (9, 7, 32, 64, 0),
    (2, 62, 16, 48, 0), (5, 1, 8, 16, 0),
    (4099, 62, 16, 48, 0), (33, 62, 48, 48, 0), (4099, 5, 48, 48, 0), (33, 20, 5, 48, 0),
    (33, 20, 17, 48, 0), (40, 20, 16, 47, 0), (17, 9, 5, 47, 0), (N, 62, 16, 48, 1),
    (33, 20, 48, 48, 2), (35, 20, 17, 48, 1), (N, 1, 16, 48, 0), (N, 1, 48, 48, 0),
])
def test_gru_seq_kernel_equals_plain(dev, dtype, b, t, i, h, off):
    xs, w, u, bi, bh, h0 = _gru_operands(dev, b, t, i, h, seed=b + t + i + h)
    if off:
        flat = torch.zeros(b * t * i + off, dtype=dtype, device=dev)
        flat[off:].copy_(xs.reshape(-1))
        xs = flat[off:].view(b, t, i)
        assert xs.is_contiguous() and xs.data_ptr() % 16 == off * xs.element_size()
    xs = xs.to(dtype)
    before = build.launches["gru_seq"]
    got = gru_sequence(xs, w, u, bi, bh, h0)
    torch.cuda.synchronize()
    assert build.launches["gru_seq"] == before + 1
    assert got.shape == (b, t, h) and got.dtype == dtype
    want = gru_sequence_plain(xs.transpose(0, 1), w, u, bi, bh, h0).transpose(0, 1)
    tol = FLOAT_TOL if dtype == torch.float32 else BF16_TOL
    assert float((got.float() - want.float()).abs().max()) <= tol
    # h0 defaults to zeros
    got0 = gru_sequence(xs, w, u, bi, bh)
    want0 = gru_sequence_plain(xs.transpose(0, 1), w, u, bi, bh, torch.zeros_like(h0))
    assert float((got0.float() - want0.transpose(0, 1).float()).abs().max()) <= tol


def test_gru_seq_wrapper_rejects_dtypes_and_oversized_layers(dev):
    xs, w, u, bi, bh, h0 = _gru_operands(dev, 4, 3, 16, 48, seed=1)
    with pytest.raises(TypeError, match="float32 or bfloat16 xs"):
        gru_sequence(xs.half(), w, u, bi, bh, h0)
    with pytest.raises(TypeError, match="float32 or bfloat16 w"):
        gru_sequence(xs, w.double(), u, bi, bh, h0)
    with pytest.raises(ValueError, match="do not chain"):
        gru_sequence(xs, w[:8], u, bi, bh, h0)
    with pytest.raises(ValueError, match="on cpu"):
        gru_sequence(xs, w, u.cpu(), bi, bh, h0)
    big = _gru_operands(dev, 4, 3, 128, 128, seed=2)
    before = build.launches["gru_seq"]
    with pytest.raises(ValueError, match="shared memory"):
        gru_sequence(*big)
    assert build.launches["gru_seq"] == before


# ---------------- K7: wkv6 ----------------

def _wkv_operands(dev, b, t, h, p, seed, strong=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    r, k, v = rn(b, t, h, p), rn(b, t, h, p), rn(b, t, h, p)
    lw = torch.full((b, t, h, p), -50.0, device=dev) if strong else -torch.exp(rn(b, t, h, p) - 1)
    return r, k, v, lw, rn(h, p) * 0.3


def _wkv_rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


# rwkv6-7b's head layout (H = 64, P = 64) at a short T, the reference's
# shapes (P = 4, 8, 16), an odd P, T = 1, and strong decay
@pytest.mark.parametrize("b,t,h,p,strong", [(8, 256, 64, 64, False), (1, 8, 1, 4, False),
                                            (3, 24, 2, 8, False), (2, 16, 4, 16, False),
                                            (2, 40, 3, 33, False), (5, 1, 2, 64, False),
                                            (2, 12, 1, 4, True), (2, 64, 4, 64, True)])
def test_wkv6_kernel_equals_plain(dev, b, t, h, p, strong):
    r, k, v, lw, u = _wkv_operands(dev, b, t, h, p, seed=b * t + h + p, strong=strong)
    before = build.launches["wkv6"]
    got = wkv6(r, k, v, lw, u)
    torch.cuda.synchronize()
    assert build.launches["wkv6"] == before + 1
    assert got.shape == (b, t, h, p) and got.dtype == torch.float32
    assert _wkv_rel(got, wkv6_plain(r, k, v, lw, u)) <= WKV_REL_TOL


# T = 1, one chunk (16), one chunk + 1, 33; P = 1, 33, 63, 64; B·H = 529
# (above the 528 blocks that 132 SMs hold at four each, and not a
# multiple of four); strong decay
@pytest.mark.parametrize("b,t,h,p,strong", [(3, 1, 2, 64, False), (2, 16, 3, 64, False),
                                            (2, 17, 3, 64, False), (1, 33, 2, 1, False),
                                            (2, 17, 2, 33, False), (1, 40, 3, 63, False),
                                            (23, 20, 23, 64, False), (3, 17, 5, 33, True),
                                            (1, 33, 2, 64, True)])
def test_wkv6_kernel_edges_equal_plain(dev, b, t, h, p, strong):
    r, k, v, lw, u = _wkv_operands(dev, b, t, h, p, seed=7 * b + t + h + p, strong=strong)
    before = build.launches["wkv6"]
    got = wkv6(r, k, v, lw, u)
    torch.cuda.synchronize()
    assert build.launches["wkv6"] == before + 1
    assert got.shape == (b, t, h, p) and torch.isfinite(got).all()
    assert _wkv_rel(got, wkv6_plain(r, k, v, lw, u)) <= WKV_REL_TOL


def test_wkv6_kernel_unaligned_input_equals_plain(dev):
    """Rows not 16-byte aligned are staged by plain loads."""
    r, k, v, lw, u = _wkv_operands(dev, 2, 20, 3, 64, seed=9)

    def shifted(a):
        flat = torch.empty(a.numel() + 1, device=dev)
        out = flat[1:].view(a.shape)
        out.copy_(a)
        return out

    args = [shifted(a) for a in (r, k, v, lw)]
    assert args[0].data_ptr() % 16 != 0
    assert _wkv_rel(wkv6(*args, u), wkv6_plain(r, k, v, lw, u)) <= WKV_REL_TOL


@pytest.mark.parametrize("t,p", [(17, 33), (40, 64), (1, 1)])
def test_wkv6_kernel_bf16_edges(dev, t, p):
    r, k, v, lw, u = _wkv_operands(dev, 2, t, 3, p, seed=t + p)
    bf = [a.to(torch.bfloat16) for a in (r, k, v, lw)]
    got = wkv6(*bf, u)
    assert got.dtype == torch.bfloat16 and got.shape == (2, t, 3, p)
    assert _wkv_rel(got, wkv6_plain(*(a.float() for a in bf), u)) <= BF16_TOL


def test_wkv6_kernel_bf16_against_the_float32_plain_version(dev):
    r, k, v, lw, u = _wkv_operands(dev, 2, 64, 4, 64, seed=5)
    bf = [a.to(torch.bfloat16) for a in (r, k, v, lw)]
    got = wkv6(*bf, u)
    assert got.dtype == torch.bfloat16
    want = wkv6_plain(*(a.float() for a in bf), u)
    assert _wkv_rel(got, want) <= BF16_TOL


def test_wkv6_wrapper_rejects_dtypes_and_head_sizes(dev):
    r, k, v, lw, u = _wkv_operands(dev, 1, 4, 2, 8, seed=1)
    with pytest.raises(TypeError, match="float32 or bfloat16 r"):
        wkv6(r.half(), k.half(), v.half(), lw.half(), u)
    with pytest.raises(TypeError, match="logw is"):
        wkv6(r, k, v, lw.double(), u)
    with pytest.raises(ValueError, match="is not"):
        wkv6(r, k[:, :2], v, lw, u)
    with pytest.raises(ValueError, match="on cpu"):
        wkv6(r, k, v, lw, u.cpu())
    big = _wkv_operands(dev, 1, 4, 1, 65, seed=2)
    before = build.launches["wkv6"]
    with pytest.raises(ValueError, match="above the kernel's 64"):
        wkv6(*big)
    assert build.launches["wkv6"] == before


# the fit's (992, 16); a row group's tail (1001, 5 rows); more chunks than
# stages (4000, 33); slices of rows by words (10, 300); no rows; one
# channel, its first 8 rows apart (600, 1), no head up to 32 rows (5, 1),
# (32, 1) and a head past them (33, 1), a head then one more chunk (257, 1);
# the head channel at C = 2 and C = 8k + 1 (none at 2 rows, a head shorter
# than 8 rows at 3 and 6, one in the second block at C = 257 and 265) and
# the die's width at row counts off 8 (994, 14) and at one row
@pytest.mark.parametrize("n,c", [(1, 1), (992, 16), (5, 200), (1001, 7), (4000, 33), (0, 4),
                                 (10, 300), (600, 5), (600, 1), (5, 1), (32, 1), (33, 1),
                                 (257, 1), (2, 2), (3, 2), (602, 2), (3, 9), (6, 9), (16, 9),
                                 (994, 17), (300, 257), (40, 265), (994, 16), (14, 16),
                                 (1, 16)])
def test_fma_rows_kernel_equals_plain(dev, n, c):
    g = torch.Generator(device=dev).manual_seed(n + c)
    d = torch.randn(n, generator=g, device=dev) * 1e-3
    xs = torch.randn((n, c), generator=g, device=dev)
    before = build.launches["fma_rows"]
    got = fma_rows(d, xs)
    assert build.launches["fma_rows"] == before + 1
    assert got.device == xs.device and torch.equal(got, fma_rows_ref(d, xs))


@pytest.mark.parametrize("n", [1, 7, 992, 3000])
@pytest.mark.parametrize("c", [1, 5, 12, 16, 20, 33])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "word-off"])
def test_fma_rows_kernel_widths_equal_plain(dev, n, c, offset):
    """Every tested width and row count bit-equal, from 16-byte aligned
    inputs (bulk copies and the words past them) and from inputs one word
    off (cp.async words)."""
    g = torch.Generator(device=dev).manual_seed(7 * n + c)
    d = (torch.randn(n + offset, generator=g, device=dev) * 1e-3)[offset:]
    xs = torch.randn(n * c + offset, generator=g, device=dev)[offset:].view(n, c)
    assert (d.data_ptr() % 16 == 0) == (offset == 0) or n == 0
    before = build.launches["fma_rows"]
    got = fma_rows(d, xs)
    assert build.launches["fma_rows"] == before + 1
    assert torch.equal(got, fma_rows_ref(d, xs))


@pytest.mark.parametrize("case", ["midpoint", "subnormal"])
def test_fma_rows_kernel_rounds_each_step_once(dev, case):
    """Where float64 lands on a float32 midpoint (a normal and a subnormal
    sum), the kernel's fused step rounds the exact sum."""
    if case == "midpoint":
        acc, d1, x1 = 1 + 2.0**-23, 2.0**-24 * (1 + 2.0**-23), 1 - 2.0**-23
    else:
        acc, d1, x1 = 2.0**-127 + 2.0**-149, 2.0**-75 * (1 + 2.0**-23), 2.0**-75 * (1 - 2.0**-23)
    d = torch.tensor([1.0, d1], device=dev)
    xs = torch.tensor([[acc], [x1]], device=dev)
    got = fma_rows(d, xs)
    assert got.item() == acc and torch.equal(got, fma_rows_ref(d, xs))


def test_fit_linear_detector_on_the_card_equals_the_cpu(dev):
    rng = np.random.default_rng(1)
    speech = rng.normal(0.8, 0.4, (300, 16)).astype(np.float32)
    silence = rng.normal(-0.8, 0.4, (300, 16)).astype(np.float32)
    build.launches.clear()
    got = fit_linear_detector(torch.as_tensor(speech, device=dev),
                              torch.as_tensor(silence, device=dev), steps=50)
    assert dict(build.launches) == {"fma_rows": 50}
    assert got == fit_linear_detector(speech, silence, steps=50)


# ---------------- the fleet: shards, resize, shard loss on the card ----------------

FLEET = [("qat", None), ("delta-int", 0.15)]


def _fleet_pair(dev, classifier, theta, **kw):
    """(a server built with ``kw``, an unsharded twin) on the same params,
    64 slots, 40 streams open."""
    pipe = _pipe(dev, classifier, theta)
    params = pipe.init_params(torch.Generator().manual_seed(7), device=dev)
    servers = (StreamingKWSServer(pipe, params, max_streams=64, **kw),
               StreamingKWSServer(pipe, params, max_streams=64, device=dev))
    for srv in servers:
        for sid in range(40):
            srv.open_stream(sid)
    return servers


def _by_sid(srv, hops, submit):
    """A step_batch of every open stream, each fed its stream id's hop;
    {sid: (scores row, top)}."""
    slab = np.zeros((srv.max_streams, 256), np.float32)
    mask = np.zeros(srv.max_streams, bool)
    for sid, slot in srv.active.items():
        slab[slot], mask[slot] = hops[sid], submit[sid]
    scores, top = srv.step_batch(slab, mask)
    return {sid: (scores[slot], top[slot]) for sid, slot in srv.active.items()}


def _assert_same_streams(a, b, sids):
    for sid in sids:
        for x, y in zip(a.state.leaves(), b.state.leaves()):
            assert torch.equal(x[a.active[sid]], y[b.active[sid]]), sid


def _fleet_ticks(servers, rng, n):
    for _ in range(n):
        hops = (rng.standard_normal((200, 256)) * 0.1).astype(np.float32)
        submit = rng.random(200) < 0.8
        outs = [_by_sid(srv, hops, submit) for srv in servers]
        for sid in outs[0]:
            assert np.array_equal(outs[0][sid][0], outs[1][sid][0])
            assert outs[0][sid][1] == outs[1][sid][1]


@pytest.mark.parametrize("classifier,theta", FLEET)
def test_shards_on_one_card_launch_once_each(dev, classifier, theta):
    sharded, twin = _fleet_pair(dev, classifier, theta, devices=[dev] * 4)
    assert sharded.n_devices == 4 and len({str(d) for d in sharded.shard_devices}) == 1
    rng = np.random.default_rng(8)
    build.launches.clear()
    _fleet_ticks((sharded, twin), rng, 3)
    assert dict(build.launches) == {"tick_fused": 3 * 4 + 3}
    hops = (rng.standard_normal((2, 40, 256)) * 0.1).astype(np.float32)
    submit = rng.random((2, 40)) < 0.8
    outs = []
    build.launches.clear()
    for srv in (sharded, twin):  # each stream id's hops in that server's slots
        slots = [srv.active[sid] for sid in range(40)]
        slab, mask = np.zeros((2, 64, 256), np.float32), np.zeros((2, 64), bool)
        slab[:, slots], mask[:, slots] = hops, submit
        scores, top = srv.run_batch(slab, mask)
        outs.append((scores[:, slots], top[:, slots]))
    assert dict(build.launches) == {"tick_fused": 2 * 4 + 2}
    assert np.array_equal(outs[0][0], outs[1][0]) and np.array_equal(outs[0][1], outs[1][1])
    _assert_same_streams(sharded, twin, list(twin.active))


@pytest.mark.parametrize("classifier,theta", FLEET)
def test_resize_on_the_card_keeps_every_stream(dev, classifier, theta):
    srv, twin = _fleet_pair(dev, classifier, theta, device=dev)
    rng = np.random.default_rng(9)
    _fleet_ticks((srv, twin), rng, 2)
    build.launches.clear()
    srv.resize(128)
    _fleet_ticks((srv, twin), rng, 2)
    srv.resize(48)
    _fleet_ticks((srv, twin), rng, 2)
    assert dict(build.launches) == {"tick_fused": 8}
    assert srv.compile_count == 1 and srv.max_streams == 48
    _assert_same_streams(srv, twin, list(twin.active))


@pytest.mark.parametrize("classifier,theta", FLEET)
def test_recover_shard_loss_on_the_card(dev, classifier, theta):
    sharded, twin = _fleet_pair(dev, classifier, theta, devices=[dev] * 4)
    rng = np.random.default_rng(10)
    _fleet_ticks((sharded, twin), rng, 2)
    info = sharded.recover_shard_loss(1)
    assert info["n_devices"] == 2 and sharded.compile_count == 2
    _assert_same_streams(sharded, twin, info["survivors"])
    for sid in info["reopened"]:
        assert not any(bool(t[sharded.active[sid]].any()) for t in sharded.state.leaves())
        twin.close_stream(sid)
        twin.open_stream(sid)
    build.launches.clear()
    _fleet_ticks((sharded, twin), rng, 2)
    assert dict(build.launches) == {"tick_fused": 2 * 2 + 2}
    _assert_same_streams(sharded, twin, list(twin.active))


def test_handle_in_flight_across_a_resize_on_the_card(dev):
    srv, twin = _fleet_pair(dev, "qat", None, device=dev)
    rng = np.random.default_rng(11)
    slab = (rng.standard_normal((64, 256)) * 0.1).astype(np.float32)
    mask = np.ones(64, bool)
    want = twin.step_batch(slab, mask)
    handle = srv.step_batch_async(slab, mask)
    srv.resize(128)
    got = handle.result()
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_logits_all_frames_and_predict_on_the_card(dev):
    pipe = _pipe(dev, "integer", None)
    params = pipe.init_params(torch.Generator().manual_seed(12), device=dev)
    cpu = KWSPipeline(pipe.config, norm_stats=FExNormStats(*(t.cpu() for t in (
        pipe.norm_stats.mu, pipe.norm_stats.sigma))))
    cpu_params = {"gru": [{k: v.cpu() for k, v in layer.items()} for layer in params["gru"]],
                  "fc": {k: v.cpu() for k, v in params["fc"].items()}}
    audio = torch.randn((5, 4000), generator=torch.Generator().manual_seed(13)) * 0.1
    fv, _ = pipe.features(audio.to(dev))
    build.launches.clear()
    logits = pipe.logits_all_frames(params, fv)
    assert dict(build.launches) == {"intgemm": 4 * fv.shape[1] + 1}
    assert torch.equal(logits.cpu(), cpu.logits_all_frames(cpu_params, fv.cpu()))
    build.launches.clear()
    top = pipe.predict(params, audio.to(dev))
    assert build.launches["fex_fused"] == 1 and build.launches["intgemm"] == 4 * fv.shape[1] + 1
    assert torch.equal(top.cpu(), cpu.predict(cpu_params, audio))


# a QAT step's gradients on the card against the CPU's, per leaf, max
# |difference| / max |gradient|: the forward is equal on the grid, the
# backward's sums run in cuBLAS's order and the CPU's
TRAIN_GRAD_TOL = 1e-5


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_train_step_on_the_card_equals_the_cpu_step(dev, state_dtype):
    from repro_torch.core.gru import GRUConfig, init_gru_classifier
    from repro_torch.training import kws
    from repro_torch.training.checkpoint import _flatten_with_names
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state, tree_map

    params = init_gru_classifier(GRUConfig(), torch.Generator().manual_seed(14), "cpu")
    cfg = AdamWConfig(lr=1e-3, weight_decay=0.01, state_dtype=state_dtype)
    opt = init_opt_state(params, cfg)
    rng = np.random.default_rng(15)
    fv = torch.from_numpy((np.round(rng.standard_normal((64, 62, 16)) * 256) / 256).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 12, 64).astype(np.int32))

    def to(tree, device):
        return tree_map(lambda t: t.to(device), tree)

    loss, grads = kws.value_and_grad(to(params, dev), fv.to(dev), y.to(dev))
    cpu_loss, cpu_grads = kws.value_and_grad(params, fv, y)
    assert abs(float(loss) - float(cpu_loss)) <= 1e-6
    for (name, g), (_, c) in zip(_flatten_with_names(grads), _flatten_with_names(cpu_grads),
                                 strict=True):
        assert g.is_cuda
        assert float((g.cpu() - c).abs().max() / c.abs().max()) <= TRAIN_GRAD_TOL, name
    build.launches.clear()
    new_p, new_opt, _ = kws.train_step(to(params, dev), to(opt, dev), fv.to(dev), y.to(dev),
                                       1e-3, ocfg=cfg)
    assert not build.launches  # the step runs PyTorch operations, as the reference runs jnp
    cpu_p, cpu_opt, _ = kws.train_step(params, opt, fv, y, 1e-3, ocfg=cfg)
    for (name, a), (_, b) in zip(_flatten_with_names((new_p, new_opt)),
                                 _flatten_with_names((cpu_p, cpu_opt)), strict=True):
        assert a.is_cuda and a.dtype == b.dtype, name
        if a.dtype == torch.int8:
            assert (a.cpu().int() - b.int()).abs().max() <= 1, name
        elif a.dim() and name.startswith("0/"):
            # the first step moves a weight by lr * g / (|g| + eps): where |g|
            # is near eps, a difference within TRAIN_GRAD_TOL can move it by
            # up to 2 lr; the moments above hold the gradient itself
            assert float((a.cpu() - b).abs().max()) <= 2e-3 + 1e-7, name
        elif a.dim():
            assert float((a.cpu() - b).abs().max()) <= TRAIN_GRAD_TOL * float(b.abs().max()), name
        else:
            assert torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("compress", [True, False], ids=["compressed", "plain"])
def test_dp_step_on_the_card_equals_the_cpu_step(dev, compress):
    """Two shards on one card (``devices=["cuda:0"] * 2``) against the
    same two shards on the CPU: the loss within 1e-6, the synced gradients
    and residuals within TRAIN_GRAD_TOL of the synced max |g| (compressed: a whole
    code may differ where a value lies within it of a rounding tie, at
    most 0.1 % of the elements), every replica alike after the step."""
    from repro_torch.core.gru import GRUConfig, init_gru_classifier
    from repro_torch.distributed.collectives import elements_apart, init_residual
    from repro_torch.training import kws
    from repro_torch.training.checkpoint import _flatten_with_names
    from repro_torch.training.optimizer import init_opt_state, tree_map

    params = init_gru_classifier(GRUConfig(), torch.Generator().manual_seed(16), "cpu")
    rng = np.random.default_rng(17)
    fv = torch.from_numpy((np.round(rng.standard_normal((32, 62, 16)) * 256) / 256).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 12, 32).astype(np.int32))

    def step(devices):
        reps = [tree_map(lambda t, d=d: t.to(d), params) for d in devices]
        resid = [init_residual(r) for r in reps] if compress else None
        opts = [init_opt_state(r, kws.OPT) for r in reps]
        grads = kws.dp_value_and_grad(reps, fv, y, residual=resid)
        new_p, _, _, _ = kws.dp_train_step(reps, opts, fv, y, 1e-3, resid)
        return grads, new_p

    (loss, synced, resid), new_p = step([dev, dev])
    (cpu_loss, cpu_synced, cpu_resid), _ = step(["cpu", "cpu"])
    assert abs(float(loss) - float(cpu_loss)) <= 1e-6
    off = total = 0
    trees = [(synced[0], cpu_synced[0])] + (list(zip(resid, cpu_resid)) if compress else [])
    for got, want in trees:  # residuals too held to the synced gradients' max |g|
        assert all(a.is_cuda for _, a in _flatten_with_names(got))
        o, t = elements_apart(got, want, cpu_synced[0], TRAIN_GRAD_TOL)
        off, total = off + o, total + t
    assert off <= (1e-3 * total if compress else 0)
    for (name, a), (_, b) in zip(_flatten_with_names(new_p[0]), _flatten_with_names(new_p[1])):
        assert torch.equal(a, b), name


def test_lm_train_step_and_decode_on_the_card_equal_the_cpus(dev):
    """The reduced rwkv6 in float32, every leaf away from zero: one train
    step (two microbatches, a cosine schedule) on the card against the
    CPU's (the loss within 1e-5, grad_norm within 1e-4 of it, the params
    within a hundredth of the learning rate), then prefill and a decode
    step (logits within 1e-4 of max |logit|); no kernel of the port
    launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import rwkv6
    from repro_torch.training.checkpoint import _flatten_with_names
    from repro_torch.training.optimizer import AdamWConfig, cosine_schedule, init_opt_state, tree_map
    from repro_torch.training.train_loop import TrainConfig, build_train_step, lm_batches

    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(), dtype="float32")
    params = rwkv6.init_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    gen = torch.Generator().manual_seed(6)  # the leaves drawn as zero take part
    for name in ("bonus_u", "mix_x", "mix_base", "cm_mix_k", "cm_mix_r", "ln1", "ln2", "ln_x"):
        params["layers"][name] = torch.randn(params["layers"][name].shape, generator=gen) * 0.1
    lr = 3e-3
    tcfg = TrainConfig(AdamWConfig(lr=lr), microbatch=2, lr_schedule=cosine_schedule(lr, 1, 10))
    batch = next(lm_batches(cfg.vocab, 1, batch=4, seq=64))
    out = {}
    build.launches.clear()
    for d in (dev, torch.device("cpu")):
        p = tree_map(lambda t, d=d: t.to(d), params)
        p, _, m = build_train_step(cfg, tcfg, d)(p, init_opt_state(p, AdamWConfig(lr=lr)), batch)
        toks = batch["tokens"].to(d)
        with torch.no_grad():
            _, cache = rwkv6.prefill(p, {"tokens": toks[:, :48]}, cfg)
            logits, _ = rwkv6.decode_step(p, cache, 48, {"tokens": toks[:, 48:49]}, cfg)
        out[d.type] = (p, m, logits)
    assert not build.launches
    (p, m, logits), (cp, cm, clogits) = out["cuda"], out["cpu"]
    assert abs(float(m["loss"]) - float(cm["loss"])) <= 1e-5
    assert abs(float(m["grad_norm"]) / float(cm["grad_norm"]) - 1) <= 1e-4
    for (name, a), (_, b) in zip(_flatten_with_names(p), _flatten_with_names(cp)):
        assert a.is_cuda and float((a.cpu() - b).abs().max()) <= 1e-2 * lr, name
    assert float((logits.cpu() - clogits).abs().max()) <= 1e-4 * float(clogits.abs().max())


def test_zamba2_train_step_and_decode_on_the_card_equal_the_cpus(dev):
    """The reduced zamba2 in float32 (5 mamba layers, shared blocks 0, 1,
    0), its vector leaves (norm scales, A_log, dt_bias, D, conv_b) moved
    off their constants: one train step (two microbatches, a cosine
    schedule) on the card against the CPU's (the loss within 1e-5,
    grad_norm within 1e-4 of it, the params within a hundredth of the
    learning rate), then prefill and two decode steps, ``cache_len`` an
    int and a tensor (logits within 1e-4 of max |logit|); no kernel of
    the port launches. Measured on an H100: loss 0, grad_norm 6.8e-6,
    params 0, logits 1.3e-5."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import zamba2
    from repro_torch.training.checkpoint import _flatten_with_names
    from repro_torch.training.optimizer import AdamWConfig, cosine_schedule, init_opt_state, tree_map
    from repro_torch.training.train_loop import TrainConfig, build_train_step, lm_batches

    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), dtype="float32")
    params = zamba2.init_params(torch.Generator().manual_seed(9), cfg, device="cpu")
    gen = torch.Generator().manual_seed(10)
    moved = [(params["mamba"], k) for k in ("ln", "dt_bias", "A_log", "D", "conv_b", "gn")]
    moved += [(sp, k) for sp in params["shared"] for k in ("ln1", "ln2")] + [(params, "final_norm")]
    for tree, k in moved:
        tree[k] = tree[k] + torch.randn(tree[k].shape, generator=gen) * 0.1
    lr = 3e-3
    tcfg = TrainConfig(AdamWConfig(lr=lr), microbatch=2, lr_schedule=cosine_schedule(lr, 1, 10))
    batch = next(lm_batches(cfg.vocab, 1, batch=4, seq=64))
    out = {}
    build.launches.clear()
    for d in (dev, torch.device("cpu")):
        p = tree_map(lambda t, d=d: t.to(d), params)
        p, _, m = build_train_step(cfg, tcfg, d)(p, init_opt_state(p, AdamWConfig(lr=lr)), batch)
        toks = batch["tokens"].to(d)
        with torch.no_grad():
            _, cache = zamba2.prefill(p, {"tokens": toks[:, :48]}, cfg, max_len=56)
            logits, cache = zamba2.decode_step(p, cache, 48, {"tokens": toks[:, 48:49]}, cfg)
            logits2, _ = zamba2.decode_step(p, cache, torch.tensor(49),
                                            {"tokens": toks[:, 49:50]}, cfg)
        out[d.type] = (p, m, logits, logits2)
    assert not build.launches
    (p, m, logits, logits2), (cp, cm, clogits, clogits2) = out["cuda"], out["cpu"]
    assert abs(float(m["loss"]) - float(cm["loss"])) <= 1e-5
    assert abs(float(m["grad_norm"]) / float(cm["grad_norm"]) - 1) <= 1e-4
    for (name, a), (_, b) in zip(_flatten_with_names(p), _flatten_with_names(cp)):
        assert a.is_cuda and float((a.cpu() - b).abs().max()) <= 1e-2 * lr, name
    for got, want in ((logits, clogits), (logits2, clogits2)):
        assert got.is_cuda
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_ssm_grid_on_the_card_equals_the_cpus(dev, arch):
    """rwkv6's and zamba2's sharded steps on a (2, 2) grid of the card
    (reduced, float32) against the same grid on the CPU: one train step's
    loss within 1e-5 and grad_norm within 1e-4 of the CPU's, then a prefill
    and two decode steps (logits within 1e-4 of max |logit|); no kernel of
    the port launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Mesh, ShardingRules, make_mesh_context
    from repro_torch.models.registry import get_backbone
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state, tree_map
    from repro_torch.training.train_loop import TrainConfig, build_train_step, lm_batches

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    backbone = get_backbone(cfg)
    params = backbone.init_params(torch.Generator().manual_seed(9), cfg, device="cpu")
    batch = next(lm_batches(cfg.vocab, 1, batch=4, seq=64))
    out = {}
    build.launches.clear()
    for d in (dev, torch.device("cpu")):
        rules = ShardingRules(mesh=Mesh((2, 2), ("data", "model"), d))
        mc = make_mesh_context(rules)
        p = tree_map(lambda t, d=d: t.to(d), params)
        step = build_train_step(cfg, TrainConfig(AdamWConfig(lr=3e-3)), d, rules)
        _, _, m = step(p, init_opt_state(p, AdamWConfig(lr=3e-3)), batch)
        toks = batch["tokens"].to(d)
        with torch.no_grad():
            _, cache = backbone.prefill(p, {"tokens": toks[:, :48]}, cfg, mc, max_len=56)
            logits, cache = backbone.decode_step(p, cache, torch.tensor(48, device=d),
                                                 {"tokens": toks[:, 48:49]}, cfg, mc)
            logits2, _ = backbone.decode_step(p, cache, torch.tensor(49, device=d),
                                              {"tokens": toks[:, 49:50]}, cfg, mc)
        out[d.type] = (m, logits, logits2)
    assert not build.launches
    (m, logits, logits2), (cm, clogits, clogits2) = out["cuda"], out["cpu"]
    assert abs(float(m["loss"]) - float(cm["loss"])) <= 1e-5
    assert abs(float(m["grad_norm"]) / float(cm["grad_norm"]) - 1) <= 1e-4
    for got, want in ((logits, clogits), (logits2, clogits2)):
        assert got.is_cuda
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m"])
def test_transformer_train_step_and_decode_on_the_card_equal_the_cpus(dev, arch):
    """The reduced transformer in float32 (qwen3: qk-norm, GQA, a tied
    head; granite: the one-card MoE route with head padding), every norm
    scale away from zero: one train step (two microbatches, a cosine
    schedule) on the card against the CPU's (the loss within 1e-5,
    grad_norm within 1e-4 of it, the params within a hundredth of the
    learning rate), then prefill and a decode step, ``cache_len`` an int
    and a tensor (logits within 1e-4 of max |logit|); no kernel of the
    port launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.training.checkpoint import _flatten_with_names
    from repro_torch.training.optimizer import AdamWConfig, cosine_schedule, init_opt_state, tree_map
    from repro_torch.training.train_loop import TrainConfig, build_train_step, lm_batches

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = transformer.init_params(torch.Generator().manual_seed(7), cfg, device="cpu")
    gen = torch.Generator().manual_seed(8)  # the norm scales drawn as zero take part
    params = tree_map(lambda t: torch.randn(t.shape, generator=gen) * 0.1
                      if t.dim() <= 2 and t.shape[-1] in (cfg.d_model, cfg.resolved_head_dim)
                      and not t.any() else t, params)
    lr = 3e-3
    tcfg = TrainConfig(AdamWConfig(lr=lr), microbatch=2, lr_schedule=cosine_schedule(lr, 1, 10))
    batch = next(lm_batches(cfg.vocab, 1, batch=4, seq=64))
    out = {}
    build.launches.clear()
    for d in (dev, torch.device("cpu")):
        p = tree_map(lambda t, d=d: t.to(d), params)
        p, _, m = build_train_step(cfg, tcfg, d)(p, init_opt_state(p, AdamWConfig(lr=lr)), batch)
        toks = batch["tokens"].to(d)
        with torch.no_grad():
            _, cache = transformer.prefill(p, {"tokens": toks[:, :48]}, cfg, max_len=56)
            logits, cache = transformer.decode_step(p, cache, 48, {"tokens": toks[:, 48:49]}, cfg)
            logits2, _ = transformer.decode_step(p, cache, torch.tensor(49),
                                                 {"tokens": toks[:, 49:50]}, cfg)
        out[d.type] = (p, m, logits, logits2)
    assert not build.launches
    (p, m, logits, logits2), (cp, cm, clogits, clogits2) = out["cuda"], out["cpu"]
    assert abs(float(m["loss"]) - float(cm["loss"])) <= 1e-5
    assert abs(float(m["grad_norm"]) / float(cm["grad_norm"]) - 1) <= 1e-4
    for (name, a), (_, b) in zip(_flatten_with_names(p), _flatten_with_names(cp)):
        assert a.is_cuda and float((a.cpu() - b).abs().max()) <= 1e-2 * lr, name
    for got, want in ((logits, clogits), (logits2, clogits2)):
        assert got.is_cuda
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m", "rwkv6-7b", "zamba2-7b"])
def test_lower_train_step_predicts_the_cards_peak(dev, arch):
    """The reduced config's train step at 4 x 512 tokens: the peak
    `lower_train_step` predicts from the port's graph on fake tensors on
    the card, against max_memory_allocated over the same step run for real
    (parameters drawn on the card, after one untimed step that makes the
    process's one-time allocations, cuBLAS's workspace among them), within
    2 %; no kernel of the port launches. The graph's FLOPs and bytes on
    the card are the CPU's (the backward's operations, which run on the
    autograd engine's device thread, are counted)."""
    import gc

    from repro_torch.launch.dryrun import train_batch_shape
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.models.registry import get_backbone
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import TrainConfig, build_train_step, lower_train_step

    cfg = get_config(arch).reduced()
    shape = train_batch_shape(cfg, ShapeSpec("t", "train", 512, 4))
    predicted, _, _ = lower_train_step(cfg, shape, TrainConfig(), dev)
    on_cpu, _, _ = lower_train_step(cfg, shape, TrainConfig(), "cpu")
    assert (predicted.flops, predicted.hbm_bytes) == (on_cpu.flops, on_cpu.hbm_bytes)
    backbone, step = get_backbone(cfg), build_train_step(cfg, TrainConfig(), dev)
    build.launches.clear()
    peaks = []
    for _ in range(2):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params = backbone.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        opt = init_opt_state(params, TrainConfig().optimizer)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev) for k, v in shape.items()}
        _, _, metrics = step(params, opt, batch)
        assert torch.isfinite(metrics["loss"])
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        del params, opt, batch, metrics
    assert not build.launches
    assert abs(predicted.peak_bytes - peaks[-1]) <= 0.02 * peaks[-1], (predicted.peak_bytes, peaks)


@pytest.mark.parametrize("path", ["dropping", "stationary"])
def test_moe_grid_route_on_the_card_equals_the_cpus(dev, path):
    """The model-axis MoE route (reduced granite, float32, 7 experts
    padded to 8) on a (2, 2) grid whose entries are all the card, FSDP
    over "data", against the same route on a (2, 2) grid of the CPU: y and
    aux within 1e-5 of max |y|, the gradients of sum(y^2) + 0.01 aux
    within 1e-4 of each leaf's max |g|; no kernel of the port launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Mesh, ShardingRules, make_mesh_context
    from repro_torch.models import moe
    from repro_torch.training.optimizer import tree_map

    base = get_config("granite-moe-3b-a800m").reduced()
    cfg = dataclasses.replace(base, dtype="float32", moe=dataclasses.replace(
        base.moe, num_experts=7, capacity_factor=1.0,
        stationary_threshold=4096 if path == "stationary" else 0))
    out = {}
    build.launches.clear()
    for d in (dev, torch.device("cpu")):
        mc = make_mesh_context(ShardingRules(mesh=Mesh((2, 2), ("data", "model"), d)))
        p = moe.moe_init(torch.Generator().manual_seed(3), cfg, mc)
        assert p["w_up"].shape[0] == 8
        p = tree_map(lambda t, d=d: t.to(d).requires_grad_(True), p)
        x = torch.randn((4, 32, cfg.d_model), generator=torch.Generator().manual_seed(4))
        x = x.to(d).requires_grad_(True)
        y, aux = moe.moe_apply(p, x, cfg, mc)
        (torch.sum(y ** 2) + 0.01 * aux).backward()
        out[d.type] = (y.detach().cpu(), float(aux), x.grad.cpu(),
                       {k: v.grad.cpu() for k, v in p.items()})
    assert not build.launches
    (y, aux, gx, gp), (cy, caux, cgx, cgp) = out["cuda"], out["cpu"]
    assert float((y - cy).abs().max()) <= 1e-5 * float(cy.abs().max())
    assert abs(aux / caux - 1) <= 1e-5
    for got, want in [(gx, cgx)] + [(gp[k], cgp[k]) for k in cgp]:
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_moe_backward_on_the_card_is_deterministic(dev):
    """The one-card MoE route's gradients (bf16, top-8 of 40 experts:
    tokens gather up to 8 slots) are bit-equal over three runs on the card:
    the dispatch gather's backward adds each token's slots in a fixed
    order (`moe._TokenGather`), where index_select's index_add adds in its
    atomics' order; no kernel of the port launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.training.optimizer import tree_map

    base = get_config("granite-moe-3b-a800m").reduced()
    cfg = dataclasses.replace(base, d_model=256, moe=dataclasses.replace(
        base.moe, num_experts=40, top_k=8, d_expert=64))
    p = tree_map(lambda t: t.to(dev, torch.bfloat16),
                 moe.moe_init(torch.Generator().manual_seed(6), cfg))
    x = torch.randn((4, 512, cfg.d_model), generator=torch.Generator().manual_seed(7))
    x = x.to(dev, torch.bfloat16)
    build.launches.clear()
    runs = []
    for _ in range(3):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
        xx = x.detach().requires_grad_(True)
        y, aux = moe.moe_apply(leaves, xx, cfg)
        (y.float().square().sum() + aux).backward()
        runs.append([xx.grad] + [leaves[k].grad for k in sorted(leaves)])
    assert not build.launches
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


def test_serve_streaming_driver_on_the_card_equals_the_cpu(dev):
    """The serving command line (`python -m repro_torch.serving.serve_streaming`)
    at 32 streams for 12 ticks, ΔGRU with the cascade: one tick_fused launch a
    tick, and every stream equal to the same driver run with ``--device cpu``
    on the card run's params and norm stats."""
    from repro_torch.serving import serve_streaming

    argv = ["--streams", "32", "--seconds", "0.2", "--classifier", "delta-int", "--theta",
            "0.15", "--cascade"]
    build.launches.clear()
    card = serve_streaming.serve(serve_streaming.parse_args(argv))
    assert build.launches["tick_fused"] == card["n_frames"] == 12
    stats = card["pipeline"].norm_stats
    params = {"gru": [{k: v.cpu() for k, v in layer.items()} for layer in card["params"]["gru"]],
              "fc": {k: v.cpu() for k, v in card["params"]["fc"].items()}}
    cpu = serve_streaming.serve(serve_streaming.parse_args(argv + ["--device", "cpu"]), params,
                                FExNormStats(stats.mu.cpu(), stats.sigma.cpu()))
    a, b = card["server"], cpu["server"]
    assert a.tick_dispatch == "cuda" and b.tick_dispatch == "cpu"
    assert card["top"] == cpu["top"] and a.active == b.active
    xs = tree_leaves([a.state.gru, a.state.carry, a.state.det])
    ys = tree_leaves([b.state.gru, b.state.carry, b.state.det])
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y)
    assert np.abs(a.scores - b.scores).max() <= 1e-6
    assert np.array_equal(a.sparsity, b.sparsity) and np.array_equal(a.wake_rate, b.wake_rate)
