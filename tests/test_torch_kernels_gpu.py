"""Each CUDA kernel of the port against its plain version, on the card.

Marked ``gpu``: run on a machine with an NVIDIA H100 as
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.
Without a CUDA device every test skips (the decision is made inside a
fixture, so every worker collects the same tests).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.fex import FExNormStats
from repro_torch.core.frontend import tree_clone, tree_leaves
from repro_torch.core.gru_delta import DeltaConfig
from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
from repro_torch.kernels import build
from repro_torch.kernels.intgemm import intgemm, intgemm_ref
from repro_torch.kernels.tick_fused import pack_operands, tick_fused, tick_reference
from repro_torch.kernels.tick_fused.gather import make_sparse_step
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


@pytest.mark.parametrize(
    "m,k,n,kind",
    [
        (N, 16, 144, "random"), (N, 48, 144, "random"), (N, 48, 12, "random"),
        (77, 48, 144, "saturate"), (1, 1, 1, "random"), (33, 7, 5, "random"),
    ],
)
def test_intgemm_kernel_equals_plain(dev, m, k, n, kind):
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randint(-8192, 8192, (m, k), generator=g, device=dev, dtype=torch.int32)
    w = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    if kind == "saturate":
        x = torch.where(torch.arange(m, device=dev)[:, None] % 2 == 0, 8191, -8192).expand(m, k).contiguous().to(torch.int32)
        w = torch.full((k, n), 127, device=dev, dtype=torch.int8)
    before = build.launches["intgemm"]
    got = intgemm(x, w)
    assert build.launches["intgemm"] == before + 1
    assert torch.equal(got, intgemm_ref(x, w))


def _pipe(dev, classifier, theta):
    delta = None if theta is None else DeltaConfig(theta, theta)
    return KWSPipeline(KWSPipelineConfig(classifier=classifier, delta=delta),
                       norm_stats=_norm_stats(dev))


@pytest.mark.parametrize("classifier,theta", BACKENDS, ids=[f"{c}-{t}" for c, t in BACKENDS])
@pytest.mark.parametrize("raw", [True, False], ids=["raw", "fv"])
@pytest.mark.parametrize("n", [N, 37], ids=["full", "ragged"])
def test_tick_kernel_equals_plain(dev, classifier, theta, raw, n):
    """Against the plain tick; for the ΔGRU backends its sparse step (K4's
    plain version) at both extremes of the fired-column list."""
    pipe = _pipe(dev, classifier, theta)
    params = pipe.prepare_params(pipe.init_params(torch.Generator().manual_seed(1), device=dev))
    ops = pack_operands(pipe, params, pipe.state, dev)
    step_fn = make_sparse_step(pipe)
    state = (tuple(pipe.streaming_init(n, dev)), pipe.streaming_features_init(n, dev),
             torch.zeros((n, 12), device=dev))
    g = torch.Generator(device=dev).manual_seed(2)
    gains = torch.logspace(-2, -0.3, n, device=dev)[:, None]
    flt = classifier == "float"
    for t, frac in enumerate([1.0, 0.7, 0.0, 0.5]):
        if raw:
            inp = torch.randn((n, 256), generator=g, device=dev) * gains
        else:
            inp = torch.round(torch.randn((n, 16), generator=g, device=dev) * 512) / 256
        mask = torch.rand(n, generator=g, device=dev) < frac
        (pg, pc, ps), _, ptop = tick_reference(pipe, raw, params, tree_clone(state), inp, mask,
                                               pipe.state, 0.7, step_fn=step_fn)
        fv = torch.zeros((n, 16), device=dev)
        before = dict(build.launches)
        (kg, kc, ks), _, ktop = tick_fused(pipe, raw, params, tree_clone(state), inp, mask, pipe.state, 0.7, operands=ops, fv_out=fv)
        assert build.launches["tick_fused"] == before.get("tick_fused", 0) + 1
        for a, b in zip(tree_leaves(kg), tree_leaves(pg)):
            if flt:
                assert float((a - b).abs().max()) <= FLOAT_TOL, f"tick {t}"
            else:
                assert torch.equal(a, b), f"tick {t}"
        for key in ("s1", "s2"):
            assert torch.equal(kc[key], pc[key])
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
        state = (kg, kc, ks)
    if theta == 64.0:  # nothing fired: every offered column was skipped
        for st in kg:
            assert torch.equal(st["skipped"], st["total"])


@pytest.mark.parametrize("classifier,theta", BACKENDS[:5], ids=[f"{c}-{t}" for c, t in BACKENDS[:5]])
def test_server_launches_one_tick_kernel_per_tick(dev, classifier, theta):
    pipe = _pipe(dev, classifier, theta)
    srv = StreamingKWSServer(pipe, pipe.init_params(torch.Generator().manual_seed(3)), max_streams=64)
    for sid in range(40):
        srv.open_stream(sid)
    rng = np.random.default_rng(4)
    build.launches.clear()
    for _ in range(3):
        srv.step_batch((rng.standard_normal((64, 256)) * 0.1).astype(np.float32), rng.random(64) < 0.8)
    srv.run_batch((rng.standard_normal((4, 64, 256)) * 0.1).astype(np.float32), np.ones((4, 64), bool))
    assert build.launches["tick_fused"] == 7
    assert build.launches["intgemm"] == 0
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
