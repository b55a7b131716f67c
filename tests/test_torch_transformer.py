"""The port's transformer backbone (`repro_torch.models.transformer`)
against the reference's (`repro.models.transformer`) on the CPU.

All eight ``backbone="transformer"`` configs, reduced: the forward's
logits, the loss and every gradient leaf of `loss_fn` from the same
parameters (the reference's tree, carried by
`convert.lm_params_from_numpy`) in float32 and in bfloat16; prefill and
decode against the full float32 forward (qwen3, gemma2, and gemma2 with
its local ring wrapped) and against the reference's decode step; the
qwen3 train step against the reference's on a 1 x 1 mesh with Auto axes;
the parameter tree, dtypes and count against ``jax.eval_shape`` of the
reference's `init_params`; `init_params` and `init_cache` on the card by
default.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding, PartitionSpec

from repro import configs as jconfigs
from repro.distributed.sharding import ShardingRules
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jo
from repro.training import train_loop as jtl
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt
from repro_torch.models.registry import get_backbone
from repro_torch.training import optimizer as to
from repro_torch.training import train_loop as ttl
from repro_torch.training.checkpoint import _flatten_with_names

ARCHS = [a for a in jconfigs.list_archs() if jconfigs.get_config(a).backbone == "transformer"]

# float32, port against reference, max |difference| / max |reference| of
# a leaf. Measured over the eight reduced configs: logits <= 8.9e-7,
# gradients <= 1.9e-6, the loss <= 8e-8 relative (contractions in another
# order).
F32_TOL = 2e-5
F32_LOSS_TOL = 1e-6
# bfloat16: XLA keeps float32 inside its fusions, the port rounds every
# operation to bfloat16. Measured: loss within 3.05e-3, logits within
# 1.25e-2 of max |logit|; every gradient leaf no further from the float32
# gradient than 1.26 times the reference's own bfloat16 error.
BF16_LOSS_TOL = 1e-2
BF16_LOGIT_TOL = 5e-2
BF16_VS_REF_ERROR = 3.0
# a routing choice that bfloat16 may tip: float32 probabilities this close
# (relative). Measured: granite's reduced config, layer 2, token 1, 0.169721
# against 0.169709 (7e-5), the only flip of the eight configs.
NEAR_TIE = 1e-2
# prefill / decode against the full forward (the reference's own test)
STREAM_RTOL, STREAM_ATOL = 1e-3, 2e-4


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


def _nrel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(np.asarray(got, np.float32) - want) / np.linalg.norm(want))


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), dtype=dtype, **kw),
            dataclasses.replace(tconfigs.get_config(arch).reduced(), dtype=dtype, **kw))


def _fan_in(name: str, shape) -> int:
    if name == "embed":
        return shape[-1]
    if name == "wo":
        return shape[-3] * shape[-2]
    if name in ("wq", "wk", "wv"):
        return shape[-3]
    return shape[-2]


def _params(jcfg, seed=0):
    """A tree shaped as the reference's `init_params` (``jax.eval_shape``)
    drawn with numpy: weights N(0, 1 / fan_in), norm scales N(0, 0.01)
    (so they take part), rounded to bfloat16 values, as float32."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jt.init_params(k, jcfg), jax.random.PRNGKey(0))

    def draw(path, s):
        name = path[-1].key
        if len(s.shape) == 1 or name in ("q_norm", "k_norm") or "ln" in name or "norm" in name:
            a = rng.standard_normal(s.shape) * 0.1
        else:
            a = rng.standard_normal(s.shape) / math.sqrt(_fan_in(name, s.shape))
        return a.astype(ml_dtypes.bfloat16).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(jcfg, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"labels": toks[:, 1:]}
    if jcfg.frontend == "embedding":
        batch["embeddings"] = rng.standard_normal((b, s, jcfg.d_model)).astype(
            ml_dtypes.bfloat16).astype(np.float32)
    else:
        batch["tokens"] = toks[:, :-1]
    return batch


def _ref_run(arch, params, batch, dtype):
    jcfg, _ = _cfgs(arch, dtype)
    p = jax.tree.map(lambda a: jnp.asarray(a, jcfg.activation_dtype), params)
    b = {k: jnp.asarray(v, jcfg.activation_dtype) if k == "embeddings" else jnp.asarray(v)
         for k, v in batch.items()}

    def loss_and_logits(p, b):  # transformer.loss_fn, with its logits
        logits, aux = jt.forward(p, b, jcfg)
        return jl.cross_entropy_loss(logits, b["labels"], jcfg.final_softcap) + 0.01 * aux, logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True))(p, b)
    return float(loss), dict(jckpt._flatten_with_names(grads)), np.asarray(logits, np.float32)


def _port_run(arch, params, batch, dtype, routes=None, pinned=None):
    """The port's (loss, gradients, logits). ``routes`` collects each MoE
    layer call's (router probabilities, chosen experts) in call order;
    ``pinned`` (such a list) makes each call choose the experts of the
    same call there."""
    _, tcfg = _cfgs(arch, dtype)
    cast = (lambda a: a.astype(ml_dtypes.bfloat16)) if dtype == "bfloat16" else (lambda a: a)
    tp = convert.lm_params_from_numpy(jax.tree.map(cast, params), "cpu")
    tb = {k: torch.from_numpy(v).to(tcfg.activation_dtype) if k == "embeddings"
          else torch.from_numpy(v) for k, v in batch.items()}
    top_k, calls = tm._top_k, [] if routes is None else routes

    def recorded(probs, k):
        vals, idx = top_k(probs, k)
        if pinned is not None:
            idx = pinned[len(calls)][1]
            vals = torch.gather(probs, -1, idx)
        calls.append((probs.detach().clone(), idx))
        return vals, idx

    leaves = jax.tree.map(lambda t: t.detach().requires_grad_(True), tp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tm, "_top_k", recorded)
        loss = tt.loss_fn(leaves, tb, tcfg)
        loss.backward()
        with torch.no_grad():
            logits, _ = tt.forward(tp, tb, tcfg)
    assert logits.dtype == tcfg.activation_dtype
    # a leaf the loss does not read (an embedding frontend's token table)
    # has no gradient: jax.grad's zeros
    grads = dict(_flatten_with_names(jax.tree.map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, leaves)))
    return float(loss.detach()), grads, _np(logits)


def _flips(f32_routes, bf16_routes):
    """[(f32 gap, f32 probability)] of every token whose bfloat16 experts
    differ from its float32 ones: the float32 probabilities of the expert
    chosen only in float32 and of the one chosen only in bfloat16."""
    out = []
    for (p32, i32), (_, i16) in zip(f32_routes, bf16_routes, strict=True):
        for t in torch.nonzero((i32.sort(-1).values != i16.sort(-1).values).any(-1)).flatten():
            only32 = sorted(set(i32[t].tolist()) - set(i16[t].tolist()))
            only16 = sorted(set(i16[t].tolist()) - set(i32[t].tolist()))
            for a, b in zip(only32, only16):
                out.append((float(p32[t, a] - p32[t, b]), float(p32[t, a])))
    return out


@pytest.fixture(scope="module")
def runs():
    """(reference, port, bfloat16 routing flips) of each (arch, dtype),
    computed once. A bfloat16 MoE run whose routing differs from the
    float32 run's (a near tie that bfloat16 rounding tips over) is run
    again with its experts pinned to the float32 choices; the flips are
    returned with it."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            jcfg, _ = _cfgs(arch)
            params, batch = _params(jcfg), _batch(jcfg)
            if dtype == "float32":
                routes = []
                port = _port_run(arch, params, batch, dtype, routes)
                cache[arch, "routes"] = routes
                flips = []
            else:
                get(arch, "float32")
                f32_routes, routes = cache[arch, "routes"], []
                port = _port_run(arch, params, batch, dtype, routes)
                flips = _flips(f32_routes, routes)
                if flips:
                    port = _port_run(arch, params, batch, dtype, pinned=f32_routes)
            cache[arch, dtype] = (_ref_run(arch, params, batch, dtype), port, flips)
        return cache[arch, dtype]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_gradients_float32(arch, runs):
    (ref_loss, ref_g, ref_logits), (loss, grads, logits), _ = runs(arch, "float32")
    assert abs(loss - ref_loss) <= F32_LOSS_TOL * abs(ref_loss)
    assert _rel(logits, ref_logits) <= F32_TOL
    assert sorted(grads) == sorted(ref_g)
    for name, w in ref_g.items():
        g = grads[name]
        assert g.dtype == torch.float32, name
        w = np.asarray(w)
        if not np.any(w):  # no gradient reaches it (padded experts): none in the port either
            assert not torch.any(g), name
            continue
        assert _rel(_np(g), w) <= F32_TOL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_gradients_bfloat16(arch, runs):
    """bfloat16 leaves and gradients; loss and logits within the measured
    tolerance of the reference's bfloat16 run; every gradient leaf no
    further from the float32 gradient than BF16_VS_REF_ERROR times the
    reference's own bfloat16 error. Where bfloat16 tips a near tie of
    the router (float32 probabilities within NEAR_TIE of each other) to
    another expert, the comparison is made with the float32 choices
    pinned."""
    (ref_loss, ref_g, ref_logits), (loss, grads, logits), flips = runs(arch, "bfloat16")
    (_, truth, _), _, _ = runs(arch, "float32")
    for gap, prob in flips:
        assert 0 <= gap <= NEAR_TIE * prob, (gap, prob)
    assert abs(loss - ref_loss) <= BF16_LOSS_TOL
    assert _rel(logits, ref_logits) <= BF16_LOGIT_TOL
    for name, w in ref_g.items():
        g, t = grads[name], np.asarray(truth[name])
        assert g.dtype == torch.bfloat16, name
        if not np.any(t):
            assert not torch.any(g), name
            continue
        assert _nrel(_np(g), t) <= BF16_VS_REF_ERROR * _nrel(np.asarray(w, np.float32), t), name


@pytest.mark.parametrize("arch,prompt,max_len", [("qwen3-4b", 32, 48), ("gemma2-27b", 32, 48),
                                                 ("gemma2-27b", 40, 48),
                                                 ("granite-moe-3b-a800m", 32, 48)],
                         ids=["qwen3", "gemma2", "gemma2-ring-wrapped", "granite"])
def test_streaming_equals_full_fp32(arch, prompt, max_len):
    """prefill(s[:n]) + decode steps == forward(s) at each position, in
    float32 (the reference's own test, three decode steps); gemma2's
    local slots are 32-slot rings, wrapped by a 40-token prompt (the roll
    of `_compress_kv`) and the window mask cuts in. The first decode
    step's logits and cache against the reference's decode step from the
    same cache. granite runs at capacity factor num_experts / top_k (every
    token kept), so the forward drops nothing that decode keeps."""
    jcfg, cfg = _cfgs(arch)
    if cfg.moe is not None:
        jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=c.moe.num_experts / c.moe.top_k)) for c in (jcfg, cfg))
    params = _params(jcfg, seed=2)
    tp = convert.lm_params_from_numpy(params, "cpu")
    toks = np.random.default_rng(3).integers(0, 100, (2, prompt + 3)).astype(np.int32)
    full, _ = tt.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    full = tt.softcap(full, cfg.final_softcap)
    last, cache = tt.prefill(tp, {"tokens": torch.from_numpy(toks[:, :prompt])}, cfg,
                             max_len=max_len)
    np.testing.assert_allclose(last.numpy(), full[:, prompt - 1].numpy(), rtol=STREAM_RTOL,
                               atol=STREAM_ATOL)
    zero = tt.init_cache(cfg, 2, max_len, device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), zero) == jax.tree.map(
        lambda t: (tuple(t.shape), t.dtype), cache)
    np_cache = jax.tree.map(lambda t: t.numpy(), cache)
    for i in range(3):
        n = prompt + i
        step = {"tokens": torch.from_numpy(toks[:, n:n + 1])}
        ld, new_cache = tt.decode_step(tp, cache, n if i % 2 else torch.tensor(n), step, cfg)
        np.testing.assert_allclose(ld.numpy(), full[:, n].numpy(), rtol=STREAM_RTOL,
                                   atol=STREAM_ATOL)
        if i == 0:
            want, want_cache = jt.decode_step(
                jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, np_cache),
                jnp.int32(n), {"tokens": jnp.asarray(toks[:, n:n + 1])}, jcfg)
            assert _rel(ld.numpy(), want) <= F32_TOL
            for (name, a), (_, b) in zip(_flatten_with_names(new_cache),
                                         jckpt._flatten_with_names(want_cache)):
                assert _rel(_np(a), b) <= F32_TOL, name
        cache = new_cache
    if cfg.sliding_window and prompt > cfg.sliding_window:  # the ring: the last 32 positions, position p in slot p % 32
        pos = torch.arange(prompt, dtype=torch.float32)[None, :, None, None]
        ring, _ = tt._compress_kv(pos, pos, cfg, "local", max_len)
        assert ring.flatten().tolist() == sorted(range(prompt - 32, prompt), key=lambda p: p % 32)


def test_train_step_follows_the_references():
    """qwen3: two steps of two microbatches with a cosine schedule from the
    same params, float32: the loss within 1e-6, grad_norm within 1e-5,
    the params within a hundredth of the learning rate and the moments
    within F32_TOL of their largest entry."""
    jcfg, tcfg = _cfgs("qwen3-4b")
    p = _params(jcfg, seed=4)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    lr = 3e-3
    jstep = jax.jit(jtl.build_train_step(jcfg, ShardingRules(mesh=mesh), jtl.TrainConfig(
        jo.AdamWConfig(lr=lr), microbatch=2, lr_schedule=jo.cosine_schedule(lr, 1, 10))))
    tstep = ttl.build_train_step(tcfg, ttl.TrainConfig(
        to.AdamWConfig(lr=lr), microbatch=2, lr_schedule=to.cosine_schedule(lr, 1, 10)), "cpu")
    jp = jax.tree.map(jnp.asarray, p)
    jp, jopt = jax.device_put((jp, jo.init_opt_state(jp, jo.AdamWConfig(lr=lr))),
                              NamedSharding(mesh, PartitionSpec()))
    tp = convert.lm_params_from_numpy(p, "cpu")
    topt = to.init_opt_state(tp, to.AdamWConfig(lr=lr))
    with mesh:
        for b in ttl.lm_batches(tcfg.vocab, 2, batch=4, seq=16):
            jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
            tp, topt, tm = tstep(tp, topt, b)
            assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-6
            assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) <= 1e-5
    for (name, a), (_, b) in zip(_flatten_with_names(tp), jckpt._flatten_with_names(jp)):
        assert np.abs(_np(a) - np.asarray(b)).max() <= 1e-2 * lr, name
    for (name, a), (_, b) in zip(_flatten_with_names(topt), jckpt._flatten_with_names(jopt)):
        a, b = _np(a), np.asarray(b)
        if a.ndim:
            assert np.abs(a - b).max() <= F32_TOL * max(np.abs(b).max(), 1e-30), name
        else:
            assert a == b, name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout(arch, monkeypatch):
    """The reference's tree (names, shapes) in the activation dtype, the
    norm scales zero; at full size (drawn on ``meta``: nothing allocated)
    the parameter count equal to the reference's tree's, within 10 % of
    the analytic `param_count` for qwen3 and granite (the reference's
    own test)."""
    from repro_torch.models import attention as ta, layers as tl, moe as tm

    jcfg, tcfg = _cfgs(arch, "bfloat16")
    params = tt.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    shapes = jax.eval_shape(lambda k: jt.init_params(k, jcfg), jax.random.PRNGKey(0))
    got = [(n, tuple(t.shape)) for n, t in _flatten_with_names(params)]
    assert got == [(n, tuple(s.shape)) for n, s in jckpt._flatten_with_names(shapes)]
    assert all(t.dtype == torch.bfloat16 for _, t in _flatten_with_names(params))
    assert all(float(t.abs().max()) == 0 for n, t in _flatten_with_names(params)
               if "norm" in n or n.split("/")[-1].startswith("ln"))
    full = tconfigs.get_config(arch)
    big = jax.eval_shape(lambda k: jt.init_params(k, jconfigs.get_config(arch)),
                         jax.random.PRNGKey(0))
    count = sum(math.prod(s.shape) for s in jax.tree.leaves(big))
    if arch in ("qwen3-4b", "granite-moe-3b-a800m"):
        assert abs(count - full.param_count()) / full.param_count() < 0.1
    meta = lambda gen, shape, fan_in=None: torch.empty(tuple(shape), device="meta")  # noqa: E731
    for module in (tl, ta, tm, tt):
        monkeypatch.setattr(module, "dense_init", meta)
    drawn = tt.init_params(torch.Generator(), full, device="meta")
    assert sum(t.numel() for _, t in _flatten_with_names(drawn)) == count


def test_init_params_and_cache_default_to_the_card(monkeypatch):
    """``device=None`` is the card (`kernels.build.resolve_device`), which
    raises where there is none."""
    from repro_torch.kernels import build

    _, cfg = _cfgs("gemma2-27b", "bfloat16")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_cache(cfg, 1, 8)
    asked = []
    monkeypatch.setattr(build, "resolve_device",
                        lambda d=None: asked.append(d) or torch.device("meta"))
    assert tt.init_params(torch.Generator().manual_seed(0), cfg)["embed"].device.type == "meta"
    cache = tt.init_cache(cfg, 1, 40)
    assert cache["layers"]["slot0_local"]["k"].shape == (1, 1, 32, 2, 16)  # the window's ring
    assert cache["layers"]["slot1_global"]["k"].device.type == "meta"
    assert asked == [None, None]


def test_every_transformer_config_resolves():
    for arch in ARCHS:
        assert get_backbone(tconfigs.get_config(arch)) is tt
