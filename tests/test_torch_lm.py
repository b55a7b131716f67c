"""The LM side of the port against the reference's, on the CPU.

The ten architecture configs field by field; `models.layers` function by
function; the gradient of the chunked WKV6 form against ``jax.grad`` of
the reference's (F8); the reduced rwkv6 backbone in float32 and bfloat16
(logits, loss, every gradient leaf) from the reference's parameters
carried by `convert.lm_params_from_numpy`; prefill and decode against the
full forward; `build_train_step` (two microbatches, a cosine schedule)
against the reference's on a 1 x 1 mesh with Auto axes; the registry and
the command line.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec

from repro import configs as jconfigs
from repro.distributed.sharding import ShardingRules
from repro.models import layers as jl
from repro.models import rwkv6 as jr
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jo
from repro.training import train_loop as jtl
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import layers as tl
from repro_torch.models import rwkv6 as tr
from repro_torch.models.registry import get_backbone
from repro_torch.training import optimizer as to
from repro_torch.training import train_loop as ttl
from repro_torch.training.checkpoint import _flatten_with_names

# float32, the port against the reference, max |difference| / max |reference|
# a leaf. Measured on the reduced rwkv6 below: logits 3.6e-6, gradients
# 8.5e-6 (the WKV6 chunked form's einsums and cumsums in another order);
# the chunked form's own gradients 6.5e-7.
F32_TOL = 5e-5
WKV_GRAD_TOL = 5e-6
# bfloat16. XLA keeps excess float32 precision inside its fusions, the
# port rounds every operation to bfloat16, so the two are different
# bfloat16 computations. Measured over seeds 0-3: loss within 2.1e-3,
# logits within 2.6e-2 of max |logit| (seed 0); a gradient leaf's
# ||port - reference|| / ||reference|| at most 0.168, and its distance to
# the float32 gradient at most 2.23 times the reference's own.
BF16_LOSS_TOL = 5e-3
BF16_LOGIT_TOL = 5e-2
BF16_GRAD_NORM_TOL = 0.25
BF16_VS_REF_ERROR = 3.0


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).astype(np.float32)
    return t.numpy()


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


def _nrel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(np.asarray(got, np.float32) - want) / np.linalg.norm(want))


def _pairs(port_tree, ref_tree):
    port, ref = _flatten_with_names(port_tree), jckpt._flatten_with_names(ref_tree)
    assert [n for n, _ in port] == [n for n, _ in ref]
    return [(n, _np(a), np.asarray(b, np.float32)) for (n, a), (_, b) in zip(port, ref)]


# ---------------- configs ----------------

def test_configs_equal_the_references():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert len(tconfigs.list_archs()) == 10
    assert tconfigs.SHAPES == {k: tconfigs.ShapeSpec(**dataclasses.asdict(v))
                               for k, v in jconfigs.SHAPES.items()}
    for name in jconfigs.list_archs():
        j, t = jconfigs.get_config(name), tconfigs.get_config(name)
        for jc, tc in ((j, t), (j.reduced(), t.reduced())):
            for f in dataclasses.fields(jc):
                a, b = getattr(tc, f.name), getattr(jc, f.name)
                if dataclasses.is_dataclass(b):
                    a, b = dataclasses.asdict(a), dataclasses.asdict(b)
                assert a == b, (name, f.name)
            assert tc.vocab_padded == jc.vocab_padded
            assert tc.resolved_head_dim == jc.resolved_head_dim
            assert tc.param_count() == jc.param_count()
            assert tc.active_param_count() == jc.active_param_count()
            assert [s.name for s in tc.shapes()] == [s.name for s in jc.shapes()]
            want = torch.bfloat16 if jc.activation_dtype == jnp.bfloat16 else torch.float32
            assert tc.activation_dtype is want
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("nope")


# ---------------- layers ----------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_equal_the_references(dtype):
    """rms_norm, softcap, rope / apply_rope, the three MLPs and the loss on
    the same inputs (bfloat16: within an ulp of the activations)."""
    rng = np.random.default_rng(1)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    tol = 1e-6 if dtype == "float32" else 1e-2
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    scale = (rng.standard_normal(16) * 0.1).astype(np.float32)
    assert _rel(_np(tl.rms_norm(xt, torch.from_numpy(scale))),
                jl.rms_norm(xj, jnp.asarray(scale))) <= tol
    assert _rel(_np(tl.softcap(xt * 40, 30.0)), jl.softcap(xj * 40, 30.0)) <= tol
    assert tl.softcap(xt, None) is xt
    pos = np.arange(5, dtype=np.int32)
    jc, js = jl.rope(jnp.asarray(pos), 16, 1e6)
    tc, ts = tl.rope(torch.from_numpy(pos), 16, 1e6)
    assert _rel(tc.numpy(), jc) <= 1e-6 and _rel(ts.numpy(), js) <= 1e-6
    assert _rel(_np(tl.apply_rope(xt, tc, ts)), jl.apply_rope(xj, jc, js)) <= tol
    h = x.reshape(10, 3, 16)[:, 0]
    for act in ("swiglu", "geglu", "gelu"):
        p = jax.tree.map(np.asarray, jl.mlp_init(jax.random.PRNGKey(2), 16, 32, act))
        tp = {k: torch.tensor(v) for k, v in p.items()}
        got = tl.mlp_apply(tp, torch.from_numpy(h).to(tdt), act)
        assert got.dtype == tdt
        assert _rel(_np(got), jl.mlp_apply(p, jnp.asarray(h, jdt), act)) <= 4 * tol, act
    logits = rng.standard_normal((2, 4, 50)).astype(np.float32) * 5
    labels = rng.integers(0, 50, (2, 4)).astype(np.int32)
    for cap in (None, 30.0):
        want = float(jl.cross_entropy_loss(jnp.asarray(logits, jdt), jnp.asarray(labels), cap))
        got = float(tl.cross_entropy_loss(torch.from_numpy(logits).to(tdt),
                                          torch.from_numpy(labels), cap))
        assert abs(got - want) <= 1e-6 * abs(want)


def test_dense_init_draws_from_the_generator():
    a = tl.dense_init(torch.Generator().manual_seed(3), (256, 512))
    b = tl.dense_init(torch.Generator().manual_seed(3), (256, 512))
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert abs(float(a.std()) * 16 - 1) < 0.02  # std 1 / sqrt(fan_in)
    assert abs(float(tl.dense_init(torch.Generator().manual_seed(3), (64, 8), 4).std()) * 2 - 1) < 0.1
    p = tl.mlp_init(torch.Generator().manual_seed(0), 8, 16, "gelu")
    assert sorted(p) == ["w_down", "w_up"]
    assert sorted(tl.mlp_init(torch.Generator().manual_seed(0), 8, 16, "swiglu")) == [
        "w_down", "w_gate", "w_up"]


# ---------------- F8: the chunked form's gradient ----------------

def _wkv_inputs(b, t, h, p, seed, strong=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, p)).astype(np.float32) for _ in range(3))
    if strong:
        lw = np.full((b, t, h, p), -50.0, np.float32)
    else:
        lw = (-np.exp(rng.standard_normal((b, t, h, p)) - 1)).astype(np.float32)
    u = (rng.standard_normal((h, p)) * 0.3).astype(np.float32)
    return r, k, v, lw, u


@pytest.mark.parametrize("b,t,h,p,chunk,strong", [(1, 32, 2, 8, 16, False),
                                                  (2, 24, 2, 8, 5, False),
                                                  (2, 20, 2, 8, 16, True)],
                         ids=["two-chunks", "padded-tail", "strong-decay"])
def test_wkv6_chunked_gradient_equals_jax_grad(b, t, h, p, chunk, strong, monkeypatch):
    """F8: the gradients in r, k, v, logw and u of a random cotangent on
    (y, final state) within WKV_GRAD_TOL of max |g| of the leaf (strong
    decay: logw's true gradient is 0 and both are rounding noise, held to
    the largest gradient of the five); the backward rebuilding ratio one
    chunk at a time gives the same gradients; the forward is unchanged
    without a graph."""
    a = _wkv_inputs(b, t, h, p, seed=t + p, strong=strong)
    rng = np.random.default_rng(1)
    gy = rng.standard_normal((b, t, h, p)).astype(np.float32)
    gs = rng.standard_normal((b, h, p, p)).astype(np.float32)

    def f(*xs):
        y, s = jr.wkv6_chunked(*xs, chunk)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    want = [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, a))]

    def port_grads():
        xs = [torch.from_numpy(x).requires_grad_(True) for x in a]
        y, s = tr.wkv6_chunked(*xs, chunk)
        (torch.sum(y * torch.from_numpy(gy)) + torch.sum(s * torch.from_numpy(gs))).backward()
        return y.detach(), s.detach(), [x.grad.numpy() for x in xs]

    y, s, got = port_grads()
    biggest = max(np.abs(w).max() for w in want)
    for name, g, w in zip("rkvwu", got, want):
        scale = biggest if (strong and name == "w") else np.abs(w).max()
        assert np.abs(g - w).max() <= WKV_GRAD_TOL * scale, name
    monkeypatch.setattr(tr, "_BACKWARD_ELEMS", 1)  # one chunk a group
    _, _, again = port_grads()
    for g, g1 in zip(got, again):
        np.testing.assert_array_equal(g, g1)
    with torch.no_grad():
        y0, s0 = tr.wkv6_chunked(*(torch.from_numpy(x) for x in a), chunk)
    assert torch.equal(y, y0) and torch.equal(s, s0)


# ---------------- the reduced backbone ----------------

def _reduced(dtype):
    return (dataclasses.replace(jconfigs.get_config("rwkv6-7b").reduced(), dtype=dtype),
            dataclasses.replace(tconfigs.get_config("rwkv6-7b").reduced(), dtype=dtype))


def _model_inputs(seed=0):
    """The reference's initial parameters with every leaf perturbed (so
    the zero-initialised mixes, norms and bonus take part), rounded to
    bfloat16 values, as float32 numpy; tokens (2, 33)."""
    jcfg, _ = _reduced("float32")
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.1)
        .astype(ml_dtypes.bfloat16).astype(np.float32),
        jr.init_params(jax.random.PRNGKey(seed), jcfg))
    toks = rng.integers(0, jcfg.vocab, (2, 33)).astype(np.int32)
    return params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _ref_model(params, batch, dtype):
    jcfg, _ = _reduced(dtype)
    p = jax.tree.map(lambda a: jnp.asarray(a, jcfg.activation_dtype), params)
    b = jax.tree.map(jnp.asarray, batch)

    def loss_and_logits(p, b):  # rwkv6.loss_fn, with its logits
        logits, _ = jr.forward(p, b, jcfg)
        return jl.cross_entropy_loss(logits, b["labels"], jcfg.final_softcap), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True))(p, b)
    return float(loss), grads, np.asarray(logits, np.float32)


def _port_model(params, batch, dtype):
    _, tcfg = _reduced(dtype)
    cast = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a,
                        params)
    tp = convert.lm_params_from_numpy(cast, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = jax.tree.map(lambda t: t.detach().requires_grad_(True), tp)
    loss = tr.loss_fn(leaves, tb, tcfg)
    loss.backward()
    loss = loss.detach()
    logits, aux = tr.forward(tp, tb, tcfg)
    assert float(aux) == 0.0 and logits.dtype == tcfg.activation_dtype
    return float(loss), jax.tree.map(lambda t: t.grad, leaves), _np(logits)


@pytest.fixture(scope="module")
def model_runs():
    params, batch = _model_inputs()
    return {dtype: (_ref_model(params, batch, dtype), _port_model(params, batch, dtype))
            for dtype in ("float32", "bfloat16")}


def test_reduced_rwkv6_float32_equals_the_reference(model_runs):
    (ref_loss, ref_g, ref_logits), (loss, grads, logits) = model_runs["float32"]
    assert abs(loss - ref_loss) <= 1e-5
    assert _rel(logits, ref_logits) <= F32_TOL
    for name, g, w in _pairs(grads, ref_g):
        assert g.dtype == np.float32 and _rel(g, w) <= F32_TOL, name


def test_reduced_rwkv6_bfloat16_against_the_reference(model_runs):
    """bfloat16 leaves and gradients; loss and logits within the measured
    tolerance of the reference's bfloat16 run; every gradient leaf within
    BF16_GRAD_NORM_TOL of the reference's (norm-relative), and no further
    from the float32 gradient than BF16_VS_REF_ERROR times the
    reference's own bfloat16 error."""
    (ref_loss, ref_g, ref_logits), (loss, grads, logits) = model_runs["bfloat16"]
    (_, truth, _), _ = model_runs["float32"]
    truth = dict((n, np.asarray(w)) for n, w in jckpt._flatten_with_names(truth))
    assert abs(loss - ref_loss) <= BF16_LOSS_TOL
    assert _rel(logits, ref_logits) <= BF16_LOGIT_TOL
    for name, g, w in _pairs(grads, ref_g):
        assert _nrel(g, w) <= BF16_GRAD_NORM_TOL, name
        assert _nrel(g, truth[name]) <= BF16_VS_REF_ERROR * _nrel(w, truth[name]), name
    for _, leaf in _flatten_with_names(grads):
        assert leaf.dtype == torch.bfloat16


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_remat_policies_give_the_same_gradients(remat):
    """"full" (the default), "dots" and "none" recompute differently and
    give the same gradients."""
    params, batch = _model_inputs(1)
    _, tcfg = _reduced("float32")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    for mode in ("full", remat):
        leaves = jax.tree.map(lambda t: t.requires_grad_(True),
                              convert.lm_params_from_numpy(params, "cpu"))
        tr.loss_fn(leaves, tb, dataclasses.replace(tcfg, remat=mode)).backward()
        grads[mode] = _flatten_with_names(jax.tree.map(lambda t: t.grad, leaves))
    for (name, a), (_, b) in zip(grads["full"], grads[remat]):
        assert torch.equal(a, b), name


def test_streaming_equals_full_fp32():
    """prefill(s[:32]) + decode(s[32]) == forward(s)[-1] in float32, the
    reference's own test, on the port with every leaf perturbed (the
    bonus u, the token-shift and channel-mix mixes and the norms take
    part); and decode's logits and cache against the reference's decode
    step from the same cache and its full forward."""
    jcfg, cfg = _reduced("float32")
    np_params, _ = _model_inputs(2)
    params = convert.lm_params_from_numpy(np_params, "cpu")
    for name in ("bonus_u", "cm_mix_k", "cm_mix_r", "mix_x", "mix_base", "ln_x"):
        assert float(params["layers"][name].abs().min()) > 0, name
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 100, (2, 33)).astype(np.int32))
    full, _ = tr.forward(params, {"tokens": toks}, cfg)
    last, cache = tr.prefill(params, {"tokens": toks[:, :32]}, cfg, max_len=48)
    np.testing.assert_allclose(last.numpy(), full[:, 31].numpy(), rtol=1e-3, atol=2e-4)
    ld, new_cache = tr.decode_step(params, cache, 32, {"tokens": toks[:, 32:33]}, cfg)
    np.testing.assert_allclose(ld.numpy(), full[:, -1].numpy(), rtol=1e-3, atol=2e-4)
    zero = tr.init_cache(cfg, 2, 48, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in zero.items()} == {
        k: (v.shape, v.dtype) for k, v in new_cache.items()}

    jp = jax.tree.map(jnp.asarray, np_params)
    np_cache = jax.tree.map(lambda t: t.numpy(), cache)
    want, want_cache = jr.decode_step(jp, jax.tree.map(jnp.asarray, np_cache), jnp.int32(32),
                                      {"tokens": jnp.asarray(toks[:, 32:33].numpy())}, jcfg)
    assert _rel(ld.numpy(), want) <= F32_TOL
    for name, a, b in _pairs(new_cache, want_cache):
        assert _rel(a, b) <= F32_TOL, name
    want_full, _ = jr.forward(jp, {"tokens": jnp.asarray(toks.numpy())}, jcfg)
    assert _rel(ld.numpy(), np.asarray(want_full)[:, -1]) <= F32_TOL


def test_init_params_layout():
    """The stacked tree of the reference (names, shapes), in the
    activation dtype, on the card by default (raising without one)."""
    jcfg, tcfg = _reduced("bfloat16")
    params = tr.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    shapes = jax.eval_shape(lambda k: jr.init_params(k, jcfg), jax.random.PRNGKey(0))
    got = [(n, tuple(t.shape)) for n, t in _flatten_with_names(params)]
    assert got == [(n, tuple(s.shape)) for n, s in jckpt._flatten_with_names(shapes)]
    assert all(t.dtype == torch.bfloat16 for _, t in _flatten_with_names(params))
    assert float(params["layers"]["decay_base"][0, 0]) == -6.0


# ---------------- the train step ----------------

def test_train_step_follows_the_references():
    """Two steps of two microbatches with a cosine schedule from the same
    params, float32: the loss within 1e-6, grad_norm within 1e-5 of it,
    the params within a hundredth of the learning rate (measured 3.3e-6
    at lr 3e-3) and the moments within F32_TOL of their largest entry."""
    jcfg, tcfg = _reduced("float32")
    p = jr.init_params(jax.random.PRNGKey(0), jcfg)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    lr = 3e-3
    jstep = jax.jit(jtl.build_train_step(jcfg, ShardingRules(mesh=mesh), jtl.TrainConfig(
        jo.AdamWConfig(lr=lr), microbatch=2, lr_schedule=jo.cosine_schedule(lr, 1, 10))))
    tstep = ttl.build_train_step(tcfg, ttl.TrainConfig(
        to.AdamWConfig(lr=lr), microbatch=2, lr_schedule=to.cosine_schedule(lr, 1, 10)), "cpu")
    # placed as the step places its outputs, so that the second step reuses
    # the first one's compilation
    jp, jopt = jax.device_put((p, jo.init_opt_state(p, jo.AdamWConfig(lr=lr))),
                              NamedSharding(mesh, PartitionSpec()))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    topt = to.init_opt_state(tp, to.AdamWConfig(lr=lr))
    batches = list(ttl.lm_batches(tcfg.vocab, 2, batch=4, seq=16))
    with mesh:
        for b in batches:
            jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
            tp, topt, tm = tstep(tp, topt, b)
            assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-6
            assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) <= 1e-5
    for name, a, b in _pairs(tp, jp):
        assert np.abs(a - b).max() <= 1e-2 * lr, name
    for name, a, b in _pairs(topt, jopt):
        if a.ndim:
            assert np.abs(a - b).max() <= F32_TOL * max(np.abs(b).max(), 1e-30), name
        else:
            assert a == b, name


# F10 (R7): from the port's own initial draw the second step's gradient
# sits where one float32 rounding of one activation moves it by 1.45e-5
# (the time mix's output product rounded once in an otherwise float64
# run). Measured against the port in float64 (the truth): grad_norm
# 2.28e-4 (port) and 7.04e-5 (reference) from it, each leaf within
# 2.37e-4 / 7.39e-5 norm-relative; the first step within 1.5e-6 / 1.1e-5.
# `python tests/test_torch_lm.py` prints these and the study behind them.
F10_STEP1_TOL = 5e-5
F10_STEP2_TOL = 5e-4


def _grads_into_metrics(module, mp):
    """Have ``module``'s train step return its averaged gradients in its
    metrics (``adamw_update`` is looked up when the step runs)."""
    update = module.adamw_update

    def wrapped(params, grads, *args, **kwargs):
        params, state, metrics = update(params, grads, *args, **kwargs)
        return params, state, dict(metrics, grads=grads)

    mp.setattr(module, "adamw_update", wrapped)


def _f10_runs(draw, mp, dtypes=("float64", "float32"), post=None):
    """The two steps of `test_train_step_follows_the_references` from
    ``draw`` (numpy float32 leaves): the port in each of ``dtypes`` (with
    ``post`` in place of `rwkv6._time_mix_post`, if given) and the
    reference in float32, each a list of (grad_norm, {leaf: gradient},
    {leaf: params after the step}) a step."""
    jcfg, tcfg = _reduced("float32")
    lr = 3e-3
    _grads_into_metrics(jtl, mp)
    _grads_into_metrics(ttl, mp)
    batches = list(ttl.lm_batches(tcfg.vocab, 2, batch=4, seq=16))
    train = ttl.TrainConfig(to.AdamWConfig(lr=lr), microbatch=2,
                            lr_schedule=to.cosine_schedule(lr, 1, 10))

    def port_run(dtype):
        cfg = dataclasses.replace(tcfg, dtype=dtype)
        p = jax.tree.map(lambda a: torch.tensor(a, dtype=cfg.activation_dtype), draw)
        opt = to.init_opt_state(p, to.AdamWConfig(lr=lr))
        step, out = ttl.build_train_step(cfg, train, "cpu"), []
        for b in batches:
            p, opt, m = step(p, opt, b)
            out.append((float(m["grad_norm"]),
                        {n: _np(g).astype(np.float64) for n, g in _flatten_with_names(m["grads"])},
                        {n: _np(t).astype(np.float64) for n, t in _flatten_with_names(p)}))
        return out

    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jstep = jax.jit(jtl.build_train_step(jcfg, ShardingRules(mesh=mesh), jtl.TrainConfig(
        jo.AdamWConfig(lr=lr), microbatch=2, lr_schedule=jo.cosine_schedule(lr, 1, 10))))
    jp = jax.tree.map(jnp.asarray, draw)
    jp, jopt = jax.device_put((jp, jo.init_opt_state(jp, jo.AdamWConfig(lr=lr))),
                              NamedSharding(mesh, PartitionSpec()))
    ref = []
    with mesh:
        for b in batches:
            jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
            ref.append((float(jm["grad_norm"]),
                        {n: np.asarray(g, np.float64) for n, g in jckpt._flatten_with_names(
                            jm["grads"])},
                        {n: np.asarray(t, np.float64) for n, t in jckpt._flatten_with_names(jp)}))
    if post is not None:
        mp.setattr(tr, "_time_mix_post", post)
    return [port_run(d) for d in dtypes] + [ref]


def _f10_distance(run, truth):
    """(grad_norm's relative distance, the largest norm-relative leaf
    distance) of a float32 run's step from the truth's."""
    t_norm, t_grads, _ = truth
    norm, grads, _ = run
    return (abs(norm / t_norm - 1),
            max(float(np.linalg.norm(grads[n] - w) / np.linalg.norm(w)) for n, w in t_grads.items()))


def _port_draw(seed):
    _, tcfg = _reduced("float32")
    return jax.tree.map(lambda t: t.numpy(),
                        tr.init_params(torch.Generator().manual_seed(seed), tcfg, device="cpu"))


def test_train_step_from_the_ports_draw_against_a_float64_truth(monkeypatch):
    """F10, settled: the two steps of `test_train_step_follows_the_references`
    from the port's initial draw, run by the port in float64 (the truth),
    by the port in float32 and by the reference in float32. Both float32
    runs are held to the truth on grad_norm and on every leaf's gradient
    (norm-relative) at the measured distances; the params after the first
    step are equal in all three, so the second step's gradients are taken
    at the same point."""
    truth, port, ref = _f10_runs(_port_draw(0), monkeypatch)
    for i, tol in enumerate((F10_STEP1_TOL, F10_STEP2_TOL)):
        for run in (port, ref):
            norm_dist, leaf_dist = _f10_distance(run[i], truth[i])
            assert norm_dist <= tol and leaf_dist <= tol, i
    for run in (port, ref):
        for name, want in truth[0][2].items():
            np.testing.assert_array_equal(run[0][2][name], want, err_msg=name)


def _f10_study():
    """The F10 study: from the port's and the reference's draws at seeds
    0-5, each float32 run's distance from the float64 truth at the second
    step; then, on the port's draw at seed 0, how far one float32 rounding
    of the time mix's output moves the truth, and the port's float32 run
    with that one product in float64."""
    from repro.models import rwkv6 as jr_

    jcfg, _ = _reduced("float32")
    post = tr._time_mix_post
    print("draw      seed  port grad_norm / leaf     reference grad_norm / leaf")
    for seed in range(6):
        for source, draw in (("port", _port_draw(seed)),
                             ("reference", jax.tree.map(np.asarray, jr_.init_params(
                                 jax.random.PRNGKey(seed), jcfg)))):
            with pytest.MonkeyPatch.context() as mp:
                truth, port, ref = _f10_runs(draw, mp)
            (pn, pl), (rn, rl) = (_f10_distance(r[1], truth[1]) for r in (port, ref))
            print(f"{source:9s} {seed}     {pn:.3g} / {pl:.3g}          {rn:.3g} / {rl:.3g}")
    draw = _port_draw(0)
    with pytest.MonkeyPatch.context() as mp:
        truth, _ = _f10_runs(draw, mp, ("float64",))
    with pytest.MonkeyPatch.context() as mp:
        rounded, _ = _f10_runs(draw, mp, ("float64",),
                               lambda *a: post(*a).to(torch.float32).to(torch.float64))
    print("the truth with the time mix's output rounded once to float32: grad_norm %.3g / "
          "leaf %.3g" % _f10_distance(rounded[1], truth[1]))

    def wide_product(p, y, g, cfg):
        wide = {k: v.double() if k in ("ln_x", "w_o") else v for k, v in p.items()}
        return post(wide, y.double(), g.double(), cfg).to(y.dtype)

    with pytest.MonkeyPatch.context() as mp:
        port64, _ = _f10_runs(draw, mp, ("float32",), wide_product)
    print("the port in float32 with that product in float64: grad_norm %.3g / leaf %.3g"
          % _f10_distance(port64[1], truth[1]))


def test_registry_and_command_line(capsys):
    """rwkv6, the transformer and zamba2 resolve to the port's modules, and
    each trains from the command line (rwkv6 is the default arch)."""
    from repro_torch.models import transformer as tt
    from repro_torch.models import zamba2 as tz

    assert get_backbone(tconfigs.get_config("rwkv6-7b")) is tr
    assert get_backbone(tconfigs.get_config("qwen3-4b")) is tt
    assert get_backbone(tconfigs.get_config("zamba2-7b")) is tz
    for argv in (["--steps", "2"], ["--arch", "qwen3-4b", "--steps", "2"],
                 ["--arch", "zamba2-7b", "--steps", "2"]):
        assert ttl.main(argv + ["--device", "cpu"]) == 0
        assert "smoke train OK" in capsys.readouterr().out


def test_command_line_trains_an_embedding_frontend(capsys):
    """musicgen (frame embeddings in place of tokens): the batches carry
    "embeddings" (batch, seq, d_model) and "labels", the same labels as
    the token recipe's, and the command line trains on them."""
    cfg = tconfigs.get_config("musicgen-medium").reduced()
    toks = list(ttl.lm_batches(cfg.vocab, 2, batch=3, seq=5))
    embs = list(ttl.lm_batches(cfg.vocab, 2, batch=3, seq=5, embed_dim=cfg.d_model))
    for t, e in zip(toks, embs):
        assert sorted(e) == ["embeddings", "labels"] and torch.equal(t["labels"], e["labels"])
        assert e["embeddings"].shape == (3, 5, cfg.d_model)
        assert e["embeddings"].dtype == torch.float32
    assert not torch.equal(embs[0]["embeddings"], embs[1]["embeddings"])
    assert ttl.main(["--arch", "musicgen-medium", "--steps", "3", "--device", "cpu"]) == 0
    assert "smoke train OK" in capsys.readouterr().out


def test_lm_params_cross_in_bfloat16():
    """bfloat16 leaves cross through their 16 bits, float32 and int32
    unchanged, nested dicts and lists kept."""
    a = (np.random.default_rng(0).standard_normal((3, 5)) * 7).astype(ml_dtypes.bfloat16)
    tree = {"x": a, "y": [np.arange(4, dtype=np.int32), np.float32(2.5) * np.ones(2, np.float32)]}
    got = convert.lm_params_from_numpy(tree, "cpu")
    assert got["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["x"].view(torch.int16).numpy(), a.view(np.int16))
    assert got["y"][0].dtype == torch.int32 and got["y"][1].dtype == torch.float32
    assert isinstance(got["y"], list)


if __name__ == "__main__":
    _f10_study()
