"""The port's Zamba2 backbone (`repro_torch.models.zamba2`) against the
reference's (`repro.models.zamba2`) on the CPU.

The reduced zamba2 (5 mamba layers, a shared block every 2: applications
0, 1, 0 of the two shared blocks): logits, loss and every gradient leaf
of `loss_fn` from the same parameters (the reference's tree, carried by
`convert.lm_params_from_numpy`) in float32, also held with the reference
against a float64 run of the port, and in bfloat16; prefill's logits and
every cache leaf and a decode step against the reference's; prefill and
a decode step against the full forward (the reference's own test); two
train steps against the reference's on a 1 x 1 mesh with Auto axes; the
parameter tree and count against ``jax.eval_shape`` of the reference's
`init_params`; checkpoints of the tree, with its ``"shared"`` list,
across both packages; `init_params` and `init_cache` on the card by
default; the registry.
"""

import dataclasses
import functools
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
from repro.models import mamba2 as jm
from repro.models import zamba2 as jz
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jo
from repro.training import train_loop as jtl
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import mamba2 as tm
from repro_torch.models import zamba2 as tz
from repro_torch.models.registry import get_backbone
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as to
from repro_torch.training import train_loop as ttl
from repro_torch.training.checkpoint import _flatten_with_names

# float32. The reduced model amplifies rounding: before a mamba block's
# gated RMSNorm its tokens' rms spans 0.029 to 6.8 (the norm divides each
# by its own), and a block multiplies a small input error by 1.5 to 4.8,
# so the reference itself lies 2.2e-5 (logits) and up to 1.7e-4 (a
# gradient leaf) of max |.| from a float64 run of the port: no float32
# run is held to 1e-5 of another here. Port against reference, max
# |difference| / max |reference|, measured: logits 3.7e-5, loss 2.4e-7
# relative, a gradient leaf <= 2.9e-4. Each float32 result is also held
# to the float64 truth: no further from it than F32_VS_REF_ERROR times the
# reference's own float32 result (measured: logits 1.57 times, a gradient
# leaf <= 1.47, mamba/D). `python tests/test_torch_zamba2.py` prints these.
F32_TOL = 5e-4
F32_LOSS_TOL = 1e-6
F32_VS_REF_ERROR = 2.0
# bfloat16: XLA keeps float32 inside its fusions, the port rounds every
# operation to bfloat16. Measured: loss within 6.5e-3 of the reference's
# bfloat16 loss; the logits 1.03 times and every gradient leaf at most
# 1.10 times as far from the float32 reference as the reference's own
# bfloat16 results (norm-relative).
BF16_LOSS_TOL = 2e-2
BF16_VS_REF_ERROR = 3.0
# the train step: a gradient at least RESOLVED of its leaf's largest (root
# of AdamW's second moment) is resolved; elsewhere the params may differ
# by STEP_TOL learning rates. Measured: 3.0e-3 learning rates where
# resolved (70 % of the elements), 0.115 elsewhere; loss 1.6e-7 / 8.2e-8,
# grad_norm 6.0e-5 / 1.8e-5, the moments 1.75e-4 of their largest.
RESOLVED = 1e-2
STEP_TOL = 0.5
# prefill / decode against the full forward (the reference's own test)
STREAM_RTOL, STREAM_ATOL = 1e-3, 2e-4


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def _nrel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jconfigs.get_config("zamba2-7b").reduced(), dtype=dtype),
            dataclasses.replace(tconfigs.get_config("zamba2-7b").reduced(), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _ref_init():
    """The reference's `init_params` of the reduced float32 config, jitted
    (eager, it takes seconds)."""
    jcfg, _ = _cfgs()
    return jax.jit(lambda key: jz.init_params(key, jcfg))


def _params(seed=0):
    """The reference's `init_params` with every vector leaf (norm scales,
    A_log, dt_bias, D, conv_b) moved by N(0, 0.1) so that it takes part,
    rounded to bfloat16 values, as float32 numpy."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        a = np.asarray(a, np.float32)
        if a.ndim - (path[0].key == "mamba") == 1:
            a = a + rng.standard_normal(a.shape).astype(np.float32) * 0.1
        return a.astype(ml_dtypes.bfloat16).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, _ref_init()(jax.random.PRNGKey(seed)))


def _batch(seed=1, b=2, s=40):
    toks = np.random.default_rng(seed).integers(0, 128, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _ref_run(params, batch, dtype):
    jcfg, _ = _cfgs(dtype)
    p = jax.tree.map(lambda a: jnp.asarray(a, jcfg.activation_dtype), params)

    def loss_and_logits(p, b):  # zamba2.loss_fn, with its logits
        logits, _ = jz.forward(p, b, jcfg)
        return jl.cross_entropy_loss(logits, b["labels"], jcfg.final_softcap), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True))(
        p, jax.tree.map(jnp.asarray, batch))
    return (float(loss), {n: np.asarray(g, np.float32) for n, g in
                          jckpt._flatten_with_names(grads)}, np.asarray(logits, np.float32))


def _port_run(params, batch, dtype):
    _, tcfg = _cfgs(dtype)
    if dtype == "bfloat16":
        params = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), params)
    tp = convert.lm_params_from_numpy(params, "cpu")
    if dtype == "float64":
        tp = jax.tree.map(lambda t: t.double(), tp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = ttl.value_and_grad(lambda p, b: tz.loss_fn(p, b, tcfg), tp, tb)
    with torch.no_grad():
        logits, aux = tz.forward(tp, tb, tcfg)
    assert float(aux) == 0.0 and logits.dtype == tcfg.activation_dtype
    assert all(g.dtype == tcfg.activation_dtype for _, g in _flatten_with_names(grads))
    return float(loss), {n: _np(g) for n, g in _flatten_with_names(grads)}, _np(logits)


@pytest.fixture(scope="module")
def model_runs():
    params, batch = _params(), _batch()
    runs = {dtype: (_ref_run(params, batch, dtype), _port_run(params, batch, dtype))
            for dtype in ("float32", "bfloat16")}
    runs["float64"] = _port_run(params, batch, "float64")
    return runs


def test_reduced_zamba2_float32_equals_the_reference(model_runs):
    (ref_loss, ref_g, ref_logits), (loss, grads, logits) = model_runs["float32"]
    _, truth, t_logits = model_runs["float64"]
    assert abs(loss - ref_loss) <= F32_LOSS_TOL * abs(ref_loss)
    assert _rel(logits, ref_logits) <= F32_TOL
    assert _rel(logits, t_logits) <= F32_VS_REF_ERROR * _rel(ref_logits, t_logits)
    assert sorted(grads) == sorted(ref_g)
    for name, w in ref_g.items():
        assert _rel(grads[name], w) <= F32_TOL, name
        assert _rel(grads[name], truth[name]) <= F32_VS_REF_ERROR * _rel(w, truth[name]), name


def test_reduced_zamba2_bfloat16_against_the_reference(model_runs):
    """bfloat16 leaves and gradients; the loss within BF16_LOSS_TOL of the
    reference's bfloat16 run; every gradient leaf and the logits no
    further from the float32 reference than BF16_VS_REF_ERROR times the
    reference's own bfloat16 error (norm-relative)."""
    (ref_loss, ref_g, ref_logits), (loss, grads, logits) = model_runs["bfloat16"]
    (_, truth, t_logits), _ = model_runs["float32"]
    assert abs(loss - ref_loss) <= BF16_LOSS_TOL
    assert _nrel(logits, t_logits) <= BF16_VS_REF_ERROR * _nrel(ref_logits, t_logits)
    for name, w in ref_g.items():
        t = truth[name]
        assert _nrel(grads[name], t) <= BF16_VS_REF_ERROR * _nrel(w, t), name


def _jit_prefill(jcfg, max_len):
    return jax.jit(lambda p, b: jz.prefill(p, b, jcfg, max_len=max_len))


def _jit_decode(jcfg):
    return jax.jit(lambda p, c, n, b: jz.decode_step(p, c, n, b, jcfg))


def test_prefill_and_decode_equal_the_references():
    """prefill of 32 tokens into a 48-position cache: its logits and every
    cache leaf (three applications' K / V, zero-padded; each layer's conv
    carry and SSD state) against the reference's prefill; then one decode
    step from the reference's cache against the reference's step, float32."""
    jcfg, cfg = _cfgs()
    params = _params(seed=2)
    jp = jax.tree.map(jnp.asarray, params)
    tp = convert.lm_params_from_numpy(params, "cpu")
    toks = np.random.default_rng(3).integers(0, 100, (2, 33)).astype(np.int32)
    want, want_cache = _jit_prefill(jcfg, 48)(jp, {"tokens": jnp.asarray(toks[:, :32])})
    got, cache = tz.prefill(tp, {"tokens": torch.from_numpy(toks[:, :32])}, cfg, max_len=48)
    assert _rel(_np(got), want) <= F32_TOL
    pairs = list(zip(_flatten_with_names(cache), jckpt._flatten_with_names(want_cache)))
    assert [n for (n, _), _ in pairs] == ["conv", "shared_kv/k", "shared_kv/v", "ssd"]
    for (name, a), (_, b) in pairs:
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32, name
        assert _rel(_np(a), b) <= F32_TOL, name
    assert not torch.any(cache["shared_kv"]["k"][:, :, 32:])
    zero = tz.init_cache(cfg, 2, 48, device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), zero) == jax.tree.map(
        lambda t: (tuple(t.shape), t.dtype), cache)
    step = toks[:, 32:33]
    want_d, want_c = _jit_decode(jcfg)(jp, want_cache, jnp.int32(32),
                                       {"tokens": jnp.asarray(step)})
    got_d, got_c = tz.decode_step(tp, convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, want_cache), "cpu"), torch.tensor(32),
        {"tokens": torch.from_numpy(step)}, cfg)
    assert _rel(_np(got_d), want_d) <= F32_TOL
    for (name, a), (_, b) in zip(_flatten_with_names(got_c), jckpt._flatten_with_names(want_c)):
        assert _rel(_np(a), b) <= F32_TOL, name


def test_streaming_equals_full_fp32():
    """prefill(s[:32]) + decode(s[32]) == forward(s)[-1] in float32, the
    reference's own test (tests/test_models_smoke.py) on the port, with
    the reference's initial parameters; then three more decode steps,
    each against the forward at its position."""
    _, cfg = _cfgs()
    params = jax.tree.map(np.asarray, _ref_init()(jax.random.PRNGKey(2)))
    tp = convert.lm_params_from_numpy(params, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 100, (2, 36)).astype(np.int32))
    with torch.no_grad():
        full, _ = tz.forward(tp, {"tokens": toks}, cfg)
        _, cache = tz.prefill(tp, {"tokens": toks[:, :32]}, cfg, max_len=48)
        for n in range(32, 36):
            ld, cache = tz.decode_step(tp, cache, n if n % 2 else torch.tensor(n),
                                       {"tokens": toks[:, n:n + 1]}, cfg)
            np.testing.assert_allclose(ld.numpy(), full[:, n].numpy(), rtol=STREAM_RTOL,
                                       atol=STREAM_ATOL)


def _train_steps():
    """Two steps of two microbatches with a cosine schedule from the same
    float32 params in both packages: (the port's per-step (loss, grad_norm)
    ratios to the reference's less 1, the params' max |difference| where
    the gradient is resolved and over all elements, in learning rates, the
    resolved share, the moments' max |difference| over their largest
    entry, the step counters)."""
    jcfg, tcfg = _cfgs()
    p = _params(seed=4)
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
    metrics = []
    with mesh:
        for b in ttl.lm_batches(tcfg.vocab, 2, batch=4, seq=16):
            jp, jopt, jm_ = jstep(jp, jopt, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
            tp, topt, tm_ = tstep(tp, topt, b)
            metrics.append(tuple(abs(float(tm_[k]) / float(jm_[k]) - 1)
                                 for k in ("loss", "grad_norm")))
    second = dict(jckpt._flatten_with_names(jopt))
    resolved_diff = all_diff = 0.0
    n_resolved = n_all = 0
    for (name, a), (_, b) in zip(_flatten_with_names(tp), jckpt._flatten_with_names(jp)):
        diff = np.abs(_np(a) - np.asarray(b)) / lr
        root_v = np.sqrt(np.asarray(second["v/" + name], np.float32))
        resolved = root_v >= RESOLVED * root_v.max()
        resolved_diff = max(resolved_diff, float(diff[resolved].max()))
        all_diff = max(all_diff, float(diff.max()))
        n_resolved, n_all = n_resolved + int(resolved.sum()), n_all + diff.size
    moments, steps = 0.0, []
    for (name, a), (_, b) in zip(_flatten_with_names(topt), jckpt._flatten_with_names(jopt)):
        a, b = _np(a), np.asarray(b, np.float32)
        if a.ndim:
            moments = max(moments, float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)))
        else:
            steps.append((a, b))
    return metrics, resolved_diff, all_diff, n_resolved / n_all, moments, steps


def test_train_step_follows_the_references():
    """Two steps of two microbatches with a cosine schedule from the same
    params, float32: the loss within 1e-6 relative, grad_norm and the
    moments within F32_TOL (of their largest entry); the params within a
    hundredth of the learning rate where the gradient is resolved (the
    reference's second moment at least RESOLVED of its leaf's largest, in
    root), and within STEP_TOL of it elsewhere: where the true gradient
    is within float32's rounding of zero, AdamW's normalised step
    m / sqrt(v) takes the sign and size of that rounding."""
    metrics, resolved_diff, all_diff, _, moments, steps = _train_steps()
    for loss, grad_norm in metrics:
        assert loss <= 1e-6 and grad_norm <= F32_TOL
    assert resolved_diff <= 1e-2 and all_diff <= STEP_TOL
    assert moments <= F32_TOL
    assert all(a == b for a, b in steps)


def test_init_params_layout(monkeypatch):
    """The reference's tree (names, shapes: ``mamba`` stacked, ``shared`` a
    list of two blocks) in the activation dtype, the zero vectors zero
    and D one; at full size (drawn on ``meta``: nothing allocated) the
    count equal to the reference's tree's, within 10 % of the analytic
    `param_count`."""
    from repro_torch.models import attention as ta
    from repro_torch.models import layers as tl

    jcfg, tcfg = _cfgs("bfloat16")
    params = tz.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    shapes = jax.eval_shape(lambda k: jz.init_params(k, jcfg), jax.random.PRNGKey(0))
    got = [(n, tuple(t.shape)) for n, t in _flatten_with_names(params)]
    assert got == [(n, tuple(s.shape)) for n, s in jckpt._flatten_with_names(shapes)]
    assert isinstance(params["shared"], list) and len(params["shared"]) == 2
    assert params["mamba"]["w_x"].shape == (5, 64, 128)
    assert all(t.dtype == torch.bfloat16 for _, t in _flatten_with_names(params))
    for name, t in _flatten_with_names(params):
        leaf = name.split("/")[-1]
        if leaf in ("ln", "ln1", "ln2", "gn", "final_norm", "dt_bias", "A_log", "conv_b"):
            assert not torch.any(t), name
        if leaf == "D":
            assert torch.equal(t, torch.ones_like(t)), name
    # layers drawn one by one: no two alike
    assert not torch.equal(params["mamba"]["w_z"][0], params["mamba"]["w_z"][1])
    full = tconfigs.get_config("zamba2-7b")
    big = jax.eval_shape(lambda k: jz.init_params(k, jconfigs.get_config("zamba2-7b")),
                         jax.random.PRNGKey(0))
    count = sum(math.prod(s.shape) for s in jax.tree.leaves(big))
    assert abs(count - full.param_count()) / full.param_count() < 0.1
    meta = lambda gen, shape, fan_in=None: torch.empty(tuple(shape), device="meta")  # noqa: E731
    for module in (tl, ta, tm, tz):
        monkeypatch.setattr(module, "dense_init", meta)
    drawn = tz.init_params(torch.Generator(), full, device="meta")
    assert sum(t.numel() for _, t in _flatten_with_names(drawn)) == count


def test_checkpoints_cross_both_packages(tmp_path):
    """A bfloat16 zamba2 tree written by the port restores into the
    reference's template bit for bit, and the reference's into the
    port's; the ``shared`` list and the stacked ``mamba`` leaves keep
    their places."""
    _, tcfg = _cfgs("bfloat16")
    tp = tz.init_params(torch.Generator().manual_seed(5), tcfg, device="cpu")
    tckpt.save_checkpoint(str(tmp_path / "port"), 3, tp)
    jtemplate = jax.tree.map(lambda a: a.astype(jnp.bfloat16), _ref_init()(jax.random.PRNGKey(0)))
    jback, step = jckpt.restore_checkpoint(str(tmp_path / "port"), jtemplate)
    assert step == 3 and isinstance(jback["shared"], list)
    for (name, a), (_, b) in zip(_flatten_with_names(tp), jckpt._flatten_with_names(jback)):
        assert b.dtype == jnp.bfloat16, name
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16), err_msg=name)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 4, jtemplate)
    tback, step = tckpt.restore_checkpoint(str(tmp_path / "ref"), tp)
    assert step == 4 and isinstance(tback["shared"], list)
    for (name, a), (_, b) in zip(_flatten_with_names(tback),
                                 jckpt._flatten_with_names(jtemplate)):
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16), err_msg=name)


def test_init_params_and_cache_default_to_the_card(monkeypatch):
    """``device=None`` is the card (`kernels.build.resolve_device`), which
    raises where there is none."""
    from repro_torch.kernels import build

    _, cfg = _cfgs("bfloat16")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tz.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tz.init_cache(cfg, 1, 8)
    asked = []
    monkeypatch.setattr(build, "resolve_device",
                        lambda d=None: asked.append(d) or torch.device("meta"))
    assert tz.init_params(torch.Generator().manual_seed(0), cfg)["embed"].device.type == "meta"
    cache = tz.init_cache(cfg, 1, 40)
    assert cache["shared_kv"]["k"].shape == (3, 1, 40, 2, 16)
    assert cache["conv"].shape == (5, 1, 3, 128) and cache["ssd"].shape == (5, 1, 8, 16, 16)
    assert cache["ssd"].device.type == "meta"
    assert asked == [None, None]


def test_registry_resolves_both_backbones():
    """zamba2-7b's backbone is the port's zamba2; "mamba2" maps to the
    block module, as in the reference's registry."""
    cfg = tconfigs.get_config("zamba2-7b")
    assert get_backbone(cfg) is tz
    assert get_backbone(dataclasses.replace(cfg, backbone="mamba2")) is tm
    with pytest.raises(KeyError, match="unknown backbone"):
        get_backbone(dataclasses.replace(cfg, backbone="nope"))


def _block_distances(params, batch):
    """Where the port's float32 lies farther from the float64 truth than
    the reference's: each block of the reduced model on the same float32
    input (the truth's, rounded), its output's distance from the float64
    block's, port and reference; for a mamba block also its narrow
    projections B, C and a_log (`_block_pre`) and the chunked SSD alone on
    the truth's rounded inputs."""
    jcfg, tcfg = _cfgs()
    _, t64 = _cfgs("float64")
    tp = convert.lm_params_from_numpy(params, "cpu")
    tp64 = jax.tree.map(lambda t: t.double(), tp)
    jp = jax.tree.map(jnp.asarray, params)
    toks = torch.from_numpy(batch["tokens"]).long()
    x, emb = tp64["embed"][toks], tp64["embed"][toks]
    shared = jax.jit(lambda p, x, e: jz._shared_apply(p, x, e, jcfg)[0])
    block = jax.jit(lambda p, x: jm.mamba2_block_apply(p, x, jcfg)[0])
    pre = jax.jit(lambda p, x: jm._block_pre(p, x, jcfg))
    ssd = jax.jit(lambda *a: jm._ssd_chunked(*a, jcfg.ssm.chunk)[0])
    for gi, (start, length) in enumerate(tz._groups(tcfg)):
        xin = x.float()
        x = tz._shared_apply(tz._shared(tp64, t64, gi), x.float().double(), emb, t64)[0]
        port = tz._shared_apply(tz._shared(tp, tcfg, gi), xin, emb.float(), tcfg)[0]
        ref = shared(jp["shared"][gi % jcfg.n_shared_blocks], _np(xin), _np(emb))
        print(f"shared application {gi}: port {_rel(_np(port), x):.3g}, reference "
              f"{_rel(ref, x):.3g} from float64")
        for i in range(start, start + length):
            xin, p64, pj = x.float(), tz._layer(tp64, i), jax.tree.map(lambda a: a[i], jp["mamba"])
            x = tm.mamba2_block_apply(p64, xin.double(), t64)[0]
            port = tm.mamba2_block_apply(tz._layer(tp, i), xin, tcfg)[0]
            pre64 = tm._block_pre(p64, xin.double(), t64)
            pre32 = tm._block_pre(tz._layer(tp, i), xin, tcfg)
            prej = pre(pj, _np(xin))
            parts = ", ".join(f"{n} {_rel(_np(pre32[k]), pre64[k]):.2g} / "
                              f"{_rel(prej[k], pre64[k]):.2g}"
                              for k, n in ((3, "B"), (4, "C"), (2, "a_log")))
            ins = [t.float() for t in pre64[1:5]]
            y64 = tm._ssd_chunked(*[t.double() for t in ins], t64.ssm.chunk)[0]
            y32 = tm._ssd_chunked(*ins, tcfg.ssm.chunk)[0]
            print(f"mamba layer {i}: port {_rel(_np(port), x):.3g}, reference "
                  f"{_rel(block(pj, _np(xin)), x):.3g} from float64; port / reference: "
                  f"{parts}, the SSD alone {_rel(_np(y32), y64):.2g} / "
                  f"{_rel(ssd(*map(_np, ins)), y64):.2g}")


def _study():
    """What the float32 and bfloat16 tolerances above rest on: each float32
    run's distance to the float64 run of the port, each mamba block's gain
    on a small input error and its tokens' rms before the gated RMSNorm,
    the train step's parameter differences where the gradient is resolved
    and elsewhere, and the bf16 decode's drift from the forward (16 steps
    after a 64-token prompt) in both packages."""
    params, batch = _params(), _batch()
    (ref_loss, ref_g, ref_logits), (loss, grads, logits) = (
        _ref_run(params, batch, "float32"), _port_run(params, batch, "float32"))
    _, truth, t_logits = _port_run(params, batch, "float64")
    print(f"float32 port against reference: loss {abs(loss / ref_loss - 1):.3g} relative, "
          f"logits {_rel(logits, ref_logits):.3g}, a gradient leaf "
          f"<= {max(_rel(grads[n], w) for n, w in ref_g.items()):.3g}")
    print(f"logits from the float64 truth: reference {_rel(ref_logits, t_logits):.3g}, "
          f"port {_rel(logits, t_logits):.3g}")
    dist = {n: (_rel(w, truth[n]), _rel(grads[n], truth[n])) for n, w in ref_g.items()}
    worst = max(dist, key=lambda n: dist[n][1] / dist[n][0])
    print(f"a gradient leaf from the truth: reference <= {max(r for r, _ in dist.values()):.3g}, "
          f"port <= {max(p for _, p in dist.values()):.3g}; the port's largest ratio "
          f"{dist[worst][1] / dist[worst][0]:.3g} ({worst})")
    (b_loss, b_g, b_logits), (loss16, g16, logits16) = (
        _ref_run(params, batch, "bfloat16"), _port_run(params, batch, "bfloat16"))
    ratios = {n: _nrel(g16[n], ref_g[n]) / _nrel(w, ref_g[n]) for n, w in b_g.items()}
    worst = max(ratios, key=ratios.get)
    print(f"bf16: loss {abs(loss16 - b_loss):.3g} from the reference's; the port's distance to "
          f"the float32 reference over the reference's own: logits "
          f"{_nrel(logits16, ref_logits) / _nrel(b_logits, ref_logits):.3g}, a gradient leaf "
          f"<= {ratios[worst]:.3g} ({worst})")
    _, t64 = _cfgs("float64")
    tp = jax.tree.map(lambda t: t.double(), convert.lm_params_from_numpy(params, "cpu"))
    x = tp["embed"][torch.from_numpy(batch["tokens"]).long()]
    gen = torch.Generator().manual_seed(0)
    for gi, (start, length) in enumerate(tz._groups(t64)):
        x = tz._shared_apply(tz._shared(tp, t64, gi), x, tp["embed"][torch.from_numpy(
            batch["tokens"]).long()], t64)[0]
        for i in range(start, start + length):
            p = tz._layer(tp, i)
            z, xh, a_log, bm, cm, _ = tm._block_pre(p, x, t64)
            y, _ = tm._ssd_chunked(xh, a_log, bm, cm, t64.ssm.chunk)
            d = torch.repeat_interleave(p["D"], t64.ssm.head_dim)
            gated = (y.reshape(*x.shape[:2], -1) + d * xh.reshape(*x.shape[:2], -1)) * \
                torch.nn.functional.silu(z)
            rms = gated.pow(2).mean(-1).sqrt()
            dx = torch.randn(x.shape, generator=gen, dtype=x.dtype) * 1e-7 * x.abs().max()
            out = tm.mamba2_block_apply(p, x, t64)[0]
            gain = ((tm.mamba2_block_apply(p, x + dx, t64)[0] - out).abs().max()
                    / out.abs().max()) / (dx.abs().max() / x.abs().max())
            print(f"mamba layer {i}: an input error's gain {float(gain):.3g}, the gated "
                  f"tokens' rms {float(rms.min()):.3g} to {float(rms.max()):.3g}")
            x = out
    _block_distances(params, batch)
    metrics, resolved_diff, all_diff, share, moments, _ = _train_steps()
    print(f"train steps: loss / grad_norm from the reference's {metrics}; params where "
          f"resolved ({share:.3g} of them) {resolved_diff:.3g} learning rates, all "
          f"{all_diff:.3g}; moments {moments:.3g} of their largest")
    for n_layers in (5, 8):
        jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16", n_layers=n_layers)
                      for c in _cfgs())
        rng = np.random.default_rng(0)
        p = jax.tree.map(lambda a: np.asarray(a, np.float32), jz.init_params(
            jax.random.PRNGKey(0), dataclasses.replace(jcfg, dtype="float32")))
        p = jax.tree_util.tree_map_with_path(
            lambda path, a: (a + rng.standard_normal(a.shape).astype(np.float32) * 0.1
                             if a.ndim - (path[0].key == "mamba") == 1 else a
                             ).astype(ml_dtypes.bfloat16), p)
        toks = rng.integers(0, 128, (1, 80)).astype(np.int32)
        jp = jax.tree.map(jnp.asarray, p)
        full = np.asarray(jax.jit(lambda p, t: jz.forward(p, {"tokens": t}, jcfg)[0])(
            jp, toks), np.float32)[0, -1]
        _, cache = jax.jit(lambda p, t: jz.prefill(p, {"tokens": t}, jcfg, max_len=80))(
            jp, toks[:, :64])
        step = jax.jit(lambda p, c, n, t: jz.decode_step(p, c, n, {"tokens": t}, jcfg))
        tp = convert.lm_params_from_numpy(p, "cpu")
        tt = torch.from_numpy(toks)
        with torch.no_grad():
            tfull = tz.forward(tp, {"tokens": tt}, tcfg)[0][0, -1].float()
            _, tcache = tz.prefill(tp, {"tokens": tt[:, :64]}, tcfg, max_len=80)
            for n in range(64, 80):
                lj, cache = step(jp, cache, jnp.int32(n), toks[:, n:n + 1])
                lt, tcache = tz.decode_step(tp, tcache, n, {"tokens": tt[:, n:n + 1]}, tcfg)
        jdrift = np.abs(np.asarray(lj, np.float32)[0] - full).max() / np.abs(full).max()
        tdrift = float((lt[0].float() - tfull).abs().max() / tfull.abs().max())
        print(f"bf16 decode at {n_layers} layers, 16 steps after 64 tokens, from the forward: "
              f"reference {jdrift:.3g}, port {tdrift:.3g} of max |logit|")


if __name__ == "__main__":
    _study()
