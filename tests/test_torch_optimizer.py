"""The port's AdamW and schedules against `repro.training.optimizer`.

Every step starts both packages from the same numpy params, gradients and
optimizer state, and runs the reference op by op (eagerly: under ``jit``
XLA fuses the update and rounds differently from either). Where the
gradient clip does not engage, the moments, int8 moment codes included,
are array-equal; the params too, at every step whose float32 bias
corrections agree (XLA's ``pow`` and torch's may differ by an ulp: they
do at 160 of the first 20 000 integer powers of 0.9; all 40 steps here
agree). Where the clip engages, the global norm is summed in another
order, so everything is held to a tolerance.
"""

import ml_dtypes
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.training import optimizer as jo
from repro_torch import convert
from repro_torch.training import optimizer as to
from repro_torch.training.checkpoint import _flatten_with_names

STEPS = 40
# the clip engaged: the global norm's sum order moves clip by an ulp, and
# with it every update; measured over 40 steps, relative to each leaf's
# largest entry: params 8.7e-8, moments 3.3e-7, int8 codes equal
CLIP_RTOL = 1e-6
# cosine_schedule: jnp.cos and torch.cos of the same float32 argument,
# relative to base_lr; measured 1.2e-7
COSINE_TOL = 5e-7


def _params(rng, dtype):
    tree = {
        "gru": [{"w_i": rng.standard_normal((16, 144)), "w_h": rng.standard_normal((48, 144)),
                 "b_i": rng.standard_normal(144)}],
        "fc": {"w": rng.standard_normal((48, 12)), "b": rng.standard_normal(12)},
        "big": rng.standard_normal((64, 128)),
    }
    return jax.tree.map(lambda a: (a * 0.1).astype(dtype), tree)


def _to_torch(tree):
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    return jax.tree.map(leaf, tree)


def _to_numpy(x):
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def _pairs(port, ref):
    p = _flatten_with_names(port)
    r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(p) == len(r)
    return [(n, _to_numpy(x), np.asarray(y)) for (n, x), (_, y) in zip(p, r)]


def _bias_corrections_agree(step):
    s = np.float32(step)
    ref = [np.asarray(1.0 - b ** jnp.asarray(s)) for b in (0.9, 0.999)]
    port = [(1.0 - b ** torch.tensor(s)).numpy() for b in (0.9, 0.999)]
    return all(np.array_equal(a, b) for a, b in zip(ref, port))


@pytest.mark.parametrize("pdtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("clip", [False, True], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_update_equals_reference(state_dtype, clip, pdtype):
    rng = np.random.default_rng(0)
    jcfg = jo.AdamWConfig(state_dtype=state_dtype)
    tcfg = to.AdamWConfig(state_dtype=state_dtype)
    params = _params(rng, pdtype)
    tp = _to_torch(params)
    ts = to.init_opt_state(tp, tcfg)
    saw_exact = 0
    for step in range(1, STEPS + 1):
        # gradients of norm ~0.1 (clip 1 not engaged) or ~40 (engaged)
        g = _params(rng, np.float32)
        if not clip:
            g = jax.tree.map(lambda a: a * np.float32(1e-3), g)
        lr = 1e-3 * 0.8 ** (step // 10)
        jp = jax.tree.map(jnp.asarray, jax.tree.map(_to_numpy, tp))
        js = jax.tree.map(lambda x: jnp.asarray(x.numpy()), ts)
        ref_p, ref_s, ref_m = jo.adamw_update(jp, jax.tree.map(jnp.asarray, g), js, jcfg, lr)
        tp, ts, tm = to.adamw_update(tp, _to_torch(g), ts, tcfg, lr)
        engaged = float(ref_m["grad_norm"]) > 1.0
        assert engaged == clip
        np.testing.assert_allclose(float(tm["grad_norm"]), float(ref_m["grad_norm"]), rtol=1e-6)
        assert int(ts["step"]) == int(np.asarray(ref_s["step"])) == step
        if not clip:
            for name, a, r in _pairs(ts, ref_s):
                np.testing.assert_array_equal(a, r, err_msg=name)
            exact = _bias_corrections_agree(step)
            saw_exact += exact
            for name, a, r in _pairs(tp, ref_p):
                assert a.dtype == r.dtype, name
                if exact:
                    np.testing.assert_array_equal(a, r, err_msg=f"{name} at step {step}")
                else:
                    np.testing.assert_allclose(a.astype(np.float32), r.astype(np.float32),
                                               rtol=1e-6, atol=1e-9, err_msg=name)
            continue
        for name, a, r in _pairs(ts, ref_s):
            if a.dtype == np.int8:
                assert np.abs(a.astype(int) - r.astype(int)).max() <= 1, name
            else:
                np.testing.assert_allclose(a, r, rtol=0, atol=CLIP_RTOL * np.abs(r).max(),
                                           err_msg=name)
        for name, a, r in _pairs(tp, ref_p):
            a, r = a.astype(np.float32), r.astype(np.float32)
            # a bf16 param may round to the neighbouring bf16 value
            ulp = 2.0**-7 if pdtype is not np.float32 else CLIP_RTOL
            np.testing.assert_allclose(a, r, rtol=ulp, atol=1e-9, err_msg=name)
    if not clip:
        assert saw_exact >= STEPS // 2


def test_int8_moments_only_for_big_leaves_in_the_references_tree():
    rng = np.random.default_rng(1)
    params = _params(rng, np.float32)
    for state_dtype in ("float32", "int8"):
        ref = jo.init_opt_state(jax.tree.map(jnp.asarray, params), jo.AdamWConfig(state_dtype=state_dtype))
        port = to.init_opt_state(_to_torch(params), to.AdamWConfig(state_dtype=state_dtype))
        for name, a, r in _pairs(port, ref):
            assert a.dtype == r.dtype and a.shape == r.shape and not a.any(), name
    assert isinstance(port["m"]["gru"][0]["w_h"], dict)  # 48 x 144 = 6912 elements
    assert not isinstance(port["m"]["gru"][0]["w_i"], dict)  # 16 x 144 = 2304
    assert port["step"].dtype == torch.int32 and port["step"].shape == ()


def test_opt_state_crosses_from_numpy():
    rng = np.random.default_rng(2)
    params = jax.tree.map(jnp.asarray, _params(rng, np.float32))
    cfg = jo.AdamWConfig(state_dtype="int8")
    g = jax.tree.map(lambda a: a * 0.01, params)
    _, state, _ = jo.adamw_update(params, g, jo.init_opt_state(params, cfg), cfg)
    port = convert.opt_state_from_numpy(jax.tree.map(np.asarray, state), "cpu")
    for name, a, r in _pairs(port, state):
        np.testing.assert_array_equal(a, r, err_msg=name)
        assert a.dtype == r.dtype
    bad = jax.tree.map(np.asarray, state)
    bad["step"] = np.int64(3)
    with pytest.raises(ValueError, match="int32"):
        convert.opt_state_from_numpy(bad, "cpu")
    bad = jax.tree.map(np.asarray, state)
    bad["m"]["fc"]["b"] = bad["m"]["fc"]["b"].astype(np.float64)
    with pytest.raises(ValueError, match="float32"):
        convert.opt_state_from_numpy(bad, "cpu")


@pytest.mark.parametrize("args", [(1e-3, 100, 1000), (3e-4, 0, 500), (1.0, 7, 7)])
def test_cosine_schedule(args):
    steps = np.arange(0, args[2] + 50)
    ref = np.asarray(jo.cosine_schedule(*args)(jnp.asarray(steps)))
    port = to.cosine_schedule(*args)(torch.from_numpy(steps)).numpy()
    assert port.dtype == np.float32
    assert np.abs(port - ref).max() <= COSINE_TOL * args[0]
    assert float(to.cosine_schedule(*args)(0)) == float(ref[0])


@pytest.mark.parametrize("seed", range(3))
def test_reduce_lr_on_plateau_sequences_equal(seed):
    rng = np.random.default_rng(seed)
    metrics = np.cumsum(rng.normal(-0.01, 0.05, 300)) + 3.0
    metrics[100:140] = metrics[100]  # a plateau: exact repeats
    ref = jo.ReduceLROnPlateau(1e-3, 0.8, 3, 5e-4)
    port = to.ReduceLROnPlateau(1e-3, 0.8, 3, 5e-4)
    lrs = [(port.step(float(m)), ref.step(float(m))) for m in metrics]
    assert [a for a, _ in lrs] == [b for _, b in lrs]
    assert min(a for a, _ in lrs) == 5e-4  # reached the floor
    assert vars(port) == vars(ref)


def test_fp32_and_int8_states_converge_similarly():
    """The port's counterpart of the reference's quadratic: both moment
    formats minimize it and the int8 one tracks float32."""
    target = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 512)).astype(np.float32))

    def losses(cfg):
        params = {"w": torch.zeros((16, 512))}
        state = to.init_opt_state(params, cfg)
        out = []
        for _ in range(60):
            w = params["w"].requires_grad_(True)
            loss = torch.mean((w - target) ** 2)
            (g,) = torch.autograd.grad(loss, [w])
            params, state, _ = to.adamw_update({"w": w}, {"w": g}, state, cfg)
            out.append(float(loss.detach()))
        return out

    fp = losses(to.AdamWConfig(lr=0.05, weight_decay=0.0))
    q8 = losses(to.AdamWConfig(lr=0.05, weight_decay=0.0, state_dtype="int8"))
    assert fp[-1] < 0.3 * fp[0] and q8[-1] < 0.3 * q8[0]
    assert abs(q8[-1] - fp[-1]) < 0.2 * fp[0]
