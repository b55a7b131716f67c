"""The port's Mamba2 blocks (`repro_torch.models.mamba2`) against the
reference's (`repro.models.mamba2`) on the CPU.

The chunked SSD form (y and the final state) and the sequential oracle
at the chunk shapes of tests/test_ssm_kernels.py and its strong decay;
the chunked form's gradient in every input against ``jax.grad`` (F8:
``jnp.clip``'s 0.5 on a bound, where the diagonal and each chunk's last
row sit, and on a padded tail); the causal conv with and without a
carried state; the block's training path and its decode step in float32
and bfloat16; the block's parameters against ``jax.eval_shape`` of the
reference's init; the zero states on the card by default.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mamba2 as jm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import mamba2 as tm

# float32, port against reference, max |difference| / max |reference|.
# Measured: the block <= 6.1e-7, its decode step <= 4.0e-7, the conv's
# carry 0 (a slice), its output within 8.0e-8.
F32_TOL = 2e-6
# The SSD forms. Measured: the chunked form's y and final state <= 8.5e-7
# / 1.0e-6 over the four shapes, the sequential oracle <= 1.6e-7; under
# strong decay the chunked y 3.5e-6 (differences of cumulative log-decays
# near -1000, summed in another order, keep fewer low bits).
SSD_TOL = 1e-5
# F8: the chunked form's gradients, max |difference| / max |g| of a leaf
# (strong decay: a_log's true gradient vanishes, held to the largest of
# the four). Measured <= 1.4e-6 over the four shapes, 4.0e-6 under strong
# decay (xh).
SSD_GRAD_TOL = 5e-6
# bfloat16: XLA keeps float32 inside its fusions, the port rounds every
# operation to bfloat16; a result no further from the float32 reference
# than BF16_VS_REF_ERROR times the reference's own bfloat16 result
# (norm-relative, at least 2^-9: bfloat16's half ulp). Measured: the
# block's six results 0.71-1.0 times, the conv's 0.90-0.99.
BF16_VS_REF_ERROR = 3.0

# (l, q) of tests/test_ssm_kernels.py: whole chunks, a padded tail (50, 16),
# one chunk longer than the sequence (16, 64)
SHAPES = [(32, 8), (64, 16), (50, 16), (16, 64)]


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def _nrel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _ssd_inputs(l, seed, strong=False, b=2, h=3, p=8, n=5):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, l, h, p)).astype(np.float32)
    scale = 20.0 if strong else 1.0
    a_log = -np.abs(rng.standard_normal((b, l, h)) * scale).astype(np.float32)
    bm = rng.standard_normal((b, l, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, n)).astype(np.float32)
    return xh, a_log, bm, cm


CASES = [(l, q, False) for l, q in SHAPES] + [(64, 16, True)]
CASE_IDS = [f"l{l}-q{q}" for l, q in SHAPES] + ["strong-decay"]


@pytest.mark.parametrize("l,q,strong", CASES, ids=CASE_IDS)
def test_ssd_forms_equal_the_references(l, q, strong):
    a = _ssd_inputs(l, seed=l + q, strong=strong)
    jy, js = jm._ssd_chunked(*map(jnp.asarray, a), q)
    ty, ts = tm._ssd_chunked(*map(torch.from_numpy, a), q)
    assert ty.shape == (2, l, 3, 8) and ts.shape == (2, 3, 5, 8)
    assert _rel(_np(ty), jy) <= SSD_TOL and _rel(_np(ts), js) <= SSD_TOL
    jseq = jm.ssd_sequential(*map(jnp.asarray, a))
    tseq = tm.ssd_sequential(*map(torch.from_numpy, a))
    assert _rel(_np(tseq), jseq) <= SSD_TOL
    # the two forms agree with each other as the reference's own test holds them
    np.testing.assert_allclose(_np(ty), _np(tseq), rtol=2e-4, atol=5e-4)


@pytest.mark.parametrize("l,q,strong", CASES, ids=CASE_IDS)
def test_ssd_chunked_gradient_equals_jax_grad(l, q, strong):
    """F8: the gradients in xh, a_log, B and C of a random cotangent on
    (y, final state) within SSD_GRAD_TOL of max |g| of the leaf."""
    a = _ssd_inputs(l, seed=l + q, strong=strong)
    rng = np.random.default_rng(1)
    gy = rng.standard_normal((2, l, 3, 8)).astype(np.float32)
    gs = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)

    def f(*xs):
        y, s = jm._ssd_chunked(*xs, q)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    want = [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, a))]
    xs = [torch.from_numpy(x).requires_grad_(True) for x in a]
    y, s = tm._ssd_chunked(*xs, q)
    (torch.sum(y * torch.from_numpy(gy)) + torch.sum(s * torch.from_numpy(gs))).backward()
    biggest = max(np.abs(w).max() for w in want)
    for name, x, w in zip(("xh", "a_log", "B", "C"), xs, want):
        scale = biggest if (strong and name == "a_log") else np.abs(w).max()
        assert np.abs(x.grad.numpy() - w).max() <= SSD_GRAD_TOL * scale, name


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jconfigs.get_config("zamba2-7b").reduced(), dtype=dtype),
            dataclasses.replace(tconfigs.get_config("zamba2-7b").reduced(), dtype=dtype))


def _block_params(seed=0):
    """The reference's block init with every leaf perturbed (so the zero
    and one initialised vectors take part), rounded to bfloat16 values,
    as float32 numpy."""
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(seed)
    p = jm.mamba2_block_init(jax.random.PRNGKey(seed), jcfg)
    return {k: (np.asarray(v) + rng.standard_normal(v.shape).astype(np.float32) * 0.1)
            .astype(ml_dtypes.bfloat16).astype(np.float32) for k, v in p.items()}


def _cast(a: np.ndarray, dtype: str) -> np.ndarray:
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_causal_conv_equals_the_references(dtype, carried):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = (rng.standard_normal((4, 12)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(12) * 0.1).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if carried else None
    jargs = [jnp.asarray(_cast(v, dtype)) for v in (x, w, b)]
    targs = [convert.lm_params_from_numpy(_cast(v, dtype), "cpu") for v in (x, w, b)]
    jy, js = jm._causal_conv(*jargs, None if st is None else jnp.asarray(_cast(st, dtype)))
    ty, ts = tm._causal_conv(*targs, None if st is None else
                             convert.lm_params_from_numpy(_cast(st, dtype), "cpu"))
    assert ty.dtype == targs[0].dtype and ts.dtype == ty.dtype
    np.testing.assert_array_equal(_np(ts), np.asarray(js, np.float32))
    if dtype == "float32":
        assert _rel(_np(ty), jy) <= F32_TOL
    else:
        truth = np.asarray(jm._causal_conv(*(jnp.asarray(np.asarray(a, np.float32))
                                             for a in jargs),
                                           None if st is None else jnp.asarray(
                                               _cast(st, dtype).astype(np.float32)))[0])
        assert _nrel(_np(ty), truth) <= BF16_VS_REF_ERROR * max(
            _nrel(np.asarray(jy, np.float32), truth), 2.0**-9)


def _block_run(mod, params, x, cfg, conv=None, ssd=None):
    """(apply's output and states, a decode step's output and states from
    the states ``conv`` / ``ssd``) of ``mod``'s block; the reference's
    jitted."""
    def run(params, x, conv, ssd):
        out, (c, s) = mod.mamba2_block_apply(params, x, cfg)
        dec, (c2, s2) = mod.mamba2_block_decode(params, x[:, :1], cfg, conv, ssd)
        return [out, c, s, dec, c2, s2]

    return (jax.jit(run) if mod is jm else run)(params, x, conv, ssd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_apply_and_decode_equal_the_references(dtype):
    """The training / prefill path (output, conv carry, SSD state) and one
    decode step from nonzero carried states, at the reduced zamba2's
    widths (d 64, 8 heads of 16, state 16, chunk 16) over 40 tokens (a
    padded chunk)."""
    jcfg, tcfg = _cfgs(dtype)
    params = _block_params()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    conv = (rng.standard_normal((2, 3, 128)) * 0.5).astype(np.float32)
    ssd = (rng.standard_normal((2, 8, 16, 16)) * 0.5).astype(np.float32)
    np_in = [_cast(v, dtype) for v in (x, conv, ssd)]
    jp = {k: jnp.asarray(_cast(v, dtype)) for k, v in params.items()}
    tp = convert.lm_params_from_numpy({k: _cast(v, dtype) for k, v in params.items()}, "cpu")
    want = _block_run(jm, jp, *map(jnp.asarray, np_in[:1]), jcfg, *map(jnp.asarray, np_in[1:]))
    t_in = [convert.lm_params_from_numpy(v, "cpu") for v in np_in]
    got = _block_run(tm, tp, t_in[0], tcfg, *t_in[1:])
    names = ["out", "conv", "ssd", "decode out", "decode conv", "decode ssd"]
    for name, g, w in zip(names, got, want):
        assert g.dtype == tcfg.activation_dtype and tuple(g.shape) == w.shape, name
    if dtype == "float32":
        for name, g, w in zip(names, got, want):
            assert _rel(_np(g), w) <= F32_TOL, name
        return
    f32, _ = _cfgs()
    truth = _block_run(jm, jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp),
                       *(jnp.asarray(np.asarray(v, np.float32)) for v in np_in[:1]), f32,
                       *(jnp.asarray(np.asarray(v, np.float32)) for v in np_in[1:]))
    for name, g, w, t in zip(names, got, want, truth):
        ref_err = _nrel(np.asarray(w, np.float32), t)
        assert _nrel(_np(g), t) <= BF16_VS_REF_ERROR * max(ref_err, 2.0**-9), name


def test_block_init_layout():
    """The reference's block tree (names, shapes), float32, the vectors
    at their initial constants, drawn from the generator."""
    jcfg, tcfg = _cfgs()
    p = tm.mamba2_block_init(torch.Generator().manual_seed(0), tcfg)
    shapes = jax.eval_shape(lambda k: jm.mamba2_block_init(k, jcfg), jax.random.PRNGKey(0))
    assert sorted(p) == sorted(shapes)
    assert {k: tuple(t.shape) for k, t in p.items()} == {k: s.shape for k, s in shapes.items()}
    assert all(t.dtype == torch.float32 for t in p.values())
    for name in ("ln", "dt_bias", "A_log", "conv_b", "gn"):
        assert not torch.any(p[name]), name
    assert torch.equal(p["D"], torch.ones(8))
    again = tm.mamba2_block_init(torch.Generator().manual_seed(0), tcfg)
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_init_states_default_to_the_card(monkeypatch):
    from repro_torch.kernels import build

    _, cfg = _cfgs("bfloat16")
    assert tm.init_conv_state(cfg, 2, device="cpu").shape == (2, 3, 128)
    ssd = tm.init_ssd_state(cfg, 2, device="cpu")
    assert ssd.shape == (2, 8, 16, 16) and ssd.dtype == torch.bfloat16 and not torch.any(ssd)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tm.init_conv_state, tm.init_ssd_state):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(cfg, 1)
    monkeypatch.setattr(build, "resolve_device", lambda d=None: torch.device("meta"))
    assert tm.init_conv_state(cfg, 1).device.type == "meta"
    assert tm.init_ssd_state(cfg, 1).device.type == "meta"
