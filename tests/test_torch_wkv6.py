"""The port's WKV6 entry point (K7's plain path on the CPU) and its two
plain forms against the reference's.

Inputs are made with numpy from a seed, as the reference's kernel test
draws them (r, k, v ~ N(0, 1), logw = -exp(N(0, 1) - 1), u ~ N(0, 0.3²)),
and go through both packages, the reference compiled with `jax.jit`.
Differences are measured relative to the largest |value| of the
reference's result (max |Δ| / max |y|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import wkv6_ref
from repro.models import rwkv6 as jr
from repro_torch.kernels import wkv6, wkv6_plain
from repro_torch.models import rwkv6 as tr

# sequential against sequential: the per-step sums run in another order;
# measured at most 2.7e-7 over the shapes below
SEQ_REL_TOL = 2e-6
# chunked against chunked: cumsums, exps and einsums in another order;
# measured at most 2.4e-6 on y and 4.1e-6 on the final state
CHUNKED_REL_TOL = 2e-5

_ref = jax.jit(wkv6_ref)
_chunked = jax.jit(jr.wkv6_chunked, static_argnums=5)


def _inputs(b, t, h, p, seed, strong=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, p)).astype(np.float32) for _ in range(3))
    if strong:
        lw = np.full((b, t, h, p), -50.0, np.float32)
    else:
        lw = (-np.exp(rng.standard_normal((b, t, h, p)) - 1)).astype(np.float32)
    u = (rng.standard_normal((h, p)) * 0.3).astype(np.float32)
    return r, k, v, lw, u


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# the reference's kernel shapes (tests/test_kernels.py:211), rwkv6-7b's
# head size P = 64 at a short T, and a longer run
SHAPES = [(1, 8, 1, 4), (3, 24, 2, 8), (2, 16, 4, 16), (2, 32, 2, 64), (1, 100, 2, 16)]


@pytest.mark.parametrize("b,t,h,p", SHAPES)
def test_wkv6_matches_the_reference(b, t, h, p):
    a = _inputs(b, t, h, p, seed=b * t + p)
    got = wkv6(*(torch.from_numpy(x) for x in a))
    assert got.shape == (b, t, h, p) and got.dtype == torch.float32
    assert _rel(got.numpy(), _ref(*a)) <= SEQ_REL_TOL


def test_wkv6_strong_decay():
    """logw = -50: the state forgets all but the last step's k v^T, so
    y_t is r_t . k_{t-1} v_{t-1} plus a vanishing remainder."""
    r, k, v, lw, _ = _inputs(2, 12, 1, 4, seed=3, strong=True)
    u = np.zeros((1, 4), np.float32)
    got = wkv6(*(torch.from_numpy(x) for x in (r, k, v, lw, u))).numpy()
    assert _rel(got, _ref(r, k, v, lw, u)) <= SEQ_REL_TOL
    last = np.zeros_like(got)
    last[:, 1:] = (r[:, 1:] * k[:, :-1]).sum(-1, keepdims=True) * v[:, :-1]
    assert _rel(got, last) <= SEQ_REL_TOL


def test_wkv6_bf16_returns_rs_dtype():
    """bf16 operands are computed with a float32 state, as on the card: the
    result is the float32 reference on the bf16-rounded operands, rounded
    once to bf16 (at most 2^-8 of |y|, bf16's unit roundoff)."""
    a = _inputs(2, 6, 2, 8, seed=5)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in a[:4]]
    got = wkv6(*bf, torch.from_numpy(a[4]))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 6, 2, 8)
    want = np.asarray(_ref(*(x.float().numpy() for x in bf), a[4]))
    assert _rel(got.float().numpy(), want) <= 2.0**-8 + SEQ_REL_TOL


@pytest.mark.parametrize("b,t,h,p", [(3, 24, 2, 8), (2, 32, 2, 64)])
def test_wkv6_plain_is_the_sequential_form(b, t, h, p):
    assert wkv6_plain is tr.wkv6_sequential
    a = _inputs(b, t, h, p, seed=21)
    got = tr.wkv6_sequential(*(torch.from_numpy(x) for x in a))
    assert _rel(got.numpy(), jr.wkv6_sequential(*(jnp.asarray(x) for x in a))) <= SEQ_REL_TOL


def test_wkv6_rejects_other_devices():
    r = torch.zeros((1, 2, 1, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        wkv6(r, r, r, r, torch.zeros((1, 4), device="meta"))


# ---------------- the chunked (training) form ----------------

@pytest.mark.parametrize("chunk", [4, 5, 16, 64], ids=["c4", "c5", "c16", "c64"])
@pytest.mark.parametrize("b,t,h,p,strong", [(3, 24, 2, 8, False), (2, 20, 2, 8, True),
                                            (2, 32, 2, 64, False)],
                         ids=["random", "strong-decay", "p64"])
def test_wkv6_chunked_matches_the_reference(b, t, h, p, strong, chunk):
    """y and the final state against the reference's chunked form, and y
    against the sequential oracle. Chunks that divide L, ones that leave
    a zero-padded tail (5 into 24 and 32, 16 into 24 and 20), and one
    chunk covering all of L (64)."""
    a = _inputs(b, t, h, p, seed=b + t + p, strong=strong)
    jy, js = _chunked(*a, chunk)
    ty, ts = tr.wkv6_chunked(*(torch.from_numpy(x) for x in a), chunk)
    assert ty.shape == (b, t, h, p) and ts.shape == (b, h, p, p)
    assert _rel(ty.numpy(), jy) <= CHUNKED_REL_TOL
    assert _rel(ts.numpy(), js) <= CHUNKED_REL_TOL
    assert _rel(ty.numpy(), _ref(*a)) <= CHUNKED_REL_TOL


def test_wkv6_chunked_final_state_is_the_recurrences():
    """The final state the chunked form returns is the one the direct
    recurrence ends in (computed here step by step in float64)."""
    r, k, v, lw, u = _inputs(1, 13, 1, 4, seed=8)
    s = np.zeros((4, 4))
    for t in range(13):
        s = s * np.exp(lw[0, t, 0].astype(np.float64))[:, None] + np.outer(k[0, t, 0], v[0, t, 0])
    _, ts = tr.wkv6_chunked(*(torch.from_numpy(x) for x in (r, k, v, lw, u)), 5)
    assert _rel(ts[0, 0].numpy(), s) <= CHUNKED_REL_TOL


# ---------------- K7's summation order, rehearsed in numpy ----------------

# K7 against its plain version on the card (chip_smoke.py, the gpu tests)
WKV_REL_TOL = 2e-6


def _fma(a, b, c):
    """float32 fused multiply-add: the product is exact in float64, the
    sum rounds there and then once more to float32 (a double rounding that
    differs from the card's single one only at exact float64 ties)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _pairwise(x):
    """Sum over the last axis as the kernel's xor butterflies do: pairs of
    neighbours, then pairs of pairs (the length a power of two)."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def wkv6_kernel_order(r, k, v, logw, u):
    """K7's arithmetic (`csrc/wkv6.cu`) in numpy float32, P zero-padded to
    64: the bonus factored out, a_t = Σ_p r_p (u_p k_p) as 8 fused chains
    of 8 keys summed pairwise; y's 16 key groups of 4 keys as fused
    chains, summed (g0 + g2) + (g1 + g3) within each quarter of 4 groups
    and (q0 + q1) + (q2 + q3) across quarters; y = fma(a_t, v_t, sum);
    S ← fma(exp(logw), S, k v)."""
    b, t, h, p = r.shape
    pad = [(0, 0)] * 3 + [(0, 64 - p)]
    r, k, v = (np.pad(x, pad) for x in (r, k, v))
    w = np.pad(np.exp(logw), pad)
    u = np.pad(u, [(0, 0), (0, 64 - p)])
    s = np.zeros((b, h, 64, 64), np.float32)  # [key, value]
    ys = np.zeros((b, t, h, 64), np.float32)
    for i in range(t):
        rt, kt, vt, wt = r[:, i], k[:, i], v[:, i], w[:, i]  # (b, h, 64)
        q = (u[None] * kt).reshape(b, h, 8, 8)
        rq = rt.reshape(b, h, 8, 8)
        chains = np.zeros((b, h, 8), np.float32)
        for j in range(8):
            chains = _fma(rq[..., j], q[..., j], chains)
        a = _pairwise(chains)  # (b, h)
        groups = np.zeros((b, h, 16, 64), np.float32)  # key group, value
        sg = s.reshape(b, h, 16, 4, 64)
        rg = rt.reshape(b, h, 16, 4)
        for j in range(4):
            groups = _fma(rg[..., j, None], sg[:, :, :, j], groups)
        g = groups.reshape(b, h, 4, 4, 64)  # quarter, group in quarter, value
        quarters = (g[:, :, :, 0] + g[:, :, :, 2]) + (g[:, :, :, 1] + g[:, :, :, 3])
        total = (quarters[:, :, 0] + quarters[:, :, 1]) + (quarters[:, :, 2] + quarters[:, :, 3])
        ys[:, i] = _fma(a[..., None], vt, total)
        s = _fma(wt[..., :, None], s, kt[..., :, None] * vt[..., None, :])
    return ys[..., :p]


@pytest.mark.parametrize("b,t,h,p,strong", [(1, 8, 1, 4, False), (2, 16, 4, 16, False),
                                            (2, 40, 3, 33, False), (2, 32, 2, 64, False),
                                            (1, 100, 2, 16, False), (2, 12, 1, 4, True),
                                            (2, 20, 2, 64, True)])
def test_kernel_summation_order_is_within_the_kernels_tolerance(b, t, h, p, strong):
    a = _inputs(b, t, h, p, seed=b * t + h + p, strong=strong)
    got = wkv6_kernel_order(*a)
    assert got.dtype == np.float32 and got.shape == (b, t, h, p)
    assert _rel(got, _ref(*a)) <= WKV_REL_TOL
