"""The port's attention (`repro_torch.models.attention`) against the
reference's (`repro.models.attention`) on the CPU.

The oracles of `tests/test_attention.py` (a dense per-head numpy
attention, the sliding-window mask, flash chunking against the dense
form, the grouped decode form against the repeat path, qk-norm's bound)
held on the port, and every function against the reference's on the
same inputs: `_mask` array-equal; `_sdpa` dense and chunked, with and
without the soft-cap and head padding, at GQA groups 1, 2 and 4;
`_sdpa_grouped`; `attn_apply` with its (k, v); `decode_attn_apply` on a
global cache, a ring before and after it wraps, and an insert index
clamped past the end, with ``cache_len`` as an int and as a tensor.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as ja
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import attention as ta

# float32, port against reference, max |difference| / max |reference|:
# measured <= 6e-7 (einsum contractions in another order)
F32_TOL = 2e-6
# bfloat16: both round every einsum's output to bfloat16 and may differ
# by an ulp there (2^-8 relative); measured <= 4e-3 of max |out|
BF16_TOL = 2e-2
# the dense numpy oracle of tests/test_attention.py
ORACLE_ATOL = 2e-5


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jnp array and a tensor, rounded to ``dtype``."""
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
        return jnp.asarray(a), torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _qkv(rng, b=2, s=32, h=8, kv=2, d=16):
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def _oracle(q, k, v, mask, scale, cap=None):
    """Dense attention, each query head h reading KV head h // g."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    out = np.zeros((b, s, h, d), np.float32)
    mk = np.asarray(mask)
    for hh in range(h):
        sc = np.einsum("bsd,btd->bst", q[:, :, hh], k[:, :, hh // g]) * scale
        if cap:
            sc = cap * np.tanh(sc / cap)
        sc = np.where(mk if mk.ndim == 3 else mk[None], sc, -1e30)
        w = np.exp(sc - sc.max(-1, keepdims=True))
        out[:, :, hh] = np.einsum("bst,btd->bsd", w / w.sum(-1, keepdims=True), v[:, :, hh // g])
    return out


def test_mask_equals_the_references():
    """Causal, windowed and length-limited masks, (S,) and (B, S) query
    positions, the length as an int and as a 0-d tensor; position 5 with
    a window of 3 attends 3, 4, 5 only."""
    m = ta._mask(torch.arange(8), torch.arange(8), True, 3, None)
    assert torch.nonzero(m[5]).flatten().tolist() == [3, 4, 5]
    qpos = np.array([[3, 7, 9], [0, 1, 2]], np.int32)
    for q_pos in (np.arange(12, dtype=np.int32), qpos):
        for causal, window, kv_len in ((True, None, None), (True, 4, None), (False, None, 7),
                                       (True, 5, 10), (False, 2, None)):
            want = np.asarray(ja._mask(jnp.asarray(q_pos), jnp.arange(12), causal, window,
                                       None if kv_len is None else jnp.int32(kv_len)))
            for length in (kv_len, None if kv_len is None else torch.tensor(kv_len)):
                got = ta._mask(torch.from_numpy(q_pos), torch.arange(12), causal, window, length)
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("g,cap,chunk,head_pad", [(1, None, None, None), (2, 30.0, 16, None),
                                                  (4, 30.0, None, 12), (2, None, 16, 12),
                                                  (4, None, 16, None), (1, 30.0, 16, 12)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_equals_the_references(g, cap, chunk, head_pad, dtype):
    """Dense and chunked, soft-capped, head-padded, GQA groups 1 / 2 / 4,
    windowed causal mask over 64 positions; float32 also against the
    dense numpy oracle."""
    rng = np.random.default_rng(10 * g + (chunk or 0))
    q, k, v = _qkv(rng, s=64, h=8, kv=8 // g)
    mask = np.asarray(ja._mask(jnp.arange(64), jnp.arange(64), True, 40, None))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = ja._sdpa(jq, jk, jv, jnp.asarray(mask), 0.25, cap, chunk, head_pad=head_pad)
    got = ta._sdpa(tq, tk, tv, torch.from_numpy(mask.copy()), 0.25, cap, chunk, head_pad=head_pad)
    assert got.dtype == tq.dtype and tuple(got.shape) == want.shape == q.shape
    assert _rel(_np(got), want) <= (F32_TOL if dtype == "float32" else BF16_TOL)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _oracle(q, k, v, mask, 0.25, cap), atol=ORACLE_ATOL)


def test_flash_chunking_matches_vanilla():
    """The reference's own oracle on the port: chunks of 16 against the
    dense form, and per-batch (B, S, Skv) masks."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(0), s=64))
    mask = ta._mask(torch.arange(64), torch.arange(64), True, None, None)
    full = ta._sdpa(q, k, v, mask, 0.25, None, None)
    np.testing.assert_allclose(ta._sdpa(q, k, v, mask, 0.25, None, 16).numpy(), full.numpy(),
                               atol=3e-5)
    per_batch = torch.stack([mask, mask & ta._mask(torch.arange(64), torch.arange(64), True, 9,
                                                   None)])
    want = ja._sdpa(*(jnp.asarray(t.numpy()) for t in (q, k, v)), jnp.asarray(per_batch.numpy()),
                    0.25, None, 16)
    assert _rel(ta._sdpa(q, k, v, per_batch, 0.25, None, 16).numpy(), want) <= F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_grouped_equals_the_references(dtype):
    """The grouped decode form against the reference's, and (float32)
    against the port's own repeat path."""
    rng = np.random.default_rng(4)
    b, h, kv, d, s_cache = 2, 8, 2, 16, 24
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s_cache, kv, d)).astype(np.float32) for _ in range(2))
    mask = np.ones((b, 1, s_cache), bool)
    mask[1, 0, 17:] = False
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    for cap in (None, 5.0):
        got = ta._sdpa_grouped(tq, tk, tv, torch.from_numpy(mask), 0.25, cap)
        want = ja._sdpa_grouped(jq, jk, jv, jnp.asarray(mask), 0.25, cap)
        assert _rel(_np(got), want) <= (F32_TOL if dtype == "float32" else BF16_TOL)
    if dtype == "float32":
        ones = torch.ones((b, 1, s_cache), dtype=torch.bool)
        np.testing.assert_allclose(ta._sdpa_grouped(tq, tk, tv, ones, 0.25, None).numpy(),
                                   ta._sdpa(tq, tk, tv, torch.ones((1, s_cache), dtype=torch.bool),
                                            0.25, None, None).numpy(), atol=2e-5)


def _configs(dtype="float32", **kw):
    jcfg = dataclasses.replace(jconfigs.get_config("qwen3-4b").reduced(), dtype=dtype, **kw)
    tcfg = dataclasses.replace(tconfigs.get_config("qwen3-4b").reduced(), dtype=dtype, **kw)
    return jcfg, tcfg


def _attn_params(cfg, seed=0):
    """Attention parameters of the reference's tree (shapes from
    ``jax.eval_shape`` of its `attn_init`) drawn with numpy, every leaf
    nonzero (so the q / k norms take part), float32."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: ja.attn_init(k, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                                   cfg.resolved_head_dim, cfg.qk_norm),
                            jax.random.PRNGKey(0))
    return {k: (rng.standard_normal(s.shape) / math.sqrt(s.shape[0] if k != "wo" else
                                                         s.shape[0] * s.shape[1])
                if k.startswith("w") else rng.standard_normal(s.shape) * 0.1).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("window,qk_norm,head_pad", [(None, True, None), (5, True, None),
                                                    (None, False, 8), (5, False, None)])
def test_attn_apply_equals_the_references(window, qk_norm, head_pad):
    """The projections, qk-norm, RoPE, the windowed causal attention and
    the output product, with the (k, v) the prefill cache keeps; the
    reference's qk-norm bound on the key norms."""
    jcfg, tcfg = _configs(qk_norm=qk_norm, attn_head_pad=head_pad)
    p = _attn_params(jcfg)
    x = np.random.default_rng(1).standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    want, (wk, wv) = ja.attn_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
                                   window=window)
    got, (k, v) = ta.attn_apply(convert.lm_params_from_numpy(p, "cpu"), torch.from_numpy(x),
                                tcfg, window=window)
    for a, b in ((got, want), (k, wk), (v, wv)):
        assert _rel(a.numpy(), b) <= F32_TOL
    if qk_norm:
        assert float(k.norm(dim=-1).max()) < 3 * math.sqrt(tcfg.resolved_head_dim)


def _decode_pair(tcfg, jcfg, p, x, kc, vc, cache_len, ring):
    want = ja.decode_attn_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
                                jnp.asarray(kc), jnp.asarray(vc), jnp.int32(cache_len), ring=ring)
    tp = convert.lm_params_from_numpy(p, "cpu")
    for length in (cache_len, torch.tensor(cache_len, dtype=torch.int32)):
        got = ta.decode_attn_apply(tp, torch.from_numpy(x), tcfg, torch.from_numpy(kc),
                                   torch.from_numpy(vc), length, ring=ring)
        assert _rel(got[0].numpy(), want[0]) <= F32_TOL
        # the caches equal but for the new key / value (projected, normed
        # and rotated in float32)
        for a, b in ((got[1], want[1]), (got[2], want[2])):
            assert _rel(a.numpy(), b) <= F32_TOL
            same = np.all(a.numpy() == np.asarray(b), axis=(0, 2, 3))
            assert np.count_nonzero(~same) <= 1
    return got


@pytest.mark.parametrize("case", ["global", "ring-before-wrap", "ring-after-wrap",
                                  "clamped"])
def test_decode_attn_apply_equals_the_references(case):
    """A (2, 16)-slot cache: a global cache at length 9; a ring at 9
    (before it wraps) and at 37 (insert at 37 % 16 = 5, every slot
    valid); a global cache at 16 and 23, past its end, where the insert
    clamps to the last slot. The caches handed in are not changed."""
    jcfg, tcfg = _configs()
    p = _attn_params(jcfg, seed=3)
    rng = np.random.default_rng(5)
    s_max = 16
    kc, vc = (rng.standard_normal((2, s_max, tcfg.n_kv_heads, tcfg.resolved_head_dim))
              .astype(np.float32) for _ in range(2))
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    lengths, ring = {"global": ([9], False), "ring-before-wrap": ([9], True),
                     "ring-after-wrap": ([37], True), "clamped": ([16, 23], False)}[case]
    for cache_len in lengths:
        k0 = kc.copy()
        _, k_new, _ = _decode_pair(tcfg, jcfg, p, x, kc, vc, cache_len, ring)
        np.testing.assert_array_equal(kc, k0)
        slot = cache_len % s_max if ring else min(cache_len, s_max - 1)
        changed = np.flatnonzero(np.any(k_new.numpy() != kc, axis=(0, 2, 3)))
        assert changed.tolist() == [slot]
