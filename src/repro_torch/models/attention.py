"""GQA attention: train (full-sequence causal), prefill and decode-step
paths, with qk-norm (Qwen3), the attention logit soft-cap (Gemma-2),
sliding windows (Gemma-2's local layers) and optional flash-style KV
chunking.

PyTorch counterpart of `repro.models.attention`, with the same
arguments, results and dtype sequence: in bfloat16 the scores come out
of a bfloat16 product, are scaled, soft-capped and masked with NEG_INF
in bfloat16, the softmax runs in float32 (`layers.wide`) and is cast
back before the PV product. No fused attention (``scaled_dot_product_
attention``) is used: it carries no soft-cap and rounds elsewhere.
``mesh_ctx`` is accepted and ignored (its ``constrain_heads`` only
places data in the reference); ``head_pad`` is the
reference's layout padding, kept so the arithmetic is the same.

Shapes: q (B, S, H, D); k, v (B, Skv, KV, D) with H % KV == 0.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.layers import apply_rope, dense_init, rms_norm, rope, softcap, wide

__all__ = ["attn_init", "attn_apply", "decode_attn_apply"]

NEG_INF = -2.0**30  # large-negative fill that survives a bfloat16 softmax


def attn_init(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int, head_dim: int,
              qk_norm: bool) -> dict:
    """One attention layer's float32 parameters, drawn from ``gen`` on its
    device."""
    p = {
        "wq": dense_init(gen, (d_model, n_heads, head_dim)),
        "wk": dense_init(gen, (d_model, n_kv, head_dim)),
        "wv": dense_init(gen, (d_model, n_kv, head_dim)),
        "wo": dense_init(gen, (n_heads, head_dim, d_model), fan_in=n_heads * head_dim),
    }
    if qk_norm:
        p["q_norm"] = torch.zeros((head_dim,), dtype=torch.float32, device=gen.device)
        p["k_norm"] = torch.zeros((head_dim,), dtype=torch.float32, device=gen.device)
    return p


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool, window: Optional[int],
          kv_len=None) -> torch.Tensor:
    """Boolean (..., S, Skv) mask of the allowed attention edges: q_pos
    (S,) or (B, S), kv_pos (Skv,), kv_len the valid cache length (an int
    or a 0-d tensor)."""
    qp = q_pos[..., :, None]
    kp = kv_pos[None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, (kv_pos.shape[0],)), dtype=torch.bool,
                   device=kv_pos.device)
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (kp > qp - window)
    if kv_len is not None:
        m = m & (kp < kv_len)
    return m


def _softmax(sc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.softmax(sc.astype(float32)).astype(dtype)``."""
    return torch.softmax(sc.to(wide(sc.dtype)), dim=-1).to(dtype)


def _sdpa(q, k, v, mask, scale, cap, chunk, head_pad=None, mesh_ctx=None):
    """q (B, S, H, D), k / v (B, Skv, KV, D), mask (S, Skv) or (B, S, Skv).

    GQA repeats each KV head over its ``g = H // KV`` query heads
    (``jnp.repeat``: query head h reads KV head h // g). ``head_pad``
    zero-pads the head axis before the products and slices it off after.
    With ``chunk`` set and Skv > chunk, a streaming softmax over KV
    chunks keeps m, l and the accumulator in float32."""
    b, s, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    h_real = h
    if head_pad is not None and head_pad > h:
        def pad_heads(t):
            return torch.cat([t, t.new_zeros(t.shape[:2] + (head_pad - h,) + t.shape[3:])], dim=2)

        q, k, v = pad_heads(q), pad_heads(k), pad_heads(v)
        h = head_pad
    if mask.dim() == 2:
        mask = mask[None]
    mask_b = mask[:, None, :, :]  # (B, 1, S, Skv)

    def block_scores(k_blk, mask_blk):
        sc = torch.einsum("bshd,bthd->bhst", q, k_blk) * scale
        sc = softcap(sc, cap)
        return torch.where(mask_blk, sc, NEG_INF)

    if chunk is None or skv <= chunk:
        w = _softmax(block_scores(k, mask_b), q.dtype)
        return torch.einsum("bhst,bthd->bshd", w, v)[:, :, :h_real]

    f32 = wide(q.dtype)
    n_blk = skv // chunk
    kb = k.reshape(b, n_blk, chunk, h, d)
    vb = v.reshape(b, n_blk, chunk, h, d)
    m_run = torch.full((b, h, s), -math.inf, dtype=f32, device=q.device)
    l_run = torch.zeros((b, h, s), dtype=f32, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=f32, device=q.device)
    for i in range(n_blk):
        sc = block_scores(kb[:, i], mask_b[..., i * chunk:(i + 1) * chunk]).to(f32)
        m_new = torch.maximum(m_run, sc.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(sc - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhst,bthd->bhsd", p.to(q.dtype), vb[:, i]).to(f32)
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.movedim(2, 1).to(q.dtype)[:, :, :h_real]


def _sdpa_grouped(q, k, v, mask, scale, cap):
    """Decode-step attention (S_q == 1): the query heads grouped as
    (KV, g) read each KV head once, no repeat. mask (B, S, Skv)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, d)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k) * scale
    sc = softcap(sc, cap)
    sc = torch.where(mask[:, None, None, :, :], sc, NEG_INF)
    w = _softmax(sc, q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, d)


def _project_qkv(p, x, cfg, positions):
    dt = x.dtype
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"].to(dt))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope(positions, cfg.resolved_head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attn_apply(p, x: torch.Tensor, cfg, window: Optional[int] = None,
               cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, mesh_ctx=None):
    """Training / prefill attention over x (B, S, d). Returns (out,
    (k, v)); the kv pair becomes the prefill cache."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    mask = _mask(positions, positions, True, window, None)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    out = _sdpa(q, k, v, mask, scale, cfg.attn_softcap, cfg.attn_chunk,
                head_pad=cfg.attn_head_pad, mesh_ctx=mesh_ctx)
    out = torch.einsum("bshe,hed->bsd", out, p["wo"].to(x.dtype))
    return out, (k, v)


def decode_attn_apply(p, x: torch.Tensor, cfg, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      cache_len, ring: bool = False):
    """One decode step of x (B, 1, d) against a (B, Smax, KV, D) cache
    holding ``cache_len`` tokens (an int, or a 0-d integer tensor on x's
    device: neither reads a value back to the host, so no layer waits
    for the card). ring=False: insert
    at cache_len and attend the causal prefix (global layers). ring=True:
    the cache is a sliding-window ring of Smax slots; insert at cache_len
    % Smax and attend every valid slot (keys carry absolute RoPE, so slot
    order does not matter). An insert index past the end is clamped to
    Smax - 1, as ``jax.lax.dynamic_update_slice_in_dim`` clamps it.
    Returns (out, k_cache, v_cache), the caches new tensors."""
    s_max = k_cache.shape[1]
    if not torch.is_tensor(cache_len):
        cache_len = torch.full((), cache_len, dtype=torch.int64, device=x.device)
    positions = cache_len.reshape(1)
    ins = torch.clamp(cache_len % s_max if ring else cache_len, 0, s_max - 1)
    ins = ins.reshape(1).to(torch.int64)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    k_cache = torch.index_copy(k_cache, 1, ins, k_new.to(k_cache.dtype))
    v_cache = torch.index_copy(v_cache, 1, ins, v_new.to(v_cache.dtype))
    kv_pos = torch.arange(s_max, device=x.device)
    if ring:
        mask = (kv_pos < torch.clamp(cache_len + 1, max=s_max))[None, None, :]
    else:
        mask = _mask(positions, kv_pos, True, None, cache_len + 1)[None]
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    out = _sdpa_grouped(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                        mask.expand(x.shape[0], 1, s_max), scale, cfg.attn_softcap)
    out = torch.einsum("bshe,hed->bsd", out, p["wo"].to(x.dtype))
    return out, k_cache, v_cache
