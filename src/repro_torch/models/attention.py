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

**On the grid** (`attn_grid`, `decode_attn_grid`; shares as in
`models.layers`): q / k / v column-parallel with the heads over "model"
where the spec keeps the axis, ``attn_head_pad`` applied before the
heads are split (model coordinate j runs padded heads [j * Hp / m, (j +
1) * Hp / m), as the reference's ``constrain_heads`` pins them); k and v
whose heads do not split (GQA's 8 kv heads on 16 shards) are computed
whole and each local q head reads its own kv group; ``wo`` row-parallel
and a psum over "model". Decode is flash-decoding over a cache whose
sequence is split (`distributed.sharding.cache_specs`): each coordinate
projects its share of the new token's k and v (its piece, or its slice
of the KV * D columns where the kv heads do not split) and gathers them,
every head's scores over the local slice, a pmax and a psum of the
exponentials over the sequence axes, the weighted values psum'd over
them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.distributed.collectives import all_gather, axis_index, pmax, psum
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    gather_param,
    rms_norm,
    rope,
    softcap,
    splits_on,
    wide,
)

__all__ = ["attn_init", "attn_apply", "decode_attn_apply", "attn_grid", "decode_attn_grid"]

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


def _project(x, w, cfg, positions, norm=None, rotate: bool = True):
    """x (B, S, d) times a (d, heads, D) weight; q and k (``rotate``)
    normed by ``norm`` (with qk-norm) and rotated, v as it is."""
    t = torch.einsum("bsd,dhe->bshe", x, w.to(x.dtype))
    return _rotate(t, cfg, positions, norm) if rotate else t


def _rotate(t, cfg, positions, norm=None):
    """q or k (B, S, heads, D) normed by ``norm`` (with qk-norm) and rotated."""
    if cfg.qk_norm:
        t = rms_norm(t, norm, cfg.norm_eps)
    cos, sin = rope(positions, cfg.resolved_head_dim, cfg.rope_theta)
    return apply_rope(t, cos, sin)


def _project_qkv(p, x, cfg, positions):
    return (_project(x, p["wq"], cfg, positions, p.get("q_norm")),
            _project(x, p["wk"], cfg, positions, p.get("k_norm")),
            _project(x, p["wv"], cfg, positions, rotate=False))


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


# --------------------------------------------------------------------------
# the sharded step: one entry a grid coordinate of mc.coords
# --------------------------------------------------------------------------

def _local_heads(cfg, mc, coord):
    """(split, n_slots, real): whether the heads are split over "model",
    the padded heads a coordinate runs, and the real ones among them."""
    h = cfg.n_heads
    hp = cfg.attn_head_pad if cfg.attn_head_pad and cfg.attn_head_pad > h else h
    m = mc.model_size
    if m > 1 and hp % m == 0:
        per = hp // m
        j = axis_index(mc.mesh, coord, mc.model_axis)
        return True, per, range(min(j * per, h), min((j + 1) * per, h))
    return False, hp, range(h)


def _model_index(mc, coord) -> int:
    return axis_index(mc.mesh, coord, mc.model_axis) if mc.model_axis else 0


def _within(want: range, start: int, n: int) -> bool:
    return not len(want) or (start <= want.start and want.stop <= start + n)


def _pick(projects: list, ws: list, spec, wants: list, n_full: int, mc) -> Tuple[list, list]:
    """Each coordinate's activations (B, S, heads, D) of the heads
    ``wants[i]`` (a range), ``projects[i](w)`` its product with a (d,
    heads, D) weight. A weight whose heads are split over "model" is
    multiplied piece by piece, and the activations all-gathered over
    "model" where some coordinate wants heads its piece lacks; a weight
    replicated over "model" is cut to the wanted heads first. Returns (the
    activations, the first head each holds)."""
    if splits_on(spec, 1, mc.model_axis):
        n_loc = n_full // mc.model_size
        starts = [_model_index(mc, c) * n_loc for c in mc.coords]
        ts = [project(w) for project, w in zip(projects, ws)]
        if all(_within(want, st, n_loc) for want, st in zip(wants, starts)):
            return ts, starts
        ts = all_gather(ts, mc.model_axis, mc, 2)
        return [t.narrow(2, want.start, len(want)) for t, want in zip(ts, wants)], \
            [want.start for want in wants]
    return [project(w.narrow(1, want.start, len(want)))
            for project, w, want in zip(projects, ws, wants)], [want.start for want in wants]


def attn_grid(ps: list, specs, xs: list, cfg, window=None, mc=None, full_kv: bool = False):
    """`attn_apply` on a share: returns (the attention outputs, psum'd
    over "model" where a coordinate's output is a partial sum over heads;
    a coordinate's (k, v) for the prefill cache: every kv head with
    ``full_kv``, else those its q heads read, or its piece's where the kv
    heads are split over "model").

    Coordinate j runs the padded heads of `_local_heads`; its real ones,
    R_j, are projected in the layout of wq's spec and moved into that one
    by an all-gather of the activations where the two differ (the
    reference's reshard), as are the kv heads its q heads read; the
    outputs go back to wo's layout the same way before the row-parallel
    product."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    g = h // kv
    hd = cfg.resolved_head_dim
    w = {k: gather_param([p[k] for p in ps], specs[k], mc) for k in ("wq", "wk", "wv", "wo")}
    layout = [_local_heads(cfg, mc, c) for c in mc.coords]
    real = [r for _, _, r in layout]
    need_kv = [range(r.start // g, (r.stop - 1) // g + 1) if len(r) else range(0) for r in real]
    if full_kv:
        need_kv = [range(kv)] * len(xs)
    positions = [torch.arange(x.shape[1], device=x.device) for x in xs]

    def projectors(norm):
        """Each coordinate's `_project` by a (d, heads, D) weight: q and k
        (``norm`` their qk-norm scale's name) normed and rotated, v as it is."""
        rotate = norm is not None
        return [lambda wt, x=x, pos=pos, p=p: _project(x, wt, cfg, pos, p.get(norm), rotate)
                for x, pos, p in zip(xs, positions, ps)]

    qs, _ = _pick(projectors("q_norm"), w["wq"], specs["wq"], real, h, mc)
    ks, k0 = _pick(projectors("k_norm"), w["wk"], specs["wk"], need_kv, kv, mc)
    vs, _ = _pick(projectors(None), w["wv"], specs["wv"], need_kv, kv, mc)
    scale = 1.0 / math.sqrt(hd)
    outs, kvs = [], []
    for i, x in enumerate(xs):
        split, n_slots, r = layout[i]
        q, k, v = qs[i], ks[i], vs[i]
        # each local q head's own kv head
        idx = torch.tensor([hh // g - k0[i] for hh in r], dtype=torch.int64, device=x.device)
        k_h, v_h = k.index_select(2, idx), v.index_select(2, idx)
        pad = n_slots - len(r)
        if pad:
            def pad_heads(t):
                return torch.cat([t, t.new_zeros(t.shape[:2] + (pad,) + t.shape[3:])], dim=2)

            q, k_h, v_h = pad_heads(q), pad_heads(k_h), pad_heads(v_h)
        mask = _mask(positions[i], positions[i], True, window, None)
        # the padded heads' outputs (zero), real heads first
        outs.append(_sdpa(q, k_h, v_h, mask, scale, cfg.attn_softcap, cfg.attn_chunk))
        kvs.append((k, v))
    outs, partial = _out_proj(outs, real, w["wo"], specs["wo"], cfg, mc)
    if partial or layout[0][0]:
        outs = psum(outs, mc.model_axis, mc)
    return outs, kvs


def _out_proj(outs: list, real: list, wo: list, spec, cfg, mc) -> Tuple[list, bool]:
    """The row-parallel output product of each coordinate's attention
    outputs ``outs`` (B, S, slots, D), its real heads ``real[i]`` first
    and zero padding after: where wo's heads are split over "model", the
    outputs in wo's layout (where a coordinate lacks heads of its piece,
    the padded outputs all-gathered over "model", in which head h is at
    h); else wo cut to the real heads. Returns (the products, whether
    wo's split makes them partial sums)."""
    h = cfg.n_heads
    if splits_on(spec, 0, mc.model_axis):
        n_loc = h // mc.model_size
        starts = [_model_index(mc, c) * n_loc for c in mc.coords]
        if all(_within(range(st, st + n_loc), r.start, len(r)) for st, r in zip(starts, real)):
            outs = [o.narrow(2, st - r.start, n_loc) for o, st, r in zip(outs, starts, real)]
        else:
            outs = [o.narrow(2, st, n_loc)
                    for o, st in zip(all_gather(outs, mc.model_axis, mc, 2), starts)]
        return [torch.einsum("bshe,hed->bsd", o, w_.to(o.dtype)) for o, w_ in zip(outs, wo)], True
    return [torch.einsum("bshe,hed->bsd", o[:, :, :len(r)], w_.narrow(0, r.start, len(r))
                         .to(o.dtype)) for o, w_, r in zip(outs, wo, real)], False


def _decode_kv(ps, xs, ws, spec, cfg, mc, positions, norm=None, rotate=True) -> list:
    """The new token's k (``rotate``, ``norm`` its qk-norm scale's name) or
    v of every kv head on each coordinate, each coordinate projecting only
    its share: its piece of a weight whose kv heads are split over
    "model", then an all-gather; where they do not split, its slice of the
    kv heads' KV * D columns (the reference's partition of the product),
    all-gathered over "model" before the qk-norm and the rotation, which
    read whole heads. Every column on every coordinate where "model" does
    not divide them."""
    kv, hd, m = cfg.n_kv_heads, cfg.resolved_head_dim, mc.model_size
    if splits_on(spec, 1, mc.model_axis):
        return all_gather([_project(x, w, cfg, pos, p.get(norm), rotate)
                           for p, x, w, pos in zip(ps, xs, ws, positions)], mc.model_axis, mc, 2)
    if m == 1 or (kv * hd) % m:
        return [_project(x, w, cfg, pos, p.get(norm), rotate)
                for p, x, w, pos in zip(ps, xs, ws, positions)]
    n = kv * hd // m
    ts = [torch.einsum("bsd,de->bse", x, w.reshape(w.shape[0], kv * hd)
                       .narrow(1, _model_index(mc, c) * n, n).to(x.dtype))
          for x, w, c in zip(xs, ws, mc.coords)]
    ts = [t.reshape(*t.shape[:2], kv, hd) for t in all_gather(ts, mc.model_axis, mc, 2)]
    if not rotate:
        return ts
    return [_rotate(t, cfg, pos, p.get(norm)) for p, t, pos in zip(ps, ts, positions)]


def decode_attn_grid(ps: list, specs, xs: list, cfg, caches: list, seq_axes, cache_len,
                     ring: bool = False, mc=None):
    """`decode_attn_apply` on a share: ``caches`` one (k, v) a coordinate,
    each (B_loc, S_loc, KV, D), the sequence split over ``seq_axes`` (empty:
    every coordinate holds it whole). Every head's q on every coordinate
    (gathered over "model" where wq's heads are split), the new token's k
    and v of every kv head, each coordinate projecting only its share
    (`_decode_kv`), the token written where its slot lies, flash-decoding
    over the slices, then ``wo`` row-parallel. Returns (outputs, new
    caches)."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    w = {k: gather_param([p[k] for p in ps], specs[k], mc) for k in ("wq", "wk", "wv", "wo")}
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)
    def length(x):
        if torch.is_tensor(cache_len):
            return cache_len.to(x.device)
        return torch.full((), cache_len, dtype=torch.int64, device=x.device)

    positions = [length(x).reshape(1) for x in xs]
    qs = [_project(x, wq, cfg, pos, p.get("q_norm"))
          for p, x, wq, pos in zip(ps, xs, w["wq"], positions)]
    if splits_on(specs["wq"], 1, mc.model_axis):
        qs = all_gather(qs, mc.model_axis, mc, 2)
    ks = _decode_kv(ps, xs, w["wk"], specs["wk"], cfg, mc, positions, "k_norm")
    vs = _decode_kv(ps, xs, w["wv"], specs["wv"], cfg, mc, positions, rotate=False)
    seq_split = bool(seq_axes) and mc.mesh is not None and \
        math.prod(mc.mesh.shape[ax] for ax in seq_axes) > 1
    parts, new_caches, stats = [], [], []
    for i, (c, x) in enumerate(zip(mc.coords, xs)):
        k_cache, v_cache = caches[i]
        s_loc = k_cache.shape[1]
        s0 = axis_index(mc.mesh, c, seq_axes) * s_loc if seq_axes else 0
        s_max = s_loc * (math.prod(mc.mesh.shape[ax] for ax in seq_axes) if seq_axes else 1)
        cl = length(x)
        ins = torch.clamp(cl % s_max if ring else cl, 0, s_max - 1) - s0
        mine = (ins >= 0) & (ins < s_loc)
        slot = torch.clamp(ins, 0, s_loc - 1).reshape(1).to(torch.int64)
        kn = torch.where(mine, ks[i].to(k_cache.dtype), k_cache.index_select(1, slot))
        vn = torch.where(mine, vs[i].to(v_cache.dtype), v_cache.index_select(1, slot))
        k_cache = torch.index_copy(k_cache, 1, slot, kn)
        v_cache = torch.index_copy(v_cache, 1, slot, vn)
        new_caches.append((k_cache, v_cache))
        kv_pos = s0 + torch.arange(s_loc, device=x.device)
        if ring:
            mask = (kv_pos < torch.clamp(cl + 1, max=s_max))[None, None, :]
        else:
            mask = _mask(cl.reshape(1), kv_pos, True, None, cl + 1)[None]
        mask = mask.expand(x.shape[0], 1, s_loc)
        q = qs[i]
        if not seq_split:
            parts.append(_sdpa_grouped(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask, scale,
                                       cfg.attn_softcap))
            continue
        b = q.shape[0]
        qg = q.reshape(b, 1, kv, h // kv, hd)
        sc = torch.einsum("bskgd,btkd->bkgst", qg, k_cache.to(q.dtype)) * scale
        sc = softcap(sc, cfg.attn_softcap)
        sc = torch.where(mask[:, None, None, :, :], sc, NEG_INF)
        stats.append(sc.to(wide(sc.dtype)))
    if seq_split:
        m = pmax([sc.amax(dim=-1, keepdim=True) for sc in stats], seq_axes, mc)
        e = [torch.exp(sc - mi) for sc, mi in zip(stats, m)]
        tot = psum([ei.sum(dim=-1, keepdim=True) for ei in e], seq_axes, mc)
        for i, (ei, ti) in enumerate(zip(e, tot)):
            q = qs[i]
            wgt = (ei / ti).to(q.dtype)
            out = torch.einsum("bkgst,btkd->bskgd", wgt, new_caches[i][1].to(q.dtype))
            parts.append(out.reshape(q.shape[0], 1, h, hd))
        parts = psum(parts, seq_axes, mc)
    outs = []
    o_split = splits_on(specs["wo"], 0, mc.model_axis)
    for i, (c, x) in enumerate(zip(mc.coords, xs)):
        w_o = w["wo"][i]
        out = parts[i]
        if o_split:
            n_loc = w_o.shape[0]
            out = out.narrow(2, axis_index(mc.mesh, c, mc.model_axis) * n_loc, n_loc)
        outs.append(torch.einsum("bshe,hed->bsd", out, w_o.to(x.dtype)))
    if o_split:
        outs = psum(outs, mc.model_axis, mc)
    return outs, new_caches
