"""The RWKV6 (Finch) WKV recurrence, in its two plain forms.

PyTorch counterpart of `repro.models.rwkv6`'s `wkv6_chunked` and
`wkv6_sequential`, with the same arguments and results. Only these two
are ported: the block, the model and its configs come with the LM side.
The recurrence, per (batch, head), from S = 0:

    y_t = r_t . (S + u ⊙ k_t v_t^T)
    S  <- diag(exp(logw_t)) S + k_t v_t^T

The chunked form is the training formulation: within a chunk every
decay factor is an exp of a clipped difference of cumulative log-decays
(the (b, nc, q, q, h, p) ``ratio`` tensor), across chunks the state is
carried by a scan. The port builds ``ratio`` in place (one tensor of that
size at a time); the values are the reference's.
"""

from __future__ import annotations

import torch

__all__ = ["wkv6_chunked", "wkv6_sequential"]


def wkv6_chunked(r, k, v, logw, u, chunk):
    """Chunked WKV6. r/k/v (B, L, H, P), logw (B, L, H, P) (<= 0),
    u (H, P). Returns (y (B, L, H, P), final state (B, H, P, P))."""
    b, l, h, p = r.shape
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        # zero-pad: k=v=0 adds nothing to the state, logw=0 leaves it
        # untouched, so the final state stays exact; padded outputs are
        # sliced off below.
        zero = lambda t: torch.cat([t, t.new_zeros((b, pad, h, p))], dim=1)  # noqa: E731
        r, k, v, logw = zero(r), zero(k), zero(v), zero(logw)
    nc = (l + pad) // q
    f32 = torch.float32
    rs = r.reshape(b, nc, q, h, p)
    ks_ = k.reshape(b, nc, q, h, p)
    vs = v.reshape(b, nc, q, h, p)
    lw = logw.reshape(b, nc, q, h, p).to(f32)

    il = torch.cumsum(lw, dim=2)  # inclusive
    el = il - lw  # exclusive: decay applied to the state BEFORE step t
    total = il[:, :, -1]  # (b, nc, h, p)

    # intra-chunk: y_t gets k_j (j < t) with decay prod_{s=j+1..t-1} w_s
    # = exp(el_t - il_j); plus the bonus u*k_t at j == t.
    ratio = el[:, :, :, None] - il[:, :, None]  # (b, nc, t, j, h, p)
    ratio.clamp_(-60.0, 0.0).exp_()
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=r.device), -1)
    ratio.masked_fill_(~tri[None, None, :, :, None, None], 0.0)
    # scores[t, j] = sum_p r_t k_j ratio[t, j], summed in place of einsum's
    # three-operand product
    ratio.mul_(rs.to(f32)[:, :, :, None]).mul_(ks_.to(f32)[:, :, None])
    scores = ratio.sum(dim=-1)  # (b, nc, t, j, h)
    del ratio
    diag_sc = (rs.to(f32) * u.to(f32) * ks_.to(f32)).sum(dim=-1)  # (b, nc, t, h)
    y_intra = torch.einsum("bctjh,bcjhp->bcthp", scores.to(r.dtype), vs) + (
        diag_sc[..., None].to(r.dtype) * vs
    )

    # chunk-local end state: sum_j exp(total - il_j) k_j v_j^T
    decay_to_end = torch.exp(torch.clamp(total[:, :, None] - il, -60.0, 0.0))
    s_local = torch.einsum(
        "bcjhp,bcjhv->bchpv", (ks_.to(f32) * decay_to_end).to(r.dtype), vs
    )  # (b, nc, h, p, v)

    s = torch.zeros((b, h, p, p), dtype=r.dtype, device=r.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * torch.exp(total[:, c])[..., None].to(s.dtype) + s_local[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)  # (b, nc, h, p, v)

    # inter-chunk: y_t += (r_t * exp(el_t)) . S_chunk_start
    y_inter = torch.einsum(
        "bcthp,bchpv->bcthv", (rs.to(f32) * torch.exp(el)).to(r.dtype), s_prevs
    )
    y = (y_intra + y_inter).reshape(b, l + pad, h, p)[:, :l]
    return y, s


def wkv6_sequential(r, k, v, logw, u):
    """Oracle: the direct recurrence, one step at a time, with the state
    in r's dtype; y promotes with u's dtype, as the reference's does."""
    b, l, h, p = r.shape
    s = torch.zeros((b, h, p, p), dtype=r.dtype, device=r.device)
    lw = logw.to(r.dtype)
    ys = []
    for t in range(l):
        kv = torch.einsum("bhp,bhv->bhpv", k[:, t], v[:, t])
        bonus = s + u[None, :, :, None] * kv  # in u's dtype where it is wider
        ys.append(torch.einsum("bhp,bhpv->bhv", r[:, t].to(bonus.dtype), bonus))
        s = s * torch.exp(lw[:, t])[..., None] + kv
    if not ys:
        return r.new_zeros((b, 0, h, p))
    return torch.stack(ys, dim=1)
