"""Mamba2 (SSD) blocks, the Zamba2 backbone's workhorse.

PyTorch counterpart of `repro.models.mamba2`, with the same parameter
tree, arguments, results and dtype sequence. The selective state-space
recurrence per head h (state N x P) is

    S_t = a_t * S_{t-1} + dt_t * B_t (x) x_t        a_t = exp(dt_t * A_h)
    y_t = C_t . S_t + D_h * x_t

with x gated by silu(z) and a gated RMSNorm before ``out_proj`` (Mamba2,
arXiv:2405.21060).

Training uses the chunked SSD form (`_ssd_chunked`, chunk Q): within a
chunk a masked (Q, Q) product per head, whose decay factors are exps of
clipped differences of cumulative log-decays (the (b, nc, q, q, h)
``ratio``, 235 MB in float32 at zamba2-7b's widths and 4096 tokens, so
plain autograd holds it); across chunks the state is carried by a loop,
in the activation dtype. The clips take `core.quant._clip`, whose
gradient is ``jnp.clip``'s (0.5 on a bound: the diagonal t = j and a
chunk's last row sit on the upper bound 0). `ssd_sequential` is the
direct recurrence, the tests' oracle. No kernel of the port runs here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant import _clip as _jnp_clip
from repro_torch.models.layers import dense_init, rms_norm, wide

__all__ = [
    "mamba2_block_init",
    "ssd_sequential",
    "mamba2_block_apply",
    "mamba2_block_decode",
    "init_conv_state",
    "init_ssd_state",
]

Params = Dict[str, Any]

_CLIP = (-60.0, 0.0)  # the log-decay differences' clip


def mamba2_block_init(gen: torch.Generator, cfg) -> Params:
    """One layer's float32 parameters, drawn from ``gen`` on its device."""
    ssm = cfg.ssm
    d = cfg.d_model
    d_in = ssm.expand * d
    n_heads = d_in // ssm.head_dim
    dev = gen.device
    full = lambda n, v: torch.full((n,), v, dtype=torch.float32, device=dev)  # noqa: E731
    return {
        "ln": full(d, 0.0),
        "w_z": dense_init(gen, (d, d_in)),
        "w_x": dense_init(gen, (d, d_in)),
        "w_B": dense_init(gen, (d, ssm.d_state)),
        "w_C": dense_init(gen, (d, ssm.d_state)),
        "w_dt": dense_init(gen, (d, n_heads)),
        "dt_bias": full(n_heads, 0.0),
        "A_log": full(n_heads, 0.0),  # A = -exp(A_log)
        "D": full(n_heads, 1.0),
        "conv_w": dense_init(gen, (ssm.d_conv, d_in), fan_in=ssm.d_conv),
        "conv_b": full(d_in, 0.0),
        "gn": full(d_in, 0.0),  # gated RMSNorm scale
        "out_proj": dense_init(gen, (d_in, d), fan_in=d_in),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time. x (B, L, C), w (K, C); ``state``
    (B, K-1, C) carries the last K-1 inputs for streaming decode. The K
    terms are summed left to right from 0. Returns (silu(y), new_state)."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, L+K-1, C)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :].to(x.dtype) for i in range(k))
    y = y + b.to(x.dtype)
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return F.silu(y), new_state


def _ssd_chunked(xh, a_log, bmat, cmat, chunk):
    """Chunked SSD scan.

    xh   : (B, L, H, P)   dt-premultiplied inputs (dt folded into x)
    a_log: (B, L, H)      per-step log decay (= dt * A <= 0)
    bmat : (B, L, N)      input projections (shared across heads, G=1)
    cmat : (B, L, N)      output projections
    returns y (B, L, H, P), final state (B, H, N, P) in xh's dtype.
    Differentiable in every input by autograd."""
    b, l, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        # zero-pad (x = 0 adds nothing, a_log = 0 keeps the state: exact)
        zero = lambda t: torch.cat([t, t.new_zeros((b, pad) + tuple(t.shape[2:]))], dim=1)  # noqa: E731
        xh, a_log, bmat, cmat = zero(xh), zero(a_log), zero(bmat), zero(cmat)
    nc = (l + pad) // q
    dt = xh.dtype
    xh = xh.reshape(b, nc, q, h, p)
    a_log = a_log.reshape(b, nc, q, h).to(wide(dt))
    bmat = bmat.reshape(b, nc, q, n)
    cmat = cmat.reshape(b, nc, q, n)

    il = torch.cumsum(a_log, dim=2)  # inclusive log-decay (b, nc, q, h)
    total = il[:, :, -1, :]  # (b, nc, h)

    # intra-chunk: y_t reads S_t after the step-t update, so input j
    # reaches output t >= j with decay prod_{s=j+1..t} a_s = exp(il_t - il_j);
    # t == j gives decay 1 (the diagonal)
    cb = torch.einsum("bcin,bcjn->bcij", cmat, bmat)  # (b, nc, q, q)
    ratio = torch.exp(_jnp_clip(il[:, :, :, None, :] - il[:, :, None, :, :], *_CLIP))
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    scores = cb[..., None] * torch.where(tri[None, None, :, :, None], ratio, 0.0).to(cb.dtype)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores.to(dt), xh)

    # chunk-local end states: S_c = sum_j exp(total - il_j) B_j (x) x_j,
    # decay and x multiplied first (the reference's contraction order)
    decay_to_end = torch.exp(_jnp_clip(total[:, :, None, :] - il, *_CLIP))  # (b, nc, q, h)
    s_local = torch.einsum("bcjn,bcjhp->bchnp", bmat, decay_to_end.to(dt)[..., None] * xh)

    # inter-chunk: the state at each chunk's start, carried in xh's dtype
    s = xh.new_zeros((b, h, n, p))
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * torch.exp(total[:, c])[:, :, None, None].to(s.dtype) + s_local[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)  # (b, nc, h, n, p)

    # the carried state decays through step t inclusive:
    # y_t += C_t . (exp(il_t) * S_chunk_start), C and the decay multiplied first
    c_decay = cmat[..., :, None] * torch.exp(il).to(dt)[..., None, :]  # (b, nc, q, n, h)
    y_inter = torch.einsum("bcinh,bchnp->bcihp", c_decay, s_prevs)
    y = (y_intra + y_inter).reshape(b, l + pad, h, p)[:, :l]
    return y, s


def ssd_sequential(xh, a_log, bmat, cmat):
    """Oracle: the direct per-step recurrence (tests only), the state in
    xh's dtype."""
    b, l, h, p = xh.shape
    n = bmat.shape[-1]
    s = xh.new_zeros((b, h, n, p))
    a = a_log.to(xh.dtype)
    ys = []
    for t in range(l):
        s = s * torch.exp(a[:, t])[:, :, None, None] + torch.einsum(
            "bn,bhp->bhnp", bmat[:, t], xh[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", cmat[:, t], s))
    if not ys:
        return xh.new_zeros((b, 0, h, p))
    return torch.stack(ys, dim=1)


def _block_pre(p, x, cfg, conv_state=None):
    """The computation before the SSD: projections, conv and dt."""
    ssm = cfg.ssm
    dt_ = x.dtype
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    z = h @ p["w_z"].to(dt_)
    xc = h @ p["w_x"].to(dt_)
    xc, new_conv = _causal_conv(xc, p["conv_w"], p["conv_b"], conv_state)
    bmat = h @ p["w_B"].to(dt_)
    cmat = h @ p["w_C"].to(dt_)
    v = (h @ p["w_dt"].to(dt_)).to(wide(dt_)) + p["dt_bias"][None, None, :]
    dt = torch.logaddexp(v, torch.zeros_like(v))  # softplus, (B, L, H)
    a_log = -torch.exp(p["A_log"])[None, None, :] * dt  # <= 0
    n_heads = xc.shape[-1] // ssm.head_dim
    xh = xc.reshape(*xc.shape[:-1], n_heads, ssm.head_dim)
    xh = xh * dt[..., None].to(dt_)  # fold dt into the input
    return z, xh, a_log, bmat, cmat, new_conv


def _block_post(p, x, y, xh, z, cfg):
    """y + D x, the gate, the gated RMSNorm and out_proj, plus the residual."""
    d_x = xh.reshape(*x.shape[:2], -1)
    d = torch.repeat_interleave(p["D"], cfg.ssm.head_dim)[None, None, :].to(x.dtype)
    y = y.reshape(*x.shape[:2], -1) + d * d_x
    y = rms_norm(y * F.silu(z), p["gn"], cfg.norm_eps)
    return x + y @ p["out_proj"].to(x.dtype)


def mamba2_block_apply(p, x, cfg):
    """Training / prefill path. x (B, L, d) -> (x + out, (conv_state,
    ssd_state)), the states a stream continues from."""
    z, xh, a_log, bmat, cmat, conv_state = _block_pre(p, x, cfg)
    y, s_final = _ssd_chunked(xh, a_log, bmat, cmat, cfg.ssm.chunk)
    return _block_post(p, x, y, xh, z, cfg), (conv_state, s_final)


def mamba2_block_decode(p, x, cfg, conv_state, ssd_state):
    """One-token decode. x (B, 1, d); the states carried explicitly."""
    z, xh, a_log, bmat, cmat, new_conv = _block_pre(p, x, cfg, conv_state)
    a = torch.exp(a_log[:, 0, :]).to(x.dtype)  # (B, H)
    s_new = ssd_state * a[:, :, None, None] + torch.einsum("bn,bhp->bhnp", bmat[:, 0], xh[:, 0])
    y = torch.einsum("bn,bhnp->bhp", cmat[:, 0], s_new)[:, None]  # (B, 1, H, P)
    return _block_post(p, x, y, xh, z, cfg), (new_conv, s_new)


def init_conv_state(cfg, batch: int, device=None) -> torch.Tensor:
    """Zero conv carries (B, K-1, d_in) in the activation dtype, on
    ``device`` (default: the card through `kernels.build.resolve_device`)."""
    from repro_torch.kernels.build import resolve_device  # lazy: kernels import models

    ssm = cfg.ssm
    return torch.zeros((batch, ssm.d_conv - 1, ssm.expand * cfg.d_model),
                       dtype=cfg.activation_dtype, device=resolve_device(device))


def init_ssd_state(cfg, batch: int, device=None) -> torch.Tensor:
    """Zero SSD states (B, H, N, P) in the activation dtype, on ``device``
    (default: the card)."""
    from repro_torch.kernels.build import resolve_device  # lazy: kernels import models

    ssm = cfg.ssm
    n_heads = ssm.expand * cfg.d_model // ssm.head_dim
    return torch.zeros((batch, n_heads, ssm.d_state, ssm.head_dim),
                       dtype=cfg.activation_dtype, device=resolve_device(device))
