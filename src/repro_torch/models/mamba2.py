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
`mamba2_block_grid` runs a block on a share of a device grid (see
`models.zamba2`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant import _clip as _jnp_clip
from repro_torch.distributed.collectives import axis_index, psum
from repro_torch.models.layers import dense_init, gather_param, rms_norm, splits_on, wide

__all__ = [
    "mamba2_block_init",
    "ssd_sequential",
    "mamba2_block_apply",
    "mamba2_block_decode",
    "mamba2_block_grid",
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


def _channels(cfg, specs, mc, coord):
    """(first, count) of d_inner at ``coord`` on the grid: its model
    coordinate's slice where w_x's columns are split over "model", whole
    heads (w_dt's split with them); all of d_inner where they are not."""
    ssm = cfg.ssm
    d_in = ssm.expand * cfg.d_model
    split = splits_on(specs["w_x"], 1, mc.model_axis)
    n = d_in // mc.model_size if split else d_in
    if n % ssm.head_dim or split != splits_on(specs["w_dt"], 1, mc.model_axis):
        raise NotImplementedError(f"{cfg.name}: {mc.model_size} model shards cut its "
                                  f"{d_in // ssm.head_dim} heads of {ssm.head_dim}")
    return (axis_index(mc.mesh, coord, mc.model_axis) * n if split else 0), n


def _block_pre(p, x, cfg, conv_state=None, channels=None):
    """The computation before the SSD: projections, conv and dt. With
    ``channels`` (first, count): a coordinate of the grid whose w_z / w_x /
    w_dt / conv_w pieces hold that slice of d_inner (whole heads); the
    replicated conv_b, dt_bias and A_log are cut to it."""
    ssm = cfg.ssm
    dt_ = x.dtype
    cut = (lambda t, per=1: t) if channels is None else \
        (lambda t, per=1: t.narrow(0, channels[0] // per, channels[1] // per))  # noqa: E731
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    z = h @ p["w_z"].to(dt_)
    xc = h @ p["w_x"].to(dt_)
    xc, new_conv = _causal_conv(xc, p["conv_w"], cut(p["conv_b"]), conv_state)
    bmat = h @ p["w_B"].to(dt_)
    cmat = h @ p["w_C"].to(dt_)
    v = (h @ p["w_dt"].to(dt_)).to(wide(dt_)) + cut(p["dt_bias"], ssm.head_dim)[None, None, :]
    dt = torch.logaddexp(v, torch.zeros_like(v))  # softplus, (B, L, H)
    a_log = -torch.exp(cut(p["A_log"], ssm.head_dim))[None, None, :] * dt  # <= 0
    n_heads = xc.shape[-1] // ssm.head_dim
    xh = xc.reshape(*xc.shape[:-1], n_heads, ssm.head_dim)
    xh = xh * dt[..., None].to(dt_)  # fold dt into the input
    return z, xh, a_log, bmat, cmat, new_conv


def _gated(p, x, y, xh, z, cfg, channels=None):
    """y + D x, gated by silu(z) (D cut to ``channels``' heads)."""
    d_x = xh.reshape(*x.shape[:2], -1)
    dd = p["D"] if channels is None else \
        p["D"].narrow(0, channels[0] // cfg.ssm.head_dim, channels[1] // cfg.ssm.head_dim)
    d = torch.repeat_interleave(dd, cfg.ssm.head_dim)[None, None, :].to(x.dtype)
    y = y.reshape(*x.shape[:2], -1) + d * d_x
    return y * F.silu(z)


def _block_post(p, x, y, xh, z, cfg):
    """y + D x, the gate, the gated RMSNorm and out_proj, plus the residual."""
    y = rms_norm(_gated(p, x, y, xh, z, cfg), p["gn"], cfg.norm_eps)
    return x + y @ p["out_proj"].to(x.dtype)


def _ssd_step(xh, a_log, bmat, cmat, s):
    """One token of the recurrence: xh (B, 1, H, P), a_log (B, 1, H), bmat
    / cmat (B, 1, N), s (B, H, N, P) -> (y (B, 1, H, P), the new state)."""
    a = torch.exp(a_log[:, 0, :]).to(xh.dtype)  # (B, H)
    s_new = s * a[:, :, None, None] + torch.einsum("bn,bhp->bhnp", bmat[:, 0], xh[:, 0])
    return torch.einsum("bn,bhnp->bhp", cmat[:, 0], s_new)[:, None], s_new


def mamba2_block_apply(p, x, cfg):
    """Training / prefill path. x (B, L, d) -> (x + out, (conv_state,
    ssd_state)), the states a stream continues from."""
    z, xh, a_log, bmat, cmat, conv_state = _block_pre(p, x, cfg)
    y, s_final = _ssd_chunked(xh, a_log, bmat, cmat, cfg.ssm.chunk)
    return _block_post(p, x, y, xh, z, cfg), (conv_state, s_final)


def mamba2_block_decode(p, x, cfg, conv_state, ssd_state):
    """One-token decode. x (B, 1, d); the states carried explicitly."""
    z, xh, a_log, bmat, cmat, new_conv = _block_pre(p, x, cfg, conv_state)
    y, s_new = _ssd_step(xh, a_log, bmat, cmat, ssd_state)
    return _block_post(p, x, y, xh, z, cfg), (new_conv, s_new)


def _gated_norm_grid(ys: list, gn: list, cfg, mc) -> list:
    """The gated RMSNorm of a share: each coordinate's slice of d_inner
    normalised by the mean square over the WHOLE d_inner, a psum of the
    slices' sums of squares over "model" (where the slices are whole, the
    norm itself)."""
    d_in = cfg.ssm.expand * cfg.d_model
    y32 = [y.to(wide(y.dtype)) for y in ys]
    ss = [torch.sum(t * t, dim=-1, keepdim=True) for t in y32]
    if ys[0].shape[-1] != d_in:
        ss = psum(ss, mc.model_axis, mc)
    return [(t * torch.rsqrt(s / d_in + cfg.norm_eps) * (1.0 + g.to(t.dtype))).to(y.dtype)
            for t, s, g, y in zip(y32, ss, gn, ys)]


def mamba2_block_grid(ps, specs, xs, cfg, mc, states=None):
    """`mamba2_block_apply` (``states`` None: returns each coordinate's
    final (conv, ssd) states) or `mamba2_block_decode` (one token from
    ``states``, a (conv, ssd) a coordinate) on a share: w_z, w_x, w_dt and
    conv_w column-parallel over "model" (each coordinate its d_inner slice,
    `_channels`), w_B and w_C replicated, the SSD on the local heads, the
    gated RMSNorm over the whole d_inner (`_gated_norm_grid`), out_proj
    row-parallel and a psum over "model"."""
    w = {k: gather_param([p[k] for p in ps], specs[k], mc) for k in ps[0]}
    gs, gns, new = [], [], []
    for i, (c, x) in enumerate(zip(mc.coords, xs)):
        p = {k: t[i] for k, t in w.items()}
        ch = _channels(cfg, specs, mc, c)
        conv_s, ssd_s = (None, None) if states is None else states[i]
        z, xh, a_log, bmat, cmat, new_conv = _block_pre(p, x, cfg, conv_s, ch)
        if states is None:
            y, s_new = _ssd_chunked(xh, a_log, bmat, cmat, cfg.ssm.chunk)
        else:
            y, s_new = _ssd_step(xh, a_log, bmat, cmat, ssd_s)
        gs.append(_gated(p, x, y, xh, z, cfg, ch))
        gns.append(p["gn"].narrow(0, *ch))
        new.append((new_conv, s_new))
    gs = _gated_norm_grid(gs, gns, cfg, mc)
    outs = [g @ w["out_proj"][i].to(x.dtype) for i, (g, x) in enumerate(zip(gs, xs))]
    if splits_on(specs["out_proj"], 0, mc.model_axis):
        outs = psum(outs, mc.model_axis, mc)
    return [x + o for x, o in zip(xs, outs)], new


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
