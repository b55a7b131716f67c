"""RWKV-6 "Finch" backbone (arXiv:2404.05892): token-shift data-dependent
mixing, per-channel data-dependent decay linear attention (WKV6), and
squared-ReLU channel mix.

PyTorch counterpart of `repro.models.rwkv6`, with the same parameter
tree, arguments and results. Per head (key / value dims P) the WKV
recurrence is, from S = 0,

    y_t = r_t . (S + u ⊙ k_t v_t^T)
    S  <- diag(exp(logw_t)) S + k_t v_t^T

with logw_t = -exp(ww_t) <= 0 data-dependent per channel.

Training uses the chunked form (`wkv6_chunked`): within a chunk every
decay factor is an exp of a clipped difference of cumulative log-decays
(the (b, nc, q, q, h, p) ``ratio`` tensor), across chunks the state is
carried by a loop. The port builds ``ratio`` in place (one tensor of
that size at a time); the values are the reference's. Its gradient
(`_IntraScores`) recomputes ``ratio`` a few chunks at a time in the
backward, so a step at rwkv6-7b's width and 4096 tokens does not hold
the reference's five or six (nc, q, q, H, P) intermediates (8.6 GB each
in float32). `wkv6_sequential` is the direct recurrence, K7's plain
version (`kernels.wkv6`); the backbone trains through the chunked form,
as the reference's does.

The model API (`init_params`, `forward`, `loss_fn`, `init_cache`,
`prefill`, `decode_step`) takes the reference's arguments. The
reference's ``lax.scan`` over the stacked layer axis is a loop over it,
and its ``jax.checkpoint`` a ``torch.utils.checkpoint`` a layer
(`ArchConfig.remat`).

With a ``mesh_ctx`` (`moe.MeshContext` over a `distributed.sharding.Mesh`)
the step is the reference's sharded one, one share a grid coordinate as
`models.transformer`'s (a full grid in one process, or with
``mesh_ctx.coord`` one coordinate's share and its lone collectives): the
residual stream's batch over the data-parallel axes, replicated over
"model"; the embedding, the head and the loss over the vocabulary slices
(`layers.embed_grid`, `head_grid`, `loss_grid`); w_r, w_k, w_v, w_g and
cm_w_k column-parallel, so each model coordinate runs the time mix and
the WKV6 recurrence on its heads, with the replicated per-channel leaves
(decay_base, decay_w2's columns, bonus_u, ln_x) cut to them; w_o
row-parallel and a psum over "model"; cm_w_v row-parallel, its product
reduce-scattered onto the columns of cm_w_r the coordinate holds, gated
there and all-gathered back (`_grid_layer`); the ddlerp LoRA whole; every
weight all-gathered over its FSDP axes where it is used. The WKV states
keep their heads over "model" (`sharding.cache_specs`), the token-shift
carries the hidden layout. Without a ``mesh_ctx`` the one-device step
runs, unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant import _clip as _jnp_clip
from repro_torch.distributed.collectives import all_gather, axis_index, psum, reduce_scatter
from repro_torch.models.layers import (
    cross_entropy_loss,
    dense_init,
    embed_grid,
    gather_param,
    grid_specs,
    head_grid,
    logits_grid,
    loss_grid,
    remat,
    rms_norm,
    splits_on,
    unstack_specs,
    wide,
)

__all__ = [
    "wkv6_chunked",
    "wkv6_sequential",
    "rwkv6_block_init",
    "rwkv6_block_apply",
    "rwkv6_block_decode",
    "init_params",
    "forward",
    "loss_fn",
    "init_cache",
    "prefill",
    "decode_step",
]

Params = Dict[str, Any]

_MIX_NAMES = ("w", "k", "v", "r", "g")
_LORA_DIM = 32
_DECAY_LORA = 64
_CLIP = (-60.0, 0.0)  # the log-decay differences' clip
# elements of one (b, chunks, q, q, h, p) float32 temporary of the
# chunked form's backward: 256 MiB, one chunk of rwkv6-7b at B = 1
_BACKWARD_ELEMS = 1 << 26


# --------------------------------------------------------------------------
# the WKV6 recurrence
# --------------------------------------------------------------------------

def _tri(q: int, device) -> torch.Tensor:
    """(q, q) bool: j < t, the intra-chunk pairs."""
    return torch.tril(torch.ones((q, q), dtype=torch.bool, device=device), -1)


def _intra_scores(rs32, ks32, el, il) -> torch.Tensor:
    """scores[b, c, t, j, h] = sum_p r_t k_j exp(clip(el_t - il_j)) over
    j < t, with ``ratio`` built in place, one tensor of its size at a
    time."""
    q = rs32.shape[2]
    ratio = el[:, :, :, None] - il[:, :, None]  # (b, nc, t, j, h, p)
    ratio.clamp_(*_CLIP).exp_()
    ratio.masked_fill_(~_tri(q, rs32.device)[None, None, :, :, None, None], 0.0)
    # summed in place of einsum's three-operand product
    ratio.mul_(rs32[:, :, :, None]).mul_(ks32[:, :, None])
    return ratio.sum(dim=-1)


class _IntraScores(torch.autograd.Function):
    """`_intra_scores` with the gradient of the reference's
    ``einsum(r, k, where(tri, exp(clip(el_t - il_j, -60, 0)), 0))``
    under ``jax.grad``: ``jnp.clip``'s derivative is 1 inside, 0.5 on a
    bound, 0 outside. The backward keeps only the (b, nc, q, h, p)
    inputs and rebuilds ``ratio`` a group of chunks at a time."""

    @staticmethod
    def forward(ctx, rs32, ks32, el, il):
        ctx.save_for_backward(rs32, ks32, el, il)
        return _intra_scores(rs32, ks32, el, il)

    @staticmethod
    def backward(ctx, d_scores):
        rs32, ks32, el, il = ctx.saved_tensors
        b, nc, q, h, p = rs32.shape
        lo, hi = _CLIP
        tri = _tri(q, rs32.device)[None, None, :, :, None, None]
        d_r, d_k = torch.empty_like(rs32), torch.empty_like(ks32)
        d_el, d_il = torch.empty_like(el), torch.empty_like(il)
        group = max(1, _BACKWARD_ELEMS // (b * q * q * h * p))
        for c0 in range(0, nc, group):
            cs = slice(c0, min(nc, c0 + group))
            r, k, ds = rs32[:, cs], ks32[:, cs], d_scores[:, cs]
            x = el[:, cs, :, None] - il[:, cs, None]  # (b, g, t, j, h, p)
            a = torch.clamp(x, lo, hi).exp_().masked_fill_(~tri, 0.0)  # ratio
            # jnp.clip's derivative, in place of x
            x = torch.where((x > lo) & (x < hi), 1.0, torch.where((x == lo) | (x == hi), 0.5, 0.0))
            a.mul_(ds[..., None])  # dscores * ratio
            d_r[:, cs] = torch.einsum("bctjhp,bcjhp->bcthp", a, k)
            d_k[:, cs] = torch.einsum("bctjhp,bcthp->bcjhp", a, r)
            a.mul_(r[:, :, :, None]).mul_(k[:, :, None]).mul_(x)  # d(el_t - il_j)
            del x
            d_el[:, cs] = a.sum(dim=3)
            d_il[:, cs] = -a.sum(dim=2)
        return d_r, d_k, d_el, d_il


def wkv6_chunked(r, k, v, logw, u, chunk):
    """Chunked WKV6. r/k/v (B, L, H, P), logw (B, L, H, P) (<= 0),
    u (H, P). Returns (y (B, L, H, P), final state (B, H, P, P)).
    Differentiable in every input (`_IntraScores`); without a graph to
    record, ``ratio`` is built once, in place."""
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
    f32 = wide(r.dtype)
    rs = r.reshape(b, nc, q, h, p)
    ks_ = k.reshape(b, nc, q, h, p)
    vs = v.reshape(b, nc, q, h, p)
    lw = logw.reshape(b, nc, q, h, p).to(f32)

    il = torch.cumsum(lw, dim=2)  # inclusive
    el = il - lw  # exclusive: decay applied to the state BEFORE step t
    total = il[:, :, -1]  # (b, nc, h, p)

    # intra-chunk: y_t gets k_j (j < t) with decay prod_{s=j+1..t-1} w_s
    # = exp(el_t - il_j); plus the bonus u*k_t at j == t.
    scores = _IntraScores.apply(rs.to(f32), ks_.to(f32), el, il)  # (b, nc, t, j, h)
    diag_sc = (rs.to(f32) * u.to(f32) * ks_.to(f32)).sum(dim=-1)  # (b, nc, t, h)
    y_intra = torch.einsum("bctjh,bcjhp->bcthp", scores.to(r.dtype), vs) + (
        diag_sc[..., None].to(r.dtype) * vs
    )

    # chunk-local end state: sum_j exp(total - il_j) k_j v_j^T
    decay_to_end = torch.exp(_jnp_clip(total[:, :, None] - il, *_CLIP))
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


# --------------------------------------------------------------------------
# the block
# --------------------------------------------------------------------------

def rwkv6_block_init(gen: torch.Generator, cfg) -> Params:
    """One layer's float32 parameters, drawn from ``gen`` on its device."""
    d = cfg.d_model
    dev = gen.device
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
    n_mix = len(_MIX_NAMES)
    return {
        "ln1": zeros(d),
        "ln2": zeros(d),
        # token-shift ddlerp
        "mix_x": zeros(d),
        "mix_base": zeros(n_mix, d),
        "mix_w1": dense_init(gen, (d, n_mix * _LORA_DIM)),
        "mix_w2": dense_init(gen, (n_mix, _LORA_DIM, d), fan_in=_LORA_DIM),
        # time-mix projections
        "w_r": dense_init(gen, (d, d)),
        "w_k": dense_init(gen, (d, d)),
        "w_v": dense_init(gen, (d, d)),
        "w_g": dense_init(gen, (d, d)),
        "w_o": dense_init(gen, (d, d)),
        # data-dependent decay: ww = base + tanh(x W1) W2
        "decay_base": torch.full((d,), -6.0, dtype=torch.float32, device=dev),
        "decay_w1": dense_init(gen, (d, _DECAY_LORA)),
        "decay_w2": dense_init(gen, (_DECAY_LORA, d), fan_in=_DECAY_LORA),
        "bonus_u": zeros(d),  # per-channel "faaaa"
        "ln_x": zeros(d),  # per-head group norm scale
        # channel mix
        "cm_mix_k": zeros(d),
        "cm_mix_r": zeros(d),
        "cm_w_k": dense_init(gen, (d, cfg.d_ff)),
        "cm_w_v": dense_init(gen, (cfg.d_ff, d), fan_in=cfg.d_ff),
        "cm_w_r": dense_init(gen, (d, d)),
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shift right by one along time; ``last`` is the streaming carry."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p, x, xs):
    """Data-dependent interpolation: the five mixed inputs
    [x_w, x_k, x_v, x_r, x_g]."""
    dt = x.dtype
    dx = xs - x
    xxx = x + dx * p["mix_x"].to(dt)
    lora = torch.tanh(xxx @ p["mix_w1"].to(dt))
    lora = lora.reshape(*x.shape[:2], len(_MIX_NAMES), _LORA_DIM)
    deltas = torch.einsum("blmr,mrd->blmd", lora, p["mix_w2"].to(dt))
    return [x + dx * (p["mix_base"][i].to(dt) + deltas[:, :, i])
            for i in range(len(_MIX_NAMES))]


def _time_mix_pre(p, x, cfg, shift_state=None, channels=None):
    """The time mix's inputs to the recurrence. ``channels`` (first,
    count): a coordinate of the grid whose w_r / w_k / w_v / w_g pieces
    hold those channels (whole heads); the replicated per-channel leaves
    (the decay's base and second LoRA factor, the bonus) are cut to them."""
    hd = cfg.resolved_head_dim
    dt = x.dtype
    heads = lambda t: t.reshape(*t.shape[:-1], t.shape[-1] // hd, hd)  # noqa: E731
    cut = (lambda t, dim: t) if channels is None else \
        (lambda t, dim: t.narrow(dim, channels[0], channels[1]))  # noqa: E731
    xs = _token_shift(x, shift_state)
    x_w, x_k, x_v, x_r, x_g = _ddlerp(p, x, xs)
    r = heads(x_r @ p["w_r"].to(dt))
    k = heads(x_k @ p["w_k"].to(dt))
    v = heads(x_v @ p["w_v"].to(dt))
    g = F.silu(x_g @ p["w_g"].to(dt))
    ww = cut(p["decay_base"], 0).to(wide(dt)) + (
        torch.tanh(x_w @ p["decay_w1"].to(dt)) @ cut(p["decay_w2"], 1).to(dt)
    ).to(wide(dt))
    logw = heads(-torch.exp(ww))  # <= 0, per channel
    u = heads(cut(p["bonus_u"], 0))
    return r, k, v, g, logw, u, x[:, -1, :]


def _time_mix_post(p, y, g, cfg, channels=None):
    """The per-head group norm, the gate and ``w_o`` (on a coordinate's
    ``channels``: its ln_x cut to them, w_o its rows, a partial sum)."""
    b, l = y.shape[:2]
    # per-head group norm, jnp.var's two passes
    y32 = y.to(wide(y.dtype))
    mean = y32.mean(-1, keepdim=True)
    var = torch.square(y32 - mean).mean(-1, keepdim=True)
    yn = (y32 - mean) * torch.rsqrt(var + 64e-5)
    ln_x = p["ln_x"] if channels is None else p["ln_x"].narrow(0, *channels)
    yn = yn.reshape(b, l, -1) * (1.0 + ln_x.to(y32.dtype))
    return (yn.to(g.dtype) * g) @ p["w_o"].to(g.dtype)


def _channel_mix_in(p, x, shift_state=None):
    """The channel mix's key product ``relu(x_k W_k)^2 W_v`` and its gate's
    input ``x_r W_r`` (on a coordinate: a partial sum over its d_ff slice
    and its columns of W_r)."""
    dt = x.dtype
    xs = _token_shift(x, shift_state)
    dx = xs - x
    x_k = x + dx * p["cm_mix_k"].to(dt)
    x_r = x + dx * p["cm_mix_r"].to(dt)
    k = torch.square(F.relu(x_k @ p["cm_w_k"].to(dt)))
    return k @ p["cm_w_v"].to(dt), x_r @ p["cm_w_r"].to(dt)


def _channel_mix(p, x, shift_state=None):
    vv, rr = _channel_mix_in(p, x, shift_state)
    return torch.sigmoid(rr) * vv, x[:, -1, :]


def _wkv6_step(r, k, v, logw, u, s):
    """One token of the recurrence: r / k / v / logw (B, 1, H, P), u (H,
    P), s (B, H, P, P) -> (y (B, 1, H, P), the new state)."""
    r1, k1, v1, lw1 = (t[:, 0] for t in (r, k, v, logw))
    kv = torch.einsum("bhp,bhv->bhpv", k1, v1)
    y = torch.einsum("bhp,bhpv->bhv", r1, s + u[None, :, :, None].to(r.dtype) * kv)[:, None]
    return y, s * torch.exp(lw1)[..., None].to(s.dtype) + kv


def rwkv6_block_apply(p, x, cfg):
    """Full-sequence block. Returns (x, (tm_shift, wkv_state, cm_shift)),
    the states a stream continues from."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    r, k, v, g, logw, u, tm_shift = _time_mix_pre(p, h, cfg)
    y, s_final = wkv6_chunked(r, k, v, logw, u, cfg.ssm.chunk)
    x = x + _time_mix_post(p, y, g, cfg)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    cm_out, cm_shift = _channel_mix(p, h2)
    return x + cm_out, (tm_shift, s_final, cm_shift)


def rwkv6_block_decode(p, x, cfg, state):
    """One-token decode. state = (tm_shift (B, d), wkv (B, H, P, P),
    cm_shift (B, d))."""
    tm_shift, s, cm_shift = state
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    r, k, v, g, logw, u, tm_new = _time_mix_pre(p, h, cfg, tm_shift)
    y, s_new = _wkv6_step(r, k, v, logw, u, s)
    x = x + _time_mix_post(p, y, g, cfg)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    cm_out, cm_new = _channel_mix(p, h2, cm_shift)
    return x + cm_out, (tm_new, s_new, cm_new)


# --------------------------------------------------------------------------
# backbone API
# --------------------------------------------------------------------------

def _layer(params: Params, i: int) -> Params:
    return {name: leaf[i] for name, leaf in params["layers"].items()}


def init_params(gen: torch.Generator, cfg, mesh_ctx=None, device=None) -> Params:
    """Random parameters drawn from ``gen`` (on its device), cast to the
    activation dtype as the reference casts them, on ``device`` (default:
    the card through `kernels.build.resolve_device`). ``layers`` stacks
    each leaf along a leading (n_layers,) axis."""
    from repro_torch.kernels.build import resolve_device  # lazy: kernels import models

    device = resolve_device(device)
    dt = cfg.activation_dtype
    cast = lambda t: t.to(device=device, dtype=dt)  # noqa: E731
    d, v = cfg.d_model, cfg.vocab_padded
    embed = cast(dense_init(gen, (v, d), fan_in=d))
    layers = [{k: cast(t) for k, t in rwkv6_block_init(gen, cfg).items()}
              for _ in range(cfg.n_layers)]
    stacked = {k: torch.stack([layer[k] for layer in layers]) for k in layers[0]}
    return {
        "embed": embed,
        "head": cast(dense_init(gen, (d, v))),
        "final_norm": torch.zeros((d,), dtype=dt, device=device),
        "layers": stacked,
    }


def _embed(params, batch, cfg) -> torch.Tensor:
    tokens = batch["tokens"].to(device=params["embed"].device, dtype=torch.int64)
    return params["embed"].to(cfg.activation_dtype)[tokens]


def forward(params, batch, cfg, mesh_ctx=None):
    """Logits (B, S, V_padded) of ``batch["tokens"]`` (B, S), and the
    reference's zero auxiliary loss."""
    if mesh_ctx is not None:
        return _grid_forward(params, batch, cfg, mesh_ctx)
    x = _embed(params, batch, cfg)
    body = remat(lambda p, x: rwkv6_block_apply(p, x, cfg)[0], cfg)
    for i in range(cfg.n_layers):
        x = body(_layer(params, i), x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["head"].to(x.dtype)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, batch, cfg, mesh_ctx=None):
    if mesh_ctx is not None:
        return _grid_loss(params, batch, cfg, mesh_ctx)
    logits, _ = forward(params, batch, cfg, mesh_ctx)
    labels = batch["labels"].to(logits.device)
    return cross_entropy_loss(logits, labels, cfg.final_softcap)


def init_cache(cfg, batch: int, max_len: int, mesh_ctx=None, device=None):
    """Zero streaming state of every layer: token-shift carries and WKV
    states, in the activation dtype (``max_len`` is unused: the state is
    constant in size)."""
    from repro_torch.kernels.build import resolve_device  # lazy: kernels import models

    device = resolve_device(device)
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    z = lambda *shape: torch.zeros(shape, dtype=cfg.activation_dtype, device=device)  # noqa: E731
    n = cfg.n_layers
    return {
        "tm_shift": z(n, batch, d),
        "wkv": z(n, batch, d // hd, hd, hd),
        "cm_shift": z(n, batch, d),
    }


def _cache(states) -> Dict[str, torch.Tensor]:
    tm, s, cm = zip(*states)
    return {"tm_shift": torch.stack(tm), "wkv": torch.stack(s), "cm_shift": torch.stack(cm)}


def _head_last(params, x, cfg) -> torch.Tensor:
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (h @ params["head"].to(h.dtype))[:, 0, :]


def prefill(params, batch, cfg, mesh_ctx=None, max_len=None):
    """The whole prompt in one pass: (logits at its last position (B, V),
    the cache a `decode_step` continues from)."""
    if mesh_ctx is not None:
        return _grid_prefill(params, batch, cfg, mesh_ctx)
    x = _embed(params, batch, cfg)
    states = []
    for i in range(cfg.n_layers):
        x, st = rwkv6_block_apply(_layer(params, i), x, cfg)
        states.append(st)
    return _head_last(params, x[:, -1:, :], cfg), _cache(states)


def decode_step(params, cache, cache_len, batch, cfg, mesh_ctx=None):
    """One token a sequence (``batch["tokens"]`` (B, 1)) from ``cache``:
    (logits (B, V), the new cache). ``cache_len`` is unused, as in the
    reference (the state is constant in size)."""
    if mesh_ctx is not None:
        return _grid_decode(params, cache, batch, cfg, mesh_ctx)
    x = _embed(params, batch, cfg)
    states = []
    for i in range(cfg.n_layers):
        c = (cache["tm_shift"][i], cache["wkv"][i], cache["cm_shift"][i])
        x, st = rwkv6_block_decode(_layer(params, i), x, cfg, c)
        states.append(st)
    return _head_last(params, x, cfg), _cache(states)


# --------------------------------------------------------------------------
# the sharded step: one share a grid coordinate (see the module docstring)
# --------------------------------------------------------------------------

def _channels(cfg, specs, mc, coord):
    """(first, count) of the time mix's channels at ``coord``: its model
    coordinate's slice of d_model where w_r's columns are split over
    "model", whole heads; every channel where they are not."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if not splits_on(specs["w_r"], 1, mc.model_axis):
        return 0, d
    n = d // mc.model_size
    if n % hd:
        raise NotImplementedError(f"{cfg.name}: {mc.model_size} model shards cut its "
                                  f"{d // hd} heads of {hd}")
    return axis_index(mc.mesh, coord, mc.model_axis) * n, n


def _grid_layer(ps, specs, xs, cfg, mc, states=None):
    """One layer on a share: the time mix on each coordinate's heads
    (`_channels`), ``w_o`` row-parallel and a psum over "model"; the
    channel mix with ``cm_w_k`` column- and ``cm_w_v`` row-parallel, its
    product reduce-scattered over "model" onto the columns of ``cm_w_r``
    the coordinate holds, gated there and all-gathered back (where
    ``cm_w_r`` is not split, a psum and the whole gate). ``states`` None:
    the whole sequence, returning each coordinate's final (tm_shift, wkv,
    cm_shift); else one token from them."""
    w = {k: gather_param([p[k] for p in ps], specs[k], mc) for k in ps[0]}
    pieces = [{k: t[i] for k, t in w.items()} for i in range(len(xs))]
    states = states or [(None, None, None)] * len(xs)
    model = mc.model_axis
    outs, tms, wkvs = [], [], []
    for c, p, x, (tm, s, _) in zip(mc.coords, pieces, xs, states):
        ch = _channels(cfg, specs, mc, c)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        r, k, v, g, logw, u, tm_new = _time_mix_pre(p, h, cfg, tm, ch)
        if s is None:
            y, s_new = wkv6_chunked(r, k, v, logw, u, cfg.ssm.chunk)
        else:
            y, s_new = _wkv6_step(r, k, v, logw, u, s)
        outs.append(_time_mix_post(p, y, g, cfg, ch))
        tms.append(tm_new)
        wkvs.append(s_new)
    if splits_on(specs["w_o"], 0, model):
        outs = psum(outs, model, mc)
    xs = [x + o for x, o in zip(xs, outs)]
    hs = [rms_norm(x, p["ln2"], cfg.norm_eps) for p, x in zip(ps, xs)]
    vvs, rrs = zip(*(_channel_mix_in(p, h, st[2]) for p, h, st in zip(pieces, hs, states)))
    ff_split = splits_on(specs["cm_w_k"], 1, model)
    if splits_on(specs["cm_w_r"], 1, model):
        n = rrs[0].shape[-1]
        if ff_split:
            vvs = reduce_scatter(list(vvs), model, mc, 2)
        else:
            vvs = [vv.narrow(2, axis_index(mc.mesh, c, model) * n, n)
                   for vv, c in zip(vvs, mc.coords)]
        cms = all_gather([torch.sigmoid(rr) * vv for rr, vv in zip(rrs, vvs)], model, mc, 2)
    else:
        if ff_split:
            vvs = psum(list(vvs), model, mc)
        cms = [torch.sigmoid(rr) * vv for rr, vv in zip(rrs, vvs)]
    return [x + cm for x, cm in zip(xs, cms)], \
        [(tm, s, h[:, -1, :]) for tm, s, h in zip(tms, wkvs, hs)]


def _grid_trunk(params, batch, cfg, mc, keep_states=False):
    """The embedding and every layer on the grid: (shares of the final
    hidden state, the parameter shares, the batch shares, the specs,
    each layer's states a coordinate where ``keep_states``)."""
    from repro_torch.distributed.sharding import to_shares

    n_rows = batch["tokens"].shape[0]
    cache = init_cache(cfg, n_rows, 1, device="meta") if keep_states else None
    specs = grid_specs(mc, params, batch, cache, n_rows)
    shares = to_shares(params, specs["params"], mc)
    bs = to_shares(batch, specs["batch"], mc)
    pspecs = specs["params"]
    xs = embed_grid([p["embed"] for p in shares], pspecs["embed"], [b["tokens"] for b in bs],
                    cfg.activation_dtype, mc)
    lspecs = unstack_specs(shares[0]["layers"], pspecs["layers"])
    body = (lambda ps, xs: _grid_layer(ps, lspecs, xs, cfg, mc)[0]) if not keep_states else None
    if body is not None:
        body = remat(body, cfg)
    states = []
    for i in range(cfg.n_layers):
        ps = [_layer(p, i) for p in shares]
        if keep_states:
            xs, st = _grid_layer(ps, lspecs, xs, cfg, mc)
            states.append(st)
        else:
            xs = body(ps, xs)
    return xs, shares, bs, specs, states


def _grid_forward(params, batch, cfg, mc):
    xs, shares, _, specs, _ = _grid_trunk(params, batch, cfg, mc)
    return logits_grid(shares, specs, xs, cfg, mc), torch.zeros((), dtype=torch.float32,
                                                                device=xs[0].device)


def _grid_loss(params, batch, cfg, mc):
    xs, shares, bs, specs, _ = _grid_trunk(params, batch, cfg, mc)
    logits, vsplit = head_grid(shares, specs["params"], xs, cfg, mc)
    return loss_grid(logits, vsplit, bs, specs["batch"], cfg, mc)


def _grid_out(shares, specs, xs, states, cfg, mc):
    """(the logits of the last position, the caches) put back together
    from the grid's shares (a coordinate's own pieces with ``coord``)."""
    from repro_torch.distributed.sharding import from_shares

    logits = logits_grid(shares, specs, xs, cfg, mc, last=True)
    caches = [_cache([layer[i] for layer in states]) for i in range(len(xs))]
    return logits, from_shares(caches, specs["cache"], mc)


def _grid_prefill(params, batch, cfg, mc):
    xs, shares, _, specs, states = _grid_trunk(params, batch, cfg, mc, keep_states=True)
    return _grid_out(shares, specs, xs, states, cfg, mc)


def _grid_decode(params, cache, batch, cfg, mc):
    from repro_torch.distributed.sharding import to_shares

    n_rows = batch["tokens"].shape[0]
    specs = grid_specs(mc, params, batch, cache, n_rows)
    shares = to_shares(params, specs["params"], mc)
    bs = to_shares(batch, specs["batch"], mc)
    cs = to_shares(cache, specs["cache"], mc)
    pspecs = specs["params"]
    xs = embed_grid([p["embed"] for p in shares], pspecs["embed"], [b["tokens"] for b in bs],
                    cfg.activation_dtype, mc)
    lspecs = unstack_specs(shares[0]["layers"], pspecs["layers"])
    states = []
    for i in range(cfg.n_layers):
        xs, st = _grid_layer([_layer(p, i) for p in shares], lspecs, xs, cfg, mc,
                             [(c["tm_shift"][i], c["wkv"][i], c["cm_shift"][i]) for c in cs])
        states.append(st)
    return _grid_out(shares, specs, xs, states, cfg, mc)
