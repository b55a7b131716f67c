"""Shared building blocks of the LM backbones.

Counterpart of `repro.models.layers`. Parameter trees are nested dicts
of tensors; stacked layers carry a leading (n_layers,) axis.
Initializers draw float32 from an explicit ``torch.Generator`` (on the
generator's device) and the caller casts to the activation dtype.

The sharded step's layers (`gather_param`, `mlp_grid`, `embed_grid`,
`cross_entropy_grid`) work on *shares*: lists with one tensor (or one
parameter piece) a grid coordinate of ``mc.coords``
(`models.moe.MeshContext`), and the `distributed.collectives` between
them. The layout is the reference's: the residual stream's batch over
the data-parallel axes, replicated over "model"; the MLP column-parallel
(gate and up) then row-parallel (down) with a psum over "model"; the
vocabulary over "model"; each weight all-gathered over its FSDP axes
where it is used, inside the rematerialised layer.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.distributed.collectives import all_gather, axes_of, axis_index, pmax, psum

__all__ = [
    "wide",
    "rms_norm",
    "softcap",
    "rope",
    "apply_rope",
    "dense_init",
    "mlp_init",
    "mlp_apply",
    "cross_entropy_loss",
    "remat",
    "gather_param",
    "splits_on",
    "mlp_grid",
    "embed_grid",
    "cross_entropy_grid",
    "grid_specs",
    "unstack_specs",
    "head_grid",
    "loss_grid",
    "logits_grid",
]


def wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype the reference's float32 statistics run in: float32 for
    bfloat16 and float32 activations, float64 for float64 ones (a
    float64 run of the port is the truth both float32 runs are held to)."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the (1 + scale) parameterization, statistics in
    float32 (`wide`) whatever the activation dtype."""
    x32 = x.to(wide(x.dtype))
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(x32.dtype))).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> (cos, sin), each (..., head_dim / 2), float32."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    # a Python base: a tensor made of theta on the card would be a copy
    # that waits for the device, once a layer
    freqs = torch.pow(theta, exponent)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D); cos / sin (..., S, D/2): rotate the two halves."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)  # broadcast over heads
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def dense_init(gen: torch.Generator, shape, fan_in: Optional[int] = None) -> torch.Tensor:
    """N(0, 1 / fan_in) in float32 on ``gen``'s device (fan_in defaults
    to ``shape[0]``)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=gen.device) * std


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, act: str) -> dict:
    p = {
        "w_up": dense_init(gen, (d_model, d_ff)),
        "w_down": dense_init(gen, (d_ff, d_model), fan_in=d_ff),
    }
    if act in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (d_model, d_ff))
    return p


def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    dt = x.dtype
    up = x @ p["w_up"].to(dt)
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"].to(dt)) * up
    elif act == "geglu":
        h = F.gelu(x @ p["w_gate"].to(dt), approximate="tanh") * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(act)
    return h @ p["w_down"].to(dt)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       final_cap: Optional[float] = None) -> torch.Tensor:
    """Mean of ``logsumexp(logits) - logits[label]`` in float32 (`wide`);
    logits (B, S, V), labels (B, S) integers."""
    logits = softcap(logits, final_cap)
    logits = logits.to(wide(logits.dtype))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(logz - gold)


def remat(fn, cfg):
    """``fn`` under ``torch.utils.checkpoint`` as ``cfg.remat`` asks, the
    counterpart of the reference's ``jax.checkpoint`` of a layer or a
    scan step: "full" recomputes it in the backward, "dots" saves the
    matrix products without batch dims (`aten.mm`, as the reference's
    ``dots_with_no_batch_dims_saveable``) and recomputes the rest,
    "none" keeps everything."""
    if cfg.remat == "none":
        return fn
    kw = {"use_reentrant": False}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                             _save_dots)
    elif cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r}: none | dots | full")
    return lambda *args: _ckpt.checkpoint(fn, *args, **kw)


def _save_dots(ctx, op, *args, **kwargs):
    if op is torch.ops.aten.mm.default:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


# --------------------------------------------------------------------------
# the sharded step's layers: one entry a grid coordinate of mc.coords
# --------------------------------------------------------------------------

def splits_on(spec, dim: int, axis) -> bool:
    """Whether ``spec`` shards dim ``dim`` over ``axis``."""
    return dim < len(spec) and axis in axes_of(spec[dim])


def gather_param(pieces: list, spec, mc) -> list:
    """A parameter's pieces all-gathered over the FSDP axes of its spec,
    dim by dim (the model axis stays sharded): the weight as it is used.
    An int8 ``{"q", "s"}`` bank gathers each part along its own spec."""
    if isinstance(pieces[0], dict):
        parts = {k: gather_param([p[k] for p in pieces], spec[k], mc) for k in pieces[0]}
        return [{k: parts[k][i] for k in parts} for i in range(len(pieces))]
    for dim, entry in enumerate(spec):
        axes = tuple(ax for ax in axes_of(entry) if ax != mc.model_axis)
        if axes:
            pieces = all_gather(pieces, axes, mc, dim)
    return pieces


def mlp_grid(ps: list, specs, xs: list, act: str, mc) -> list:
    """`mlp_apply` on a share: gate and up column-parallel, down
    row-parallel and a psum over "model" where the hidden dim is split
    over it. A hidden dim replicated over "model", as the shared
    expert's, runs whole: the model coordinates of one data shard hold the
    same rows (the residual stream is replicated over "model") and the
    same weights, so it runs once for them and they share the result."""
    w = {k: gather_param([p[k] for p in ps], specs[k], mc) for k in ps[0]}
    if splits_on(specs["w_up"], 1, mc.model_axis):
        ys = [mlp_apply({k: w[k][i] for k in w}, x, act) for i, x in enumerate(xs)]
        return psum(ys, mc.model_axis, mc)
    once, ys = {}, []
    for i, (c, x) in enumerate(zip(mc.coords, xs)):
        rows = tuple(j for ax, j in zip(mc.mesh.axis_names, c) if ax != mc.model_axis)
        if rows not in once:
            once[rows] = mlp_apply({k: w[k][i] for k in w}, x, act)
        ys.append(once[rows].to(x.device))
    return ys


def _vocab_start(mc, coord, v_loc: int) -> int:
    return axis_index(mc.mesh, coord, mc.model_axis) * v_loc


def embed_grid(pieces: list, spec, tokens: list, dtype, mc) -> list:
    """The token embedding on a share: with the vocabulary over "model",
    each coordinate looks up the tokens of its vocabulary slice (zero
    elsewhere) and a psum over "model" adds the slices."""
    w = gather_param(pieces, spec, mc)
    if not splits_on(spec, 0, mc.model_axis):
        return [wi.to(dtype)[t.to(torch.int64)] for wi, t in zip(w, tokens)]
    xs = []
    for c, wi, t in zip(mc.coords, w, tokens):
        v_loc = wi.shape[0]
        ids = t.to(device=wi.device, dtype=torch.int64) - _vocab_start(mc, c, v_loc)
        ok = (ids >= 0) & (ids < v_loc)
        x = wi.to(dtype)[torch.clamp(ids, 0, v_loc - 1)]
        xs.append(torch.where(ok[..., None], x, torch.zeros((), dtype=dtype, device=x.device)))
    return psum(xs, mc.model_axis, mc)


def cross_entropy_grid(logits: list, labels: list, final_cap, vocab_split: bool,
                       batch_split: bool, n_tokens: int, mc) -> list:
    """`cross_entropy_loss` on a share of logits (B_loc, S, V_loc): with
    the vocabulary over "model" the max and the sum of exponentials are
    a pmax and a psum over "model", the gold logit a masked local gather
    and a psum; the mean over the global batch a psum over the
    data-parallel axes (where the batch is split over them) of the local
    sums, divided by ``n_tokens``."""
    ls = [softcap(lg, final_cap) for lg in logits]
    ls = [lg.to(wide(lg.dtype)) for lg in ls]
    labels = [lb.to(device=lg.device, dtype=torch.int64) for lb, lg in zip(labels, ls)]
    if not vocab_split:
        logz = [torch.logsumexp(lg, dim=-1) for lg in ls]
        gold = [torch.gather(lg, -1, lb[..., None])[..., 0] for lg, lb in zip(ls, labels)]
    else:
        m = pmax([lg.amax(dim=-1) for lg in ls], mc.model_axis, mc)
        se = psum([torch.exp(lg - mi[..., None]).sum(dim=-1) for lg, mi in zip(ls, m)],
                  mc.model_axis, mc)
        logz = [mi + torch.log(s_) for mi, s_ in zip(m, se)]
        gold = []
        for c, lg, lb in zip(mc.coords, ls, labels):
            v_loc = lg.shape[-1]
            ids = lb - _vocab_start(mc, c, v_loc)
            ok = (ids >= 0) & (ids < v_loc)
            g = torch.gather(lg, -1, torch.clamp(ids, 0, v_loc - 1)[..., None])[..., 0]
            gold.append(torch.where(ok, g, torch.zeros((), dtype=g.dtype, device=g.device)))
        gold = psum(gold, mc.model_axis, mc)
    if not batch_split:
        return [torch.mean(z - g) for z, g in zip(logz, gold)]
    sums = psum([torch.sum(z - g) for z, g in zip(logz, gold)], mc.dp_axes, mc)
    return [t / n_tokens for t in sums]


def grid_specs(mc, params, batch, cache=None, batch_size=None) -> dict:
    """The specs of a sharded step's trees: ``mc.specs`` for a coordinate's
    share (computed from the whole trees by its caller), else
    {"params", "batch"} (and "cache", given a whole cache or its ``meta``
    stand-in and the global ``batch_size``) of the whole trees."""
    if mc.coord is not None:
        return mc.specs
    from repro_torch.distributed.sharding import (batch_specs, cache_specs, context_rules,
                                                  param_specs)

    rules = context_rules(mc)
    out = {"params": param_specs(params, rules), "batch": batch_specs(batch, rules)}
    if cache is not None:
        out["cache"] = cache_specs(cache, rules, batch_size)
    return out


def unstack_specs(tree, specs):
    """A stack's specs without its layer axis. A layer axis the rules split
    (a shared expert's stack read as an expert axis, where the steps
    divide the model axis: no config on the production meshes) would need
    every step gathered; it raises."""
    from repro_torch.distributed.sharding import P
    from repro_torch.training.optimizer import tree_map

    def one(t, spec):
        if spec[0] is not None:
            raise NotImplementedError(f"a stacked leaf's layer axis split over {spec[0]!r}")
        return P(*spec[1:])

    return tree_map(one, tree, specs)


def head_grid(shares, specs, xs, cfg, mc):
    """The final norm and the output product on a share: (logits a
    coordinate, whether the vocabulary is split over "model"); the tied
    embedding's transpose where ``cfg.tie_embeddings``."""
    hs = [rms_norm(x, p["final_norm"], cfg.norm_eps) for p, x in zip(shares, xs)]
    if cfg.tie_embeddings:
        w = gather_param([p["embed"] for p in shares], specs["embed"], mc)
        return [h @ wi.T.to(h.dtype) for h, wi in zip(hs, w)], \
            splits_on(specs["embed"], 0, mc.model_axis)
    w = gather_param([p["head"] for p in shares], specs["head"], mc)
    return [h @ wi.to(h.dtype) for h, wi in zip(hs, w)], splits_on(specs["head"], 1, mc.model_axis)


def logits_grid(shares, specs, xs, cfg, mc, last: bool = False):
    """`head_grid`'s logits put back together (`sharding.from_shares`; a
    coordinate's own piece with ``coord``): (B, S, V) at every position,
    or with ``last`` the soft-capped (B, V) of the last one."""
    from repro_torch.distributed.sharding import P, from_shares

    if last:
        xs = [x[:, -1:, :] for x in xs]
    logits, vsplit = head_grid(shares, specs["params"], xs, cfg, mc)
    rows = next(iter(specs["batch"].values()))[0]
    vocab = mc.model_axis if vsplit else None
    if last:
        return from_shares([softcap(lg[:, 0, :], cfg.final_softcap) for lg in logits],
                           P(rows, vocab), mc)
    return from_shares(logits, P(rows, None, vocab), mc)


def loss_grid(logits: list, vsplit: bool, bs: list, bspecs, cfg, mc) -> torch.Tensor:
    """The mean cross-entropy of a share of logits against its labels
    (`cross_entropy_grid`), as the first coordinate holds it."""
    labels = [b["labels"] for b in bs]
    bsplit = bspecs["labels"][0] is not None
    n_tokens = labels[0].numel() * (math.prod(mc.mesh.shape[ax] for ax in mc.dp_axes)
                                    if bsplit else 1)
    return cross_entropy_grid(logits, labels, cfg.final_softcap, vsplit, bsplit, n_tokens, mc)[0]
