"""Shared building blocks of the LM backbones.

Counterpart of `repro.models.layers`. Parameter trees are nested dicts
of tensors; stacked layers carry a leading (n_layers,) axis.
Initializers draw float32 from an explicit ``torch.Generator`` (on the
generator's device) and the caller casts to the activation dtype.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

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
