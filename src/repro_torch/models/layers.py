"""Shared building blocks of the LM backbones.

Counterpart of `repro.models.layers`. Parameter trees are nested dicts
of tensors; stacked layers carry a leading (n_layers,) axis.
Initializers draw float32 from an explicit ``torch.Generator`` (on the
generator's device) and the caller casts to the activation dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "rms_norm",
    "softcap",
    "rope",
    "apply_rope",
    "dense_init",
    "mlp_init",
    "mlp_apply",
    "cross_entropy_loss",
]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the (1 + scale) parameterization, statistics in
    float32 whatever the activation dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> (cos, sin), each (..., head_dim / 2), float32."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exponent)
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
    """Mean of ``logsumexp(logits) - logits[label]`` in float32; logits
    (B, S, V), labels (B, S) integers."""
    logits = softcap(logits, final_cap).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(logz - gold)
