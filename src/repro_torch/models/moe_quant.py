"""Serving-time int8 quantization of MoE expert FFN banks.

PyTorch counterpart of `repro.models.moe_quant`: expert banks stored as
int8 codes and one float32 absmax scale a last-dim row, dequantized on
the fly inside the expert products (`models.moe._expert_ffn`). The
``shared`` expert MLP stays unquantized.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["dequant_weight", "quantize_expert_params", "quantize_expert_shapes"]

_QUANT_NAMES = ("w_up", "w_gate", "w_down")


def _quant_leaf(x: torch.Tensor) -> dict:
    """Per-row scale ``max |x| / 127 + 1e-12``, codes ``round(x / scale)``
    (half to even, a division as the reference's) clipped to +-127."""
    x32 = x.to(torch.float32)
    scale = torch.amax(torch.abs(x32), dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(torch.float32)}


def dequant_weight(w, dtype: torch.dtype) -> torch.Tensor:
    """An expert bank in ``dtype``: int8 ``{"q", "s"}`` dequantized, a
    tensor cast."""
    if isinstance(w, dict) and "q" in w:
        return (w["q"].to(torch.float32) * w["s"]).to(dtype)
    return w.to(dtype)


def _walk(node, leaf_fn, under_moe=False):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if under_moe and k in _QUANT_NAMES and not isinstance(v, dict):
                out[k] = leaf_fn(v)
            else:
                out[k] = _walk(v, leaf_fn, (under_moe or k == "moe") and k != "shared")
        return out
    if isinstance(node, list):
        return [_walk(v, leaf_fn, under_moe) for v in node]
    return node


def quantize_expert_params(params: Any) -> Any:
    """The tree with every expert bank under a ``moe`` key quantized."""
    return _walk(params, _quant_leaf)


def quantize_expert_shapes(params_shape: Any) -> Any:
    """The same transform on abstract leaves: each bank becomes ``meta``
    tensors of the codes' and scales' shapes and dtypes (any tensor works
    as input; nothing is allocated)."""
    def leaf(v):
        return {"q": torch.empty(tuple(v.shape), dtype=torch.int8, device="meta"),
                "s": torch.empty(tuple(v.shape[:-1]) + (1,), dtype=torch.float32, device="meta")}

    return _walk(params_shape, leaf)
