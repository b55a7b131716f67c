"""Serving-side KWS classifier quantization (the paper's WMEM image).

Counterpart of `repro.serving.quantize`: `quantize_classifier` converts
the float/QAT GRU-FC parameters of `repro_torch.core.gru` into a
`repro_torch.core.gru_int.QuantizedClassifier`: int8 weight codes and
frac-15 accumulator-resident bias codes, with the same round-half-even
the QAT fake-quant applies, so the integer engine consumes exactly the
values the QAT forward sees.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import quant
from repro_torch.core.gru import GRUConfig
from repro_torch.core.gru_int import QuantizedClassifier

__all__ = ["quantize_classifier"]


def _w_codes(w: torch.Tensor) -> torch.Tensor:
    """Float weights -> int8 codes on the paper's fixed frac-7 grid."""
    return quant.quantize_int(w, quant.WEIGHT_INT8, torch.int8)


def _b_codes(b: torch.Tensor) -> torch.Tensor:
    """Float biases -> int32 codes at the accumulator scale (frac 15)."""
    return quant.quantize_int(b, quant.BIAS_Q8_15, torch.int32)


def quantize_classifier(params: Any, config: GRUConfig) -> QuantizedClassifier:
    """Float/QAT GRU-FC params -> `QuantizedClassifier` integer codes,
    on the params' device. ``config`` is checked against the param
    geometry, which would otherwise surface as silently wrong codes."""
    if len(params["gru"]) != config.num_layers:
        raise ValueError(
            f"params have {len(params['gru'])} GRU layers, config says "
            f"{config.num_layers}"
        )
    if params["gru"][0]["w_h"].shape[0] != config.hidden_dim:
        raise ValueError(
            f"params hidden_dim {params['gru'][0]['w_h'].shape[0]} != "
            f"config.hidden_dim {config.hidden_dim}"
        )
    gru = tuple(
        {
            "w_i": _w_codes(layer["w_i"]),
            "w_h": _w_codes(layer["w_h"]),
            "b_i": _b_codes(layer["b_i"]),
            "b_h": _b_codes(layer["b_h"]),
        }
        for layer in params["gru"]
    )
    return QuantizedClassifier(
        gru=gru,
        fc_w=_w_codes(params["fc"]["w"]),
        fc_b=_b_codes(params["fc"]["b"]),
    )
