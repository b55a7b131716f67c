"""Bit-exact integer GRU-FC engine (the IC's digital classifier on codes).

PyTorch counterpart of `repro.core.gru_int`: the same 16 -> GRU(48) ->
GRU(48) -> FC(12) network, evaluated entirely on integer codes the way
the chip's 8 HPEs do (Sections II, III-E):

  * weights as int8 codes (frac 7, `quant.WEIGHT_INT8`),
  * activations / hidden state as Q6.8 int32 codes (`quant.ACT_Q6_8`),
  * biases pre-loaded in the 24-bit accumulator at the product scale
    (frac 15, `quant.BIAS_Q8_15`),
  * matmuls through `repro_torch.kernels.intgemm` (24-bit saturating
    accumulator; the CUDA kernel on the card, its plain version on the
    CPU),
  * sigmoid/tanh as Q6.8 ROM lookups over the summed-preactivation
    domain, and every rescale one round-half-even shift plus Q6.8
    saturation.

For parameters from `repro_torch.serving.quantize.quantize_classifier`
and inputs on the Q6.8 grid, the dequantized outputs equal the QAT path
of `repro_torch.core.gru` bit for bit (the edge: the int24 clip before
the bias add binds only for |x . w| >= 256).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.core import quant
from repro_torch.core.gru import GRUConfig
from repro_torch.kernels.intgemm import intgemm

__all__ = [
    "QuantizedClassifier",
    "int_gru_cell",
    "int_gru_layer",
    "int_gru_classifier_forward",
    "int_gru_classifier_step",
    "int_init_states",
    "quantize_acts",
    "dequantize_acts",
]

# Rescale shifts fixed by the paper's formats: an act (frac 8) x weight
# (frac 7) accumulator carries frac 15 -> Q6.8 needs >> 7; an act x act
# product carries frac 16 -> Q6.8 needs >> 8. 1.0 in Q6.8 is 1 << 8.
_ACC_SHIFT = quant.WEIGHT_INT8.frac_bits
_ACT_SHIFT = quant.ACT_Q6_8.frac_bits
_ONE_Q68 = 1 << quant.ACT_Q6_8.frac_bits


@dataclasses.dataclass(frozen=True)
class QuantizedClassifier:
    """All classifier parameters as integer codes.

    gru  — per-layer dicts {w_i (I, 3H) int8, w_h (H, 3H) int8,
           b_i (3H,) int32 frac-15, b_h (3H,) int32 frac-15}.
    fc_w — (H, K) int8 weight codes.
    fc_b — (K,) int32 bias codes, frac-15.
    """

    gru: Tuple[Dict[str, torch.Tensor], ...]
    fc_w: torch.Tensor
    fc_b: torch.Tensor

    def to(self, device) -> "QuantizedClassifier":
        """The same codes on ``device``."""
        return QuantizedClassifier(
            gru=tuple({k: v.to(device) for k, v in layer.items()} for layer in self.gru),
            fc_w=self.fc_w.to(device),
            fc_b=self.fc_b.to(device),
        )


def quantize_acts(x: torch.Tensor) -> torch.Tensor:
    """Float activations -> Q6.8 int32 codes (exact for on-grid inputs)."""
    return quant.quantize_int(x, quant.ACT_Q6_8)


def dequantize_acts(codes: torch.Tensor) -> torch.Tensor:
    """Q6.8 codes -> float32 (exact: code * 2^-8)."""
    return quant.dequantize_int(codes, quant.ACT_Q6_8)


def _accum(
    x_codes: torch.Tensor, w_codes: torch.Tensor, b_codes: torch.Tensor
) -> torch.Tensor:
    """x (B, K) Q6.8 @ w (K, N) int8 + bias (frac 15) -> Q6.8 codes."""
    acc = intgemm(x_codes, w_codes) + b_codes
    return quant.clip_act_codes(quant.round_shift_even(acc, _ACC_SHIFT))


def int_gru_cell(
    layer: Dict[str, torch.Tensor],
    h: torch.Tensor,
    x: torch.Tensor,
    config: GRUConfig,
) -> torch.Tensor:
    """One GRU step on codes: x (B, I), h (B, H) -> h' (B, H), int32."""
    gi = _accum(x, layer["w_i"], layer["b_i"])  # (B, 3H)
    gh = _accum(h, layer["w_h"], layer["b_h"])
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    r = quant.lut_sigmoid_q68(i_r + h_r)
    z = quant.lut_sigmoid_q68(i_z + h_z)
    rn = quant.clip_act_codes(quant.round_shift_even(r * h_n, _ACT_SHIFT))
    n = quant.lut_tanh_q68(i_n + rn)
    h_new = quant.round_shift_even((_ONE_Q68 - z) * n + z * h, _ACT_SHIFT)
    return quant.clip_act_codes(h_new)


def int_gru_layer(
    layer: Dict[str, torch.Tensor],
    xs: torch.Tensor,
    config: GRUConfig,
    h0=None,
):
    """xs (B, T, I) codes -> (hs (B, T, H), h_T (B, H)) codes."""
    h = h0
    if h is None:
        h = torch.zeros(
            (xs.shape[0], config.hidden_dim), dtype=torch.int32, device=xs.device
        )
    hs = []
    for t in range(xs.shape[1]):
        h = int_gru_cell(layer, h, xs[:, t].contiguous(), config)
        hs.append(h)
    return torch.stack(hs, dim=1), h


def int_gru_classifier_forward(
    qparams: QuantizedClassifier, fv_codes: torch.Tensor, config: GRUConfig
) -> torch.Tensor:
    """fv codes (B, T, C) -> per-frame logit codes (B, T, K), int32."""
    xs = fv_codes
    for layer in qparams.gru:
        xs, _ = int_gru_layer(layer, xs, config)
    b, t, h = xs.shape
    logits = _accum(xs.reshape(b * t, h), qparams.fc_w, qparams.fc_b)
    return logits.reshape(b, t, -1)


def int_gru_classifier_step(
    qparams: QuantizedClassifier,
    states: List[torch.Tensor],
    fv_t: torch.Tensor,
    config: GRUConfig,
):
    """Streaming step on codes: one frame (B, C) -> (states, (B, K))."""
    new_states = []
    x = fv_t
    for layer, h in zip(qparams.gru, states):
        x = int_gru_cell(layer, h, x, config)
        new_states.append(x)
    return new_states, _accum(x, qparams.fc_w, qparams.fc_b)


def int_init_states(config: GRUConfig, batch: int, device) -> List[torch.Tensor]:
    """Per-layer int32 Q6.8 hidden-state codes, zeros on ``device``."""
    return [
        torch.zeros((batch, config.hidden_dim), dtype=torch.int32, device=device)
        for _ in range(config.num_layers)
    ]
