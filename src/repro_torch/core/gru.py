"""GRU-FC classifier (paper Sections II, III-E).

PyTorch counterpart of `repro.core.gru`. Network: 16-in -> GRU(48) ->
GRU(48) -> FC(12), PyTorch gate convention:

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh   (W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

Parameters keep the reference layout: per layer ``w_i`` (I, 3H), ``w_h``
(H, 3H), ``b_i`` / ``b_h`` (3H,); ``fc.w`` (H, K), ``fc.b`` (K,).

With ``quantized=True`` (QAT) weights are fake-quantized to int8, biases
to the accumulator grid and activations to Q6.8, and the gate
nonlinearities are the Q6.8 ROMs of `repro_torch.core.quant`: on the
Q6.8 grid the ROM equals ``fake_quant(sigmoid(.))`` exactly, so no device
sigmoid or tanh decides a code. QAT trains through them: a gate's backward
is the reference's derivative of ``fake_quant(sigmoid(x))`` /
``fake_quant(tanh(x))`` at the float preactivation, and every fake-quant
is straight through (`quant.fake_quant`). With ``quantized=False`` (the float
backend) nothing is quantized and the gates are float ``sigmoid`` /
``tanh``; that path agrees with the reference within a tolerance only.

Products of Q6.8 activations and int8 weights are exact in float32, so
the QAT matmuls are exact as long as they run in full float32: TF32 must
be off on the card (`_matmul` refuses otherwise, for the float backend
too). The backward's matmuls are taken under the same switch, so they run
in full float32 as well.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import quant

__all__ = [
    "GRUConfig",
    "init_gru_classifier",
    "gru_cell",
    "gru_layer",
    "fc_logits",
    "gru_classifier_forward",
    "gru_classifier_step",
    "init_states",
    "classifier_macs",
    "classifier_param_bytes",
]


@dataclasses.dataclass(frozen=True)
class GRUConfig:
    input_dim: int = 16
    hidden_dim: int = 48
    num_layers: int = 2
    num_classes: int = 12
    quantized: bool = True  # QAT fake-quant on weights + activations

    @property
    def weight_spec(self) -> quant.QuantSpec:
        return quant.WEIGHT_INT8

    @property
    def act_spec(self) -> quant.QuantSpec:
        return quant.ACT_Q6_8


Params = Dict[str, Any]


def init_gru_classifier(
    config: GRUConfig,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Params:
    """Uniform(-1/sqrt(H), 1/sqrt(H)) init, PyTorch-style, drawn from
    ``generator`` on the host and placed on ``device`` (the card by
    default: `kernels.build.resolve_device`, which raises where there is
    none)."""
    from repro_torch.kernels.build import resolve_device  # lazy: kernels import core

    device = resolve_device(device)
    h = config.hidden_dim
    k = 1.0 / math.sqrt(h)

    def u(*shape):
        x = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (x * (2 * k) - k).to(device)

    params: Params = {"gru": [], "fc": {}}
    for layer in range(config.num_layers):
        in_dim = config.input_dim if layer == 0 else h
        params["gru"].append(
            {
                "w_i": u(in_dim, 3 * h),
                "w_h": u(h, 3 * h),
                "b_i": u(3 * h),
                "b_h": u(3 * h),
            }
        )
    params["fc"] = {"w": u(h, config.num_classes), "b": u(config.num_classes)}
    return params


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the classifier needs full-float32 matmuls; set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )
    return x @ w


def _layer_weights(layer: Params):
    # Biases are pre-loaded into the 24-bit HPE accumulator, which works
    # at the Q6.8 x int8 product scale (frac 15).
    wq = lambda w: quant.fake_quant(w, quant.WEIGHT_INT8)  # noqa: E731
    bq = lambda b: quant.fake_quant(b, quant.BIAS_Q8_15)  # noqa: E731
    return wq(layer["w_i"]), wq(layer["w_h"]), bq(layer["b_i"]), bq(layer["b_h"])


# the gates' ROMs, float functions, and the reference's derivative rules
# for them (jax's, written in its order, from the float value a = f(x))
_GATES = {
    "sigmoid": (quant.lut_sigmoid_q68, torch.sigmoid, lambda g, a: g * (a * (1 - a))),
    "tanh": (quant.lut_tanh_q68, torch.tanh, lambda g, a: (g + g * a) * (1 - a)),
}


class _Gate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        ctx.save_for_backward(x)
        ctx.name = name
        # no Q6.8 clip: a gate sum spans twice the activation range
        codes = torch.round(x * 2.0**quant.ACT_Q6_8.frac_bits).to(torch.int64)
        return quant.dequantize_int(_GATES[name][0](codes), quant.ACT_Q6_8)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        _, fn, rule = _GATES[ctx.name]
        return rule(g, fn(x)), None


def _gate(name: str, x: torch.Tensor) -> torch.Tensor:
    """A Q6.8 gate, ``"sigmoid"`` or ``"tanh"``, on a float tensor that
    lies on the Q6.8 grid: its ROM lookup forward, and backward the
    reference's derivative of ``fake_quant(sigmoid(x))`` /
    ``fake_quant(tanh(x))``, taken from the float preactivation ``x``
    (the output clip passes the gates' whole range)."""
    return _Gate.apply(x, name)


def gru_cell(
    layer: Params, h: torch.Tensor, x: torch.Tensor, config: GRUConfig
) -> torch.Tensor:
    """One GRU step: x (B, I), h (B, H) -> h' (B, H)."""
    if not config.quantized:
        gi = _matmul(x, layer["w_i"]) + layer["b_i"]
        gh = _matmul(h, layer["w_h"]) + layer["b_h"]
        i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
        h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h
    aq = lambda v: quant.fake_quant(v, quant.ACT_Q6_8)  # noqa: E731
    w_i, w_h, b_i, b_h = _layer_weights(layer)
    gi = aq(_matmul(x, w_i) + b_i)  # (B, 3H)
    gh = aq(_matmul(h, w_h) + b_h)
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    # Gate outputs are register values: on the IC sigmoid/tanh are Q6.8
    # ROM lookups, so downstream consumers never see a float
    # intermediate (this is what keeps QAT bit-replayable on codes).
    r = _gate("sigmoid", i_r + h_r)
    z = _gate("sigmoid", i_z + h_z)
    n = _gate("tanh", i_n + aq(r * h_n))
    return aq((1.0 - z) * n + z * h)


def gru_layer(
    layer: Params, xs: torch.Tensor, config: GRUConfig, h0=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs (B, T, I) -> (hs (B, T, H), h_T (B, H)): `gru_cell` over the
    sequence from ``h0`` (zeros in xs's dtype by default)."""
    h = h0
    if h is None:
        h = torch.zeros((xs.shape[0], config.hidden_dim), dtype=xs.dtype, device=xs.device)
    hs = []
    for t in range(xs.shape[1]):
        h = gru_cell(layer, h, xs[:, t], config)
        hs.append(h)
    if not hs:
        return xs.new_zeros((xs.shape[0], 0, config.hidden_dim)), h
    return torch.stack(hs, dim=1), h


def fc_logits(params: Params, x: torch.Tensor, config: GRUConfig) -> torch.Tensor:
    """The dense FC head on the last axis: (..., H) -> (..., K)."""
    if not config.quantized:
        return _matmul(x, params["fc"]["w"]) + params["fc"]["b"]
    w = quant.fake_quant(params["fc"]["w"], quant.WEIGHT_INT8)
    b = quant.fake_quant(params["fc"]["b"], quant.BIAS_Q8_15)
    return quant.fake_quant(_matmul(x, w) + b, quant.ACT_Q6_8)


def gru_classifier_forward(
    params: Params, fv: torch.Tensor, config: GRUConfig
) -> torch.Tensor:
    """fv (B, T, C) -> logits (B, T, num_classes), per frame."""
    xs = fv
    for layer in params["gru"]:
        xs, _ = gru_layer(layer, xs, config)
    return fc_logits(params, xs, config)


def gru_classifier_step(
    params: Params,
    states: List[torch.Tensor],
    fv_t: torch.Tensor,
    config: GRUConfig,
):
    """Streaming step: one frame fv_t (B, C) -> (new states, logits (B, K))."""
    new_states = []
    x = fv_t
    for layer, h in zip(params["gru"], states):
        x = gru_cell(layer, h, x, config)
        new_states.append(x)
    return new_states, fc_logits(params, x, config)


def init_states(config: GRUConfig, batch: int, device) -> List[torch.Tensor]:
    """Per-layer float32 hidden states, zeros on ``device``."""
    return [
        torch.zeros((batch, config.hidden_dim), dtype=torch.float32, device=device)
        for _ in range(config.num_layers)
    ]


def classifier_macs(config: GRUConfig) -> int:
    """MAC count per frame: the latency model's input (Section III-E).

    The paper's 2 x 48 GRU + FC over 16 inputs is 24 204 weights; at 8
    HPEs and 250 kHz that gives the reported 12.4 ms (`core.energy`).
    """
    macs = 0
    h = config.hidden_dim
    for layer in range(config.num_layers):
        in_dim = config.input_dim if layer == 0 else h
        macs += 3 * h * (in_dim + h) + 2 * 3 * h  # matmuls + two bias adds
    macs += config.num_classes * h + config.num_classes
    return macs


def classifier_param_bytes(config: GRUConfig, bits: int = 8) -> int:
    """Bytes of the classifier's weights and biases at ``bits`` a value."""
    h = config.hidden_dim
    n = 0
    for layer in range(config.num_layers):
        in_dim = config.input_dim if layer == 0 else h
        n += 3 * h * (in_dim + h) + 2 * 3 * h
    n += config.num_classes * h + config.num_classes
    return n * bits // 8
