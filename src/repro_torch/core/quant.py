"""Fixed-point / quantization substrate matching the paper's datapath.

PyTorch counterpart of `repro.core.quant`. The IC uses (Section II / III-E):
  * 12-bit unsigned quantizer on the decimated FEx output (FV_Raw),
  * 10-bit logarithmic LUT output (FV_Log),
  * 14-bit signed activations in Q6.8 (6 integer + 8 fractional bits)
    for FV_Norm and all GRU activations,
  * 8-bit signed weights,
  * 24-bit accumulators in the 8 HPEs.

Every nonlinearity that decides a code is a ROM built once on the host in
float32: the 12 -> 10-bit log compressor and the Q6.8 sigmoid / tanh
gates. Lookups then give the same codes on every device, so no device
`log2`, `sigmoid` or `tanh` ever decides a code. Rounding is
round-half-to-even (`torch.round`) everywhere, as in the reference.

The quantizers train through the reference's straight-through estimator:
`ste_round` passes the gradient through unchanged, and the saturating clip
passes it where a value lies inside the format, halves it on a bound and
stops it outside, as ``jnp.clip`` (a maximum, then a minimum) does.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

__all__ = [
    "QuantSpec",
    "ACT_Q6_8",
    "WEIGHT_INT8",
    "ACC_INT24",
    "BIAS_Q8_15",
    "FV_RAW_U12",
    "FV_LOG_U10",
    "ste_round",
    "fake_quant",
    "quantize_int",
    "dequantize_int",
    "quantize_unsigned",
    "quantizer_scale",
    "log_rom",
    "log_compress_lut",
    "log_compress_eager",
    "round_shift_even",
    "clip_act_codes",
    "sigmoid_rom",
    "tanh_rom",
    "lut_sigmoid_q68",
    "lut_tanh_q68",
    "LUT_MIN",
    "LUT_MAX",
]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """A fixed-point format: `bits` total, `frac_bits` fractional, signed."""

    bits: int
    frac_bits: int
    signed: bool = True

    @property
    def scale(self) -> float:
        """LSB weight: value = code * 2**-frac_bits."""
        return 2.0 ** (-self.frac_bits)

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1)) if self.signed else 0

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.signed else 2**self.bits - 1

    @property
    def max_value(self) -> float:
        return self.qmax * self.scale

    @property
    def min_value(self) -> float:
        return self.qmin * self.scale


# The paper's formats.
ACT_Q6_8 = QuantSpec(bits=14, frac_bits=8, signed=True)  # activations / FV_Norm
WEIGHT_INT8 = QuantSpec(bits=8, frac_bits=7, signed=True)  # weights in [-1, 1)
ACC_INT24 = QuantSpec(bits=24, frac_bits=16, signed=True)  # HPE accumulator
FV_RAW_U12 = QuantSpec(bits=12, frac_bits=0, signed=False)  # quantizer output
FV_LOG_U10 = QuantSpec(bits=10, frac_bits=0, signed=False)  # log LUT output
# Biases live pre-loaded in the HPE accumulator, at the accumulation
# scale of a Q6.8 activation x int8 weight product (frac = 8 + 7 = 15).
BIAS_Q8_15 = QuantSpec(bits=24, frac_bits=15, signed=True)


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round-half-to-even with a straight-through gradient."""
    return _SteRound.apply(x)


class _Clip(torch.autograd.Function):
    # torch.clamp's gradient is 1 on a bound; jnp.clip's is 0.5 there,
    # since the max and the min each split a tie between their operands
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        mask = torch.where((x > lo) & (x < hi), 1.0,
                           torch.where((x == lo) | (x == hi), 0.5, 0.0))
        return g * mask.to(g.dtype), None, None


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``torch.clamp(x, lo, hi)`` with ``jnp.clip``'s gradient: 1 inside
    the bounds, 0.5 on one, 0 outside."""
    return _Clip.apply(x, lo, hi)


def fake_quant(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Quantize-dequantize to `spec` on the float path (QAT forward).

    Saturates at the format bounds, like the HPE accumulator and the
    activation registers; the gradient is straight through, 0.5 on a
    bound and 0 beyond one, as in the reference.
    """
    q = ste_round(x * 2.0**spec.frac_bits)
    q = _clip(q, spec.qmin, spec.qmax)
    return q * spec.scale


def quantize_int(
    x: torch.Tensor, spec: QuantSpec, dtype=torch.int32
) -> torch.Tensor:
    """Float -> integer codes (saturating). Bit-exact integer path entry."""
    q = torch.round(x * 2.0**spec.frac_bits)
    return torch.clamp(q, spec.qmin, spec.qmax).to(dtype)


def dequantize_int(codes: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    return codes.to(torch.float32) * spec.scale


def _f32(v: float) -> float:
    return float(np.float32(v))


def quantizer_scale(bits: int, x_max: float) -> float:
    """``levels / x_max`` as the reference's compiled tick evaluates it.

    XLA rewrites the division by the constant ``x_max`` into a product
    with its float32 reciprocal and folds the constants, so the tick
    computes ``clip(x) * (levels * (1 / x_max))`` in float32; 5850.0
    for the paper's 12 bits over 0.7. A true division rounds
    differently and flips FV_Raw codes near half-LSB boundaries.
    """
    return _f32(_f32(1.0 / _f32(x_max)) * (2**bits - 1))


def quantize_unsigned(x: torch.Tensor, bits: int, x_max: float) -> torch.Tensor:
    """The FEx 12-bit unsigned quantizer: [0, x_max] -> float codes.

    Mirrors the DeltaSigma-TDC + decimation output register width.
    Values are clipped (the TDC count register saturates); the gradient
    is straight through.
    """
    return ste_round(_clip(x, 0.0, x_max) * quantizer_scale(bits, x_max))


def _log_scale(in_bits: int, out_bits: int) -> float:
    """``(2^out_bits - 1) / (in_bits * ln 2)`` as the compiled tick folds it.

    The reference writes ``(2^out - 1) * log2(1 + v) / in_bits``; XLA
    evaluates ``log2`` as ``ln(.) * (1 / ln 2)`` and folds the constants
    left to right in float32. The fold decides code 63, where the exact
    value 511.5 is a tie: the folded scale gives 511.
    """
    inv_ln2 = _f32(1.0 / _f32(np.log(2.0)))
    return _f32(_f32((2.0**out_bits - 1.0) * inv_ln2) / in_bits)


@functools.lru_cache(maxsize=None)
def _log_rom_host(in_bits: int, out_bits: int) -> torch.Tensor:
    v = torch.arange(2**in_bits, dtype=torch.float32)
    return torch.round(torch.log(1.0 + v) * _log_scale(in_bits, out_bits))


@functools.lru_cache(maxsize=None)
def _on_device(rom_fn, device: torch.device, *args) -> torch.Tensor:
    return rom_fn(*args).to(device)


def _rom_device(device) -> torch.device:
    """A ROM's device: the card unless the caller names another
    (`kernels.build.resolve_device`, which raises where there is none)."""
    from repro_torch.kernels.build import resolve_device  # lazy: kernels import core

    return resolve_device(device)


def log_rom(
    device=None, in_bits: int = 12, out_bits: int = 10
) -> torch.Tensor:
    """The 12-bit -> 10-bit logarithmic compression ROM (Section II).

    ``out = round((2^out_bits - 1) * log2(1 + v) / in_bits)`` for every
    input code ``v``, float32, 4096 entries: a monotone companding curve
    exactly representable as a ROM on the IC. On ``device``, the card by
    default.
    """
    return _on_device(_log_rom_host, _rom_device(device), in_bits, out_bits)


def log_compress_lut(
    codes: torch.Tensor, in_bits: int = 12, out_bits: int = 10
) -> torch.Tensor:
    """FV_Raw float codes -> FV_Log float codes through the ROM."""
    rom = log_rom(codes.device, in_bits, out_bits)
    idx = torch.clamp(codes, 0.0, 2.0**in_bits - 1.0).to(torch.int64)
    return rom[idx]


@functools.lru_cache(maxsize=None)
def _log_eager_host(in_bits: int, out_bits: int) -> torch.Tensor:
    v = torch.arange(2**in_bits, dtype=torch.float32)
    return torch.round((2.0**out_bits - 1.0) * torch.log2(1.0 + v) / float(in_bits))


def log_compress_eager(
    codes: torch.Tensor, in_bits: int = 12, out_bits: int = 10
) -> torch.Tensor:
    """FV_Raw float codes -> FV_Log float codes by the closed form
    ``round((2^out_bits - 1) * log2(1 + v) / in_bits)``, rounded half to
    even, as the reference's eager `log_compress_lut` evaluates it (its
    value, without the straight-through round). Evaluated once on the host
    for every code and looked up, so no device ``log2`` decides a value.
    It differs from `log_rom` only at code 63, the tie: 512 here, 511 in
    the ROM the tick reads."""
    table = _on_device(_log_eager_host, codes.device, in_bits, out_bits)
    idx = torch.clamp(codes, 0.0, 2.0**in_bits - 1.0).to(torch.int64)
    return table[idx]


# --------------------------------------------------------------------------
# Bit-exact integer inference substrate (the IC's datapath on codes).
#
# The contract with the QAT fake-quant path: every float op the QAT
# forward performs on grid values is exactly representable in float32
# for the network's magnitudes, so replaying it on integer codes with
# the same round-to-nearest-even rule is bit-identical. Rescaling a
# frac-a x frac-b product back to Q6.8 is a single `round_shift_even`;
# sigmoid/tanh are ROM lookups over the 15-bit sum of two saturated
# Q6.8 addends, exactly as the IC's LUTs.
# --------------------------------------------------------------------------

def round_shift_even(codes: torch.Tensor, shift: int) -> torch.Tensor:
    """``round(codes / 2**shift)`` with ties-to-even, pure integer ops.

    `codes` must be a signed integer tensor; the arithmetic right shift
    floors for negatives, and the remainder test rounds the tie toward
    the even quotient.
    """
    if shift == 0:
        return codes
    half = 1 << (shift - 1)
    q = codes >> shift
    r = codes - (q << shift)  # remainder in [0, 2**shift)
    round_up = (r > half) | ((r == half) & ((q & 1) == 1))
    return q + round_up.to(q.dtype)


def clip_act_codes(codes: torch.Tensor) -> torch.Tensor:
    """Saturate integer codes to the Q6.8 activation register range."""
    return torch.clamp(codes, ACT_Q6_8.qmin, ACT_Q6_8.qmax)


# Domain of the sigmoid/tanh ROMs: the sum of two saturated Q6.8 codes
# (gate preactivations are i_gate + h_gate with both addends already
# clipped to the activation register), i.e. [2*qmin, 2*qmax].
LUT_MIN = 2 * ACT_Q6_8.qmin
LUT_MAX = 2 * ACT_Q6_8.qmax


def _gate_rom_host(fn) -> torch.Tensor:
    codes = torch.arange(LUT_MIN, LUT_MAX + 1, dtype=torch.int32)
    return quantize_int(fn(codes.to(torch.float32) * ACT_Q6_8.scale), ACT_Q6_8)


@functools.lru_cache(maxsize=None)
def _sigmoid_rom_host() -> torch.Tensor:
    return _gate_rom_host(torch.sigmoid)


@functools.lru_cache(maxsize=None)
def _tanh_rom_host() -> torch.Tensor:
    return _gate_rom_host(torch.tanh)


def sigmoid_rom(device=None) -> torch.Tensor:
    """Q6.8 sigmoid ROM over the summed-preactivation code domain.

    Entry ``i`` holds ``quantize_int(sigmoid((i + LUT_MIN) * 2^-8))``
    (int32, 32 767 entries), evaluated once on the host in float32, on
    ``device`` (the card by default).
    """
    return _on_device(_sigmoid_rom_host, _rom_device(device))


def tanh_rom(device=None) -> torch.Tensor:
    """Q6.8 tanh ROM over the summed-preactivation code domain, on
    ``device`` (the card by default)."""
    return _on_device(_tanh_rom_host, _rom_device(device))


def _lookup(rom: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    idx = torch.clamp(codes, LUT_MIN, LUT_MAX) - LUT_MIN
    return rom[idx.to(torch.int64)].to(codes.dtype)


def lut_sigmoid_q68(codes: torch.Tensor) -> torch.Tensor:
    """Integer sigmoid: summed Q6.8 preactivation codes -> Q6.8 codes."""
    return _lookup(sigmoid_rom(codes.device), codes)


def lut_tanh_q68(codes: torch.Tensor) -> torch.Tensor:
    """Integer tanh: summed Q6.8 preactivation codes -> Q6.8 codes."""
    return _lookup(tanh_rom(codes.device), codes)
