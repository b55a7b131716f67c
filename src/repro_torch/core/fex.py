"""Software model of the analog feature extractor (paper Section II, Fig. 2).

PyTorch counterpart of `repro.core.fex`:

Chain:  audio 16 kHz --2x oversample--> 32 kHz
        -> 16-ch band-pass biquad bank (Butterworth 2nd order, Q=2, Mel)
        -> full-wave rectifier |x|
        -> averaging (low-pass) + subsampler  == 16 ms frame shift
        -> 12-bit unsigned quantizer                  (FV_Raw)
        -> logarithmic compressor (12b -> 10b ROM)    (FV_Log)
        -> input normalizer (x - mu) / sigma, Q6.8    (FV_Norm)

The IIR is written as the reference's compiled scan evaluates it: XLA
contracts ``b0*x + s1`` and ``b2*x - a2*y`` (and ``b1*x - a1*y``) into
fused multiply-adds. The state of a 512-step recursion amplifies a
one-ulp difference, so the port rounds exactly there and nowhere else
(`fma_f32`), and the CUDA kernels use ``__fmaf_rn`` at the same places.

On a CUDA tensor the batch filterbank runs the hand-written kernels of
`repro_torch.kernels.fex_fused`: `fex_frames` is K1 (biquad, |.| and
frame mean in one launch) and `biquad_filterbank_streaming` its
per-sample scan entry; on a CPU tensor both take the plain scan
`biquad_scan`. The streaming frame step `biquad_filterbank_frame_mean`
is the serving tick's plain version and stays plain on every device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core import quant
from repro_torch.core.filters import BiquadCoeffs, design_filterbank

__all__ = [
    "FExConfig",
    "FExNormStats",
    "fma_f32",
    "oversample2x",
    "biquad_scan",
    "biquad_filterbank",
    "biquad_filterbank_streaming",
    "biquad_filterbank_frame_mean",
    "full_wave_rectify",
    "frame_average",
    "SUM_BLOCK",
    "frame_sum",
    "xla_sum",
    "eager_mean_std",
    "fex_frames",
    "fex_forward",
    "fit_norm_stats",
]


@dataclasses.dataclass(frozen=True)
class FExConfig:
    num_channels: int = 16
    fs_audio: float = 16000.0  # GSCD sampling rate
    oversample: int = 2  # paper: 2x to keep 8 kHz channel off Nyquist
    frame_shift_ms: float = 16.0
    f_lo: float = 100.0
    f_hi: float = 8000.0
    q: float = 2.0
    quant_bits: int = 12  # FV_Raw quantizer
    log_bits: int = 10  # FV_Log LUT output
    # Full-scale of the 12-bit quantizer, in rectified-average units of a
    # full-scale (+-1) input (a full-scale sine rectifies to 2/pi ~ 0.64).
    quant_full_scale: float = 0.7

    @property
    def fs_internal(self) -> float:
        return self.fs_audio * self.oversample

    @property
    def frame_len(self) -> int:
        """Samples per frame at the internal rate (512 for the paper values)."""
        n = self.fs_internal * self.frame_shift_ms / 1000.0
        if abs(n - round(n)) > 1e-9:
            raise ValueError(f"frame shift {self.frame_shift_ms} ms not integral")
        return int(round(n))

    def filterbank(self) -> BiquadCoeffs:
        return design_filterbank(
            self.num_channels, self.fs_internal, self.f_lo, self.f_hi, self.q
        )


@dataclasses.dataclass(frozen=True)
class FExNormStats:
    """mu / sigma of FV_Log over the training set (Section III-F)."""

    mu: torch.Tensor  # (C,)
    sigma: torch.Tensor  # (C,)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with ONE rounding, as an FMA unit gives it.

    The product of two float32 values is exact in float64. The float64
    sum is rounded to odd (TwoSum yields its error; an inexact sum whose
    last bit is even steps one ulp toward the exact value), and rounding
    a round-to-odd value of p + 2 or more bits to float32 is the correct
    single rounding (Boldo and Melquiond, 2008). A plain float64 sum
    would round twice and miss about one tie in 2^29.
    """
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.copysign(torch.full_like(s, math.inf), err)
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def oversample2x(audio: torch.Tensor) -> torch.Tensor:
    """Linear-interpolation 2x upsampling along the last axis.

    Models the paper's 16 kHz -> 32 kHz oversampling. (B, T) -> (B, 2T);
    the last sample is edge-replicated.
    """
    nxt = torch.cat([audio[..., 1:], audio[..., -1:]], dim=-1)
    mid = 0.5 * (audio + nxt)
    out = torch.stack([audio, mid], dim=-1)
    return out.reshape(*audio.shape[:-1], audio.shape[-1] * 2)


def _coeff_rows(coeffs, like: torch.Tensor):
    """BiquadCoeffs or a stacked (5, C) tensor -> five (C,) rows."""
    if isinstance(coeffs, BiquadCoeffs):
        coeffs = coeffs.stacked(device=like.device)
    arr = torch.as_tensor(coeffs, dtype=like.dtype, device=like.device)
    return arr[0], arr[1], arr[2], arr[3], arr[4]


def _zero_state(x: torch.Tensor, c: int):
    z = lambda: torch.zeros((x.shape[0], c), dtype=x.dtype, device=x.device)  # noqa: E731
    return z(), z()


def _biquad_step(rows, xc, s1, s2):
    """One transposed-DF-II step for every (stream, channel); xc is (B, 1)."""
    b0, b1, b2, a1, a2 = rows
    y = fma_f32(b0, xc, s1)
    s1_new = fma_f32(b1, xc, -(a1 * y)) + s2
    s2_new = fma_f32(b2, xc, -(a2 * y))
    return y, s1_new, s2_new


def biquad_scan(
    x: torch.Tensor,
    coeffs,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The plain filterbank scan, on any device: (B, T) ->
    (y (B, T, C), (s1, s2)), one `_biquad_step` per sample."""
    rows = _coeff_rows(coeffs, x)
    s1, s2 = _zero_state(x, rows[0].shape[-1]) if state is None else state
    ys = []
    for t in range(x.shape[-1]):
        y, s1, s2 = _biquad_step(rows, x[:, t : t + 1], s1, s2)
        ys.append(y)
    return torch.stack(ys, dim=-2), (s1, s2)


def biquad_filterbank_streaming(
    x: torch.Tensor,
    coeffs,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Stateful filterbank step for chunked/streaming input.

    x: (B, T_chunk); coeffs: BiquadCoeffs or stacked (5, C) tensor;
    state: transposed-DF-II carry (s1, s2), each (B, C), or None for a
    quiescent filter. Returns (y (B, T_chunk, C), new_state). A CUDA
    tensor runs the kernel's scan entry, a CPU tensor `biquad_scan`.
    """
    from repro_torch.kernels.fex_fused.ops import biquad_stream

    return biquad_stream(x, coeffs, state)


def biquad_filterbank_frame_mean(
    x: torch.Tensor,
    coeffs,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """`biquad_filterbank_streaming` + |.| + frame mean, fused in the loop.

    x is ONE frame of internal-rate samples (B, frame_len). The rectified
    sum is accumulated step by step (never materializing (B, T, C)) and
    divided by the frame length. Returns (mean_abs (B, C), new_state).
    """
    rows = _coeff_rows(coeffs, x)
    t = x.shape[-1]
    s1, s2 = _zero_state(x, rows[0].shape[-1]) if state is None else state
    acc = torch.zeros_like(s1)
    for i in range(t):
        y, s1, s2 = _biquad_step(rows, x[:, i : i + 1], s1, s2)
        acc = acc + torch.abs(y)
    return acc / t, (s1, s2)


def biquad_filterbank(x: torch.Tensor, coeffs) -> torch.Tensor:
    """Apply C biquads to x: (..., T) -> (..., T, C)."""
    batch_shape = x.shape[:-1]
    t = x.shape[-1]
    ys, _ = biquad_filterbank_streaming(x.reshape(-1, t), coeffs)
    return ys.reshape(*batch_shape, t, ys.shape[-1])


def full_wave_rectify(y: torch.Tensor) -> torch.Tensor:
    """The FWR stage |x| (the PFD-based time-domain rectifier on silicon)."""
    return torch.abs(y)


def frame_average(y: torch.Tensor, frame_len: int) -> torch.Tensor:
    """Averaging LPF + subsampler: (..., T, C) -> (..., T//frame_len, C)."""
    t = y.shape[-2]
    n_frames = t // frame_len
    y = y[..., : n_frames * frame_len, :]
    shape = y.shape[:-2] + (n_frames, frame_len, y.shape[-1])
    return y.reshape(shape).mean(dim=-2)


#: Window of XLA's CPU reduction rewrite, and so of every frame sum.
SUM_BLOCK = 32


def frame_sum(a: torch.Tensor, frame_len: int) -> torch.Tensor:
    """(B, T, C) -> (B, T // frame_len, C) frame sums in the order of the
    reference's compiled reductions: XLA's CPU backend splits a long
    reduction into windows of `SUM_BLOCK`, so the samples are summed left
    to right in consecutive blocks of 32 and the block sums left to
    right. Explicit adds, so the bits are the same on every device."""
    b, t, c = a.shape
    a = a[:, : (t // frame_len) * frame_len].reshape(b, t // frame_len, frame_len, c)
    total = None
    for start in range(0, frame_len, SUM_BLOCK):
        part = a[:, :, start]
        for i in range(start + 1, min(start + SUM_BLOCK, frame_len)):
            part = part + a[:, :, i]
        total = part if total is None else total + part
    return total


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over dim 0 of a float32 tensor (N, ...) in the order of
    XLA's CPU reduce: past one window (`SUM_BLOCK`, 32) the rows are padded
    with zeros evenly to whole windows (the odd zero after them), each
    window is summed left to right from 0, then the window sums the same
    way; 32 rows or fewer are summed left to right from 0. Explicit adds,
    so the bits are the same on every device."""
    n = x.shape[0]
    if n > SUM_BLOCK:
        pad, rest = -n % SUM_BLOCK, x.shape[1:]
        x = torch.cat([x.new_zeros((pad // 2, *rest)), x,
                       x.new_zeros((pad - pad // 2, *rest))])
        wins = x.reshape(-1, SUM_BLOCK, *rest)
        acc = torch.zeros_like(wins[:, 0])
        for i in range(SUM_BLOCK):
            acc = acc + wins[:, i]
        return xla_sum(acc)
    acc = x.new_zeros(x.shape[1:])
    for i in range(n):
        acc = acc + x[i]
    return acc


def eager_mean_std(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column mean and population std of float32 rows (N, C), as the
    reference's eager ``x.mean(0)`` and ``x.std(0)`` compute them on the
    CPU. The mean is `xla_sum` times float32(1/N): XLA folds the division
    by a constant into that product. The std takes d = x - mean and d * d,
    each rounded, sums them by `xla_sum`, and divides by N: a true
    division, since the jitted ``_std`` gets ``ddof`` as a traced argument
    and its divisor is no constant. At N <= 32 XLA fuses it all into one
    loop and contracts ``d * d + acc`` into an FMA. The same float32
    operations on every device, so the bits are the same."""
    n = flat.shape[0]
    mu = xla_sum(flat) * torch.tensor(1.0 / n, dtype=torch.float32).item()
    d = flat - mu
    if n > SUM_BLOCK:
        sq = xla_sum(d * d)
    else:
        sq = flat.new_zeros(flat.shape[1:])
        for i in range(n):
            sq = fma_f32(d[i], d[i], sq)
    # a CUDA tensor divided by a Python number is multiplied by its
    # reciprocal; the vectorized CPU torch.sqrt is an ulp off on ~0.6 % of
    # inputs, while the float64 root of a float32 rounds to it correctly
    var = sq / torch.full_like(sq, float(n))
    return mu, torch.sqrt(var.double()).float()


def fex_frames(
    audio: torch.Tensor, config: FExConfig, coeffs=None
) -> torch.Tensor:
    """audio (B, T @ fs_audio) -> rectified-average frames (B, F, C), float:
    oversampling, then K1 (`repro_torch.kernels.fex_fused.fex_fused`)
    with ``coeffs`` (None: the nominal filterbank)."""
    from repro_torch.kernels.fex_fused.ops import fex_fused

    x = oversample2x(audio) if config.oversample == 2 else audio
    return fex_fused(
        x, config.filterbank() if coeffs is None else coeffs, config.frame_len
    )


def fex_forward(
    audio: torch.Tensor,
    config: FExConfig,
    norm_stats: Optional[FExNormStats] = None,
    use_log: bool = True,
    use_norm: bool = True,
    frames: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full FEx: audio -> (fv_norm, fv_raw).

    fv_raw : float codes of the 12-bit quantizer, shape (B, F, C).
    fv_norm: the classifier input on the Q6.8 grid; use_log / use_norm
      reproduce the Fig. 2 ablation as in the reference.
    `frames` short-circuits the filterbank when precomputed.
    """
    if frames is None:
        frames = fex_frames(audio, config)
    fv_raw = quant.quantize_unsigned(
        frames, config.quant_bits, config.quant_full_scale
    )
    x = fv_raw
    if use_log:
        x = quant.log_compress_lut(x, config.quant_bits, config.log_bits)
    if use_norm:
        if norm_stats is None:
            raise ValueError("use_norm=True requires norm_stats (mu/sigma)")
        x = (x - norm_stats.mu) / norm_stats.sigma
    else:
        in_bits = config.log_bits if use_log else config.quant_bits
        x = x * 2.0 ** -(in_bits - 5)
    return quant.fake_quant(x, quant.ACT_Q6_8), fv_raw


def fit_norm_stats(fv_log: torch.Tensor, eps: float = 1e-3) -> FExNormStats:
    """mu/sigma over all frames of the training set (per channel), as the
    reference's eager fit (`src/repro/core/fex.py:267-271`) computes them
    (`eager_mean_std`)."""
    mu, std = eager_mean_std(fv_log.reshape(-1, fv_log.shape[-1]))
    return FExNormStats(mu=mu, sigma=std + eps)
