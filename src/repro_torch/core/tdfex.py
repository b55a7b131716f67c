"""Behavioral simulation of the time-domain analog FEx (paper Section III).

PyTorch counterpart of `repro.core.tdfex`. Signal chain (Fig. 3):

  VTC      voltage -> PWM duty, linear plus HD2/HD3 distortion (-70 dB,
           Fig. 7) and input-referred noise (248 uV_RMS, Fig. 17c).
  Rec-BPF  the SRO Tow-Thomas biquad of eq. (5) with PFD full-wave
           rectification: the bilinear biquad + |.|, on a die whose
           centre frequencies carry the chip's mismatch.
  SRO PFM + DeltaSigma TDC
           f = (f_free + k_sro * u) * (1 + gain mismatch); the 15-phase
           counter samples floor(15 * phase) at the TDC rate; XOR
           differentiators and a first-order CIC decimate by R, which
           telescopes to floor-quantized phase increments per frame.
  post     beta offset, alpha gain calibration and the 12-bit code scale.

The arithmetic follows the reference's compiled (XLA, CPU) graph, which
is the oracle: products used once are contracted into fused
multiply-adds (``f_free + k_sro * u``, the VTC's cubic term), the
cumulative phase is summed in the blocked order of XLA's reduce-window
rewrite (`blocked_cumsum`), and ``/ full_scale * 4095`` is one product
with the folded constant (`fv_scale`). Noise is drawn from explicit
`torch.Generator`s, so it matches the reference in its statistics, not
its values.

Rates: the TDC runs at 64 kHz (2x the 32 kHz internal rate) with
R = 1024, so frames are exactly 16 ms, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.fex import FExConfig, biquad_filterbank, fma_f32, oversample2x
from repro_torch.core.filters import BiquadCoeffs, design_bandpass_biquad, design_filterbank

__all__ = [
    "TDFExConfig",
    "TDFExState",
    "draw_chip",
    "vtc",
    "design_mismatched_filterbank",
    "rec_bpf",
    "blocked_cumsum",
    "sro_frequency",
    "sro_tdc",
    "tdfex_raw_counts",
    "fv_scale",
    "counts_to_fv_raw",
    "tdfex_forward",
]


def _f32(v: float) -> float:
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class TDFExConfig:
    fex: FExConfig = dataclasses.field(default_factory=FExConfig)
    # --- VTC (Section III-A) ---
    vtc_hd2_db: float = -70.0  # 2nd-harmonic distortion (post-layout, Fig. 7)
    vtc_hd3_db: float = -70.0
    input_noise_rms: float = 248e-6 / 0.125  # 248 uV_RMS at 0.125 full scale
    # --- SRO PFM encoder / TDC (Sections III-B/D) ---
    tdc_oversample: int = 2  # TDC rate = 2 x 32 kHz = 64 kHz
    decimation: int = 1024  # R: 64 kHz / 1024 -> 16 ms frames
    n_phases: int = 15  # ring oscillator taps
    f_free_hz: float = 4000.0  # SRO free-running frequency (offset beta)
    k_sro_hz: float = 120000.0  # Hz per unit rectified input (gain)
    # --- mismatch (Fig. 17a) ---
    gain_mismatch_sigma: float = 0.15
    cf_mismatch_sigma: float = 0.03
    phase_noise_rms: float = 0.0  # optional per-step phase jitter (cycles)

    @property
    def f_tdc(self) -> float:
        return self.fex.fs_internal * self.tdc_oversample

    @property
    def beta_nominal(self) -> float:
        """Free-running counts per frame: f_free * n_phases * R / f_tdc."""
        return self.f_free_hz * self.n_phases * self.decimation / self.f_tdc

    def counts_per_frame(self, u: float) -> float:
        """Ideal (unquantized) counts for constant rectified input u."""
        return (
            (self.f_free_hz + self.k_sro_hz * u)
            * self.n_phases
            * self.decimation
            / self.f_tdc
        )


@dataclasses.dataclass(frozen=True)
class TDFExState:
    """Per-chip mismatch realization (drawn once per simulated die)."""

    gain_mismatch: torch.Tensor  # (C,) multiplicative, ~N(0, sigma)
    cf_mismatch: torch.Tensor  # (C,) multiplicative on f0


def draw_chip(
    generator: Optional[torch.Generator], cfg: TDFExConfig, device=None
) -> TDFExState:
    """A die's gain and centre-frequency mismatch, (C,) float32 each,
    drawn from ``generator`` (on its device) and placed on ``device``
    (default: the generator's). Without a generator the draw takes the
    default generator of ``device``, which defaults to the card
    (`kernels.build.resolve_device`: raises where there is none)."""
    from repro_torch.kernels.build import resolve_device

    c = cfg.fex.num_channels
    if generator is not None:
        gdev = generator.device
    else:
        gdev = device = resolve_device(device)
    draw = lambda: torch.randn((c,), generator=generator, device=gdev)  # noqa: E731
    gm, cm = draw(), draw()
    return TDFExState(
        gain_mismatch=(cfg.gain_mismatch_sigma * gm).to(device or gdev),
        cf_mismatch=(cfg.cf_mismatch_sigma * cm).to(device or gdev),
    )


def _noise(shape, generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    gdev = generator.device
    return torch.randn(shape, generator=generator, device=gdev).to(like.device)


def vtc(
    audio: torch.Tensor,
    cfg: TDFExConfig,
    generator: Optional[torch.Generator] = None,
    audio_rate: bool = True,
) -> torch.Tensor:
    """VTC: audio at fs_audio -> PWM duty at fs_internal (32 kHz).

    ``y = x + hd2*x*x + hd3*x*x*x``, as the reference's compiled graph
    rounds it: the cubic term is one fused multiply-add; with hd2 == hd3
    XLA shares the product ``hd2*x*x`` between both terms, so the
    quadratic addition is not fused, otherwise it is. ``generator`` adds
    the input-referred noise. ``audio_rate=False``: the stimulus is
    already at fs_internal (the calibration bench's analog tones).
    """
    x = oversample2x(audio) if (audio_rate and cfg.fex.oversample == 2) else audio
    hd2 = _f32(10.0 ** (cfg.vtc_hd2_db / 20.0))
    hd3 = _f32(10.0 ** (cfg.vtc_hd3_db / 20.0))
    if hd2 == hd3:
        p = (x * hd2) * x
        y = fma_f32(p, x, x + p)
    else:
        y = fma_f32((x * hd3) * x, x, fma_f32(x * hd2, x, x))
    if generator is not None and cfg.input_noise_rms > 0:
        y = y + cfg.input_noise_rms * _noise(y.shape, generator, y)
    return y


def design_mismatched_filterbank(
    cfg: TDFExConfig, chip: Optional[TDFExState] = None
) -> BiquadCoeffs:
    """The (possibly mismatched) Rec-BPF filterbank of one die: the
    biquads redesigned at f0 * (1 + cf mismatch), in numpy; designed once
    per die (the chip's filterbank is fixed hardware)."""
    fexc = cfg.fex
    if chip is None:
        return fexc.filterbank()
    f0 = np.asarray(
        design_filterbank(
            fexc.num_channels, fexc.fs_internal, fexc.f_lo, fexc.f_hi, fexc.q
        ).f0
    )
    f0 = f0 * (1.0 + np.asarray(chip.cf_mismatch.detach().cpu(), np.float32))
    f0 = np.clip(f0, 10.0, fexc.fs_internal / 2 * 0.95)
    return design_bandpass_biquad(f0, fs=fexc.fs_internal, q=fexc.q)


def rec_bpf(
    duty: torch.Tensor, cfg: TDFExConfig, chip: Optional[TDFExState] = None
) -> torch.Tensor:
    """16-channel rectifying BPF: duty (B, T) -> rectified (B, T, C); on a
    CUDA tensor the filterbank is the scan entry of the K1 kernel."""
    return torch.abs(biquad_filterbank(duty, design_mismatched_filterbank(cfg, chip)))


def _inclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right inclusive sums along the last axis, one add each."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, dim=-1)


def blocked_cumsum(x: torch.Tensor, dim: int, base: int = 16) -> torch.Tensor:
    """Inclusive float32 cumulative sum in the order of the reference's
    compiled ``jnp.cumsum`` on the CPU.

    XLA rewrites the cumulative reduce-window into blocks of ``base``:
    left-to-right sums inside each block, the block totals scanned the
    same way (recursively), and each block's sums offset by the sum of
    the blocks before it. The same adds in the same order give the same
    bits on any device, unlike ``torch.cumsum`` (float64 accumulation on
    the CPU, a parallel scan on the card).
    """
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= base:
        out = _inclusive_scan(x)
    else:
        m = -(-n // base)
        pad = m * base - n
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
        inner = _inclusive_scan(x.reshape(x.shape[:-1] + (m, base)))
        prefix = blocked_cumsum(inner[..., -1], -1, base)
        excl = torch.cat([prefix.new_zeros(prefix.shape[:-1] + (1,)), prefix[..., :-1]], dim=-1)
        out = (inner + excl[..., None]).reshape(x.shape[:-1] + (m * base,))[..., :n]
    return out.movedim(-1, dim)


def sro_frequency(
    u: torch.Tensor, cfg: TDFExConfig, gain: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Instantaneous SRO frequency ``max((f_free + k_sro*u) * gain, 0)``
    (Hz), with ``f_free + k_sro*u`` one fused multiply-add as compiled;
    ``gain`` None is the mismatch-free die (no product at all)."""
    f = fma_f32(u, u.new_tensor(_f32(cfg.k_sro_hz)), u.new_tensor(_f32(cfg.f_free_hz)))
    if gain is not None:
        f = f * gain
    return torch.clamp_min(f, 0.0)


def _gain(chip: Optional[TDFExState], like: torch.Tensor) -> Optional[torch.Tensor]:
    if chip is None:
        return None
    return 1.0 + chip.gain_mismatch.to(device=like.device, dtype=torch.float32)


def sro_tdc(
    rectified: torch.Tensor,
    cfg: TDFExConfig,
    chip: Optional[TDFExState] = None,
    generator: Optional[torch.Generator] = None,
    return_diff_stream: bool = False,
):
    """SRO PFM encoder + 1st-order DeltaSigma TDC + XOR diff + CIC decimate.

    rectified: (B, T, C) at fs_internal. Returns float32 counts per frame
    (B, F, C); with ``return_diff_stream`` also the differentiator stream
    (B, T * tdc_oversample, C). ``generator`` adds SRO phase jitter.
    """
    b, _, c = rectified.shape
    f_inst = sro_frequency(rectified, cfg, _gain(chip, rectified))
    step = torch.repeat_interleave(f_inst * _f32(1.0 / cfg.f_tdc), cfg.tdc_oversample, dim=1)
    phase = blocked_cumsum(step, dim=1)  # cycles (lossless integrator)
    if generator is not None and cfg.phase_noise_rms > 0:
        phase = phase + cfg.phase_noise_rms * _noise(phase.shape, generator, phase)
    counts = torch.floor(phase * float(cfg.n_phases))  # 15-phase counter samples
    prev = torch.cat([torch.zeros_like(counts[:, :1]), counts[:, :-1]], dim=1)
    diff = counts - prev  # XOR differentiator
    r = cfg.decimation
    n_frames = diff.shape[1] // r
    # first-order CIC: the boxcar of R differences; integers, exact in any order
    fv_counts = diff[:, : n_frames * r].reshape(b, n_frames, r, c).sum(dim=2)
    if return_diff_stream:
        return fv_counts, diff
    return fv_counts


def tdfex_raw_counts(
    audio: torch.Tensor,
    cfg: TDFExConfig,
    chip: Optional[TDFExState] = None,
    generator: Optional[torch.Generator] = None,
    audio_rate: bool = True,
) -> torch.Tensor:
    """audio (B, T) -> TDC counts (B, F, C): the chip's FV before post-proc.
    ``generator`` draws the VTC noise and the SRO jitter."""
    duty = vtc(audio, cfg, generator, audio_rate=audio_rate)
    rect = rec_bpf(duty, cfg, chip)
    return sro_tdc(rect, cfg, chip, generator)


def fv_scale(cfg: TDFExConfig) -> float:
    """``4095 / full_scale_counts`` as the compiled graph folds it: the
    float32 reciprocal of the count-domain full scale times 4095, in
    float32 (0.203125 for the paper's values). The full scale is
    ``k_sro * quant_full_scale`` worth of rectified input, in counts."""
    full_scale_counts = (
        cfg.k_sro_hz
        * cfg.fex.quant_full_scale
        * cfg.n_phases
        * cfg.decimation
        / cfg.f_tdc
    )
    return _f32(_f32(1.0 / _f32(full_scale_counts)) * (2.0**cfg.fex.quant_bits - 1.0))


def counts_to_fv_raw(
    counts: torch.Tensor,
    cfg: TDFExConfig,
    beta,
    alpha,
) -> torch.Tensor:
    """Offset / gain calibration into the 12-bit code domain of the
    software model: ``clip(round(alpha * (counts - beta) * fv_scale))``."""
    sig = alpha * (counts - beta)
    codes = torch.round(sig * fv_scale(cfg))
    return torch.clamp(codes, 0.0, 2.0**cfg.fex.quant_bits - 1.0)


def tdfex_forward(
    audio: torch.Tensor,
    cfg: TDFExConfig,
    beta,
    alpha,
    chip: Optional[TDFExState] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Full hardware-sim FEx to FV_Raw codes (B, F, C)."""
    counts = tdfex_raw_counts(audio, cfg, chip, generator)
    return counts_to_fv_raw(counts, cfg, beta, alpha)
