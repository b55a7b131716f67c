"""Per-chip calibration, mirroring the measurement flow of Section III-F.

PyTorch counterpart of `repro.core.calibration`. The chip requires:

  beta     — per-channel offset = free-running SRO counts per frame,
             measured with a zero input (Fig. 13's offset subtractor);
  alpha    — per-channel gain correction, measured with a reference sine
             at each channel's centre frequency (Fig. 17a -> 17b);
  mu/sigma — mean / std of FV_Log over the training set, for the input
             normalizer (Section III-F applies the same mu/sigma at test
             time).

`calibrate_state` packages the bench flow into the `FrontendState` the
"hardware" / "hardware-pallas" frontends consume. The measurements run
on ``device`` (the card by default), through the same VTC, Rec-BPF and
cumulative-phase TDC as the "hardware" frontend.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.fex import FExNormStats, eager_mean_std
from repro_torch.core.filters import design_filterbank
from repro_torch.core.frontend import FrontendState, hardware_state
from repro_torch.core.tdfex import TDFExConfig, TDFExState, tdfex_raw_counts
from repro_torch.kernels.build import resolve_device

__all__ = [
    "measure_beta",
    "measure_alpha",
    "calibrate_chip",
    "calibrate_state",
    "fit_norm_stats_from_counts",
]


def _chip_on(chip: Optional[TDFExState], device) -> Optional[TDFExState]:
    if chip is None:
        return None
    return TDFExState(
        gain_mismatch=chip.gain_mismatch.to(device), cf_mismatch=chip.cf_mismatch.to(device)
    )


def measure_beta(
    cfg: TDFExConfig,
    chip: Optional[TDFExState] = None,
    n_frames: int = 16,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Zero-input measurement of the free-running offset (counts/frame),
    (C,) float32 on ``device``."""
    device = resolve_device(device)
    t = int(cfg.fex.fs_audio * n_frames * cfg.fex.frame_shift_ms / 1000.0)
    silence = torch.zeros((1, t), dtype=torch.float32, device=device)
    counts = tdfex_raw_counts(silence, cfg, _chip_on(chip, device), generator)
    # drop the first frames (filter settling) and average
    return _mean(counts[0, 2:, :], 0)


def measure_alpha(
    cfg: TDFExConfig,
    beta: torch.Tensor,
    chip: Optional[TDFExState] = None,
    amplitude: float = 0.25,
    n_frames: int = 24,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Reference-tone gain equalization, (C,) float32 on ``device``.

    Each channel is driven with a sine at its design centre frequency,
    and alpha makes every channel report the same signal counts; alpha
    is normalized to mean 1 (pure equalization, no overall gain).
    """
    device = resolve_device(device)
    fexc = cfg.fex
    f0 = np.asarray(
        design_filterbank(
            fexc.num_channels, fexc.fs_internal, fexc.f_lo, fexc.f_hi, fexc.q
        ).f0
    )
    # analog tones at the internal rate (the function generator of Fig. 16
    # is not band-limited by the dataset's 16 kHz sampling)
    t = int(fexc.fs_internal * n_frames * fexc.frame_shift_ms / 1000.0)
    ts = np.arange(t) / fexc.fs_internal
    tones = torch.as_tensor(
        (amplitude * np.sin(2 * np.pi * f0[:, None] * ts[None, :])).astype(np.float32),
        device=device,
    )  # (C, T): one tone per channel
    counts = tdfex_raw_counts(tones, cfg, _chip_on(chip, device), generator, audio_rate=False)
    settled = _mean(counts[:, 4:, :], 1)  # (C, C), settling frames dropped
    own = torch.clamp_min(torch.diagonal(settled) - beta.to(device), 1e-6)
    alpha = _mean(own, 0) / own
    return alpha / _mean(alpha, 0)


def _mean(v: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.mean`` as the reference's compiled reduction evaluates it:
    summed left to right along ``dim``, then multiplied by the float32
    reciprocal of the count (XLA folds the division)."""
    v = v.movedim(dim, 0)
    total = v[0]
    for x in v[1:]:
        total = total + x
    return total * float(np.float32(1.0 / v.shape[0]))


def calibrate_chip(
    cfg: TDFExConfig,
    chip: Optional[TDFExState] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full per-chip calibration -> (beta, alpha); ``generator`` draws the
    bench's noise for both measurements."""
    beta = measure_beta(cfg, chip, generator=generator, device=device)
    alpha = measure_alpha(cfg, beta, chip, generator=generator, device=device)
    return beta, alpha


def calibrate_state(
    cfg: TDFExConfig,
    chip: Optional[TDFExState] = None,
    generator: Optional[torch.Generator] = None,
    norm_stats: Optional[FExNormStats] = None,
    device=None,
) -> FrontendState:
    """Full bench calibration -> the `FrontendState` the hardware
    frontends consume: beta / alpha plus the die's Rec-BPF coefficients,
    on ``device`` (the card by default). ``norm_stats`` can be attached
    now or later (`FrontendState.with_norm_stats`)."""
    device = resolve_device(device)
    beta, alpha = calibrate_chip(cfg, chip, generator, device=device)
    return hardware_state(cfg, chip, beta=beta, alpha=alpha, norm_stats=norm_stats,
                          device=device)


def fit_norm_stats_from_counts(
    fv_raw: torch.Tensor, cfg: TDFExConfig, eps: float = 1e-3
) -> FExNormStats:
    """mu/sigma of FV_Log over recorded training-set features (B, F, C).

    FV_Log comes from the closed-form log (`quant.log_compress_eager`), as
    the reference's eager fit computes it: 512 at code 63, where the ROM
    the serving tick reads gives 511 (ROADMAP queue 3, P1). mu and sigma
    follow the reference's eager ``flat.mean(0)`` / ``flat.std(0)``
    (`src/repro/core/calibration.py:133-141`, `fex.eager_mean_std`)."""
    fv_log = quant.log_compress_eager(fv_raw, cfg.fex.quant_bits, cfg.fex.log_bits)
    mu, std = eager_mean_std(fv_log.reshape(-1, fv_log.shape[-1]))
    return FExNormStats(mu=mu, sigma=std + eps)
