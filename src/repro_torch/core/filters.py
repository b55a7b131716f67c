"""Biquad band-pass filter design for the 16-channel FEx.

Counterpart of `repro.core.filters`: the same numpy design, kept here so
the port imports nothing of the JAX package.

The paper (Section II) models each analog channel as a *second-order
Butterworth band-pass filter* with Q = 2, center frequencies Mel-spaced
from 100 Hz to 8 kHz, running at a 32 kHz internal rate (the 16 kHz GSCD
audio is 2x oversampled so the top channel does not collide with Nyquist).

A second-order (one-pole-pair) Butterworth band-pass is exactly the
constant-Q biquad

    H(s) = (w0/Q) s / (s^2 + (w0/Q) s + w0^2)

discretized with the bilinear transform + frequency pre-warping (the RBJ
audio-EQ-cookbook BPF with unity peak gain, so each channel has 0 dB gain
at its center frequency).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "BiquadCoeffs",
    "mel_to_hz",
    "hz_to_mel",
    "mel_center_frequencies",
    "design_bandpass_biquad",
    "design_filterbank",
    "biquad_frequency_response",
]


@dataclasses.dataclass(frozen=True)
class BiquadCoeffs:
    """Normalized (a0 == 1) biquad coefficients for C channels.

    y[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2] - a1 y[n-1] - a2 y[n-2]

    Arrays all have shape (C,). For the band-pass design b1 == 0.
    """

    b0: np.ndarray
    b1: np.ndarray
    b2: np.ndarray
    a1: np.ndarray
    a2: np.ndarray
    fs: float
    f0: np.ndarray  # center frequencies (Hz), for reference
    q: float

    @property
    def num_channels(self) -> int:
        return int(self.b0.shape[0])

    def as_arrays(self, dtype=torch.float32, device=None):
        """(b0, b1, b2, a1, a2) as tensors of shape (C,) on ``device``
        (the card when None, as `stacked`)."""
        device = _resolve_device(device)
        return tuple(
            torch.as_tensor(v, dtype=dtype, device=device)
            for v in (self.b0, self.b1, self.b2, self.a1, self.a2)
        )

    def stacked(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """Shape (5, C): rows are b0, b1, b2, a1, a2, on ``device``
        (default: `kernels.build.resolve_device`, which raises where there
        is no card)."""
        rows = np.stack([self.b0, self.b1, self.b2, self.a1, self.a2])
        return torch.as_tensor(rows, dtype=dtype, device=_resolve_device(device))


def _resolve_device(device) -> torch.device:
    from repro_torch.kernels.build import resolve_device  # lazy: kernels import core

    return resolve_device(device)


def hz_to_mel(f_hz):
    """HTK-style Mel scale, as used for Mel-spaced analog filterbanks."""
    return 2595.0 * np.log10(1.0 + np.asarray(f_hz, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_center_frequencies(
    num_channels: int = 16, f_lo: float = 100.0, f_hi: float = 8000.0
) -> np.ndarray:
    """Center frequencies Mel-spaced from f_lo to f_hi inclusive."""
    mels = np.linspace(hz_to_mel(f_lo), hz_to_mel(f_hi), num_channels)
    return mel_to_hz(mels)


def design_bandpass_biquad(f0_hz, fs: float, q: float = 2.0) -> BiquadCoeffs:
    """Bilinear-transform design of the unity-peak-gain band-pass biquad.

    RBJ cookbook "BPF (constant 0 dB peak gain)":
        w0 = 2*pi*f0/fs ; alpha = sin(w0) / (2*Q)
        b = [alpha, 0, -alpha] / a0 ; a = [1+alpha, -2 cos w0, 1-alpha] / a0
    """
    f0 = np.atleast_1d(np.asarray(f0_hz, dtype=np.float64))
    if np.any(f0 <= 0) or np.any(f0 >= fs / 2):
        raise ValueError(
            f"center frequencies must lie in (0, fs/2); got {f0} at fs={fs}"
        )
    w0 = 2.0 * math.pi * f0 / fs
    alpha = np.sin(w0) / (2.0 * q)
    a0 = 1.0 + alpha
    b0 = alpha / a0
    b1 = np.zeros_like(b0)
    b2 = -alpha / a0
    a1 = (-2.0 * np.cos(w0)) / a0
    a2 = (1.0 - alpha) / a0
    return BiquadCoeffs(b0=b0, b1=b1, b2=b2, a1=a1, a2=a2, fs=fs, f0=f0, q=q)


def design_filterbank(
    num_channels: int = 16,
    fs: float = 32000.0,
    f_lo: float = 100.0,
    f_hi: float = 8000.0,
    q: float = 2.0,
) -> BiquadCoeffs:
    """The paper's 16-channel Mel filterbank at the 32 kHz internal rate."""
    return design_bandpass_biquad(
        mel_center_frequencies(num_channels, f_lo, f_hi), fs=fs, q=q
    )


def biquad_frequency_response(coeffs: BiquadCoeffs, freqs_hz) -> np.ndarray:
    """|H(e^{jw})| evaluated at freqs_hz. Shape (C, F). Pure numpy oracle."""
    f = np.asarray(freqs_hz, dtype=np.float64)
    z = np.exp(-1j * 2.0 * math.pi * f / coeffs.fs)  # z^-1, shape (F,)
    z = z[None, :]
    num = (
        coeffs.b0[:, None]
        + coeffs.b1[:, None] * z
        + coeffs.b2[:, None] * z**2
    )
    den = 1.0 + coeffs.a1[:, None] * z + coeffs.a2[:, None] * z**2
    return np.abs(num / den)
