"""Measurement stimuli (the function generator + sound card of Fig. 16).

Counterpart of `repro.data.audio`, copied: host-side numpy."""

from __future__ import annotations

import numpy as np

__all__ = ["sine", "multitone", "white_noise", "silence"]


def sine(freq_hz: float, duration_s: float, fs: float = 16000.0,
         amplitude: float = 0.125, phase: float = 0.0) -> np.ndarray:
    t = np.arange(int(duration_s * fs)) / fs
    return (amplitude * np.sin(2 * np.pi * freq_hz * t + phase)).astype(np.float32)


def multitone(freqs_hz, duration_s: float, fs: float = 16000.0,
              amplitude: float = 0.125) -> np.ndarray:
    t = np.arange(int(duration_s * fs)) / fs
    out = np.zeros_like(t)
    for i, f in enumerate(freqs_hz):
        out += np.sin(2 * np.pi * f * t + 0.7 * i)
    out /= max(len(list(freqs_hz)), 1)
    return (amplitude * out).astype(np.float32)


def white_noise(duration_s: float, fs: float = 16000.0, rms: float = 0.02,
                seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rms * rng.standard_normal(int(duration_s * fs))).astype(np.float32)


def silence(duration_s: float, fs: float = 16000.0) -> np.ndarray:
    return np.zeros(int(duration_s * fs), np.float32)
