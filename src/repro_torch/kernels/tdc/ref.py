"""Plain versions of the SRO ΔΣ TDC kernel (``csrc/tdc.cu``).

`tdc_counts_plain` is the kernel's arithmetic in float32, one PyTorch op
at a time: the fractional-carry loop of the reference's Pallas body
(``src/repro/kernels/tdc/kernel.py:35 _tdc_kernel``), with ``f0 + k*u``
as one fused multiply-add where the reference's compiled body contracts
it. `tdc_counts_ref` is a copy of the reference's exact float64 numpy
oracle (`repro.kernels.tdc.ref.tdc_counts_ref`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fex import fma_f32

__all__ = ["tdc_counts_plain", "tdc_counts_ref"]


def tdc_counts_plain(
    u: torch.Tensor,  # (B, T, C) float32 rectified input, T whole frames
    f0_eff: torch.Tensor,  # (C,)
    k_eff: torch.Tensor,  # (C,)
    samples_per_frame: int,
    os: int,
    scale: float,  # n_phases / f_tdc, exactly a float32
) -> torch.Tensor:
    """(B, T, C) -> (B, T // samples_per_frame, C) float32 counts.

    Per sample ``delta = scale * max(f0 + k*u, 0)``; per ZOH tick (``os``
    a sample) ``r += delta; incr = floor(r); r -= incr; acc += incr``,
    ``acc`` written and zeroed per frame. The carry r runs on across
    frames. The frame sum is taken tick by tick, as the reference's body
    does: a frame's count past 2^24 rounds, and then only that order
    agrees with it.
    """
    b, t, c = u.shape
    n_frames = t // samples_per_frame
    delta = torch.clamp_min(fma_f32(k_eff, u, f0_eff), 0.0) * scale
    r = torch.zeros((b, c), dtype=torch.float32, device=u.device)
    counts = []
    for f in range(n_frames):
        acc = torch.zeros_like(r)
        for i in range(f * samples_per_frame, (f + 1) * samples_per_frame):
            d = delta[:, i]
            for _ in range(os):
                r = r + d
                incr = torch.floor(r)
                r = r - incr
                acc = acc + incr
        counts.append(acc)
    if not counts:
        return torch.zeros((b, 0, c), dtype=torch.float32, device=u.device)
    return torch.stack(counts, dim=1)


def tdc_counts_ref(
    u: np.ndarray,  # (B, T, C) rectified input at the internal rate
    f0_eff: np.ndarray,  # (C,)
    k_eff: np.ndarray,  # (C,)
    samples_per_frame: int,
    os: int,
    f_tdc: float,
    n_phases: int = 15,
) -> np.ndarray:
    """Exact float64 oracle: (B, F, C) counts from the cumulative phase."""
    u = np.asarray(u, np.float64)
    b, t, c = u.shape
    n_frames = t // samples_per_frame
    u = u[:, : n_frames * samples_per_frame, :]
    uu = np.repeat(u, os, axis=1)
    f = np.maximum(
        np.asarray(f0_eff, np.float64)[None, None, :]
        + np.asarray(k_eff, np.float64)[None, None, :] * uu,
        0.0,
    )
    phase = np.cumsum(f / f_tdc, axis=1)
    counts = np.floor(n_phases * phase)
    ticks_per_frame = samples_per_frame * os
    frame_edges = counts[:, ticks_per_frame - 1 :: ticks_per_frame, :]
    prev = np.concatenate([np.zeros((b, 1, c)), frame_edges[:, :-1, :]], axis=1)
    return (frame_edges - prev).astype(np.float64)
