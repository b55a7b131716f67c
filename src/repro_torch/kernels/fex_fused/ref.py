"""Plain versions of the batch filterbank kernels (``csrc/fex_fused.cu``).

Counterpart of `repro.kernels.fex_fused.ref.fex_fused_ref`. The IIR is
the port's plain scan (`repro_torch.core.fex`, fused multiply-adds where
the reference's compiled scan has them). The frame sum of |y| runs in
the order of the reference's compiled frame mean (`core.fex.frame_sum`:
blocks of 32 samples, then the block sums); the mean is
``sum * (1 / frame_len)``, as XLA folds the division. The kernel sums in the same
order, so kernel and plain agree bit for bit, and both equal the
reference's XLA tier.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fex import biquad_scan, frame_sum
from repro_torch.core.filters import BiquadCoeffs

__all__ = ["biquad_stream_ref", "fex_fused_ref", "stacked_coeffs"]


def stacked_coeffs(coeffs, device) -> torch.Tensor:
    """BiquadCoeffs or a stacked (5, C) array -> (5, C) float32 on
    ``device``. Coefficients stay float32 whatever the audio's dtype."""
    if isinstance(coeffs, BiquadCoeffs):
        return coeffs.stacked(device=device)
    return torch.as_tensor(coeffs, dtype=torch.float32, device=device)


def biquad_stream_ref(
    x: torch.Tensor,
    coeffs,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(B, T) -> (y (B, T, C), (s1, s2)): the plain scan of the
    ``biquad_stream_launch`` entry."""
    return biquad_scan(x, stacked_coeffs(coeffs, x.device), state)


def fex_fused_ref(x: torch.Tensor, coeffs, frame_len: int) -> torch.Tensor:
    """(B, T) float32 or bfloat16 -> (B, T // frame_len, C) float32 frames
    of mean |y|, the IIR carry running on across frames."""
    x = x.float()
    y, _ = biquad_scan(x, stacked_coeffs(coeffs, x.device))
    return frame_sum(torch.abs(y), frame_len) * float(np.float32(1.0 / frame_len))
