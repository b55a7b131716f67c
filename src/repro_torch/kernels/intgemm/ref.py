"""Plain version of the integer GEMM: exact int64 sum, then int24 clip.

Counterpart of `repro.kernels.intgemm.ref.intgemm_ref`. Products of
14-bit activation codes and 8-bit weight codes are < 2^20, so the sum is
exact for any K the classifier uses; the only nonlinearity is the final
saturation to the IC's 24-bit HPE accumulator range. Written as a
broadcast product and sum because CUDA has no integer matmul.
"""

from __future__ import annotations

import torch

INT24_MAX = 2**23 - 1
INT24_MIN = -(2**23)


def intgemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int codes x (K, N) int8 -> (M, N) int32, saturated to int24."""
    acc = (x.to(torch.int64).unsqueeze(-1) * w.to(torch.int64)).sum(dim=-2)
    return torch.clamp(acc, INT24_MIN, INT24_MAX).to(torch.int32)
