"""Plain version of the fit's row chain (``csrc/fma_rows.cu``).

``acc = fma(d[i], xs[i], acc)`` over the rows in order from zero, each
step rounded once to float32, as the reference's compiled gradient of
the linear detector's loss takes the weight gradient. The kernel runs
the same chain with the card's fused multiply-add, so kernel and plain
agree bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.fex import fma_f32

__all__ = ["fma_rows_ref"]

_F32_MIN_NORMAL = 1.1754943508222875e-38


def fma_rows_ref(d: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(N,) and (N, C) float32 -> (C,) float32, on their device.

    Each product is exact in float64, so a step is RN32(RN64(p + acc)),
    which equals the fused RN32(p + acc) unless the float64 sum lands on
    a midpoint of two float32 values (or below the smallest normal). The
    sums are checked for that afterwards; where one does, the chain is
    taken again with `fma_f32` step by step."""
    p = d.double()[:, None] * xs.double()
    acc = torch.zeros(xs.shape[1], dtype=torch.float64, device=xs.device)
    sums = []
    for row in p:
        sums.append(row + acc)
        acc = sums[-1].float().double()
    if not sums:
        return acc.float()
    s = torch.stack(sums)
    low = s.view(torch.int64) & ((1 << 29) - 1)  # the bits float32 drops
    if bool(((low == 1 << 28) | ((s.abs() < _F32_MIN_NORMAL) & (s != 0))).any()):
        acc = torch.zeros(xs.shape[1], dtype=torch.float32, device=xs.device)
        for i in range(xs.shape[0]):
            acc = fma_f32(d[i].expand_as(acc), xs[i], acc)
    return acc.float()
