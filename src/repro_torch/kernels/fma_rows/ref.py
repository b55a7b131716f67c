"""Plain version of the fit's row chain (``csrc/fma_rows.cu``).

``acc = fma(d[i], xs[i], acc)`` over the rows in order from zero, each
step rounded once to float32, as the reference's compiled gradient of
the linear detector's loss takes the weight gradient. At one channel and
more than `FUSED_ROWS` rows XLA's CPU code takes that product as a
column-major GEMV whose first tile of `HEAD_ROWS` rows multiplies and
adds apart: acc = d[0] xs[0], then acc + d[i] xs[i] with the product and
the sum each rounded, and the fused chain from row 8 on. At one channel
and up to `FUSED_ROWS` rows XLA fuses the dot into the elementwise work
that forms d, and that fusion's loop is the fused chain from row 0.
The kernel runs the same steps with the card's rounded multiply, add and
fused multiply-add, so kernel and plain agree bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.fex import fma_f32

__all__ = ["FUSED_ROWS", "HEAD_ROWS", "fma_rows_ref"]

_F32_MIN_NORMAL = 1.1754943508222875e-38
#: Rows that, at one channel, are multiplied and added apart before the
#: fused chain (XLA's 8-row GEMV tile, peeled for the first product).
HEAD_ROWS = 8
#: Rows up to which, at one channel, XLA fuses the dot into the
#: elementwise work and runs the fused chain from row 0.
FUSED_ROWS = 32


def _head(d: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The first HEAD_ROWS rows of a one-channel chain, float32."""
    acc = d[0] * xs[0]
    for i in range(1, HEAD_ROWS):
        acc = acc + d[i] * xs[i]
    return acc


def fma_rows_ref(d: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(N,) and (N, C) float32 -> (C,) float32, on their device.

    Each product is exact in float64, so a step is RN32(RN64(p + acc)),
    which equals the fused RN32(p + acc) unless the float64 sum lands on
    a midpoint of two float32 values (or below the smallest normal). The
    sums are checked for that afterwards; where one does, the chain is
    taken again with `fma_f32` step by step. At one channel and more
    than `FUSED_ROWS` rows the first `HEAD_ROWS` rows are taken apart
    first (`_head`)."""
    start = HEAD_ROWS if xs.shape[1] == 1 and xs.shape[0] > FUSED_ROWS else 0
    acc32 = (_head(d, xs) if start else
             torch.zeros(xs.shape[1], dtype=torch.float32, device=xs.device))
    d, xs = d[start:], xs[start:]
    p = d.double()[:, None] * xs.double()
    acc = acc32.double()
    sums = []
    for row in p:
        sums.append(row + acc)
        acc = sums[-1].float().double()
    if not sums:
        return acc32
    s = torch.stack(sums)
    low = s.view(torch.int64) & ((1 << 29) - 1)  # the bits float32 drops
    if bool(((low == 1 << 28) | ((s.abs() < _F32_MIN_NORMAL) & (s != 0))).any()):
        acc = acc32
        for i in range(xs.shape[0]):
            acc = fma_f32(d[i].expand_as(acc), xs[i], acc)
    return acc.float()
