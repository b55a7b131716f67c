"""Plain version of the fit's row chain (``csrc/fma_rows.cu``).

``acc = fma(d[i], xs[i], acc)`` over the rows in order from zero, each
step rounded once to float32, as the reference's compiled gradient of
the linear detector's loss takes the weight gradient: XLA's CPU code
takes that product as a column-major GEMV, and at most one channel
(`head_channel`) is taken otherwise: its first tile of up to
`HEAD_ROWS` rows multiplies and adds apart (acc = d[0] xs[0], then
acc + d[i] xs[i] with the product and the sum each rounded), and the
fused chain runs from row 8 on. That channel is the GEMV's first channel
past its 8-channel tiles where there is exactly one (C = 8k + 1), and
channel 0 where C = 2 (the code LLVM makes of those widths' first tile);
each from 3 rows up. At one channel the head is taken past `FUSED_ROWS`
rows only: up to them XLA fuses the dot into the elementwise work that
forms d, and that fusion's loop is the fused chain from row 0.
The kernel runs the same steps with the card's rounded multiply, add and
fused multiply-add, so kernel and plain agree bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.fex import fma_f32

__all__ = ["FUSED_ROWS", "HEAD_ROWS", "fma_rows_ref", "head_channel"]

_F32_MIN_NORMAL = 1.1754943508222875e-38
#: Rows that, on the `head_channel`, are multiplied and added apart before
#: the fused chain (XLA's 8-row GEMV tile, the first one peeled).
HEAD_ROWS = 8
#: Rows up to which, at one channel, XLA fuses the dot into the
#: elementwise work and runs the fused chain from row 0.
FUSED_ROWS = 32
#: Rows from which a channel of C >= 2 takes the head (at 2 rows the
#: compiled code fuses the second step as well).
HEAD_FROM = 3


def head_channel(n: int, c: int) -> int:
    """The channel whose first rows (up to `HEAD_ROWS`) are multiplied and
    added apart for ``n`` rows of ``c`` channels, or -1 for none: at C = 1
    channel 0 past `FUSED_ROWS` rows; at C = 2 channel 0, and at C = 8k + 1
    (k >= 1) channel C - 1, from `HEAD_FROM` rows."""
    if c == 1:
        return 0 if n > FUSED_ROWS else -1
    if n < HEAD_FROM:
        return -1
    if c == 2:
        return 0
    return c - 1 if c % 8 == 1 else -1


def _head(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A chain over the rows of ``d`` (N,) and ``x`` (N, C) with each
    product and each sum rounded apart, float32."""
    acc = d[0] * x[0]
    for i in range(1, d.shape[0]):
        acc = acc + d[i] * x[i]
    return acc


def _fused(d: torch.Tensor, xs: torch.Tensor, acc32: torch.Tensor) -> torch.Tensor:
    """The fused chain over the rows from ``acc32``. Each product is exact
    in float64, so a step is RN32(RN64(p + acc)), which equals the fused
    RN32(p + acc) unless the float64 sum lands on a midpoint of two float32
    values (or below the smallest normal). The sums are checked for that
    afterwards; where one does, the chain is taken again with `fma_f32`
    step by step."""
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


def fma_rows_ref(d: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(N,) and (N, C) float32 -> (C,) float32, on their device: the fused
    chain from zero on every channel, but on the `head_channel` its first
    rows (up to `HEAD_ROWS`) taken apart first (`_head`)."""
    n, c = xs.shape
    h = head_channel(n, c)
    if h < 0:
        return _fused(d, xs, torch.zeros(c, dtype=torch.float32, device=xs.device))
    start = min(HEAD_ROWS, n)
    col = xs[:, h:h + 1]
    head = _fused(d[start:], col[start:], _head(d[:start], col[:start]))
    if c == 1:
        return head
    rest = torch.cat([xs[:, :h], xs[:, h + 1:]], dim=1)
    rest = _fused(d, rest, torch.zeros(c - 1, dtype=torch.float32, device=xs.device))
    return torch.cat([rest[:h], head, rest[h:]])
