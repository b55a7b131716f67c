"""Public entry point of the fit's row chain.

A CUDA tensor launches the hand-written kernel (``csrc/fma_rows.cu``); a
CPU tensor takes the plain version `fma_rows_ref`; any other device
raises. `repro_torch.serving.cascade.fit_linear_detector` takes its weight
gradient through it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fma_rows.ref import fma_rows_ref, head_channel

__all__ = ["FmaRowsGeometry", "fma_rows", "fma_rows_geometry", "stage_bytes"]

#: csrc/fma_rows.cu's limits: channels a block, chunks in flight, helper
#: warps, rows a chain step loads ahead, the ring's bytes and the barriers'
#: in front.
MAX_COLS = 256
MAX_STAGES = 16
HELPERS = 4
GROUP = 8
RING_BYTES = 192 * 1024
BARRIER_BYTES = 3 * MAX_STAGES * 8
#: Rows a chunk where two chunks fit the ring: a multiple of 32, so the
#: column-major copy's columns (rows + 4 words) start 4 banks apart; few
#: chunks, since the producer takes ~800 cycles to issue one.
CHUNK_ROWS = 256


@dataclasses.dataclass(frozen=True)
class FmaRowsGeometry:
    """How `csrc/fma_rows.cu` is launched: ``rows`` a chunk (a multiple of
    8), ``stages`` chunks in flight, ``cols`` channels a block (``blocks``
    blocks), whether d and xs go by bulk copy, whether every copy of the
    launch is a bulk copy (no cp.async words, not even a ragged chunk's
    last ones), and the dynamic shared bytes."""

    rows: int
    stages: int
    cols: int
    blocks: int
    bulk_d: bool
    bulk_x: bool
    bulk_only: bool
    smem: int

    @property
    def flags(self) -> int:
        return int(self.bulk_d) | (int(self.bulk_x) << 1) | (int(self.bulk_only) << 2)

    @property
    def threads(self) -> int:
        """A block's threads: a chain warp a 32 channels, the producer
        warp and the helper warps."""
        return 32 * (-(-self.cols // 32) + 1 + HELPERS)


def stage_bytes(rows: int, c: int) -> int:
    """A stage of the ring: d, the chunk of xs as it lands (a block's
    whole rows, or its slice where C > 256), its column-major copy
    (columns of rows + 4 words) and a group's words of padding (the chain
    loads one group past a chunk's last)."""
    cols = min(c, MAX_COLS)
    landed = c if cols == c else cols
    return 4 * (rows * (1 + landed) + cols * (rows + 4) + GROUP)


def fma_rows_geometry(n: int, c: int, d_aligned: bool = True,
                      x_aligned: bool = True) -> FmaRowsGeometry:
    """The launch geometry for ``n`` rows of ``c`` channels; ``d_aligned``
    / ``x_aligned``: the input's address is 16-byte aligned. A chunk of a
    multiple of 8 rows starts every d and xs run on a 16-byte boundary of
    an aligned base, so a bulk copy needs only that (and, for xs, one
    block owning whole rows: C <= 256); the few words past a ragged last
    chunk's whole 16-byte words go by cp.async. Raises for n < 0 or c <= 0."""
    if n < 0 or c <= 0:
        raise ValueError(f"fma_rows geometry: n={n} c={c}")
    cols = min(c, MAX_COLS)
    blocks = -(-c // cols)
    rows = CHUNK_ROWS
    while rows > GROUP and 2 * stage_bytes(rows, c) > RING_BYTES:
        rows -= GROUP
    chunks = max(1, -(-n // rows))
    stages = max(1, min(MAX_STAGES, RING_BYTES // stage_bytes(rows, c), chunks))
    bulk_x = x_aligned and blocks == 1
    return FmaRowsGeometry(rows=rows, stages=stages, cols=cols, blocks=blocks,
                           bulk_d=d_aligned, bulk_x=bulk_x,
                           bulk_only=d_aligned and bulk_x and n % 4 == 0 and (n * c) % 4 == 0,
                           smem=BARRIER_BYTES + stages * stage_bytes(rows, c))


def fma_rows(d: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """acc = fma(d[i], xs[i], acc) over the rows i in order from acc = 0,
    each step rounded once: (N,) and (N, C) float32 -> (C,) float32. On
    the channel `ref.head_channel` names, the first rows (up to
    `ref.HEAD_ROWS`) are multiplied and added apart (`fma_rows_ref`)."""
    if not build.route(xs, "fma_rows"):
        return fma_rows_ref(d, xs)
    if d.dtype != torch.float32 or xs.dtype != torch.float32:
        raise TypeError(f"fma_rows takes float32 d and xs; got {d.dtype} and {xs.dtype}")
    if d.dim() != 1 or xs.dim() != 2 or d.shape[0] != xs.shape[0]:
        raise ValueError(f"fma_rows takes (N,) d and (N, C) xs; got {tuple(d.shape)} and "
                         f"{tuple(xs.shape)}")
    if d.device != xs.device:
        raise ValueError(f"d on {d.device} but xs on {xs.device}")
    n, c = xs.shape
    out = torch.empty(c, dtype=torch.float32, device=xs.device)
    if c == 0:
        return out
    d, xs = d.contiguous(), xs.contiguous()
    geo = fma_rows_geometry(n, c, d.data_ptr() % 16 == 0, xs.data_ptr() % 16 == 0)
    lib = build.library("fma_rows")
    with torch.cuda.device(xs.device):
        rc = lib.fma_rows_launch(d.data_ptr(), xs.data_ptr(), out.data_ptr(), n, c,
                                 head_channel(n, c), geo.rows, geo.stages, geo.cols, geo.flags,
                                 geo.smem,
                                 torch.cuda.current_stream(xs.device).cuda_stream)
    build.check("fma_rows", rc)
    build.launches["fma_rows"] += 1
    return out
