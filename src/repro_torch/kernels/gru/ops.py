"""Public entry point of the weights-resident GRU sequence kernel.

Counterpart of `repro.kernels.gru.ops.gru_sequence`, batch-major. A CUDA
tensor launches the hand-written kernel (``csrc/gru_seq.cu``, which
replaces ``src/repro/kernels/gru/kernel.py:73 gru_sequence_pallas``); a
CPU tensor takes the plain version `gru_sequence_plain`; any other
device raises. There is no block-size or tier argument: the kernel
tiles the batch itself and masks the ragged last tile, and
`gru_seq_geometry` picks its instantiation and how x is staged.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gru.ref import gru_sequence_plain

__all__ = ["GruSeqGeometry", "gru_seq_geometry", "gru_sequence", "occupancy", "smem_bytes"]

#: csrc/gru_seq.cu's tile: rows a thread, adjacent hidden units a thread,
#: rows a block, steps of x in flight, the generic instantiation's threads.
R = 2
U = 2
ROWS = 16
STAGES = 4
MAX_THREADS = 512
#: Shared memory a block may use on Hopper.
_MAX_SMEM = 232448
#: The instantiations with widths known at compile time: (I, H) -> index
#: (0 is the generic one).
INSTANTIATIONS = {(16, 48): 1, (48, 48): 2}
#: How the x ring is filled: 16-byte cp.async, 4-byte cp.async words, or
#: elements loaded through registers (bf16 runs no cp.async size fits).
COPY16, COPY_WORDS, COPY_ELEMS = 0, 1, 2


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _stride(n: int) -> int:
    """A padded shared-memory row of ``n`` bytes: whole 16-byte words, 16
    mod 32, so the rows a warp reads at once fall in distinct banks."""
    r = _round16(n)
    return r + 16 if r % 32 == 0 else r


def smem_bytes(i: int, h: int, x_bf16: bool = False) -> int:
    """Shared memory of one block: W (I, 3H) and U (H, 3H) float32, the
    double-buffered h tile and a ring of STAGES x tiles, ROWS padded rows
    each."""
    es = 2 if x_bf16 else 4
    return (_round16(i * 3 * h * 4) + _round16(h * 3 * h * 4) + 2 * ROWS * _stride(4 * h)
            + STAGES * ROWS * _stride(i * es))


@dataclasses.dataclass(frozen=True)
class GruSeqGeometry:
    """How `csrc/gru_seq.cu` is launched: ``rows`` a block (``blocks``
    blocks), ``threads`` a block, the dynamic shared bytes, the
    instantiation (0 generic, 1 (16, 48), 2 (48, 48)) and the x ring's
    copy mode (COPY16, COPY_WORDS or COPY_ELEMS)."""

    rows: int
    blocks: int
    threads: int
    smem: int
    inst: int
    copy: int


def gru_seq_geometry(b: int, i: int, h: int, x_bf16: bool = False,
                     x_offset: int = 0) -> GruSeqGeometry:
    """The launch geometry for ``b`` rows of a layer I -> H; ``x_offset``:
    xs's address modulo 16. A row's step is a run of I elements at
    ``x_offset + (row T + t) I`` elements: 16-byte copies where every run
    is whole 16-byte words on a 16-byte boundary, 4-byte words where it is
    whole words, else (bf16 of an odd I, or a base off 4 bytes) elements.
    Raises for non-positive widths and for a layer whose block exceeds
    the shared memory or thread limit."""
    if b < 0 or i <= 0 or h <= 0:
        raise ValueError(f"gru_sequence geometry: b={b} i={i} h={h}")
    smem = smem_bytes(i, h, x_bf16)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"a layer of I={i}, H={h} needs {smem} bytes of shared memory; a block "
            f"has {_MAX_SMEM}"
        )
    threads = ROWS // R * -(-h // U)
    if threads > MAX_THREADS:
        raise ValueError(f"a layer of H={h} needs {threads} threads a block; the kernel "
                         f"takes {MAX_THREADS}")
    run = i * (2 if x_bf16 else 4)
    if x_offset % 16 == 0 and run % 16 == 0:
        copy = COPY16
    elif x_offset % 4 == 0 and run % 4 == 0:
        copy = COPY_WORDS
    else:
        copy = COPY_ELEMS
    return GruSeqGeometry(rows=ROWS, blocks=-(-b // ROWS), threads=threads, smem=smem,
                          inst=INSTANTIATIONS.get((i, h), 0), copy=copy)


def occupancy(geo: GruSeqGeometry, x_bf16: bool = False) -> int:
    """Blocks an SM of a launch of ``geo`` on the current card (the CUDA
    occupancy API)."""
    blocks = ctypes.c_int()
    build.check("gru_seq", build.library("gru_seq").gru_seq_occupancy(
        geo.inst, int(x_bf16), geo.threads, geo.smem, ctypes.addressof(blocks)))
    return blocks.value


def gru_sequence(
    xs: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    b_i: torch.Tensor,
    b_h: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """xs (B, T, I) -> all hidden states (B, T, H) in xs's dtype, for the
    layer w (I, 3H), u (H, 3H), b_i / b_h (3H,) and h0 (B, H) (zeros by
    default). PyTorch gate convention; state and sums in float32."""
    b, t, i = xs.shape
    h = u.shape[0]
    if h0 is None:
        h0 = torch.zeros((b, h), dtype=xs.dtype, device=xs.device)
    if not build.route(xs, "gru_seq"):
        return gru_sequence_plain(xs.transpose(0, 1), w, u, b_i, b_h, h0).transpose(0, 1).contiguous()
    if xs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gru_sequence takes float32 or bfloat16 xs; got {xs.dtype}")
    if (w.shape != (i, 3 * h) or u.shape != (h, 3 * h) or b_i.shape != (3 * h,)
            or b_h.shape != (3 * h,) or h0.shape != (b, h)):
        raise ValueError(
            f"gru_sequence shapes do not chain: xs {tuple(xs.shape)}, w {tuple(w.shape)}, "
            f"u {tuple(u.shape)}, b_i {tuple(b_i.shape)}, b_h {tuple(b_h.shape)}, "
            f"h0 {tuple(h0.shape)}"
        )
    for name, a in (("w", w), ("u", u), ("b_i", b_i), ("b_h", b_h), ("h0", h0)):
        if a.device != xs.device:
            raise ValueError(f"xs on {xs.device} but {name} on {a.device}")
        if a.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"gru_sequence takes float32 or bfloat16 {name}; got {a.dtype}")
    bf16 = xs.dtype == torch.bfloat16
    xs = xs.contiguous()
    geo = gru_seq_geometry(b, i, h, bf16, xs.data_ptr() % 16)
    out = torch.empty((b, t, h), dtype=xs.dtype, device=xs.device)
    if out.numel() == 0:
        return out
    f = lambda a: a.to(torch.float32).contiguous()  # noqa: E731
    w, u, b_i, b_h, h0 = f(w), f(u), f(b_i), f(b_h), f(h0)
    lib = build.library("gru_seq")
    with torch.cuda.device(xs.device):
        rc = lib.gru_seq_launch(
            xs.data_ptr(), int(bf16), w.data_ptr(), u.data_ptr(), b_i.data_ptr(),
            b_h.data_ptr(), h0.data_ptr(), out.data_ptr(), b, t, i, h, geo.inst, geo.copy,
            geo.threads, geo.smem, torch.cuda.current_stream(xs.device).cuda_stream,
        )
    build.check("gru_seq", rc)
    build.launches["gru_seq"] += 1
    return out
