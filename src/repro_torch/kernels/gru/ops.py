"""Public entry point of the weights-resident GRU sequence kernel.

Counterpart of `repro.kernels.gru.ops.gru_sequence`, batch-major. A CUDA
tensor launches the hand-written kernel (``csrc/gru_seq.cu``, which
replaces ``src/repro/kernels/gru/kernel.py:73 gru_sequence_pallas``); a
CPU tensor takes the plain version `gru_sequence_plain`; any other
device raises. There is no block-size or tier argument: the kernel
tiles the batch itself and masks the ragged last tile.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gru.ref import gru_sequence_plain

__all__ = ["gru_sequence", "smem_bytes"]

# Shared memory a block may use on Hopper, and the kernel's tile: rows of
# the batch per block (ROWS in gru_seq.cu).
_MAX_SMEM = 232448
_ROWS = 16


def smem_bytes(i: int, h: int) -> int:
    """Shared memory of one block: W, U, b_i, b_h and the double-buffered
    h and x tiles, float32."""
    return 4 * ((i + h) * 3 * h + 6 * h + 2 * _ROWS * (h + i))


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
    smem = smem_bytes(i, h)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"a layer of I={i}, H={h} needs {smem} bytes of shared memory; a block "
            f"has {_MAX_SMEM}"
        )
    out = torch.empty((b, t, h), dtype=xs.dtype, device=xs.device)
    if out.numel() == 0:
        return out
    f = lambda a: a.to(torch.float32).contiguous()  # noqa: E731
    xs, w, u, b_i, b_h, h0 = xs.contiguous(), f(w), f(u), f(b_i), f(b_h), f(h0)
    lib = build.library("gru_seq")
    with torch.cuda.device(xs.device):
        rc = lib.gru_seq_launch(
            xs.data_ptr(), int(xs.dtype == torch.bfloat16), w.data_ptr(), u.data_ptr(),
            b_i.data_ptr(), b_h.data_ptr(), h0.data_ptr(), out.data_ptr(),
            b, t, i, h, smem, torch.cuda.current_stream(xs.device).cuda_stream,
        )
    build.check("gru_seq", rc)
    build.launches["gru_seq"] += 1
    return out
