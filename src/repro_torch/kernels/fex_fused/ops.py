"""Public entry points of the batch filterbank kernels.

Counterpart of `repro.kernels.fex_fused.ops.fex_fused`. A CUDA tensor
launches the hand-written kernel (``csrc/fex_fused.cu``, which replaces
``src/repro/kernels/fex_fused/kernel.py:82 fex_fused_pallas``); a CPU
tensor takes the plain version (`fex_fused_ref`); any other device
raises. `biquad_stream` is the same IIR step writing y per sample: the
batch Rec-BPF scan of the hardware frontends, which the reference runs
as a ``lax.scan`` outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fex import SUM_BLOCK
from repro_torch.kernels import build
from repro_torch.kernels.fex_fused.ref import (
    biquad_stream_ref,
    fex_fused_ref,
    stacked_coeffs,
)

__all__ = ["FexGeometry", "biquad_stream", "fex_fused", "fex_geometry"]


@dataclasses.dataclass(frozen=True)
class FexGeometry:
    """How `csrc/fex_fused.cu` is launched for (B, T) audio and C channels."""

    clips_per_block: int  # 32 // C clips (at most B): one filter lane each channel
    bulk: bool  # the audio staged by bulk copies (else cp.async words / loads)
    fast: bool  # K1 with frames of whole 32-sample blocks: the branch-free body
    store_bulk: bool  # the scan's y leaves by bulk stores (else the writer warp copies)


def fex_geometry(b: int, t: int, c: int, frame_len: Optional[int], row_stride: int,
                 aligned: bool, bf16: bool) -> FexGeometry:
    """The launch geometry for ``b`` clips of ``t`` samples at row stride
    ``row_stride`` (elements) and ``c`` channels: K1 with frames of
    ``frame_len`` samples (``t`` a whole number of them), or the scan entry
    (``frame_len`` None; float32 only). ``aligned``: the audio's address is
    16-byte aligned. Raises where nothing can be launched."""
    if (min(b, t, c) <= 0 or row_stride < t or (frame_len is not None
                                                and (frame_len <= 0 or t % frame_len))
            or (bf16 and frame_len is None)):
        raise ValueError(f"fex geometry: b={b} t={t} c={c} frame_len={frame_len} "
                         f"row_stride={row_stride} bf16={bf16}")
    esize = 2 if bf16 else 4
    # a bulk copy's addresses and size are multiples of 16 bytes: every
    # clip's run starts aligned and every chunk, the last too, is whole words
    bulk = aligned and (row_stride * esize) % 16 == 0 and (t * esize) % 16 == 0
    return FexGeometry(
        clips_per_block=max(1, min(32 // min(c, 32), b)), bulk=bulk,
        fast=frame_len is not None and frame_len % SUM_BLOCK == 0,
        # each clip's y is t * c contiguous floats of (B, T, C)
        store_bulk=frame_len is None and c <= 32 and (t * c) % 4 == 0,
    )


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x itself where its rows can be read in place (unit sample stride,
    rows apart by at least their length), else a contiguous copy."""
    if x.stride(-1) == 1 and x.stride(0) >= x.shape[-1]:
        return x
    return x.contiguous()


def _check(x: torch.Tensor, coeffs: torch.Tensor, dtypes, name: str) -> None:
    if x.dtype not in dtypes:
        raise TypeError(f"{name} takes {' or '.join(map(str, dtypes))} audio; got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name} takes (B, T) audio; got {tuple(x.shape)}")
    if coeffs.dim() != 2 or coeffs.shape[0] != 5:
        raise ValueError(f"{name} takes (5, C) coefficients; got {tuple(coeffs.shape)}")


def fex_fused(x: torch.Tensor, coeffs, frame_len: int) -> torch.Tensor:
    """Fused biquad + |.| + frame mean: (B, T) float32 or bfloat16 at the
    internal rate -> (B, T // frame_len, C) float32.

    T is trimmed to whole frames; the kernel reads the kept samples of
    each clip in place (no copy of the trimmed view). The IIR carry starts
    from zero and runs on across frames; coefficients (BiquadCoeffs or a
    stacked (5, C) array) stay float32 whatever the audio's dtype.
    """
    coeffs = stacked_coeffs(coeffs, x.device)
    x = x[:, : (x.shape[-1] // frame_len) * frame_len]
    if not build.route(x, "fex_fused"):
        return fex_fused_ref(x, coeffs, frame_len)
    _check(x, coeffs, (torch.float32, torch.bfloat16), "fex_fused")
    b, t = x.shape
    c = coeffs.shape[1]
    out = torch.empty((b, t // frame_len, c), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    x, coeffs = _rows(x), coeffs.contiguous()
    bf16 = x.dtype == torch.bfloat16
    geo = fex_geometry(b, t, c, frame_len, x.stride(0), x.data_ptr() % 16 == 0, bf16)
    lib = build.library("fex_fused")
    with torch.cuda.device(x.device):
        rc = lib.fex_fused_launch(
            x.data_ptr(), int(bf16), coeffs.data_ptr(), out.data_ptr(), b, t, x.stride(0), c,
            frame_len, float(np.float32(1.0 / frame_len)), geo.clips_per_block, int(geo.bulk),
            int(geo.fast), torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check("fex_fused", rc)
    build.launches["fex_fused"] += 1
    return out


def biquad_stream(
    x: torch.Tensor,
    coeffs,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The filterbank per sample: (B, T) float32 -> (y (B, T, C),
    (s1, s2)), from the carry ``state`` ((B, C) each; None: zero)."""
    coeffs = stacked_coeffs(coeffs, x.device)
    if not build.route(x, "biquad_stream"):
        return biquad_stream_ref(x, coeffs, state)
    _check(x, coeffs, (torch.float32,), "biquad_stream")
    b, t = x.shape
    c = coeffs.shape[1]
    if state is None:
        s1 = torch.zeros((b, c), dtype=torch.float32, device=x.device)
        s2 = torch.zeros_like(s1)
    else:
        for s in state:
            if tuple(s.shape) != (b, c) or s.dtype != torch.float32 or s.device != x.device:
                raise ValueError(
                    f"biquad_stream: carry must be float32 {(b, c)} on {x.device}; got "
                    f"{s.dtype} {tuple(s.shape)} on {s.device}"
                )
        s1, s2 = (s.clone(memory_format=torch.contiguous_format) for s in state)
    y = torch.empty((b, t, c), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, (s1, s2)
    x, coeffs = _rows(x), coeffs.contiguous()
    geo = fex_geometry(b, t, c, None, x.stride(0), x.data_ptr() % 16 == 0, False)
    lib = build.library("fex_fused")
    with torch.cuda.device(x.device):
        rc = lib.biquad_stream_launch(
            x.data_ptr(), coeffs.data_ptr(), s1.data_ptr(), s2.data_ptr(), y.data_ptr(),
            b, t, x.stride(0), c, geo.clips_per_block, int(geo.bulk), int(geo.store_bulk),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check("fex_fused", rc)
    build.launches["biquad_stream"] += 1
    return y, (s1, s2)
