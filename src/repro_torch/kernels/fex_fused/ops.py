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

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.fex_fused.ref import (
    biquad_stream_ref,
    fex_fused_ref,
    stacked_coeffs,
)

__all__ = ["biquad_stream", "fex_fused"]


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

    T is trimmed to whole frames. The IIR carry starts from zero and runs
    on across frames; coefficients (BiquadCoeffs or a stacked (5, C)
    array) stay float32 whatever the audio's dtype.
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
    x, coeffs = x.contiguous(), coeffs.contiguous()
    lib = build.library("fex_fused")
    with torch.cuda.device(x.device):
        rc = lib.fex_fused_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), coeffs.data_ptr(),
            out.data_ptr(), b, t, c, frame_len, float(np.float32(1.0 / frame_len)),
            torch.cuda.current_stream(x.device).cuda_stream,
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
    x, coeffs = x.contiguous(), coeffs.contiguous()
    lib = build.library("fex_fused")
    with torch.cuda.device(x.device):
        rc = lib.biquad_stream_launch(
            x.data_ptr(), coeffs.data_ptr(), s1.data_ptr(), s2.data_ptr(), y.data_ptr(),
            b, t, c, torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check("fex_fused", rc)
    build.launches["biquad_stream"] += 1
    return y, (s1, s2)
