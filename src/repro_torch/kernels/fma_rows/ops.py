"""Public entry point of the fit's row chain.

A CUDA tensor launches the hand-written kernel (``csrc/fma_rows.cu``); a
CPU tensor takes the plain version `fma_rows_ref`; any other device
raises. `repro_torch.serving.cascade.fit_linear_detector` takes its weight
gradient through it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fma_rows.ref import fma_rows_ref

__all__ = ["fma_rows"]


def fma_rows(d: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """acc = fma(d[i], xs[i], acc) over the rows i in order from acc = 0,
    each step rounded once: (N,) and (N, C) float32 -> (C,) float32."""
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
    lib = build.library("fma_rows")
    with torch.cuda.device(xs.device):
        rc = lib.fma_rows_launch(d.data_ptr(), xs.data_ptr(), out.data_ptr(), n, c,
                                 torch.cuda.current_stream(xs.device).cuda_stream)
    build.check("fma_rows", rc)
    build.launches["fma_rows"] += 1
    return out
