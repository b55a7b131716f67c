"""Public entry point of the saturating integer GEMM.

Counterpart of `repro.kernels.intgemm.ops.intgemm`. A CUDA tensor
launches the hand-written kernel (``csrc/intgemm.cu``, which replaces
``src/repro/kernels/intgemm/kernel.py:46 intgemm_pallas``); a CPU tensor
takes the plain version `intgemm_ref`; any other device raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.intgemm.ref import intgemm_ref

# The largest (K, N) weight matrix the entry point takes: the bytes of
# shared memory a Hopper block may use, the limit of the first kernel
# (which staged the whole matrix); the tiled kernel stages chunks and
# keeps the contract.
_MAX_W_BYTES = 232448


def intgemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int32 activation codes x (K, N) int8 weight codes -> (M, N)
    int32, summed exactly and saturated once to int24.

    The kernel sums in int32, exact for 14-bit codes and K < 2^11 (the
    classifier's range); the plain version sums in int64.
    """
    if not build.route(x, "intgemm"):
        return intgemm_ref(x, w)
    if x.dtype != torch.int32 or w.dtype != torch.int8:
        raise TypeError(
            f"intgemm takes int32 x and int8 w; got {x.dtype} and {w.dtype}"
        )
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"intgemm shapes {tuple(x.shape)} x {tuple(w.shape)} do not chain"
        )
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("intgemm takes contiguous tensors")
    m, k = x.shape
    n = w.shape[1]
    if k * n > _MAX_W_BYTES:
        raise ValueError(
            f"a ({k}, {n}) int8 weight matrix exceeds the {_MAX_W_BYTES} bytes "
            "intgemm takes"
        )
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out.zero_()
    lib = build.library("intgemm")
    with torch.cuda.device(x.device):
        rc = lib.intgemm_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check("intgemm", rc)
    build.launches["intgemm"] += 1
    return out
