from repro_torch.kernels.intgemm.ops import intgemm
from repro_torch.kernels.intgemm.ref import INT24_MAX, INT24_MIN, intgemm_ref

__all__ = ["INT24_MAX", "INT24_MIN", "intgemm", "intgemm_ref"]
