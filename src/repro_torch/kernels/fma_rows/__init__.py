from repro_torch.kernels.fma_rows.ops import fma_rows
from repro_torch.kernels.fma_rows.ref import fma_rows_ref

__all__ = ["fma_rows", "fma_rows_ref"]
