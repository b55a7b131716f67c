from repro_torch.kernels.tdc.ops import tdc_counts
from repro_torch.kernels.tdc.ref import tdc_counts_plain, tdc_counts_ref

__all__ = ["tdc_counts", "tdc_counts_plain", "tdc_counts_ref"]
