from repro_torch.kernels.fex_fused.ops import biquad_stream, fex_fused
from repro_torch.kernels.fex_fused.ref import biquad_stream_ref, fex_fused_ref

__all__ = ["biquad_stream", "biquad_stream_ref", "fex_fused", "fex_fused_ref"]
