"""Hand-written CUDA kernels of the port, each beside its plain version.

``build`` compiles and loads them and counts their launches; a wrapper
launches its kernel for a CUDA tensor and takes its plain PyTorch
version for a CPU tensor. The two kernels reached only through their
own entry points are exported here, as `repro.kernels` exports them:
`gru_sequence` (K6) and `wkv6` (K7), each with its plain version.
"""

from repro_torch.kernels.gru import gru_sequence, gru_sequence_plain
from repro_torch.kernels.wkv6 import wkv6, wkv6_plain

__all__ = ["gru_sequence", "gru_sequence_plain", "wkv6", "wkv6_plain"]
