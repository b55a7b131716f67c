from repro_torch.kernels.gru.ops import gru_sequence
from repro_torch.kernels.gru.ref import gru_sequence_plain

__all__ = ["gru_sequence", "gru_sequence_plain"]
