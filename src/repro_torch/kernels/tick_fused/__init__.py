from repro_torch.kernels.tick_fused.ops import TickOperands, pack_operands, tick_fused
from repro_torch.kernels.tick_fused.ref import softmax, tick_reference

__all__ = ["TickOperands", "pack_operands", "softmax", "tick_fused", "tick_reference"]
