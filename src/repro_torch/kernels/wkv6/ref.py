"""Plain version of the WKV6 kernel: the backbone's own sequential
recurrence, as `repro.kernels.wkv6.ref` takes it."""

from repro_torch.models.rwkv6 import wkv6_sequential

__all__ = ["wkv6_plain"]

wkv6_plain = wkv6_sequential
