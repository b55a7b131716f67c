"""Model code of the port: the RWKV6 backbone (`models.rwkv6`, with the
two WKV6 forms) and the shared layers; `get_backbone` resolves an
`ArchConfig`'s backbone."""

from repro_torch.models.registry import get_backbone

__all__ = ["get_backbone"]
