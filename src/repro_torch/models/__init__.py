"""Model code of the port: the RWKV6 backbone (`models.rwkv6`, with the
two WKV6 forms), the transformer (`models.transformer`, dense and MoE),
the Zamba2 hybrid (`models.zamba2` over the Mamba2 blocks of
`models.mamba2`) and the shared layers; `get_backbone` resolves an
`ArchConfig`'s backbone."""

from repro_torch.models.registry import get_backbone

__all__ = ["get_backbone"]
