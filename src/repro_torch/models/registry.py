"""Backbone registry: ``cfg.backbone`` -> the module implementing the
model API (init_params / forward / loss_fn / init_cache / prefill /
decode_step), as `repro.models.registry`. ``"mamba2"`` maps to the
block-level `models.mamba2`, as the reference's registry does (no config
uses it).
"""

from __future__ import annotations


def get_backbone(cfg):
    if cfg.backbone == "rwkv6":
        from repro_torch.models import rwkv6

        return rwkv6
    if cfg.backbone == "transformer":
        from repro_torch.models import transformer

        return transformer
    if cfg.backbone == "zamba2":
        from repro_torch.models import zamba2

        return zamba2
    if cfg.backbone == "mamba2":
        from repro_torch.models import mamba2

        return mamba2
    raise KeyError(f"unknown backbone {cfg.backbone!r}")
