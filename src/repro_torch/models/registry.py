"""Backbone registry: ``cfg.backbone`` -> the module implementing the
model API (init_params / forward / loss_fn / init_cache / prefill /
decode_step), as `repro.models.registry`.

RWKV6 and the transformer (dense and one-card MoE) are ported. Mamba2
and Zamba2 raise `NotImplementedError` naming their ROADMAP.md item
(queue 1, item 5d).
"""

from __future__ import annotations

_NOT_PORTED = {
    "mamba2": "ROADMAP.md queue 1, item 5d (Mamba2 / Zamba2)",
    "zamba2": "ROADMAP.md queue 1, item 5d (Mamba2 / Zamba2)",
}


def get_backbone(cfg):
    if cfg.backbone == "rwkv6":
        from repro_torch.models import rwkv6

        return rwkv6
    if cfg.backbone == "transformer":
        from repro_torch.models import transformer

        return transformer
    if cfg.backbone in _NOT_PORTED:
        raise NotImplementedError(
            f"the {cfg.backbone} backbone ({cfg.name}) is not ported yet: "
            f"{_NOT_PORTED[cfg.backbone]}"
        )
    raise KeyError(f"unknown backbone {cfg.backbone!r}")
