"""Config registry: ``--arch <id>`` resolution, as `repro.configs`."""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, SHAPES, ShapeSpec
from repro_torch.configs.musicgen_medium import CONFIG as musicgen_medium
from repro_torch.configs.qwen3_4b import CONFIG as qwen3_4b
from repro_torch.configs.gemma2_27b import CONFIG as gemma2_27b
from repro_torch.configs.codeqwen15_7b import CONFIG as codeqwen15_7b
from repro_torch.configs.phi4_mini import CONFIG as phi4_mini
from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b
from repro_torch.configs.llava_next_mistral_7b import CONFIG as llava_next_mistral_7b
from repro_torch.configs.rwkv6_7b import CONFIG as rwkv6_7b
from repro_torch.configs.kimi_k2 import CONFIG as kimi_k2
from repro_torch.configs.granite_moe_3b import CONFIG as granite_moe_3b

_REGISTRY: Dict[str, ArchConfig] = {
    c.name: c
    for c in [
        musicgen_medium,
        qwen3_4b,
        gemma2_27b,
        codeqwen15_7b,
        phi4_mini,
        zamba2_7b,
        llava_next_mistral_7b,
        rwkv6_7b,
        kimi_k2,
        granite_moe_3b,
    ]
}


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "SHAPES", "ShapeSpec",
    "get_config", "list_archs",
]
