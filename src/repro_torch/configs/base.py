"""Config system: architecture configs + input-shape registry.

Counterpart of `repro.configs.base`: the same frozen dataclasses and
fields, pure data (no download, no weights). Every architecture is a
frozen `ArchConfig`, selected by ``--arch <id>`` through
`repro_torch.configs.get_config`. `reduced()` returns the same family at
smoke-test scale (a forward and a train step on the CPU in seconds);
`activation_dtype` is a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

__all__ = ["MoEConfig", "SSMConfig", "ArchConfig", "ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    num_shared_experts: int = 0
    first_k_dense: int = 0  # leading dense layers (DeepSeek/Kimi style)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # tokens-per-shard * top_k below which EP switches to the
    # weights-stationary path (tokens move, experts stay; see
    # models/moe.py). 0 disables.
    stationary_threshold: int = 4096


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block parameters."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    backbone: str  # transformer | mamba2 | rwkv6 | zamba2
    source: str  # citation string from the assignment table
    # core dims
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    n_heads: int = 0  # 0 for attention-free backbones
    n_kv_heads: int = 0
    head_dim: Optional[int] = None
    # transformer details
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None  # window for local layers
    layer_pattern: Tuple[str, ...] = ("global",)  # scan-step pattern,
    # e.g. gemma2: ("local", "global"); entries: local|global|moe|mamba
    mlp_act: str = "swiglu"  # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    post_norms: bool = False  # Gemma-2 sandwich norms
    scale_embeddings: bool = False  # Gemma: embeddings * sqrt(d_model)
    # modality frontend: "token" consumes int tokens; "embedding" consumes
    # precomputed frame/patch embeddings (audio/vlm stub per assignment)
    frontend: str = "token"
    # mixtures / ssm
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # zamba2: shared attention block applied every k mamba layers
    shared_attn_every: int = 0
    n_shared_blocks: int = 2
    # execution knobs (perf levers — defaults are the faithful baseline)
    dtype: str = "bfloat16"
    remat: str = "full"  # none | dots | full — "full" is the safe default
    # at 27B-1T scale; "dots" is a §Perf lever where memory allows
    attn_chunk: Optional[int] = None  # flash-style KV chunking if set
    attn_head_pad: Optional[int] = None  # zero-pad heads for clean TP
    serve_quant: bool = False  # int8 expert weights at serve time
    # shapes this arch skips
    skip_shapes: Tuple[str, ...] = ()

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/head
        shard cleanly on any mesh axis (MaxText-style padding; labels
        never index the pad rows)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def activation_dtype(self) -> torch.dtype:
        """bfloat16 or float32, as the reference's; "float64" runs the
        port in float64 (a truth for the float32 runs, `models.layers.wide`)."""
        return {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(self.dtype, torch.float32)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        n_mlp_mats = 3 if self.mlp_act in ("swiglu", "geglu") else 2
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        if self.backbone == "rwkv6":
            # time-mix r/k/v/g/o (5 d^2) + channel-mix k/v (2 d f) + r
            # (d^2) + ddlerp/decay LoRAs (~448 d)
            per = 6 * d * d + 2 * d * f + 448 * d
            total += self.n_layers * per
        elif self.backbone in ("mamba2", "zamba2"):
            ssm = self.ssm
            d_in = ssm.expand * d
            per = d * (2 * d_in + 2 * ssm.d_state) + d_in * d  # in/out proj
            total += self.n_layers * per
            if self.shared_attn_every:
                attn = 2 * d * (self.n_heads + self.n_kv_heads) * hd + 2 * d * d
                mlp = n_mlp_mats * d * f
                total += self.n_shared_blocks * (attn + mlp)
        else:
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd
            attn += self.n_heads * hd * d
            moe_layers = 0
            if self.moe is not None:
                moe_layers = self.n_layers - self.moe.first_k_dense
                dense_layers = self.moe.first_k_dense
            else:
                dense_layers = self.n_layers
            total += self.n_layers * attn
            total += dense_layers * n_mlp_mats * d * f
            if self.moe is not None:
                per_exp = n_mlp_mats * d * self.moe.d_expert
                total += moe_layers * (
                    self.moe.num_experts * per_exp
                    + self.moe.num_shared_experts * per_exp
                    + d * self.moe.num_experts  # router
                )
        return total

    def active_param_count(self) -> int:
        """Params touched per token (for MoE MODEL_FLOPS = 6*N_active*D)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        n_mlp_mats = 3 if self.mlp_act in ("swiglu", "geglu") else 2
        per_exp = n_mlp_mats * self.d_model * self.moe.d_expert
        moe_layers = self.n_layers - self.moe.first_k_dense
        inactive = moe_layers * per_exp * (
            self.moe.num_experts - self.moe.top_k
        )
        return full - inactive

    def reduced(self) -> "ArchConfig":
        """Smoke-test scale: same family/topology, tiny dims."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.shared_attn_every else 2),
            d_model=64,
            d_ff=128,
            vocab=128,
            head_dim=16,
            sliding_window=32 if self.sliding_window else None,
        )
        if self.n_heads:
            kw["n_heads"] = 4
            kw["n_kv_heads"] = max(1, min(self.n_kv_heads, 2))
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=8, top_k=2, d_expert=32
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=16
            )
        if self.shared_attn_every:
            kw["shared_attn_every"] = 2
            kw["n_layers"] = 5
        return dataclasses.replace(self, **kw)

    def shapes(self):
        return [s for n, s in SHAPES.items() if n not in self.skip_shapes]
