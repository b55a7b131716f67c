"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) expert
d_ff=512 vocab=49155, 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

Experts are padded 40 -> 48 on the 16-way model axis (padded experts
routed -inf; see models/moe.py). Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    backbone="transformer",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    n_layers=32,
    d_model=1536,
    d_ff=512,
    vocab=49155,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    mlp_act="swiglu",
    tie_embeddings=True,
    moe=MoEConfig(
        num_experts=40,
        top_k=8,
        d_expert=512,
        capacity_factor=1.25,
    ),
    layer_pattern=("moe",),
    skip_shapes=("long_500k",),
    # 24 heads do not divide a 16-way model axis: the reference zero-pads
    # them to 32 inside attention (semantics-preserving)
    attn_head_pad=32,
)
