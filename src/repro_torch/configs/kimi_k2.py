"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) expert
d_ff=2048 vocab=163840, 384 routed experts top-8 + 1 shared expert,
first layer dense [arXiv:2501.kimi2; unverified] (paper-table entry).

~1.03T parameters, ~32B active. Assumptions, as the reference's: GQA
kv=8 (not MLA), head_dim = d_model / n_heads = 112, and the single dense
layer's FFN at 16384 (~ top_k * d_expert compute parity, DeepSeek-V3
style). Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    backbone="transformer",
    source="arXiv:2501.kimi2; unverified",
    n_layers=61,
    d_model=7168,
    d_ff=16384,  # dense-prefix layer FFN (assumption, see module docstring)
    vocab=163840,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    mlp_act="swiglu",
    moe=MoEConfig(
        num_experts=384,
        top_k=8,
        d_expert=2048,
        num_shared_experts=1,
        first_k_dense=1,
        capacity_factor=1.25,
    ),
    layer_pattern=("moe",),
    skip_shapes=("long_500k",),
)
