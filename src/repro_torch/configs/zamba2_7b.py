"""zamba2-7b [hybrid] — 81L d_model=3584, Mamba2 backbone with shared
attention blocks, ssm_state=64 [arXiv:2411.15242; unverified].

81 Mamba2 layers; a shared transformer block (32H MHA kv=32, d_ff=14336)
is applied every 6 mamba layers, alternating between 2 shared parameter
sets (Zamba2's shared-block scheme), fed concat(hidden, embedding).
Hybrid constant-state backbone -> long_500k decode runs.
"""

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    backbone="zamba2",
    source="arXiv:2411.15242; unverified",
    n_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab=32000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    mlp_act="swiglu",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    shared_attn_every=6,
    n_shared_blocks=2,
)
