"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk_norm, head_dim 128, tied embeddings
[hf:Qwen/Qwen3-8B; hf]. Pure full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    backbone="transformer",
    source="hf:Qwen/Qwen3-8B; hf",
    n_layers=36,
    d_model=2560,
    d_ff=9728,
    vocab=151936,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    mlp_act="swiglu",
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
