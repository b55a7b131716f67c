"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE + SwiGLU + GQA, tied embeddings
[arXiv:2412.08905; hf]. Pure full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    backbone="transformer",
    source="arXiv:2412.08905; hf",
    n_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab=200064,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    mlp_act="swiglu",
    tie_embeddings=True,
    skip_shapes=("long_500k",),
    # 24 heads do not divide a 16-way model axis: the reference zero-pads
    # them to 32 inside attention (semantics-preserving)
    attn_head_pad=32,
)
