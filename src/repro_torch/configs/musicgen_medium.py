"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24 == MHA) d_ff=6144 vocab=2048
[arXiv:2306.05284; hf]. The EnCodec frontend is a stub: input_specs()
provides precomputed frame embeddings (assignment spec); the LM head
predicts the 2048-entry codebook. Pure full attention -> long_500k
skipped.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    backbone="transformer",
    source="arXiv:2306.05284; hf",
    n_layers=48,
    d_model=1536,
    d_ff=6144,
    vocab=2048,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    mlp_act="gelu",
    frontend="embedding",
    skip_shapes=("long_500k",),
    # 24 heads do not divide a 16-way model axis: the reference zero-pads
    # them to 32 inside attention (semantics-preserving)
    attn_head_pad=32,
)
