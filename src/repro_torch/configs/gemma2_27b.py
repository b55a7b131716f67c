"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 [arXiv:2408.00118; hf].

Local+global alternating attention (4096 window on local layers), attn
logit softcap 50, final logit softcap 30, GeGLU, sandwich norms, scaled
tied embeddings. The alternating 4k window makes half the stack
sub-quadratic, so long_500k decode is exercised (the hybrid-window
case); global layers use a data-axis-sharded 500k cache.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    backbone="transformer",
    source="arXiv:2408.00118; hf",
    n_layers=46,
    d_model=4608,
    d_ff=36864,
    vocab=256000,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    layer_pattern=("local", "global"),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_act="geglu",
    post_norms=True,
    scale_embeddings=True,
    tie_embeddings=True,
)
