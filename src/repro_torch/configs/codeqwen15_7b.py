"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32 == MHA)
d_ff=13440 vocab=92416 [hf:Qwen/CodeQwen1.5-7B; hf]. 64k-context code
model (rope theta 1e6). Pure full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    backbone="transformer",
    source="hf:Qwen/CodeQwen1.5-7B; hf",
    n_layers=32,
    d_model=4096,
    d_ff=13440,
    vocab=92416,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    rope_theta=1e6,
    mlp_act="swiglu",
    skip_shapes=("long_500k",),
)
