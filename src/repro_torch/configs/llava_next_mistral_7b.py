"""llava-next-mistral-7b [vlm] — Mistral-7B backbone: 32L d_model=4096
32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

The anyres vision tower + projector is a stub per the assignment:
input_specs() provides precomputed patch embeddings interleaved with
text positions; the backbone is what we lower. Full attention ->
long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    backbone="transformer",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab=32000,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    rope_theta=1e6,
    mlp_act="swiglu",
    frontend="embedding",
    skip_shapes=("long_500k",),
)
