"""rwkv6-7b (Finch) [ssm] — 32L d_model=4096 attn-free d_ff=14336
vocab=65536, data-dependent decay linear attention
[arXiv:2404.05892; hf]. Constant-state recurrence -> long_500k runs.
head size 64 (RWKV-6 standard).
"""

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    backbone="rwkv6",
    source="arXiv:2404.05892; hf",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab=65536,
    n_heads=64,  # d_model / head size 64
    n_kv_heads=64,
    head_dim=64,
    ssm=SSMConfig(d_state=64, head_dim=64, chunk=128),
)
