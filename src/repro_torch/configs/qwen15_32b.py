"""qwen1.5-32b [dense] — Qwen1.5 with QKV bias: 64L d_model=5120 40H
(GQA kv=40, i.e. MHA) ff=27392 vocab=152064.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    optimizer="adamw",
    remat="full",
)

SMOKE = ArchConfig(
    name="qwen1.5-32b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    qkv_bias=True,
    remat="none",
)
