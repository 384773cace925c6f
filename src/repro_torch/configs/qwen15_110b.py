"""qwen1.5-110b [dense] — Qwen1.5 architecture with QKV bias
(hf:Qwen/Qwen1.5-0.5B family): 80L d_model=8192 64H (GQA kv=8) ff=49152
vocab=152064.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    optimizer="adafactor",
    remat="full",
)

SMOKE = ArchConfig(
    name="qwen1.5-110b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=128,
    qkv_bias=True,
    remat="none",
)
