"""codeqwen1.5-7b [dense] — CodeQwen1.5-7B (hf:Qwen/CodeQwen1.5-7B):
32L d_model=4096 32H (kv=32) ff=13440 vocab=92416, QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    optimizer="adamw",
    remat="dots",
)

SMOKE = ArchConfig(
    name="codeqwen1.5-7b-smoke",
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
