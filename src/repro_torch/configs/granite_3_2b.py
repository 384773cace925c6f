"""granite-3-2b [dense] — IBM Granite 3.0 2B base, GQA
(hf:ibm-granite/granite-3.0-2b-base): 40L d_model=2048 32H (kv=8) ff=8192
vocab=49155.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    optimizer="adamw",
    remat="dots",
)

SMOKE = ArchConfig(
    name="granite-3-2b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=128,
    remat="none",
)
