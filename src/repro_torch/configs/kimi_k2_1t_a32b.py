"""kimi-k2-1t-a32b [moe] — Kimi K2 trillion-parameter MoE (paper-table,
arXiv:2501.kimi2): 61L d_model=7168 64H (GQA kv=8) expert ff=2048
vocab=163840, 384 experts top-8 (~32B active).

Scale notes (DESIGN §6): params are kept in bfloat16 and optimized with
Adafactor (factored second moment, no first moment) so the 1T parameter
state fits 16 GB/chip HBM on the 16x16 pod.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    param_dtype="bfloat16",
    optimizer="adafactor",
    remat="full",
)

SMOKE = ArchConfig(
    name="kimi-k2-1t-a32b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=128,
    num_experts=8,
    experts_per_token=4,
    param_dtype="bfloat16",
    remat="none",
)
