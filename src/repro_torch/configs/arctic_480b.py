"""arctic-480b [moe] — Snowflake Arctic: 128-expert top-2 MoE with a dense
residual MLP in every layer (hf:Snowflake/snowflake-arctic-base).

35L d_model=7168 56H (GQA kv=8) ff=4864 vocab=32000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    dense_residual=True,
    optimizer="adafactor",
    remat="full",
)

SMOKE = ArchConfig(
    name="arctic-480b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=128,
    num_experts=8,
    experts_per_token=2,
    dense_residual=True,
    remat="none",
)
