"""mamba2-370m [ssm] — SSD (state-space duality), arXiv:2405.21060.

48L d_model=1024, attention-free, vocab 50280, ssm_state=128, headdim 64
(d_inner = 2048 -> 32 ssm heads), tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=16,          # unused (attention-free)
    num_kv_heads=16,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
    optimizer="adamw",
    remat="full",
)

SMOKE = ArchConfig(
    name="mamba2-370m-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=128,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=32,
    tie_embeddings=True,
    remat="none",
)
