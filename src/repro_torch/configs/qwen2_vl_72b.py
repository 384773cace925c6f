"""qwen2-vl-72b [vlm] — Qwen2-VL backbone with M-RoPE (arXiv:2409.12191):
80L d_model=8192 64H (GQA kv=8) ff=29568 vocab=152064.

Backbone only: the vision frontend is a STUB — ``input_specs`` provides
M-RoPE position triples (3, B, T) and (for multimodal batches) precomputed
patch embeddings; dynamic resolution is represented by the position ids.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    optimizer="adamw",
    remat="full",
)

SMOKE = ArchConfig(
    name="qwen2-vl-72b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(2, 3, 3),
    remat="none",
)
