"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 pattern
(arXiv:2402.19427): 38L d_model=4096 16H (MQA kv=1) ff=12288 vocab=256000,
local window 2048. 12 x (rec, rec, attn) blocks + (rec, rec) tail.

Sub-quadratic: the ``long_500k`` decode cell runs (O(1) recurrent state +
ring-buffered 2048-window KV).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    tail_pattern=("rec", "rec"),
    rnn_width=4096,
    window=2048,
    optimizer="adamw",
    remat="full",
)

SMOKE = ArchConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    block_pattern=("rec", "rec", "attn"),
    tail_pattern=("rec", "rec"),
    rnn_width=64,
    window=16,
    remat="none",
)
