"""hubert-xlarge [audio] — encoder-only transformer, same backbone as
wav2vec2 (arXiv:2106.07447): 48L d_model=1280 16H (kv=16) ff=5120 vocab=504.

Modality frontend (CNN feature extractor) is a STUB: ``input_specs``
provides precomputed frame embeddings (B, T, 512). Encoder-only: no decode
shapes (see DESIGN §Arch-applicability).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    is_decoder=False,
    embed_inputs=False,
    optimizer="adamw",
    remat="dots",
)

SMOKE = ArchConfig(
    name="hubert-xlarge-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=64,
    causal=False,
    is_decoder=False,
    embed_inputs=False,
    remat="none",
)
