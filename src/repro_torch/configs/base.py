"""Architecture + shape schema for the assigned LM zoo.

A copy of ``repro.configs.base`` (plain dataclasses), so the port needs no
JAX. Every assigned architecture gets one ``<id>.py`` in this package
exporting ``CONFIG`` (full size) and ``SMOKE`` (reduced, runs on CPU).
Field for field the reference's; the port runs the dense family
(``granite-3-2b``'s ``CONFIG`` at full width on one H100).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    dense_residual: bool = False    # arctic: dense MLP residual next to MoE
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- hybrid (recurrentgemma) ---
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    tail_pattern: tuple[str, ...] = ()    # leftover layers after full blocks
    rnn_width: int = 0               # RG-LRU recurrence width (0 -> d_model)
    window: int = 0                  # local-attention window
    # --- positional / misc ---
    qkv_bias: bool = False
    mrope: bool = False
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    rope_theta: float = 10000.0
    causal: bool = True
    is_decoder: bool = True          # False: encoder-only (no decode shapes)
    embed_inputs: bool = True        # False: inputs are precomputed embeddings
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # --- training-scale knobs ---
    param_dtype: str = "float32"     # 'bfloat16' for the 1T arch (DESIGN §6)
    activation_dtype: str = "float32"  # 'bfloat16': §Perf memory-term lever
    optimizer: str = "adamw"         # 'adafactor' for >=100B params
    remat: str = "full"              # 'none' | 'dots' | 'full'
    # attention chunking (blockwise/flash); 0 -> plain attention
    q_chunk: int = 512
    kv_chunk: int = 1024
    # forward-only causal chunk skipping (prefill/serve paths set this via
    # dataclasses.replace; it is not reverse-differentiable)
    attn_fwd_only: bool = False
    # triangular pair-scan attention: exact causal FLOPs, differentiable
    # (§Perf lever; see models.layers.pairscan_attention)
    attn_pairs: bool = False
    # replicate KV projections when kv_heads < TP degree instead of
    # row-paralleling them (kills the per-layer k/v all-reduce; §Perf lever)
    replicate_kv: bool = False
    # fully unroll every scan/loop so cost_analysis sees true trip counts.
    # Used ONLY by the dry-run's roofline calibration lowerings (XLA's
    # HloCostAnalysis counts while-loop bodies once).
    unroll_loops: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 256 multiple so embed/unembed shard cleanly on
        any production mesh (padded logit columns are masked to -inf)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM / hybrid-local only)"""
        return self.family == "ssm" or (
            self.family == "hybrid" and self.window > 0
        )

    def param_count(self) -> int:
        """Analytic parameter count (drives MODEL_FLOPS and optimizer pick)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if not self.embed_inputs:
            emb = self.vocab_size * d  # output head only
        att = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        mlp = 3 * d * self.d_ff
        per_layer = 0
        if self.family == "moe":
            moe = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
            per_layer = att + moe + (3 * d * self.d_ff if self.dense_residual else 0)
        elif self.family == "ssm":
            din = self.d_inner
            n = self.ssm_state
            per_layer = d * (2 * din + 2 * n + self.ssm_heads) \
                + din * d + self.conv_width * (din + 2 * n)
        elif self.family == "hybrid":
            w = self.rnn_width or d
            rec = d * w * 2 + w * d + 2 * w * (self.conv_width + 2) + mlp
            attn_l = att + mlp
            pat = self.block_pattern * (self.num_layers // max(len(self.block_pattern), 1)) \
                + self.tail_pattern
            n_rec = sum(1 for t in pat[: self.num_layers] if t == "rec")
            n_att = self.num_layers - n_rec
            return emb + n_rec * rec + n_att * attn_l
        else:
            per_layer = att + mlp
        return emb + self.num_layers * per_layer

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        hd = self.resolved_head_dim
        att = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        act_moe = self.experts_per_token * 3 * d * self.d_ff \
            + d * self.num_experts
        dense = 3 * d * self.d_ff if self.dense_residual else 0
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + self.num_layers * (att + act_moe + dense)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]
    num_microbatches: int = 1


# The assigned shape set (LM-family: seq_len x global_batch).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train", num_microbatches=16),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell; reason if not."""
    if shape.kind == "decode" and not arch.is_decoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
