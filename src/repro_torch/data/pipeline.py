"""Deterministic synthetic data pipelines (numpy only): copies of
``repro.data.pipeline``.

Token pipeline: seeded per (host, step) so every host materializes only its
slice of the global batch. Vector pipeline: clustered Gaussians that mimic
SIFT-like local structure for the ANN benchmarks. Each makes the same
generator calls in the same order as the reference, so the same seed gives
the same arrays bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.transformer import FRONTEND_DIM


@dataclasses.dataclass
class TokenPipeline:
    arch: ArchConfig
    shape: ShapeConfig
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        if self.shape.global_batch % self.num_hosts:
            raise ValueError(f"global batch {self.shape.global_batch} does "
                             f"not split over {self.num_hosts} hosts")
        self.local_batch = self.shape.global_batch // self.num_hosts

    def batch(self, step: int) -> dict:
        """The host-local slice of global batch ``step`` (deterministic)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id
        )
        b, t = self.local_batch, self.shape.seq_len
        v = self.arch.vocab_size
        out: dict = {}
        if self.arch.embed_inputs:
            toks = rng.integers(0, v, (b, t + 1), dtype=np.int32)
            out["tokens"] = toks[:, :-1]
            out["labels"] = toks[:, 1:]
        else:
            out["embeds"] = rng.standard_normal((b, t, FRONTEND_DIM)).astype(
                np.float32
            )
            out["labels"] = rng.integers(0, v, (b, t), dtype=np.int32)
        out["positions"] = np.broadcast_to(
            np.arange(t, dtype=np.int32)[None], (b, t)
        ).copy()
        if self.arch.mrope:
            out["positions3"] = np.broadcast_to(
                np.arange(t, dtype=np.int32)[None, None], (3, b, t)
            ).copy()
        return out


def clustered_vectors(
    n: int, dim: int, num_clusters: int = 64, seed: int = 0, scale: float = 0.15
) -> np.ndarray:
    """SIFT-like clustered vector dataset for the ANN benchmarks."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((num_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, num_clusters, n)
    x = centers[assign] + scale * rng.standard_normal((n, dim)).astype(np.float32)
    return np.ascontiguousarray(x, np.float32)


def query_vectors(
    x: np.ndarray, q: int, seed: int = 1, noise: float = 0.1
) -> np.ndarray:
    """Queries near data points (realistic ANN workload)."""
    rng = np.random.default_rng(seed)
    base = x[rng.integers(0, len(x), q)]
    return (base + noise * rng.standard_normal(base.shape)).astype(np.float32)
