"""Synthetic vector datasets for the ANN benchmarks (numpy only).

Copies of ``clustered_vectors`` / ``query_vectors`` from
``repro.data.pipeline``: same generator calls in the same order, so the same
seed gives the same arrays bit for bit.
"""
from __future__ import annotations

import numpy as np


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
