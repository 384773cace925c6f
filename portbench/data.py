"""The benchmark's inputs, all drawn on the device from seeds.

The collection and its queries come from one model: a mixture of
Gaussian clusters, each spread over a low-dimensional subspace of its own
(``rank`` directions), plus a little noise in every dimension. Real
descriptors and embeddings (SIFT, CLIP) have a local intrinsic dimension
far below their width, and a graph index depends on it: over clusters
spread in all d dimensions, as the port's own generator
(``repro_torch.data.pipeline.clustered_vectors``) draws them, the nearest
neighbours past the first are all but equidistant, and recall at a fixed
beam falls as the collection grows (0.96 at 10,000 vectors, 0.58 at
60,000, L = 64).

The model's centres and subspaces come from the configuration's
``data_seed``; the collection is its first ``n`` draws; every batch of
queries is fresh draws from ``(--seed, batch index)``, so any batch can be
drawn again after the window for the reference without keeping it. All of
it is drawn with a ``torch.Generator`` on the device in a few large calls,
and only elementwise sums, so the same seed gives the same bits.

The traffic generator reads a mix's parameters (``traffic/<mix>.json``).
"""
from __future__ import annotations

import numpy as np
import torch


def batch_seed(seed: int, index: int) -> int:
    """A well-mixed 63-bit generator seed for batch ``index`` of run
    ``seed`` (any non-negative Python ints)."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(
        2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


CHUNK = 4096            # rows drawn at a time (bounds the gathered subspaces)


class Mixture:
    """``clusters`` clusters in ``dim`` dimensions: cluster c has a
    standard-normal centre and a (dim, rank) basis of N(0, scale^2)
    entries; a draw picks a cluster uniformly and returns its centre plus
    its basis times N(0, I_rank), plus ``noise`` x N(0, I_dim)."""

    def __init__(self, dim: int, *, clusters: int, rank: int, scale: float,
                 noise: float, seed: int, device):
        g = generator(seed, device)
        self.dim, self.rank, self.noise = dim, rank, float(noise)
        self.centres = torch.randn(clusters, dim, generator=g, device=device)
        self.bases = float(scale) * torch.randn(clusters, dim, rank,
                                                generator=g, device=device)
        self.g = g                   # continues into the collection's draws

    def draw(self, size: int, g: torch.Generator) -> torch.Tensor:
        """(size, dim) float32 draws from ``g``."""
        dev = self.centres.device
        c = torch.randint(0, self.centres.shape[0], (size,), generator=g,
                          device=dev)
        z = torch.randn(size, self.rank, generator=g, device=dev)
        eps = torch.randn(size, self.dim, generator=g, device=dev)
        out = torch.empty(size, self.dim, device=dev)
        for s in range(0, size, CHUNK):
            blk = slice(s, s + CHUNK)
            spread = (self.bases[c[blk]] * z[blk, None, :]).sum(-1)
            out[blk] = self.centres[c[blk]] + spread + self.noise * eps[blk]
        return out

    def collection(self, n: int) -> torch.Tensor:
        """The collection: the model's first ``n`` draws."""
        return self.draw(n, self.g)

    def queries(self, size: int, seed: int) -> torch.Tensor:
        """A batch of ``size`` fresh queries drawn from ``seed``."""
        return self.draw(size, generator(seed, self.centres.device))


class Traffic:
    """A mix's batches, from its parameters.

    Keys of a mix file: ``loop`` (the module of ``portbench/loops/`` that
    drives the window: ``closed``, one client that sends its next batch
    when the last one's results are back), ``batch`` (queries a batch),
    ``k`` and ``trace_batches`` (batches a traced run profiles). Every batch
    is fresh queries drawn from ``(seed, batch index)``.
    """

    def __init__(self, spec: dict, *, seed: int):
        self.loop = str(spec["loop"])
        self.seed = int(seed)
        self.batch = int(spec["batch"])
        self.k = int(spec["k"])
        self.trace_batches = int(spec["trace_batches"])
