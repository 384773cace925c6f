"""Lightweight LSH routing index (paper Sec 4.3): port of ``repro.core.lsh``.

A sample of vectors is projected onto random hyperplanes and the sign
pattern is packed into 32-bit words. Torch has no uint32 arithmetic to
speak of, so the words are held as int32 with the same bit pattern: the bits
are packed in int64 and folded to the signed range before the cast. The
numpy generator calls are the reference's, so the planes and sample ids are
identical for the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ref as kernels_ref


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., B) {0,1} -> (..., B//32) int32 holding the uint32 words,
    little-endian within a word."""
    *lead, b = bits.shape
    w = b // 32
    bits = bits.reshape(*lead, w, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits << shifts).sum(-1)                   # [0, 2**32)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def hash_codes(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Random-hyperplane binary hash, packed. x: (N, d), planes: (d, B)
    -> (N, B//32) int32."""
    return pack_bits(x @ planes > 0)


def hamming_distance(codes: torch.Tensor, qcode: torch.Tensor) -> torch.Tensor:
    """Hamming distances between packed codes (S, W) and a query code (W,)
    -> (S,) int32. The words are int32 views of uint32 bit patterns: the
    popcount counts the sign bit as a bit (``kernels.ref.hamming_ref``)."""
    return kernels_ref.hamming_ref(codes, qcode[None, :])[0]


@dataclasses.dataclass
class LSHIndex:
    planes: torch.Tensor        # (d, B) float32
    sample_ids: torch.Tensor    # (S,) int32 — vector ids (reassigned space)
    sample_codes: torch.Tensor  # (S, B//32) int32 (uint32 bit patterns)
    sample_pq: torch.Tensor     # (S, M) uint8 — PQ codes of the sample

    @property
    def memory_bytes(self) -> int:
        return int(
            self.planes.numel() * 4
            + self.sample_ids.numel() * 4
            + self.sample_codes.numel() * 4
            + self.sample_pq.numel()
        )

    def query(self, q: torch.Tensor, top_t: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Entry vector ids and Hamming distances for a single query (d,):
        the ``top_t`` nearest samples by a stable sort, the lower sample
        first on ties, as ``jnp.argsort`` orders them."""
        qcode = hash_codes(q[None, :], self.planes)[0]
        ham = hamming_distance(self.sample_codes, qcode)
        top = torch.sort(ham, stable=True).indices[:top_t]
        return self.sample_ids[top], ham[top]


def build_lsh(
    x: np.ndarray,
    pq_codes: np.ndarray,
    bits: int,
    sample: int,
    seed: int = 0,
    *,
    device: str | torch.device = "cuda",
) -> LSHIndex:
    """Sample vectors, hash them, remember their ids and PQ codes.

    ``x`` must already be in the *reassigned* id space (row i == vector id i)
    so that routed entries can be mapped to pages with id // capacity.
    """
    device = resolve_device(device)
    n, d = x.shape
    rng = np.random.default_rng(seed)
    sample = min(sample, n)
    ids = rng.choice(n, size=sample, replace=False).astype(np.int32)
    planes = torch.as_tensor(
        rng.standard_normal((d, bits)).astype(np.float32)
    ).to(device)
    codes = hash_codes(
        torch.as_tensor(np.asarray(x[ids], np.float32)).to(device), planes
    )
    return LSHIndex(
        planes=planes,
        sample_ids=torch.as_tensor(ids).to(device),
        sample_codes=codes,
        sample_pq=torch.as_tensor(np.asarray(pq_codes[ids])).to(device),
    )
