"""Product quantization: the compressed vector representation of the paper.

Port of ``repro.core.pq``. Codebooks are trained with Lloyd k-means per
subspace, vectors are encoded by an argmin over expanded-norm squared
distances (the reference's exact formula, so codes differ only on
near-ties), and a query's ADC table holds its squared distance to every
centroid of every subspace. The ADC sum itself is the ``pq_adc`` kernel
(``repro_torch.kernels.ops``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ref


def _sq_dists(sub: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """(N, dsub) x (K, dsub) -> (N, K) expanded-norm squared L2, in the
    reference's order of operations."""
    return (
        (sub * sub).sum(-1)[:, None]
        - 2.0 * sub @ cents.T
        + (cents * cents).sum(-1)[None, :]
    )


def _kmeans_1sub(xsub: torch.Tensor, init: torch.Tensor, *, ksub: int,
                 iters: int) -> torch.Tensor:
    """Lloyd k-means for one PQ subspace. xsub: (N, dsub), init: (ksub,)
    row ids of the starting centroids.

    Each centroid's members are summed one after another in row order (a
    stable sort by assignment, then a segment sum): no atomic adds, so two
    same-seed trainings on the card give the same bits, and the CPU's sums
    are those of a serial scatter-add. The reference's one-hot product sums
    the same members in another order."""
    cents = xsub[init]
    for _ in range(iters):
        assign = _sq_dists(xsub, cents).argmin(1)
        counts = torch.bincount(assign, minlength=ksub)
        order = torch.sort(assign, stable=True).indices
        sums = torch.segment_reduce(xsub[order], "sum", lengths=counts, axis=0)
        counts = counts.to(xsub.dtype)
        cents = torch.where(
            counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], cents
        )
    return cents


def train_pq(
    x: np.ndarray, m: int, ksub: int = 256, iters: int = 12, seed: int = 0,
    *, device: str | torch.device = "cuda",
) -> np.ndarray:
    """Train PQ codebooks on ``device``. Returns (M, ksub, dsub) float32.

    Each subspace starts from ``ksub`` distinct rows (with replacement only
    when there are fewer rows than centroids), drawn from one
    ``torch.Generator`` seeded with ``seed`` in place of the reference's
    ``jax.random.choice``, so codebooks match the reference statistically,
    not bit for bit.
    """
    device = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32)).to(device)
    n, d = xt.shape
    dsub = d // m
    gen = torch.Generator().manual_seed(seed)
    books = []
    for j in range(m):
        if n >= ksub:
            init = torch.randperm(n, generator=gen)[:ksub]
        else:
            init = torch.randint(0, n, (ksub,), generator=gen)
        xsub = xt[:, j * dsub:(j + 1) * dsub].contiguous()
        books.append(_kmeans_1sub(xsub, init.to(device), ksub=ksub, iters=iters))
    return torch.stack(books).cpu().numpy()


def pq_encode(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Encode vectors to PQ codes. x: (N, d), codebooks (M, ksub, dsub)
    -> (N, M) uint8 on x's device."""
    n = x.shape[0]
    m, _, dsub = codebooks.shape
    codes = torch.empty((n, m), dtype=torch.uint8, device=x.device)
    for j in range(m):
        sub = x[:, j * dsub:(j + 1) * dsub]
        codes[:, j] = _sq_dists(sub, codebooks[j]).argmin(1).to(torch.uint8)
    return codes


def pq_lut(q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Per-query ADC lookup tables. q: (Q, d), codebooks (M, ksub, dsub)
    -> (Q, M, ksub) squared sub-distances (``kernels.ref.pq_lut_ref``, the
    plain version of ``kernels.ops.pq_lut``)."""
    return ref.pq_lut_ref(q, codebooks)


def adc_distance(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Asymmetric distance: the sum of the LUT entries the codes select.

    codes: (..., M) uint8, lut: (M, ksub) -> (...,) float32. The plain
    counterpart of ``repro.core.pq.adc_distance``; the search's batched
    ADC is the ``pq_adc`` kernel."""
    m = lut.shape[0]
    rows = torch.arange(m, device=lut.device)
    return lut[rows, codes.long()].sum(-1)


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Reconstruct approximate vectors from codes (for diagnostics).
    codes: (N, M), codebooks: (M, ksub, dsub) -> (N, M * dsub)."""
    m, _, dsub = codebooks.shape
    rows = torch.arange(m, device=codebooks.device)
    return codebooks[rows, codes.long()].reshape(codes.shape[0], m * dsub)
