"""CUDA wrapper: the search's ADC lookup tables.

Replaces no Pallas kernel: the reference builds the tables in plain jnp
(``src/repro/core/pq.py`` ``pq_lut``). Added because the same formula in
PyTorch (``kernels.ref.pq_lut_ref``) writes two (Q, M, K, dsub) float32
intermediates to device memory. The kernel is ``csrc/pq_lut.cu``: bound by
the bytes of the (Q, M, K) tables it writes, it computes each entry in
registers from a codebook staged in shared memory and stores it with
full-width coalesced writes; the intermediates never exist. Each entry is
the float32 sum of the squared differences in coordinate order, rounded at
every step as the plain formula's terms are. ``launch_plan`` sizes the
block, its query tile and the codebook chunk from (Q, M, K, dsub).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.page_scan import NUM_SMS, sm_count

SMEM_BUDGET = 48 * 1024  # shared memory a block stages at once
MAX_THREADS = 256        # the kernel's launch bound
MAX_PASSES = 8           # queries a thread sums (its 4 x 8 accumulators)
MAX_K = 4 * MAX_THREADS  # one row of K, four a thread, fits in a block


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"pq_lut: {msg}")


class LaunchPlan(NamedTuple):
    grid: int        # blocks: subspaces x query tiles
    threads: int     # rows x ceil(K / 4)
    rows: int        # queries a block sums at once, ceil(K / 4) threads each
    passes: int      # times a block does so: its tile is rows x passes
    chunk: int       # codebook coordinates staged at once
    smem_bytes: int  # the chunk of (K, dsub) codebook and of the tile's queries


def launch_plan(nq: int, m: int, k: int, dsub: int,
                sms: int = NUM_SMS) -> LaunchPlan:
    """As many queries a block as fit ``MAX_THREADS`` threads of four k
    each, times ``MAX_PASSES``, halved while that leaves fewer than two
    blocks an SM (a block's staging costs as much as its passes, so fewer,
    fuller blocks are faster); the codebook in chunks of as many
    coordinates as fit ``SMEM_BUDGET`` beside the tile's queries."""
    _require(1 <= k <= MAX_K, f"K must be in [1, {MAX_K}], got {k}")
    _require(dsub >= 1, f"dsub must be at least 1, got {dsub}")
    k4n = -(-k // 4)
    rows = MAX_THREADS // k4n
    passes = MAX_PASSES
    while passes > 1 and m * -(-nq // (rows * passes)) < 2 * sms:
        passes //= 2
    tile = rows * passes
    chunk = min(dsub, SMEM_BUDGET // (4 * (4 * k4n + tile)))
    return LaunchPlan(grid=m * -(-nq // tile), threads=rows * k4n, rows=rows,
                      passes=passes, chunk=chunk,
                      smem_bytes=4 * chunk * (4 * k4n + tile))


def pq_lut(q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """q: (Q, d) float32, codebooks: (M, K, dsub) float32 with d = M x dsub,
    both contiguous on one CUDA device -> (Q, M, K) float32 tables,
    ``out[i, m, k] = sum_j (q[i, m * dsub + j] - codebooks[m, k, j]) ** 2``."""
    _require(q.dtype == torch.float32 and codebooks.dtype == torch.float32,
             f"need float32 q and codebooks, got {q.dtype} and {codebooks.dtype}")
    _require(q.dim() == 2, f"need (Q, d) queries, got {tuple(q.shape)}")
    _require(codebooks.dim() == 3,
             f"need (M, K, dsub) codebooks, got {tuple(codebooks.shape)}")
    m, k, dsub = codebooks.shape
    _require(q.shape[1] == m * dsub,
             f"queries of d = {q.shape[1]} do not split into {m} x {dsub}")
    _require(q.is_cuda and codebooks.device == q.device,
             "q and codebooks must be on one CUDA device")
    _require(q.is_contiguous() and codebooks.is_contiguous(),
             "q and codebooks must be contiguous")
    nq = q.shape[0]
    out = torch.empty((nq, m, k), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    plan = launch_plan(nq, m, k, dsub, sms=sm_count(q.device))
    with torch.cuda.device(q.device):
        rc = _build.library().pageann_pq_lut(
            q.data_ptr(), codebooks.data_ptr(), out.data_ptr(), nq, m, k, dsub,
            plan.rows, plan.passes, plan.chunk, plan.threads,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "pq_lut")
    return out
