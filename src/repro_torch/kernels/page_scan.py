"""CUDA wrapper: the fused page scan of one search hop.

Replaces ``src/repro/kernels/page_scan.py`` (``page_scan``, the unmasked
kernels ``_page_scan_kernel`` and ``_page_scan_members_kernel``). The kernel
is ``csrc/page_scan.cu``: bound by bytes on the H100 (each record row is
read once for ~3 flops per float). One block per (query, page) loads its own
page id, copies the member rows to shared memory with 16-byte loads, scores
one member per warp, and gathers neighbour ADC sums from the query's table
in shared memory instead of the TPU's one-hot matrix-unit contraction.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import record_layout as rl

SMEM_LIMIT = 227 * 1024  # dynamic shared memory one H100 block may use


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"page_scan: {msg}")


def page_scan(
    recs: torch.Tensor,
    page_ids: torch.Tensor,
    q: torch.Tensor,
    lut: torch.Tensor | None,
    *,
    capacity: int,
    dim: int,
    rp: int,
    compute_adc: bool = True,
):
    """recs: (P, rows, 128) f32, page_ids: (Q, b) int32 in [0, P), q:
    (Q, dim) f32, lut: (Q, M, K) f32 (ignored and may be None without ADC);
    all contiguous on one CUDA device.

    -> (member_d (Q, b, capacity) f32, nbr_d (Q, b, rp) f32 or None).
    ``compute_adc=False`` launches the members-only kernel, which never
    reads the code rows (MEM_ALL records have none).
    """
    dev = recs.device
    _require(recs.is_cuda, "recs must be on a CUDA device")
    tensors = [recs, page_ids, q] + ([lut] if compute_adc else [])
    _require(all(t.device == dev for t in tensors),
             "all inputs must be on one CUDA device")
    _require(all(t.is_contiguous() for t in tensors),
             "inputs must be contiguous")
    _require(recs.dtype == torch.float32 and q.dtype == torch.float32,
             "recs and q must be float32")
    _require(page_ids.dtype == torch.int32, "page_ids must be int32")
    _require(recs.dim() == 3 and recs.shape[2] == rl.PAGE_LANES,
             f"recs must be (P, rows, {rl.PAGE_LANES}), got {tuple(recs.shape)}")
    _require(page_ids.dim() == 2, "page_ids must be (Q, b)")
    nq, b = page_ids.shape
    num_pages, rows, _ = recs.shape
    mrows = rl.member_rows(capacity, dim)
    _require(tuple(q.shape) == (nq, dim),
             f"q must be ({nq}, {dim}), got {tuple(q.shape)}")
    _require(num_pages > 0, "empty page store")
    _require(0 < rp <= rl.PAGE_LANES, f"rp must be in (0, 128], got {rp}")
    m = k = 0
    if compute_adc:
        _require(lut.dtype == torch.float32 and lut.dim() == 3
                 and lut.shape[0] == nq,
                 f"lut must be ({nq}, M, K) float32, got {tuple(lut.shape)}")
        m, k = lut.shape[1:]
        _require(1 <= k <= 256, f"K must be in [1, 256], got {k}")
    _require(mrows + m <= rows,
             f"records of {rows} rows cannot hold {mrows} member rows and "
             f"{m} code rows")
    smem = (mrows * rl.PAGE_LANES + dim + m * k) * 4
    _require(smem <= SMEM_LIMIT,
             f"{smem} bytes of shared memory needed, {SMEM_LIMIT} available")

    member_d = torch.empty((nq, b, capacity), dtype=torch.float32, device=dev)
    nbr_d = (torch.empty((nq, b, rp), dtype=torch.float32, device=dev)
             if compute_adc else None)
    if nq * b == 0:
        return member_d, nbr_d
    with torch.cuda.device(dev):
        rc = _build.library().pageann_page_scan(
            recs.data_ptr(), page_ids.data_ptr(), q.data_ptr(),
            lut.data_ptr() if compute_adc else None,
            member_d.data_ptr(),
            nbr_d.data_ptr() if compute_adc else None,
            nq, b, num_pages, rows, mrows, m, k, capacity, dim, rp,
            int(compute_adc), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "page_scan" if compute_adc else "page_scan_members")
    return member_d, nbr_d
