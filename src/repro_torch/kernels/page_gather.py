"""CUDA wrapper: page-aligned gather + member L2.

Replaces ``src/repro/kernels/page_gather.py`` (``page_gather_l2``), batched
over queries. The kernel is ``csrc/page_gather.cu``: bound by bytes on the
H100 (three flops a loaded float). One warp scores one (query, page) item:
it loads its own page id, issues every member load of the page at once and
keeps them and the query's columns in registers, with no shared memory. Its
block size is the members-only page scan's (``page_scan.members_threads``),
and the sum is its code (``csrc/member_l2.cuh``), so the two give the same
bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import page_scan as page_scan_k


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"page_gather_l2: {msg}")


def page_gather_l2(pages: torch.Tensor, page_ids: torch.Tensor,
                   q: torch.Tensor) -> torch.Tensor:
    """pages: (P, cap, d) f32, page_ids: (Q, b) int32 in [0, P), q: (Q, d)
    f32, all contiguous on one CUDA device -> (Q, b, cap) f32 squared L2
    of each page vector to its query."""
    _require(pages.is_cuda, "pages must be on a CUDA device")
    _require(page_ids.device == pages.device and q.device == pages.device,
             "all inputs must be on one CUDA device")
    _require(pages.dtype == torch.float32 and q.dtype == torch.float32,
             "pages and q must be float32")
    _require(page_ids.dtype == torch.int32 and page_ids.dim() == 2,
             "page_ids must be (Q, b) int32")
    _require(pages.dim() == 3 and pages.shape[0] > 0,
             f"pages must be a non-empty (P, cap, d), got {tuple(pages.shape)}")
    _require(all(t.is_contiguous() for t in (pages, page_ids, q)),
             "inputs must be contiguous")
    num_pages, cap, dim = pages.shape
    nq, b = page_ids.shape
    _require(tuple(q.shape) == (nq, dim),
             f"q must be ({nq}, {dim}), got {tuple(q.shape)}")
    out = torch.empty((nq, b, cap), dtype=torch.float32, device=pages.device)
    if out.numel() == 0:
        return out
    threads = page_scan_k.members_threads(nq * b,
                                          page_scan_k.sm_count(pages.device))
    with torch.cuda.device(pages.device):
        rc = _build.library().pageann_page_gather_l2(
            pages.data_ptr(), page_ids.data_ptr(), q.data_ptr(),
            out.data_ptr(), nq, b, num_pages, cap, dim, threads,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "page_gather_l2")
    return out
