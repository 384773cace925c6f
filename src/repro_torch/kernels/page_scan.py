"""CUDA wrappers: the fused page scan of one search hop.

Replaces ``src/repro/kernels/page_scan.py``: ``page_scan`` (the kernels
``_page_scan_kernel``, ``_page_scan_members_kernel`` and their masked
twins) and ``page_scan_recs`` (the four ``_page_scan_recs_*`` kernels). The
kernel is ``csrc/page_scan.cu``: bound by bytes on the H100 (each record
row is read once for ~3 flops per float, and with ADC the query's (M, K)
table is the largest input). With ADC one block serves one query: it
stages the query and its table once and the member rows of its pages
together (16-byte ``cp.async``), scores one (page, member) per warp and
one (page, neighbour column) per thread, gathering ADC sums from the table
in shared memory instead of the TPU's one-hot matrix-unit contraction.
Members-only scans run one warp per (query, page) with no shared memory: the
warp issues every member load of its record at once and keeps them in
registers. ``launch_plan`` picks the grid, threads, shared memory and pages
per block and per chunk. Every variant sums a member in the same order, so
a staged record scores bit for bit like the same record read by page id,
and the members-only scores equal the ADC variants', whatever the plan.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import record_layout as rl

SMEM_LIMIT = 227 * 1024  # dynamic shared memory one H100 block may use
CHUNK_BYTES = 24 * 1024  # member rows one block stages at once
NUM_SMS = 132            # streaming multiprocessors of an H100 SXM
MAX_THREADS = 256        # the kernel's launch bound
MEMBERS_WARPS = 4        # warps (pages) a members-only block, at most


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"page_scan: {msg}")


class LaunchPlan(NamedTuple):
    grid: int             # blocks
    threads: int          # threads per block
    smem_bytes: int       # dynamic shared memory per block
    pages_per_block: int  # ADC: pages of one query that one block scores;
                          # members only: the block's warps, one page each
    pages_per_chunk: int  # pages whose member rows are in shared memory at
                          # once (members only: 1, nothing is staged)


def launch_plan(nq: int, b: int, *, capacity: int, dim: int, rp: int, m: int,
                k: int, compute_adc: bool, sms: int = NUM_SMS,
                pages_per_block: int | None = None,
                pages_per_chunk: int | None = None,
                threads: int | None = None) -> LaunchPlan:
    """How the kernel is launched for a hop of ``nq`` queries x ``b`` pages.

    With ADC a block owns one query's pages, so its (M, K) table is staged
    once; when fewer queries than ``sms`` would leave SMs idle, each
    query's pages are split over up to ``ceil(2 sms / nq)`` blocks (at
    Q = 64 one page a block was the fastest plan on the H100). A block
    stages the member rows of up to ``CHUNK_BYTES`` of pages at once and
    loops over the rest. ``pages_per_block``, ``pages_per_chunk`` and
    ``threads`` replace the plan's own choices (every plan gives the same
    bits). Raises where one page's rows, the query and its table do not fit
    in one block's shared memory.

    Members only, one warp scores one (query, slot) item and a block the
    next ``threads / 32`` of them, with no shared memory:
    ``MEMBERS_WARPS`` warps a block, fewer while that leaves fewer blocks
    than ``sms``. Only ``threads`` may be replaced."""
    if not compute_adc:
        _require(pages_per_block is None and pages_per_chunk is None,
                 "a members-only scan runs one page a warp; threads sets "
                 "the warps of a block")
        if threads is None:
            threads = members_threads(nq * b, sms)
        warps = max(1, threads // 32)
        return LaunchPlan(grid=-(-nq * b // warps), threads=threads,
                          smem_bytes=0, pages_per_block=warps,
                          pages_per_chunk=1)
    page_floats = rl.member_rows(capacity, dim) * rl.PAGE_LANES
    fixed = dim + m * k
    smem_min = (fixed + page_floats) * 4
    _require(smem_min <= SMEM_LIMIT,
             f"{smem_min} bytes of shared memory needed, {SMEM_LIMIT} available")
    ppb = pages_per_block
    if ppb is None:
        groups = 1 if nq >= sms else max(1, min(b, -(-2 * sms // max(nq, 1))))
        ppb = -(-b // groups)
    ppb = max(1, min(b, ppb))
    fit = min(CHUNK_BYTES // 4, SMEM_LIMIT // 4 - fixed) // page_floats
    ppc = max(1, min(ppb, pages_per_chunk or fit))
    if threads is None:
        threads = MAX_THREADS if ppc * rp > 128 else 128
    return LaunchPlan(grid=nq * -(-b // ppb), threads=threads,
                      smem_bytes=(fixed + ppc * page_floats) * 4,
                      pages_per_block=ppb, pages_per_chunk=ppc)


def members_threads(items: int, sms: int = NUM_SMS) -> int:
    """Threads a block of a one-warp-per-item member scan (the members-only
    page scan, ``page_gather_l2``): ``MEMBERS_WARPS`` warps, halved while
    that leaves fewer blocks than ``sms``."""
    warps = MEMBERS_WARPS
    while warps > 1 and -(-items // warps) < sms:
        warps //= 2
    return 32 * warps


@functools.cache
def sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(recs, page_ids, q, lut, member_mask, *, nq, b, capacity, dim,
            rp, compute_adc, staged):
    """Check the inputs the two wrappers share, plan, allocate, launch,
    count."""
    dev = recs.device
    tensors = [recs, q] + ([page_ids] if page_ids is not None else [])
    tensors += [lut] if compute_adc else []
    tensors += [member_mask] if member_mask is not None else []
    _require(all(t.device == dev for t in tensors),
             "all inputs must be on one CUDA device")
    _require(all(t.is_contiguous() for t in tensors),
             "inputs must be contiguous")
    _require(recs.dtype == torch.float32 and q.dtype == torch.float32,
             "recs and q must be float32")
    _require(recs.data_ptr() % 16 == 0,
             "recs must be 16-byte aligned (the kernel copies float4s)")
    rows = recs.shape[-2]
    mrows = rl.member_rows(capacity, dim)
    _require(tuple(q.shape) == (nq, dim),
             f"q must be ({nq}, {dim}), got {tuple(q.shape)}")
    _require(0 < rp <= rl.PAGE_LANES, f"rp must be in (0, 128], got {rp}")
    m = k = 0
    if compute_adc:
        _require(lut.dtype == torch.float32 and lut.dim() == 3
                 and lut.shape[0] == nq,
                 f"lut must be ({nq}, M, K) float32, got {tuple(lut.shape)}")
        m, k = lut.shape[1:]
        _require(1 <= k <= 256, f"K must be in [1, 256], got {k}")
    if member_mask is not None:
        _require(member_mask.dtype == torch.float32
                 and tuple(member_mask.shape) == (nq, b, capacity),
                 f"member_mask must be ({nq}, {b}, {capacity}) float32, got "
                 f"{tuple(member_mask.shape)} {member_mask.dtype}")
    _require(mrows + m <= rows,
             f"records of {rows} rows cannot hold {mrows} member rows and "
             f"{m} code rows")
    plan = launch_plan(nq, b, capacity=capacity, dim=dim, rp=rp, m=m, k=k,
                       compute_adc=compute_adc, sms=sm_count(dev))

    member_d = torch.empty((nq, b, capacity), dtype=torch.float32, device=dev)
    nbr_d = (torch.empty((nq, b, rp), dtype=torch.float32, device=dev)
             if compute_adc else None)
    if nq * b == 0:
        return member_d, nbr_d
    num_records = recs.shape[0] if not staged else nq * b
    with torch.cuda.device(dev):
        rc = _build.library().pageann_page_scan(
            recs.data_ptr(),
            page_ids.data_ptr() if page_ids is not None else None,
            q.data_ptr(),
            lut.data_ptr() if compute_adc else None,
            member_mask.data_ptr() if member_mask is not None else None,
            member_d.data_ptr(),
            nbr_d.data_ptr() if compute_adc else None,
            nq, b, num_records, rows, mrows, m, k, capacity, dim, rp,
            int(compute_adc), int(staged), *plan,
            torch.cuda.current_stream().cuda_stream,
        )
    name = "page_scan" + ("_recs" if staged else "")
    name += "" if compute_adc else "_members"
    name += "_masked" if member_mask is not None else ""
    _build.check(rc, name)
    return member_d, nbr_d


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
    member_mask: torch.Tensor | None = None,
):
    """recs: (P, rows, 128) f32, page_ids: (Q, b) int32 in [0, P), q:
    (Q, dim) f32, lut: (Q, M, K) f32 (ignored and may be None without ADC),
    member_mask: (Q, b, capacity) f32 or None; all contiguous on one CUDA
    device.

    -> (member_d (Q, b, capacity) f32, nbr_d (Q, b, rp) f32 or None).
    ``compute_adc=False`` launches the members-only kernel, which never
    reads the code rows (MEM_ALL records have none). Members whose mask is
    <= 0 score ``+inf``; the neighbour ADC is never masked.
    """
    _require(recs.is_cuda, "recs must be on a CUDA device")
    _require(recs.dim() == 3 and recs.shape[2] == rl.PAGE_LANES,
             f"recs must be (P, rows, {rl.PAGE_LANES}), got {tuple(recs.shape)}")
    _require(page_ids.dtype == torch.int32 and page_ids.dim() == 2,
             "page_ids must be (Q, b) int32")
    _require(recs.shape[0] > 0, "empty page store")
    nq, b = page_ids.shape
    return _launch(recs, page_ids, q, lut, member_mask, nq=nq, b=b,
                   capacity=capacity, dim=dim, rp=rp,
                   compute_adc=compute_adc, staged=False)


def page_scan_recs(
    recs_b: torch.Tensor,
    q: torch.Tensor,
    lut: torch.Tensor | None,
    *,
    capacity: int,
    dim: int,
    rp: int,
    compute_adc: bool = True,
    member_mask: torch.Tensor | None = None,
):
    """``page_scan`` on an already-staged batch: recs_b (Q, b, rows, 128)
    f32, record (i, j) scored for query i; the other inputs and the outputs
    as ``page_scan``'s."""
    _require(recs_b.is_cuda, "recs must be on a CUDA device")
    _require(recs_b.dim() == 4 and recs_b.shape[3] == rl.PAGE_LANES,
             f"recs_b must be (Q, b, rows, {rl.PAGE_LANES}), got "
             f"{tuple(recs_b.shape)}")
    nq, b = recs_b.shape[:2]
    return _launch(recs_b, None, q, lut, member_mask, nq=nq, b=b,
                   capacity=capacity, dim=dim, rp=rp,
                   compute_adc=compute_adc, staged=True)
