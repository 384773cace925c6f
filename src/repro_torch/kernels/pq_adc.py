"""CUDA wrappers: PQ asymmetric distance (ADC) for a batch of queries.

Replaces ``src/repro/kernels/pq_adc.py`` (``pq_adc``). The kernel is
``csrc/pq_adc.cu``: bound by bytes on the H100 (one add per code byte, the
queries' (M, K) tables most of the bytes); the TPU's one-hot matrix-unit
contraction becomes a gather from the query's table, brought into shared
memory by one bulk asynchronous copy, one thread per code row.
``pq_adc_gather`` reads each code row by id from the code table itself, so
the search never writes the gathered (Q, N, M) codes; ``pq_adc`` takes codes
already gathered. Both launch the same kernel body and count as ``pq_adc``.
``launch_plan`` sizes the grid and the block to the rows.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

SMEM_LIMIT = 227 * 1024  # dynamic shared memory one H100 block may use
MAX_THREADS = 256        # the kernel's launch bound
MAX_ROWS = 1024          # code rows one block scores (four a thread)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"pq_adc: {msg}")


class LaunchPlan(NamedTuple):
    grid: int            # blocks: queries x chunks
    threads: int         # threads per block, a multiple of 32
    chunks: int          # blocks a query's rows are split over
    rows_per_block: int  # rows one block scores (the last block fewer)
    smem_bytes: int      # one query's (M, K) f32 table


def launch_plan(nq: int, n: int, m: int, k: int) -> LaunchPlan:
    """One block a query while its ``n`` rows fit in ``MAX_ROWS``, so the
    table is copied once a query; threads: the rows rounded up to whole
    warps, at most ``MAX_THREADS`` (a thread loops over the rest). At the
    HYBRID re-score (240 rows) a block is 8 warps, at the entry estimates
    (16 rows) one."""
    chunks = max(1, -(-n // MAX_ROWS))
    rows = -(-n // chunks)
    threads = min(MAX_THREADS, 32 * max(1, -(-rows // 32)))
    return LaunchPlan(grid=nq * chunks, threads=threads, chunks=chunks,
                      rows_per_block=rows, smem_bytes=m * k * 4)


def _check_lut(lut: torch.Tensor, device: torch.device, nq: int, m: int) -> int:
    _require(lut.device == device, "the codes and lut must be on one CUDA device")
    _require(lut.dtype == torch.float32, f"need a float32 lut, got {lut.dtype}")
    _require(lut.dim() == 3 and lut.shape[0] == nq and lut.shape[1] == m,
             f"need a ({nq}, {m}, K) lut, got {tuple(lut.shape)}")
    _require(lut.is_contiguous(), "lut must be contiguous")
    k = lut.shape[2]
    _require(1 <= k <= 256, f"K must be in [1, 256], got {k}")
    _require(m * k * 4 <= SMEM_LIMIT,
             f"an (M, K) = ({m}, {k}) table does not fit in shared memory")
    return k


def _launch(table, ids, lut, *, nq: int, n: int, m: int, k: int) -> torch.Tensor:
    out = torch.empty((nq, n), dtype=torch.float32, device=lut.device)
    if out.numel() == 0:
        return out
    plan = launch_plan(nq, n, m, k)
    with torch.cuda.device(lut.device):
        rc = _build.library().pageann_pq_adc(
            table.data_ptr(), ids.data_ptr() if ids is not None else None,
            lut.data_ptr(), out.data_ptr(),
            ids.stride(0) if ids is not None else 0, nq, n, m, k,
            plan.chunks, plan.rows_per_block, plan.threads,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "pq_adc")
    return out


def pq_adc(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """codes: (Q, N, M) uint8, lut: (Q, M, K) float32, both contiguous on
    one CUDA device -> (Q, N) float32 ADC distances."""
    _require(codes.is_cuda, "codes must be on a CUDA device")
    _require(codes.dtype == torch.uint8, f"need uint8 codes, got {codes.dtype}")
    _require(codes.dim() == 3, f"need (Q, N, M) codes, got {tuple(codes.shape)}")
    _require(codes.is_contiguous(), "codes must be contiguous")
    nq, n, m = codes.shape
    k = _check_lut(lut, codes.device, nq, m)
    return _launch(codes, None, lut, nq=nq, n=n, m=m, k=k)


def pq_adc_gather(table: torch.Tensor, ids: torch.Tensor,
                  lut: torch.Tensor) -> torch.Tensor:
    """table: (R, M) uint8 code rows, contiguous; ids: (Q, N) int64 rows
    of ``table`` in [0, R) (rows of any stride, elements adjacent; other
    integer types are converted first); lut: (Q, M, K) float32, contiguous;
    all on one CUDA device -> (Q, N) float32, equal to
    ``pq_adc(table[ids], lut)``."""
    _require(table.is_cuda, "table must be on a CUDA device")
    _require(table.dtype == torch.uint8, f"need a uint8 table, got {table.dtype}")
    _require(table.dim() == 2 and table.is_contiguous(),
             f"need a contiguous (R, M) table, got {tuple(table.shape)}")
    _require(ids.device == table.device, "ids must be on the table's device")
    _require(not ids.is_floating_point() and not ids.is_complex(),
             f"need integer ids, got {ids.dtype}")
    _require(ids.dim() == 2, f"need (Q, N) ids, got {tuple(ids.shape)}")
    nq, n = ids.shape
    ids = ids.to(torch.int64)
    if ids.stride(1) != 1 or ids.stride(0) > 2**31 - 1:
        ids = ids.contiguous()
    m = table.shape[1]
    k = _check_lut(lut, table.device, nq, m)
    return _launch(table, ids, lut, nq=nq, n=n, m=m, k=k)


def blocks_per_sm(threads: int, smem_bytes: int) -> int:
    """Blocks of the main path's kernel (rows by id, 16-byte code rows,
    bulk table copy) one SM holds at once, as the CUDA runtime computes
    it."""
    blocks = ctypes.c_int(0)
    rc = _build.library().pageann_pq_adc_blocks_per_sm(
        threads, smem_bytes, ctypes.addressof(blocks))
    if rc != 0:
        raise RuntimeError(f"pq_adc occupancy query failed: cudaError {rc}")
    return blocks.value
