"""CUDA wrapper: PQ asymmetric distance (ADC) for a batch of queries.

Replaces ``src/repro/kernels/pq_adc.py`` (``pq_adc``). The kernel is
``csrc/pq_adc.cu``: bound by bytes on the H100 (one add per code byte); the
TPU's one-hot matrix-unit contraction becomes a gather from the query's
table staged in shared memory, one thread per code row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

SMEM_LIMIT = 227 * 1024  # dynamic shared memory one H100 block may use


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"pq_adc: {msg}")


def pq_adc(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """codes: (Q, N, M) uint8, lut: (Q, M, K) float32, both contiguous on
    one CUDA device -> (Q, N) float32 ADC distances."""
    _require(codes.is_cuda and lut.device == codes.device,
             "codes and lut must be on one CUDA device")
    _require(codes.dtype == torch.uint8 and lut.dtype == torch.float32,
             f"need uint8 codes and float32 lut, got {codes.dtype}/{lut.dtype}")
    _require(codes.dim() == 3 and lut.dim() == 3
             and codes.shape[0] == lut.shape[0]
             and codes.shape[2] == lut.shape[1],
             f"need (Q, N, M) and (Q, M, K), got {tuple(codes.shape)} and "
             f"{tuple(lut.shape)}")
    _require(1 <= lut.shape[2] <= 256, f"K must be in [1, 256], got {lut.shape[2]}")
    _require(codes.is_contiguous() and lut.is_contiguous(),
             "inputs must be contiguous")
    nq, n, m = codes.shape
    k = lut.shape[2]
    _require(m * k * 4 <= SMEM_LIMIT,
             f"an (M, K) = ({m}, {k}) table does not fit in shared memory")
    out = torch.empty((nq, n), dtype=torch.float32, device=codes.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(codes.device):
        rc = _build.library().pageann_pq_adc(
            codes.data_ptr(), lut.data_ptr(), out.data_ptr(), nq, n, m, k,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "pq_adc")
    return out
