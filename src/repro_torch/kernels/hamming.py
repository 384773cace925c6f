"""CUDA wrapper: XOR + popcount Hamming sweep for the LSH router.

Replaces ``src/repro/kernels/hamming.py`` (``hamming``). The kernel is
``csrc/hamming.cu``: bound by bytes on the H100 (a popcount per 4-byte
word); one thread per (query, sample) with coalesced stores and the
hardware ``__popc`` in place of the TPU's SWAR bit-twiddle.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"hamming: {msg}")


def hamming(codes: torch.Tensor, qcodes: torch.Tensor) -> torch.Tensor:
    """codes: (S, W) int32, qcodes: (Q, W) int32 (uint32 bit patterns), both
    contiguous on one CUDA device -> (Q, S) int32 Hamming distances."""
    _require(codes.is_cuda and qcodes.device == codes.device,
             "codes and qcodes must be on one CUDA device")
    _require(codes.dtype == torch.int32 and qcodes.dtype == torch.int32,
             "codes and qcodes must be int32")
    _require(codes.dim() == 2 and qcodes.dim() == 2
             and codes.shape[1] == qcodes.shape[1],
             f"need (S, W) and (Q, W), got {tuple(codes.shape)} and "
             f"{tuple(qcodes.shape)}")
    _require(codes.is_contiguous() and qcodes.is_contiguous(),
             "inputs must be contiguous")
    s, w = codes.shape
    nq = qcodes.shape[0]
    out = torch.empty((nq, s), dtype=torch.int32, device=codes.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(codes.device):
        rc = _build.library().pageann_hamming(
            codes.data_ptr(), qcodes.data_ptr(), out.data_ptr(), nq, s, w,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "hamming")
    return out
