"""CUDA wrappers: XOR + popcount Hamming sweep for the LSH router.

Replaces ``src/repro/kernels/hamming.py`` (``hamming``), and with
``hamming_topk`` also the stable top-T the reference's routing takes of its
output (``lax.top_k`` in ``repro.core.search.init_state``). The kernels are
in ``csrc/hamming.cu``: bound by bytes on the H100 (a popcount per 4-byte
word), with the hardware ``__popc`` in place of the TPU's SWAR
bit-twiddle. ``hamming`` scores 4 samples a thread with one 16-byte store
(and 16-byte code loads for W = 2, the LSH's 64 bits); ``hamming_topk``
runs one block a query, a counting sort on the 32 W + 1 possible values,
and writes only the (Q, T) result. Both count their launches as
``hamming``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"hamming: {msg}")


def _check(codes: torch.Tensor, qcodes: torch.Tensor) -> None:
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


def hamming(codes: torch.Tensor, qcodes: torch.Tensor) -> torch.Tensor:
    """codes: (S, W) int32, qcodes: (Q, W) int32 (uint32 bit patterns), both
    contiguous on one CUDA device -> (Q, S) int32 Hamming distances."""
    _check(codes, qcodes)
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


def hamming_topk(codes: torch.Tensor, qcodes: torch.Tensor,
                 t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """codes: (S, W) int32, qcodes: (Q, W) int32, both contiguous on one
    CUDA device -> (vals (Q, t) int32, idx (Q, t) int32): the first t of a
    stable ascending sort of each row of ``hamming(codes, qcodes)``, the
    lower sample first on ties (``lax.top_k``'s order). Raises when
    t > S, as ``lax.top_k`` does."""
    _check(codes, qcodes)
    s, w = codes.shape
    nq = qcodes.shape[0]
    _require(0 <= t <= s, f"t = {t} must be in [0, S = {s}]")
    vals = torch.empty((nq, t), dtype=torch.int32, device=codes.device)
    idx = torch.empty((nq, t), dtype=torch.int32, device=codes.device)
    if vals.numel() == 0:
        return vals, idx
    with torch.cuda.device(codes.device):
        rc = _build.library().pageann_hamming_topk(
            codes.data_ptr(), qcodes.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), nq, s, w, t,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "hamming")
    return vals, idx
