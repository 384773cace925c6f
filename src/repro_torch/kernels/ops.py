"""Dispatch: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

The search path calls these with ``impl=None``: a tensor on the CPU goes to
the plain PyTorch version in ``ref``, a tensor on a CUDA device to the
hand-written kernel. There is no fallback — if the kernels cannot be built
or a launch fails on the card, the call raises. ``impl="plain"`` forces the
plain version on any device; tests and ``chip_smoke.py`` use it to hold the
kernels against it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import hamming as hamming_k
from repro_torch.kernels import page_scan as page_scan_k
from repro_torch.kernels import pq_adc as pq_adc_k

reset_launch_counts = _build.reset_launch_counts
launch_counts = _build.launch_counts


def _use_kernel(impl: str | None, t: torch.Tensor) -> bool:
    if impl is None:
        return t.is_cuda
    if impl == "plain":
        return False
    raise ValueError(f"impl must be None or 'plain', got {impl!r}")


def hamming(codes: torch.Tensor, qcodes: torch.Tensor, *,
            impl: str | None = None) -> torch.Tensor:
    """(S, W) int32 codes, (Q, W) int32 query codes -> (Q, S) int32."""
    if _use_kernel(impl, codes):
        return hamming_k.hamming(codes, qcodes)
    return ref.hamming_ref(codes, qcodes)


def pq_adc(codes: torch.Tensor, lut: torch.Tensor, *,
           impl: str | None = None) -> torch.Tensor:
    """(Q, N, M) uint8 codes, (Q, M, K) f32 tables -> (Q, N) f32."""
    if _use_kernel(impl, codes):
        return pq_adc_k.pq_adc(codes.contiguous(), lut.contiguous())
    return ref.pq_adc_ref(codes, lut)


def page_scan(recs, page_ids, q, lut, *, capacity: int, dim: int, rp: int,
              compute_adc: bool = True, member_mask=None,
              impl: str | None = None):
    """Fused hop scan. recs (P, rows, 128) f32, page_ids (Q, b) >= 0,
    q (Q, d) f32, lut (Q, M, K) f32, member_mask (Q, b, cap) f32 or None
    -> ((Q, b, cap) member L2, (Q, b, rp) neighbour ADC or None when
    ``compute_adc`` is false). Members whose mask is <= 0 score ``+inf``."""
    if _use_kernel(impl, recs):
        return page_scan_k.page_scan(
            recs, page_ids.to(torch.int32).contiguous(), q.contiguous(),
            lut.contiguous() if compute_adc else None,
            capacity=capacity, dim=dim, rp=rp, compute_adc=compute_adc,
            member_mask=_mask_arg(member_mask),
        )
    return ref.page_scan_ref(
        recs, page_ids, q, lut,
        capacity=capacity, dim=dim, rp=rp, compute_adc=compute_adc,
        member_mask=member_mask,
    )


def page_scan_recs(recs_b, q, lut, *, capacity: int, dim: int, rp: int,
                   compute_adc: bool = True, member_mask=None,
                   impl: str | None = None):
    """``page_scan`` on an already-staged batch: recs_b (Q, b, rows, 128)
    f32 (the streamed tier's fetched records); same outputs and mask."""
    if _use_kernel(impl, recs_b):
        return page_scan_k.page_scan_recs(
            recs_b.contiguous(), q.contiguous(),
            lut.contiguous() if compute_adc else None,
            capacity=capacity, dim=dim, rp=rp, compute_adc=compute_adc,
            member_mask=_mask_arg(member_mask),
        )
    return ref.page_scan_recs_ref(
        recs_b, q, lut,
        capacity=capacity, dim=dim, rp=rp, compute_adc=compute_adc,
        member_mask=member_mask,
    )


def _mask_arg(member_mask):
    if member_mask is None:
        return None
    return member_mask.to(torch.float32).contiguous()
