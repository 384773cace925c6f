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
from repro_torch.kernels import l2_distance as l2_distance_k
from repro_torch.kernels import page_gather as page_gather_k
from repro_torch.kernels import page_scan as page_scan_k
from repro_torch.kernels import pq_adc as pq_adc_k
from repro_torch.kernels import pq_lut as pq_lut_k

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


def hamming_topk(codes: torch.Tensor, qcodes: torch.Tensor, t: int, *,
                 impl: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The LSH routing's sweep and its stable top-T in one call: (S, W)
    int32 codes, (Q, W) int32 query codes -> (vals (Q, t) int32, idx
    (Q, t) int32), the first t of each row of ``hamming`` sorted
    ascending, the lower sample first on ties (``lax.top_k``'s order). The
    kernel never writes the (Q, S) distances; it counts as ``hamming``."""
    if _use_kernel(impl, codes):
        return hamming_k.hamming_topk(codes, qcodes, t)
    return ref.hamming_topk_ref(codes, qcodes, t)


def pq_lut(q: torch.Tensor, codebooks: torch.Tensor, *,
           impl: str | None = None) -> torch.Tensor:
    """(Q, d) f32 queries, (M, K, dsub) f32 codebooks -> (Q, M, K) f32 ADC
    tables, each entry the squared distance of a query's subspace slice to
    one centroid. The kernel never writes the (Q, M, K, dsub) terms."""
    if _use_kernel(impl, q):
        return pq_lut_k.pq_lut(q.contiguous(), codebooks.contiguous())
    return ref.pq_lut_ref(q, codebooks)


def pq_adc(codes: torch.Tensor, lut: torch.Tensor, *,
           impl: str | None = None) -> torch.Tensor:
    """(Q, N, M) uint8 codes, (Q, M, K) f32 tables -> (Q, N) f32."""
    if _use_kernel(impl, codes):
        return pq_adc_k.pq_adc(codes.contiguous(), lut.contiguous())
    return ref.pq_adc_ref(codes, lut)


def pq_adc_gather(table: torch.Tensor, ids: torch.Tensor, lut: torch.Tensor,
                  *, impl: str | None = None) -> torch.Tensor:
    """(R, M) uint8 code table, (Q, N) int row ids in [0, R), (Q, M, K) f32
    tables -> (Q, N) f32, ``pq_adc(table[ids], lut)``: the kernel reads each
    row by id, so the gathered codes are never written."""
    if _use_kernel(impl, table):
        return pq_adc_k.pq_adc_gather(table.contiguous(), ids,
                                      lut.contiguous())
    return ref.pq_adc_gather_ref(table, ids, lut)


def l2_distance(q: torch.Tensor, x: torch.Tensor,
                keep: torch.Tensor | None = None, *,
                impl: str | None = None) -> torch.Tensor:
    """(Q, d), (N, d), (N,) bool or None -> (Q, N) f32 squared L2,
    ``(|q|^2 - 2 q.x) + |x|^2``, ``+inf`` where ``keep`` is false."""
    if _use_kernel(impl, q):
        return l2_distance_k.l2_distance(q, x, keep)
    return ref.l2_distance_ref(q, x, keep)


def page_gather_l2(pages: torch.Tensor, page_ids: torch.Tensor,
                   q: torch.Tensor, *, impl: str | None = None) -> torch.Tensor:
    """pages (P, cap, d) f32, page_ids (Q, b) >= 0, q (Q, d) f32 -> (Q, b,
    cap) f32 squared L2 of each gathered page vector to its query."""
    if _use_kernel(impl, pages):
        return page_gather_k.page_gather_l2(
            pages.contiguous(), page_ids.to(torch.int32).contiguous(),
            q.contiguous())
    return ref.page_gather_l2_ref(pages, page_ids, q)


def delta_scan(q: torch.Tensor, vecs: torch.Tensor, live: torch.Tensor,
               k: int, *, mask: torch.Tensor | None = None,
               impl: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Brute-force scan of the mutable index's in-memory delta tier.

    q: (Q, d) f32 queries, vecs: (C, d) f32 delta rows, live: (C,) bool.
    The distances go through ``l2_distance``, whose epilogue scores rows
    that are dead, or fail the filter ``mask`` (C,) bool, ``+inf``; the
    per-query ascending top-k is a stable sort, lower row first on ties
    (``lax.top_k``'s order). Returns (dists (Q, k) f32, slots (Q, k) int32
    rows of ``vecs``); non-finite entries mean fewer than k live rows.
    """
    keep = live if mask is None else live & mask
    d = l2_distance(q, vecs, keep, impl=impl)
    vals, slots = torch.sort(d, dim=-1, stable=True)
    return vals[:, :k], slots[:, :k].to(torch.int32)


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
