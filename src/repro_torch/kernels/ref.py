"""Plain PyTorch versions of the hot-path kernels, batched over queries.

Each function is the port's semantic ground truth for one CUDA kernel in
``repro_torch.kernels.csrc``: ``ops`` dispatches CPU tensors here, the tests
hold these against ``repro.kernels.ref`` (the JAX oracles), and
``chip_smoke.py`` holds the kernels against these on the card. Where the
JAX oracle takes one query (the search ``vmap``s over queries), the version
here takes the whole batch: a leading ``Q`` axis on the query-side inputs
and outputs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import record_layout

_U32 = 0xFFFFFFFF


def hamming_ref(codes: torch.Tensor, qcodes: torch.Tensor) -> torch.Tensor:
    """Hamming distance between packed 32-bit codes.

    codes: (S, W) int32 holding the uint32 bit patterns, qcodes: (Q, W)
    int32 -> (Q, S) int32. The popcount is the same SWAR bit-twiddle as
    ``repro.kernels.ref.hamming_ref``, carried out in int64 so no step
    depends on unsigned 32-bit arithmetic.
    """
    v = torch.bitwise_xor(codes[None, :, :], qcodes[:, None, :]).to(torch.int64)
    v = v & _U32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    pc = ((v * 0x01010101) & _U32) >> 24
    return pc.sum(-1).to(torch.int32)


def hamming_topk_ref(codes: torch.Tensor, qcodes: torch.Tensor,
                     t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The routing's stable top-T of the Hamming sweep. codes: (S, W)
    int32, qcodes: (Q, W) int32 -> (vals (Q, t) int32, idx (Q, t) int32),
    the first t of a stable ascending sort of each row of ``hamming_ref``:
    the lower sample first on ties, as ``lax.top_k`` orders them. Raises
    when t > S, as ``lax.top_k`` does."""
    s = codes.shape[0]
    if not 0 <= t <= s:
        raise ValueError(f"hamming_topk: t = {t} must be in [0, S = {s}]")
    vals, idx = torch.sort(hamming_ref(codes, qcodes), dim=-1, stable=True)
    return vals[:, :t], idx[:, :t].to(torch.int32)


def l2_distance_ref(q: torch.Tensor, x: torch.Tensor,
                    keep: torch.Tensor | None = None) -> torch.Tensor:
    """Squared L2 distances. q: (Q, d), x: (N, d), keep: (N,) bool or None
    -> (Q, N) f32, ``+inf`` in the columns where ``keep`` is false.

    The expanded form of ``repro.kernels.ref.l2_distance_ref`` in its
    evaluation order, ``(|q|^2 - 2 q.x) + |x|^2``. It is not exact at zero:
    a vector's distance to itself comes out a few ulps of its squared norm
    away from 0, and can be negative (ROADMAP C1). The port keeps that form
    so the delta tier's top-k order matches the reference's.
    """
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    d = (
        (q * q).sum(-1)[:, None]
        - 2.0 * q @ x.T
        + (x * x).sum(-1)[None, :]
    )
    if keep is None:
        return d
    return torch.where(keep[None, :], d, float("inf"))


def page_gather_l2_ref(pages: torch.Tensor, page_ids: torch.Tensor,
                       q: torch.Tensor) -> torch.Tensor:
    """Gather page vectors and score them against each query.

    pages: (P, cap, d) f32, page_ids: (Q, b) int (>= 0), q: (Q, d)
    -> (Q, b, cap) squared L2 distances, in the difference form
    ``sum((x - q)^2)``.
    """
    gathered = pages[page_ids.to(torch.int64)].to(torch.float32)
    diff = gathered - q.to(torch.float32)[:, None, None, :]
    return (diff * diff).sum(-1)


def pq_lut_ref(q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """ADC lookup tables. q: (Q, d), codebooks: (M, K, dsub) -> (Q, M, K)
    squared sub-distances (``core.pq.pq_lut`` returns this); writes the
    (Q, M, K, dsub) difference and its square before the sum."""
    m, _, dsub = codebooks.shape
    qs = q.reshape(q.shape[0], m, 1, dsub)
    return ((qs - codebooks[None]) ** 2).sum(-1)


def pq_adc_ref(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """ADC distance. codes: (Q, N, M) uint8, lut: (Q, M, K) f32 -> (Q, N)
    f32, the sum over subspaces j of ``lut[q, j, codes[q, n, j]]``."""
    idx = codes.to(torch.int64).transpose(1, 2)        # (Q, M, N)
    return lut.gather(2, idx).sum(1)                   # (Q, N)


def pq_adc_gather_ref(table: torch.Tensor, ids: torch.Tensor,
                      lut: torch.Tensor) -> torch.Tensor:
    """ADC distance of code rows read by id. table: (R, M) uint8, ids:
    (Q, N) int (in [0, R)), lut: (Q, M, K) f32 -> (Q, N) f32, ``pq_adc_ref``
    on the gathered codes ``table[ids]``."""
    return pq_adc_ref(table[ids.long()], lut)


def page_scan_recs_ref(
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
    """Both score sets of already-gathered page records.

    recs_b: (Q, b, rows, 128) f32 packed records (``core.layout.
    pack_page_records``), q: (Q, d) f32, lut: (Q, M, K) f32, member_mask:
    (Q, b, capacity) f32 or None.
    -> (member_d (Q, b, capacity) f32, nbr_d (Q, b, rp) f32 or None).
    Member vectors are read back out of the dense packing (``128 // d`` per
    row for d <= 128, ``ceil(d / 128)`` rows each above), neighbour codes
    from the M subspace-major code rows after the member block. Members
    whose mask is <= 0 score ``+inf`` (the filter); the neighbour ADC is
    never masked.
    """
    nq, b = recs_b.shape[:2]
    rv = record_layout.member_rows(capacity, dim)
    if dim <= record_layout.PAGE_LANES:
        vpr = record_layout.vectors_per_row(dim)
        block = recs_b[:, :, :rv, : vpr * dim]
        vecs = block.reshape(nq, b, rv * vpr, dim)[:, :, :capacity]
    else:
        rpv = record_layout.rows_per_vector(dim)
        block = recs_b[:, :, :rv, :]
        vecs = block.reshape(
            nq, b, capacity, rpv * record_layout.PAGE_LANES
        )[:, :, :, :dim]
    diff = vecs - q[:, None, None, :]
    member_d = (diff * diff).sum(-1)
    if member_mask is not None:
        member_d = torch.where(member_mask > 0, member_d, float("inf"))
    if not compute_adc:
        return member_d, None
    m, k = lut.shape[1:]
    codes = recs_b[:, :, rv:rv + m, :rp].to(torch.int64)        # (Q, b, M, rp)
    table = lut[:, None, :, :].expand(nq, b, m, k)
    nbr_d = table.gather(3, codes).sum(2)                      # (Q, b, rp)
    return member_d, nbr_d


def page_scan_ref(
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
    """Fused page scan: gather each query's pages, score both sets.

    recs: (P, rows, 128) f32, page_ids: (Q, b) int (>= 0), q: (Q, d),
    lut: (Q, M, K) f32, member_mask: (Q, b, cap) f32 or None
    -> (member_d (Q, b, cap), nbr_d (Q, b, rp) or None).
    """
    return page_scan_recs_ref(
        recs[page_ids.to(torch.int64)], q, lut,
        capacity=capacity, dim=dim, rp=rp, compute_adc=compute_adc,
        member_mask=member_mask,
    )
