"""Packed page-record geometry — the ONE authoritative copy.

``core.layout.pack_page_records`` (producer), the ``page_scan`` Pallas
kernel, and the ``ref.page_scan_ref`` oracle (consumers) must agree on
where member vectors and neighbor-code rows live inside the (rows, 128)
record tile. This leaf module (no jax, no package imports — safe on both
sides of the core <-> kernels boundary) owns that arithmetic so the layout
can never silently desync from the kernels that read it.
"""
from __future__ import annotations

PAGE_LANES = 128  # f32 lane width of one record row (TPU tile minor dim)


def vectors_per_row(dim: int) -> int:
    """Member vectors packed side by side in one 128-lane record row
    (1 when a vector itself spans multiple rows, i.e. dim > 128)."""
    return max(1, PAGE_LANES // dim)


def rows_per_vector(dim: int) -> int:
    """Record rows one member vector spans (1 unless dim > 128)."""
    return -(-dim // PAGE_LANES)


def member_rows(capacity: int, dim: int) -> int:
    """Rows of the member-vector block of one packed page record."""
    if dim <= PAGE_LANES:
        return -(-capacity // vectors_per_row(dim))
    return capacity * rows_per_vector(dim)


def record_rows(capacity: int, dim: int, m_disk: int) -> int:
    """Row count of one packed page record: densely packed member vectors +
    M_disk transposed code rows, padded to the (8, 128) f32 tile."""
    return -(-(member_rows(capacity, dim) + m_disk) // 8) * 8
