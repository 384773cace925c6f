"""Peaks of the card and the least work of the search's kernels.

Frozen copies of ``repro_torch.launch.roofline.kernel_bound`` and its
data-sheet peaks (one NVIDIA H100 SXM at 700 W: 3.35 TB/s of HBM3, 67
TFLOP/s of float32 outside the tensor cores), and counts of the bytes and
operations a batch's page scans and ADC scorings need, from what is known
outside the program: the geometry the configuration fixes and each query's
counters (``SearchResult.hops``, ``.ios``, ``.cache_hits``).

Rules of the counts. They count the work whatever implements it, each
input byte once a launch and each output byte once, never once a query.
Where the bytes of a launch are not known from outside they take the
least: the page records a scan reads and the code rows an ADC gathers are
shared by the queries of a launch, and how many distinct ones a launch
touches is not counted by the program yet, so they count none of them.
The counts are therefore lower bounds, and a share computed from them can
only read low, never above what the card did.

A loop iteration of the hop loop launches one page scan and (HYBRID and
MEM_ALL) one ADC scoring over the lanes still active, and a lane is active
in iterations 1 .. its ``hops``. Before the loop, one ADC scoring estimates
the T routed entries of every query.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def kernel_bound(bytes_: float, ops_: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops_ / F32_OPS_PER_S
    return dict(seconds=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_, operations=ops_)


def lane_iterations(hops) -> int:
    """Lanes summed over a batch's loop iterations: sum of hops."""
    return int(np.asarray(hops, np.int64).sum())


def page_scan_counts(g: dict, *, hops, reads: int) -> tuple:
    """(bytes, operations) of a batch's page scans. ``g``: the geometry
    (``dim``, ``capacity``, ``rp``, ``m_disk``, ``ksub``, ``io_batch``,
    ``adc`` (the scan scores on-page codes), ``fill`` (members a page, on
    average)); ``reads``: pages read over the batch (ios + cache hits).

    A lane's launch reads its query, its b page ids and (ADC) its disk
    LUT, and writes b x capacity member
    distances and (ADC) b x rp estimates. A page read computes each
    member's distance (d subtractions, d multiply-adds: 3 d operations)
    and (ADC) rp x m_disk table adds."""
    lanes = lane_iterations(hops)
    b, cap, rp = g["io_batch"], g["capacity"], g["rp"]
    adc = bool(g["adc"])
    per_lane = (g["dim"] * 4 + b * 4 + b * cap * 4
                + (g["m_disk"] * g["ksub"] * 4 + b * rp * 4 if adc else 0))
    per_read = g["fill"] * g["dim"] * 3 + (rp * g["m_disk"] if adc else 0)
    return lanes * per_lane, reads * per_read


def pq_adc_counts(g: dict, *, nq: int, hops) -> tuple:
    """(bytes, operations) of a batch's ADC scorings: the entries' (nq x
    T ids of 8 bytes, the disk LUT, T outputs; T x m_disk adds) and, in
    HYBRID and MEM_ALL, each lane's neighbour re-score every iteration
    (b x rp ids, the in-memory LUT, b x rp outputs; b x rp x m_mem
    adds)."""
    t, m_disk, m_mem, ksub = g["entries"], g["m_disk"], g["m_mem"], g["ksub"]
    bytes_ = nq * (t * 8 + m_disk * ksub * 4 + t * 4)
    ops_ = nq * t * m_disk
    if g["mem_codes"]:
        n = g["io_batch"] * g["rp"]
        lanes = lane_iterations(hops)
        bytes_ += lanes * (n * 8 + m_mem * ksub * 4 + n * 4)
        ops_ += lanes * n * m_mem
    return bytes_, ops_


def share_percent(bound_seconds: float, device_seconds: float):
    """The bound's share of the device time, in %; None without device
    time to compare with."""
    if device_seconds <= 0:
        return None
    return 100.0 * bound_seconds / device_seconds
