"""The roofline counts on hand-worked shapes, and the trace's reduction
on a hand-made timeline."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import roofline, trace
from portbench.metrics import (device_idle_share, device_us_per_query,
                               page_scan_roofline)

G = dict(dim=128, capacity=6, pages=1667, fill=6.0, rp=48, m_disk=16,
         m_mem=32, ksub=256, io_batch=5, entries=16, adc=True,
         mem_codes=True)


def test_page_scan_counts_by_hand():
    # two queries: 2 and 1 loop iterations (3 lanes), 7 pages read
    b, o = roofline.page_scan_counts(G, hops=[2, 1], reads=7)
    per_lane = 128 * 4 + 5 * 4 + 5 * 6 * 4 + 16 * 256 * 4 + 5 * 48 * 4
    assert per_lane == 17996 and b == 3 * 17996
    assert o == 7 * (6 * 128 * 3 + 48 * 16) == 21504
    # members only (MEM_ALL): no LUT or estimates
    mem = dict(G, adc=False)
    b, o = roofline.page_scan_counts(mem, hops=[2, 1], reads=7)
    assert b == 3 * (512 + 20 + 120) and o == 7 * 2304


def test_pq_adc_counts_by_hand():
    b, o = roofline.pq_adc_counts(G, nq=2, hops=np.array([2, 1]))
    entries = 2 * (16 * 8 + 16 * 256 * 4 + 16 * 4)
    hops = 3 * (240 * 8 + 32 * 256 * 4 + 240 * 4)
    assert (b, o) == (entries + hops, 2 * 16 * 16 + 3 * 240 * 32)
    # DISK_ONLY re-scores nothing in memory: the entries alone
    b, o = roofline.pq_adc_counts(dict(G, mem_codes=False), nq=2,
                                  hops=[2, 1])
    assert (b, o) == (entries, 512)


def test_kernel_bound_takes_the_longer_of_bytes_and_operations():
    k = roofline.kernel_bound(3.35e12, 67e12 / 2)
    assert k["seconds"] == pytest.approx(1.0) and k["bound_by"] == "bytes"
    k = roofline.kernel_bound(1.0, 67e12 * 2)
    assert k["seconds"] == pytest.approx(2.0)
    assert k["bound_by"] == "operations"
    assert roofline.share_percent(1.0, 0.0) is None
    assert roofline.share_percent(1.0, 4.0) == 25.0


def timeline():
    host = [(trace.SPAN, 0.0, 10.0), ("aten::nonzero", 2.0, 5.0),
            ("cudaLaunchKernel", 0.9, 1.0)]
    device = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k3", 6.0, 7.0),
              ("late", 11.0, 12.0)]
    return trace.summarize(host, device)


def test_the_trace_reduces_to_busy_time_names_and_idle_gaps():
    s = timeline()
    assert s["window_s"] == 10.0 and s["busy_s"] == 3.0
    assert s["device_by_name"] == {"k1": 1.0, "k2": 1.5, "k3": 1.0}
    assert s["idle_by_host"] == {"host outside any op": 4.0,
                                 "aten::nonzero": 3.0}
    assert trace.device_seconds(s, ("k1", "k3")) == 2.0
    bd = trace.breakdown(s)
    assert bd["device_ops"][0] == ["k2", 1.5]
    assert bd["idle_gaps"][0] == ["host outside any op", 4.0]
    assert device_idle_share.read(dict(trace=s)) == pytest.approx(70.0)


def test_a_reader_with_nothing_to_read_returns_none():
    s = trace.summarize([], [])
    assert device_idle_share.read(dict(trace=s)) is None
    record = dict(trace=s, geometry=G, traced=[])
    assert page_scan_roofline.read(record) is None


def test_page_scan_roofline_from_a_traced_batch():
    s = trace.summarize([(trace.SPAN, 0.0, 1.0)],
                        [("void page_scan_adc_kernel<1>", 0.1, 0.1 + 1e-5)])
    batch = dict(nq=2, hops=np.array([2, 1]), ios=np.array([4, 3]),
                 cache_hits=np.zeros(2))
    record = dict(trace=s, geometry=G, traced=[batch])
    bound = 3 * 17996 / roofline.HBM_BYTES_PER_S
    assert page_scan_roofline.read(record) == pytest.approx(
        100 * bound / 1e-5, rel=1e-6)


def test_device_time_a_query_from_the_trace():
    s = timeline()
    traced = [dict(nq=1000), dict(nq=500)]
    assert device_us_per_query.read(dict(trace=s, traced=traced)) == \
        pytest.approx(3.0 / 1500 * 1e6)
    assert device_us_per_query.read(dict(trace=trace.summarize([], []),
                                         traced=[])) is None
