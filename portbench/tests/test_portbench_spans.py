"""The span readers on a hand-made timeline: ``spans.split`` and the four
metrics that read the program's spans, with the shares worked out by
hand, and None where the traced window had no device activity or the
program keeps no span tracer. The program's tracer is stood in for by one
of the same shape (``repro_torch.obs.trace.ProfilerTracer``: spans stamped
in seconds since ``base_ns``, ``epoch_ns``), as the harness imports
nothing of the program outside ``system.py``."""
from __future__ import annotations

import sys
import types

import pytest

from portbench import spans
from portbench.metrics import (edge_idle_share, hop_host_us, hop_idle_share,
                               hop_sync_us)

READERS = [hop_host_us, hop_sync_us, hop_idle_share, edge_idle_share]
MS = 1e-3
BASE_NS = 1_792_324_872_617_660_000     # an epoch stamp, in ns


class Tracer:
    """The program's process tracer's shape, as the readers use it."""

    def __init__(self):
        self.base_ns = BASE_NS
        self._spans = []

    def add(self, name, t0, t1, args):
        self._spans.append(types.SimpleNamespace(
            name=name, ts=t0, dur=t1 - t0, args=args))

    def spans(self):
        return list(self._spans)

    def epoch_ns(self, t):
        return self.base_ns + round(t * 1e9)


def test_split_counts_idle_time_inside_the_spans_only():
    kernels = [("a", 1.0, 3.0), ("b", 2.0, 4.0), ("c", 6.0, 7.0)]
    # the busy union is [1, 4] and [6, 7]
    assert spans.split([(0.0, 10.0)], kernels) == pytest.approx(6.0)
    assert spans.split([(1.5, 3.5)], kernels) == 0.0
    assert spans.split([(3.0, 6.5)], kernels) == pytest.approx(2.0)
    # overlapping spans count once; no kernels: all idle
    assert spans.split([(4.0, 5.0), (4.5, 6.0)], kernels) == pytest.approx(2.0)
    assert spans.split([(0.0, 2.0)], []) == 2.0
    assert spans.split([], kernels) == 0.0


@pytest.fixture
def timeline(monkeypatch):
    """A traced window of 100 ms holding one search (ms): upload 10-12,
    start 12-20, hops 20-30 (sync 20-22, 4 lanes), 30-40 (sync 30-35, 2
    lanes), 40-42 (sync only, no lane), download 42-50; kernels 5-15,
    16-25, 33-38, 44-46. A stale search after the window and a span of
    another name are left out."""
    tr = Tracer()
    monkeypatch.setitem(sys.modules, spans.PROGRAM_TRACE,
                        types.SimpleNamespace(PROFILED=tr))
    for name, t0, t1, args in [
            ("pageann.search", 10, 50, {}), ("pageann.upload", 10, 12, {}),
            ("pageann.start", 12, 20, {}),
            ("pageann.hop", 20, 30, {"hop": 0, "lanes": 4}),
            ("pageann.hop.sync", 20, 22, {}),
            ("pageann.hop", 30, 40, {"hop": 1, "lanes": 2}),
            ("pageann.hop.sync", 30, 35, {}),
            ("pageann.hop", 40, 42, {"hop": 2, "lanes": 0}),
            ("pageann.hop.sync", 40, 42, {}),
            ("pageann.download", 42, 50, {}),
            ("pageann.search", 200, 210, {}), ("page_fetch", 20, 40, {})]:
        tr.add(name, t0 * MS, t1 * MS, args)
    base = tr.epoch_ns(0.0) * 1e-9
    kernels = [(n, base + a * MS, base + b * MS)
               for n, a, b in [("k", 5, 15), ("k", 16, 25), ("k", 33, 38),
                               ("k", 44, 46)]]
    return dict(trace=dict(window_s=0.1, busy_s=0.026, kernels=kernels,
                           device_by_name={"k": 0.026}, idle_by_host={}))


def test_program_spans_are_those_of_the_window(timeline):
    got = spans.program_spans(timeline)
    assert len(got) == 10 and got[0].name == "pageann.search"
    assert all(s.name.startswith("pageann.") for s in got)
    assert got[0].end - got[0].start == pytest.approx(0.040, abs=1e-6)


def test_the_readers_by_hand(timeline):
    # hops that hopped: 10 - 2 and 10 - 5 ms of host time; syncs 2, 5, 2 ms
    assert hop_host_us.read(timeline) == pytest.approx(6500.0, abs=0.01)
    assert hop_sync_us.read(timeline) == pytest.approx(3000.0, abs=0.01)
    # idle inside the hops (20-42): 20-25 and 33-38 busy, 12 ms idle
    assert hop_idle_share.read(timeline) == pytest.approx(12.0, abs=1e-3)
    # edges 10-20 (1 ms idle: 15-16) and 42-50 (6 ms idle)
    assert edge_idle_share.read(timeline) == pytest.approx(7.0, abs=1e-3)


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__)
def test_each_reader_gives_none_without_device_activity(timeline, reader,
                                                        monkeypatch):
    idle = dict(trace=dict(timeline["trace"], busy_s=0.0, kernels=[]))
    assert reader.read(idle) is None
    # device activity but no program span: a program whose trace module
    # has no such tracer, or none loaded
    monkeypatch.setitem(sys.modules, spans.PROGRAM_TRACE,
                        types.SimpleNamespace())
    assert reader.read(timeline) is None
    monkeypatch.delitem(sys.modules, spans.PROGRAM_TRACE)
    assert reader.read(timeline) is None
