"""The out-of-core configuration (``bigann-budget25``): a tiny budgeted cell
through the harness on the CPU is ``correct`` and answers as the resident
one does, bit for bit; the streamed tier's five readers on a hand-made
timeline, worked out by hand, and None where the program emitted no
``pageann.hop.fetch`` span (a resident index, or a program older than the
span)."""
from __future__ import annotations

import json
import sys
import types

import numpy as np
import pytest

from portbench import data, run, spans
from portbench.metrics import (fetch_idle_share, fetch_ms_per_hop,
                               h2d_roofline, stage_hit_share, streamed_share)
from portbench.tests import cells
from portbench.tests.test_portbench_rehearsal import rehearse
from portbench.tests.test_portbench_spans import MS, Tracer

READERS = [fetch_ms_per_hop, fetch_idle_share, streamed_share,
           stage_hit_share, h2d_roofline]
BUDGET = "tiny-budget.batch"
RESIDENT = "tiny-hybrid.batch"
COPY = h2d_roofline.COPIES[0]
RECORD = 12_288                  # B: a HYBRID page record at d = 128


def test_the_budgeted_config_is_the_resident_one_with_a_budget():
    """Same collection, same index settings, same limits: only where the
    pages live differs."""
    cfgs = cells.REPO / "portbench" / "configs"
    budget = json.loads((cfgs / "bigann-budget25.json").read_text())
    hybrid = json.loads((cfgs / "bigann-hybrid.json").read_text())
    for key in ("n", "dim", "data", "pageann", "limits"):
        assert budget[key] == hybrid[key], key
    assert hybrid["memory_budget"] is None
    assert budget["memory_budget"] == 0.25


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """``cells.make_root``'s two cells and ``tiny-budget.batch``: the tiny
    HYBRID configuration under ``bigann-budget25``'s budget."""
    manifest = cells.make_root(tmp_path_factory.mktemp("budget"))
    tmp = manifest.parent
    cfg = cells.tiny_config("tiny-budget", "hybrid", "bigann-budget25.json")
    assert cfg["memory_budget"] == 0.25
    (tmp / "portbench" / "configs" / "tiny-budget.json").write_text(
        json.dumps(cfg))
    doc = json.loads(manifest.read_text())
    doc["configs"].append(dict(name="tiny-budget", source="test",
                               reduced=[], why="test",
                               file="portbench/configs/tiny-budget.json"))
    doc["workloads"].append(dict(name=BUDGET, config="tiny-budget",
                                 traffic="batch", chips=1, why="test"))
    for m in doc["per_layer"]:
        m["workloads"].append(BUDGET)
    manifest.write_text(json.dumps(doc))
    return tmp


def test_a_budgeted_run_is_correct(root):
    result, _ = rehearse(root, BUDGET)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert result["checks"]["recall_at_10"]["value"] >= 0.90


def test_a_budgeted_cell_answers_as_the_resident_one_bit_for_bit(root):
    """The same seed's batches through both cells' set-up: ids, distances,
    ios, hops and cache hits equal, and the budgeted index streamed."""
    import torch

    torch.set_num_threads(2)
    seed = 2**31 + 11
    answers, systems = {}, {}
    for workload in (RESIDENT, BUDGET):
        cell = run.load_cell(root / "BENCHMARK.json", workload)
        inputs, system, traffic, _ = run.setup_cell(
            cell, seed=seed, device="cpu", cache=root / "cache")
        answers[workload] = [
            system.search(inputs.queries(traffic.batch,
                                         data.batch_seed(seed, i))
                          .cpu().numpy(), traffic.k)
            for i in range(3)]
        systems[workload] = system
    assert systems[RESIDENT].index.fetcher is None
    assert systems[BUDGET].index.fetch_stats()["pages_fetched"] > 0
    for want, got in zip(answers[RESIDENT], answers[BUDGET]):
        for field in ("ids", "dists", "ios", "hops", "cache_hits"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field), err_msg=field)


def _timeline(monkeypatch, fetch: bool) -> dict:
    """A traced window of 100 ms (ms): one search 10-50, hops 20-30 and
    30-40; with ``fetch``, a ``pageann.hop.fetch`` in each hop, 22-27
    (10 page reads, 8 streamed, 6 read off the file) and 36-38 (6, 4, 1).
    Device: kernels 5-15 and 30-37, the pinned copies 26.000-26.002 and
    37.000-37.001."""
    tr = Tracer()
    monkeypatch.setitem(sys.modules, spans.PROGRAM_TRACE,
                        types.SimpleNamespace(PROFILED=tr))
    items = [("pageann.search", 10, 50, {}),
             ("pageann.hop", 20, 30, {"hop": 0, "lanes": 2}),
             ("pageann.hop.sync", 20, 21, {}),
             ("pageann.hop", 30, 40, {"hop": 1, "lanes": 2}),
             ("pageann.hop.sync", 30, 31, {}),
             ("page_fetch", 22, 27, {})]
    if fetch:
        items += [("pageann.hop.fetch", 22, 27,
                   dict(lanes=10, streamed=8, misses=6, bytes=8 * RECORD)),
                  ("pageann.hop.fetch", 36, 38,
                   dict(lanes=6, streamed=4, misses=1, bytes=4 * RECORD))]
    for name, t0, t1, args in items:
        tr.add(name, t0 * MS, t1 * MS, args)
    base = tr.epoch_ns(0.0) * 1e-9
    kernels = [(n, base + a * MS, base + b * MS)
               for n, a, b in [("k", 5, 15), ("k", 30, 37),
                               (COPY, 26.000, 26.002), (COPY, 37.000, 37.001)]]
    busy = 0.010 + 0.007 + 0.000002 + 0.000001
    return dict(trace=dict(window_s=0.1, busy_s=busy, kernels=kernels,
                           device_by_name={"k": 0.017, COPY: 3e-6},
                           idle_by_host={}))


def test_the_streamed_tier_readers_by_hand(monkeypatch):
    record = _timeline(monkeypatch, fetch=True)
    assert fetch_ms_per_hop.read(record) == pytest.approx((5 + 2) / 2)
    assert streamed_share.read(record) == pytest.approx(100 * 12 / 16)
    assert stage_hit_share.read(record) == pytest.approx(100 * (1 - 7 / 12))
    # idle inside 22-27 (26.000-26.002 busy) and 36-38 (36-37.001 busy)
    idle = (5 - 0.002) + (2 - 1.001)
    assert fetch_idle_share.read(record) == pytest.approx(idle, abs=1e-3)


def test_the_h2d_roofline_by_hand(monkeypatch):
    """12 records of 12,288 B cross the link in 147,456 / 64e9 s = 2.304
    us at the least; the copies took 3 us on the card: 76.8%."""
    assert h2d_roofline.bound_seconds(12 * RECORD) == pytest.approx(2.304e-6)
    record = _timeline(monkeypatch, fetch=True)
    assert h2d_roofline.read(record) == pytest.approx(76.8, rel=1e-6)
    # no pinned copy on the card's timeline: nothing to compare with
    record["trace"]["device_by_name"].pop(COPY)
    assert h2d_roofline.read(record) is None


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__)
def test_each_reader_gives_none_without_fetch_spans(monkeypatch, reader):
    # the program's other spans are there, as from a resident index or a
    # program without the span
    assert reader.read(_timeline(monkeypatch, fetch=False)) is None
    record = _timeline(monkeypatch, fetch=True)
    assert reader.read(record) is not None
    monkeypatch.delitem(sys.modules, spans.PROGRAM_TRACE)
    assert reader.read(record) is None
