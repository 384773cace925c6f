"""The search's spans (``repro_torch.obs.trace.span``) over a port index.

A search with a tracer attached gives the phase tree on the ``search``
track, one ``pageann.hop`` a loop iteration with the lanes it ran, and,
over a memory-budgeted index, one ``pageann.hop.fetch`` a hop with the
hop's page reads, streamed reads, staging misses and bytes; its results
equal an untraced search's bit for bit, resident and streamed;
with no tracer and no profiler a site builds no span and the process
tracer stays empty; under ``torch.profiler`` the same spans are
``record_function`` events of the profile and the process tracer's copies
agree with them in start and end. The module imports no JAX, so its
``cuda`` case runs on a GPU host with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_spans.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import MemoryMode, PageANNConfig, PageANNIndex
from repro_torch.obs import trace
from repro_torch.obs.trace import PROFILED, Tracer
from repro_torch.serve import BatchingEngine

torch.set_num_threads(1)

N, D, Q, K = 800, 16, 24, 5
HOP_CHILDREN = ["pageann.hop.sync", "pageann.hop.select", "pageann.hop.score",
                "pageann.hop.merge"]
FETCH = "pageann.hop.fetch"
FIELDS = ("ids", "dists", "ios", "hops", "cache_hits")
ROOT = Path(__file__).resolve().parents[1]


def _from_root(module):
    """A module of the checkout's root (the benchmark, the chip smoke)."""
    import importlib

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(module)


def _data():
    """Clustered vectors and queries near them, from fixed seeds."""
    rng = np.random.default_rng(3)
    centres = 4.0 * rng.standard_normal((8, D))
    x = centres[rng.integers(0, 8, N)] + rng.standard_normal((N, D))
    q = x[rng.integers(0, N, Q)] + 0.3 * rng.standard_normal((Q, D))
    return x.astype(np.float32), q.astype(np.float32)


def _build(mode, device="cpu"):
    x, _ = _data()
    cfg = PageANNConfig(dim=D, graph_degree=12, build_beam=24, pq_subspaces=4,
                        lsh_sample=128, lsh_entries=8, beam_width=32,
                        max_hops=48, build_rounds=1, memory_mode=mode)
    return PageANNIndex.build(x, cfg, device=device)


@pytest.fixture(scope="module")
def index():
    return _build(MemoryMode.HYBRID)


@pytest.fixture(scope="module")
def streamed(index, tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("spans") / "idx")
    index.save(directory)
    return PageANNIndex.load(directory, device="cpu", memory_budget=0.25)


def _equal(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def _inside(child, parent):
    return (parent.ts <= child.ts
            and child.ts + child.dur <= parent.ts + parent.dur)


def _traced(index, q):
    tr = Tracer()
    index.tracer = tr
    try:
        res = index.search(q, k=K)
    finally:
        index.tracer = None
    return res, tr.spans()


@pytest.mark.parametrize("which", ["resident", "streamed"])
def test_a_traced_search_gives_the_span_tree(index, streamed, which):
    """Each phase once, on the ``search`` track, nested in
    ``pageann.search``; one ``pageann.hop`` a loop iteration, numbered, its
    ``lanes`` the queries still hopping, holding its sync and (when a lane
    ran) select, score and merge in that order; a streamed search's score
    holds one ``pageann.hop.fetch``, a resident one's none."""
    idx = index if which == "resident" else streamed
    q = _data()[1]
    res, spans = _traced(idx, q)
    assert {s.track for s in spans} == {"search"}
    search = [s for s in spans if s.name == "pageann.search"]
    assert len(search) == 1
    assert search[0].args == {"queries": Q, "k": K, "mode": "hybrid"}
    for name in ("pageann.upload", "pageann.start", "pageann.download"):
        (s,) = [s for s in spans if s.name == name]
        assert _inside(s, search[0])
    hops = [s for s in spans if s.name == "pageann.hop"]
    assert [h.args["hop"] for h in hops] == list(range(len(hops)))
    assert len(hops) == res.hops.max() + 1
    assert [h.args["lanes"] for h in hops] == [
        int((res.hops > h).sum()) for h in range(len(hops))]
    assert len(set(h.args["lanes"] for h in hops)) > 2    # lanes drop out
    children = [s for s in spans if s.name in HOP_CHILDREN]
    for h in hops:
        assert _inside(h, search[0])
        mine = [c.name for c in children if _inside(c, h)]
        assert mine == (HOP_CHILDREN if h.args["lanes"] else HOP_CHILDREN[:1])
    assert len(children) == sum(4 if h.args["lanes"] else 1 for h in hops)
    fetches = [s for s in spans if s.name == FETCH]
    scores = [s for s in spans if s.name == "pageann.hop.score"]
    if which == "streamed":
        assert idx.fetcher.tracer is None
        assert len(fetches) == len(scores)
        assert all(_inside(f, s) for f, s in zip(fetches, scores))
    else:
        assert fetches == []


@pytest.mark.parametrize("which", ["resident", "streamed"])
def test_traced_results_equal_untraced_ones(index, streamed, which):
    idx = index if which == "resident" else streamed
    q = _data()[1]
    plain = idx.search(q, k=K)
    traced, spans = _traced(idx, q)
    assert spans
    _equal(traced, plain)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = idx.search(q, k=K)
    _equal(profiled, plain)


def test_a_streamed_hop_is_one_fetch_span_with_its_counts(index, streamed):
    """Each hop of a budgeted search reads its pages through one
    ``pageann.hop.fetch``: ``lanes`` the hop's page reads and ``streamed``
    those not resident, hop by hop as the resident index's profile
    schedules them; ``misses`` and ``streamed`` sum to the fetcher's
    counters; ``bytes`` is the streamed records'. Under the profiler the
    process tracer takes the same spans. Results equal the untraced and
    the resident search's bit for bit."""
    q = _data()[1]
    want, trail = index.profile(q, k=K)
    rmap = streamed.data.resident_map.numpy()
    pages = trail.pages.transpose(1, 0, 2)                 # (H, Q, b)
    reads = [p[p >= 0] for p, a in zip(pages, trail.active.T) if a.any()]
    streamed.fetcher.reset_stats()
    res, spans = _traced(streamed, q)
    stats = streamed.fetch_stats()
    _equal(res, want)
    _equal(res, streamed.search(q, k=K))
    fetches = [s for s in spans if s.name == FETCH]
    assert [f.args["lanes"] for f in fetches] == [r.size for r in reads]
    assert [f.args["streamed"] for f in fetches] == [
        int((rmap[r] < 0).sum()) for r in reads]
    assert sum(f.args["lanes"] for f in fetches) == int(
        res.ios.sum() + res.cache_hits.sum())
    assert sum(f.args["misses"] for f in fetches) == stats["pages_fetched"]
    assert sum(f.args["streamed"] for f in fetches) == (
        stats["pages_fetched"] + stats["fetch_hits"]) > 0
    record = int(np.prod(streamed.data.page_recs.shape[1:])) * 4
    assert all(f.args["bytes"] == f.args["streamed"] * record
               for f in fetches)
    assert all(0 <= f.args["misses"] <= f.args["streamed"] <= f.args["lanes"]
               for f in fetches)
    PROFILED.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = streamed.search(q, k=K)
    _equal(profiled, want)
    got = [s for s in PROFILED.spans() if s.name == FETCH]
    assert [g.args["lanes"] for g in got] == [f.args["lanes"] for f in fetches]
    assert [g.args["streamed"] for g in got] == [
        f.args["streamed"] for f in fetches]


def test_with_no_tracer_and_no_profiler_a_site_builds_nothing(
        index, monkeypatch):
    """The off path is two checks: no span object, no ``record_function``,
    nothing recorded in the process tracer."""
    def refuse(*a, **k):
        raise AssertionError("a span was built with tracing off")

    PROFILED.clear()
    monkeypatch.setattr(trace, "_ProgramSpan", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    index.tracer = Tracer(enabled=False)
    try:
        index.search(_data()[1], k=K)
    finally:
        index.tracer = None
    index.search(_data()[1], k=K)
    assert len(PROFILED) == 0 and PROFILED.dropped == 0


def _profiled_search(index, q, activities):
    PROFILED.clear()
    with torch.profiler.profile(activities=activities) as prof:
        res = index.search(q, k=K)
    return res, prof


def _agreement(prof):
    """The process tracer's spans beside the profile's ``pageann.*``
    events, in order: the largest start and end difference in seconds."""
    events = sorted(
        (e for e in prof.profiler.kineto_results.events()
         if e.name().startswith("pageann.")
         and e.device_type() == torch.autograd.DeviceType.CPU),
        key=lambda e: e.start_ns())
    spans = sorted((s for s in PROFILED.spans()
                    if s.name.startswith("pageann.")), key=lambda s: s.ts)
    assert [e.name() for e in events] == [s.name for s in spans]
    worst = 0.0
    for e, s in zip(events, spans):
        t0 = PROFILED.epoch_ns(s.ts)
        t1 = PROFILED.epoch_ns(s.ts + s.dur)
        worst = max(worst, abs(t0 - e.start_ns()) * 1e-9,
                    abs(t1 - e.end_ns()) * 1e-9)
    return spans, worst


def test_profiled_spans_are_record_functions_on_the_profiles_clock(index):
    """No tracer attached: under the profiler every phase is a
    ``record_function`` event of the profile, and the process tracer's
    copy of it starts and ends within 1 ms of it on its clock."""
    q = _data()[1]
    res, prof = _profiled_search(index, q,
                                 [torch.profiler.ProfilerActivity.CPU])
    spans, worst = _agreement(prof)
    assert sum(s.name == "pageann.hop" for s in spans) == res.hops.max() + 1
    assert {"pageann.search", "pageann.upload", "pageann.start",
            "pageann.download", *HOP_CHILDREN} <= {s.name for s in spans}
    assert worst < 1e-3
    # the profiler off again: the process tracer takes nothing more
    index.search(q, k=K)
    assert len(PROFILED) == len(spans)


def test_the_benchmarks_reader_finds_the_profiled_spans(index):
    """``portbench/spans.py`` reads the process tracer by its module's name
    (the harness imports nothing of the program but through its adapter):
    over a window that covers the search, it finds every ``pageann.*`` span
    of the profile, on the profile's clock. Fails if the tracer it reads
    is renamed or reshaped."""
    spans_mod = _from_root("portbench.spans")
    q = _data()[1]
    _, prof = _profiled_search(index, q, [torch.profiler.ProfilerActivity.CPU])
    events = sorted(
        (e for e in prof.profiler.kineto_results.events()
         if e.name().startswith("pageann.")
         and e.device_type() == torch.autograd.DeviceType.CPU),
        key=lambda e: e.start_ns())
    lo = min(e.start_ns() for e in events) * 1e-9
    hi = max(e.end_ns() for e in events) * 1e-9
    record = {"trace": {"kernels": [("kernel", lo, hi)]}}
    got = spans_mod.program_spans(record)
    assert [i.name for i in got] == [e.name() for e in events]
    for i, e in zip(got, events):
        assert abs(i.start - e.start_ns() * 1e-9) < 1e-3
        assert abs(i.end - e.end_ns() * 1e-9) < 1e-3
    hops = spans_mod.named(got, "pageann.hop")
    assert [h.args["hop"] for h in hops] == list(range(len(hops)))
    # a window after the search holds none of its spans
    assert spans_mod.program_spans(
        {"trace": {"kernels": [("kernel", hi + 1.0, hi + 2.0)]}}) == []


def test_engine_dispatch_holds_the_search_spans(index):
    """An engine hangs its tracer on the index: each ``device_dispatch``
    holds the ``pageann.search`` of its batch, and that search its hops."""
    q = _data()[1]
    tr = Tracer()
    eng = BatchingEngine.from_index(index, k=K, batch_size=8, tracer=tr)
    try:
        assert index.tracer is tr
        eng.search(q)
    finally:
        eng.close()
        index.tracer = None
    spans = tr.spans()
    dispatches = [s for s in spans if s.name == "device_dispatch"]
    searches = [s for s in spans if s.name == "pageann.search"]
    assert len(dispatches) == len(searches) == Q // 8
    for d in dispatches:
        (s,) = [s for s in searches if _inside(s, d)]
        assert s.args["queries"] == 8
    hops = [s for s in spans if s.name == "pageann.hop"]
    assert hops and all(any(_inside(h, s) for s in searches) for h in hops)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the search's kernels run there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_profiled_spans_agree_with_the_device_trace_on_the_card(cuda):
    """On the card, with CUDA activities traced: the process tracer's spans
    agree with the profile's ``record_function`` events within 1 ms, and
    the device ran kernels inside the search span."""
    idx = _build(MemoryMode.HYBRID, device=cuda)
    q = _data()[1]
    idx.search(q, k=K)                                    # build the kernels
    res, prof = _profiled_search(idx, q, [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    _equal(res, idx.search(q, k=K))
    spans, worst = _agreement(prof)
    print(f"span clock agreement on {torch.cuda.get_device_name(cuda)}: "
          f"{worst * 1e6:.1f} us over {len(spans)} spans")
    assert worst < 1e-3
    (search,) = [s for s in spans if s.name == "pageann.search"]
    s0 = PROFILED.epoch_ns(search.ts)
    s1 = PROFILED.epoch_ns(search.ts + search.dur)
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation()]
    assert kernels and all(s0 <= e.start_ns() for e in kernels)
    assert any(e.end_ns() <= s1 for e in kernels)


@pytest.mark.cuda
def test_the_smokes_search_profile_counts_no_span_as_device_work(
        cuda, monkeypatch):
    """``chip_smoke.py``'s search profile leaves out the annotations that
    the profiler mirrors from the search's spans onto the card's timeline:
    its device time and launches are those of the search without spans."""
    smoke = _from_root("chip_smoke")
    idx = _build(MemoryMode.HYBRID, device=cuda)
    q = _data()[1]
    idx.search(q, k=K)                                    # build the kernels
    with_spans = smoke._profile_search(idx, q)
    monkeypatch.setattr(trace, "_profiler_enabled", lambda: False)
    without = smoke._profile_search(idx, q)
    assert with_spans["device_launches"] == without["device_launches"] > 0
    assert not any(t["name"].startswith("pageann.")
                   for t in with_spans["top"])
    assert with_spans["device_busy_ms"] < with_spans["profiled_wall_ms"]
