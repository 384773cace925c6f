"""The port's observability layer (``repro_torch.obs`` and the per-hop search
profile) against the JAX package's.

The tracer, the metrics registry, the exposition parser, the HTTP sidecar
and the report renderer are copies of pure-Python modules: they are held to
the reference's behaviour case for case (the engine-free cases of
``tests/test_observability.py``), and where both packages render the same
input, the text must be equal. ``serve_registry`` runs over a stand-in
source whose ``metrics()`` returns the reference's ``EngineMetrics``, and
over the port's ``BatchingEngine`` itself (the engine cases of
``tests/test_observability.py``): its quantiles against numpy, its
exposition against its ``metrics()``, and its span phases and stamps
against the reference engine's under one fake clock.

The profile: the port's ``profile_search`` trail must equal the
reference's on a JAX-built index (``torch_jax_artifacts``): pages, ios,
cache hits, active and stall exactly, the worst top-k distance within
rtol = atol = 1e-5; and the port's profiled results equal its unprofiled
search bit for bit.
"""
import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Num as JNum
from repro.core import SearchParams as JParams
from repro.core import lsh as jlsh
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer
from repro.obs import report as jreport
from repro.obs import serve_registry as jax_serve_registry
from repro.serve import BatchingEngine as JEngine
from repro.serve.engine import EngineMetrics
from repro_torch.core import (
    AdaptiveParams,
    MemoryMode,
    Num,
    SearchParams,
    load_pageann,
)
from repro_torch.core import lsh as tlsh
from repro_torch.core.search import PAD, SearchResult
from repro_torch.obs import (
    NULL_TRACER,
    MetricsRegistry,
    MetricsServer,
    Tracer,
    parse_prometheus_text,
    sample_value,
    serve_registry,
)
from repro_torch.obs import report as report_mod
from repro_torch.obs.metrics import _ENGINE_FIELDS
from repro_torch.serve import BatchingEngine
from torch_jax_artifacts import dataset, metadata_artifact

# six test workers share the host's cores; the port's small searches gain
# nothing from more intra-op threads than one
torch.set_num_threads(1)

K = 10


# ------------------------------------------------------------------ tracer
def test_tracer_records_spans_in_order():
    t = {"v": 0.0}
    tr = Tracer(clock=lambda: t["v"])
    t["v"] = 1.0
    with tr.span("phase_a", cat="x", track="eng", n=3):
        t["v"] = 1.5
    tr.add("phase_b", 2.0, 2.25, track="req-1", args={"k": 10})
    tr.instant("marker")
    spans = tr.spans()
    assert [s.name for s in spans] == ["phase_a", "phase_b", "marker"]
    a, b, m = spans
    assert (a.ts, a.dur, a.track, a.args) == (1.0, 0.5, "eng", {"n": 3})
    assert (b.ts, b.dur) == (2.0, 0.25)
    assert m.dur == 0.0
    assert len(tr) == 3 and tr.dropped == 0
    assert tr.now() == 1.5


def test_tracer_disabled_is_noop_and_shares_null_span():
    tr = Tracer(enabled=False)
    s1 = tr.span("a")
    s2 = tr.span("b")
    assert s1 is s2 is NULL_TRACER.span("c")   # one shared no-op manager
    with s1:
        pass
    tr.add("c", 0.0, 1.0)
    tr.instant("d")
    assert len(tr) == 0 and tr.spans() == []
    with pytest.raises(ValueError, match="capacity"):
        Tracer(capacity=0)


def test_tracer_ring_buffer_drops_oldest_and_counts():
    tr = Tracer(capacity=4, clock=lambda: 0.0)
    for i in range(7):
        tr.add(f"s{i}", float(i), float(i))
    assert len(tr) == 4
    assert tr.dropped == 3
    assert [s.name for s in tr.spans()] == ["s3", "s4", "s5", "s6"]
    tr.clear()
    assert len(tr) == 0 and tr.dropped == 0


def test_tracer_negative_duration_clamps_to_zero():
    tr = Tracer()
    tr.add("backwards", 5.0, 4.0)
    assert tr.spans()[0].dur == 0.0


def test_chrome_export_structure_and_equal_to_the_reference(tmp_path):
    tracers = Tracer(clock=lambda: 0.0), JTracer(clock=lambda: 0.0)
    for tr in tracers:
        tr.add("first", 10.0, 10.002, cat="engine", track="engine")
        tr.add("second", 10.001, 10.004, track="req-1", args={"k": 5})
    doc = json.loads(tracers[0].to_chrome_json())
    assert tracers[0].to_chrome_json() == tracers[1].to_chrome_json()
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    body = [e for e in events if e["ph"] == "X"]
    # one process_name + one thread_name per distinct track
    assert {e["args"]["name"] for e in meta} == {"repro-serve", "engine", "req-1"}
    # timestamps are microseconds relative to the earliest span
    first = next(e for e in body if e["name"] == "first")
    second = next(e for e in body if e["name"] == "second")
    assert first["ts"] == 0.0 and first["dur"] == pytest.approx(2000.0)
    assert second["ts"] == pytest.approx(1000.0)
    assert second["args"] == {"k": 5}
    assert first["tid"] != second["tid"]
    out = tmp_path / "trace.json"
    tracers[0].save(str(out))
    assert json.loads(out.read_text()) == doc


# ---------------------------------------------------------------- registry
def test_registry_counter_gauge_roundtrip():
    reg = MetricsRegistry()
    c = reg.counter("t_requests_total", "req")
    c.inc()
    c.inc(4.0)
    reg.gauge("t_qps", "qps").set(123.5)
    parsed = parse_prometheus_text(reg.render())
    assert sample_value(parsed, "t_requests_total") == 5.0
    assert sample_value(parsed, "t_qps") == 123.5
    assert reg.counter("t_requests_total", "req") is c
    assert reg.get("t_qps").value() == 123.5
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("t_requests_total", "req")
    with pytest.raises(TypeError):
        c.observe(1.0)


def test_registry_histogram_buckets_sum_count():
    reg = MetricsRegistry()
    h = reg.histogram("t_lat_ms", "lat", buckets=(1.0, 5.0, 10.0))
    for v in (0.5, 0.7, 3.0, 7.0, 50.0):
        h.observe(v)
    parsed = parse_prometheus_text(reg.render())
    assert sample_value(parsed, "t_lat_ms_bucket", le="1") == 2
    assert sample_value(parsed, "t_lat_ms_bucket", le="5") == 3
    assert sample_value(parsed, "t_lat_ms_bucket", le="10") == 4
    assert sample_value(parsed, "t_lat_ms_bucket", le="+Inf") == 5
    assert sample_value(parsed, "t_lat_ms_sum") == pytest.approx(61.2)
    assert sample_value(parsed, "t_lat_ms_count") == 5
    # observe_window replaces the distribution rather than accumulating
    h.observe_window([2.0, 2.0])
    parsed = parse_prometheus_text(reg.render())
    assert sample_value(parsed, "t_lat_ms_count") == 2
    assert sample_value(parsed, "t_lat_ms_bucket", le="5") == 2
    with pytest.raises(TypeError):
        h.set(1.0)


def test_registry_labels_and_validation():
    reg = MetricsRegistry()
    g = reg.gauge("t_pages", "pages")
    g.set(7, labels={"collection": 'we"ird'})
    g.set(9, labels={"collection": "other"})
    parsed = parse_prometheus_text(reg.render())
    assert sample_value(parsed, "t_pages", collection='we"ird') == 7
    assert sample_value(parsed, "t_pages", collection="other") == 9
    with pytest.raises(KeyError):
        sample_value(parsed, "t_pages", collection="absent")
    with pytest.raises(ValueError):
        reg.counter("bad name", "x")
    with pytest.raises(ValueError):
        reg.histogram("t_h", "x", buckets=(2.0, 1.0))
    with pytest.raises(ValueError):
        g.set(1, labels={"bad-label": "x"})
    with pytest.raises(ValueError):
        parse_prometheus_text("t_ok 1\nthis is not a sample line !!\n")


def test_registry_renders_the_reference_text():
    """The same instruments and samples render the same exposition text,
    quantile-relevant float formatting and label escaping included."""
    texts = []
    for reg in (MetricsRegistry(), JRegistry()):
        reg.counter("t_total", "a counter").inc(3)
        reg.gauge("t_ratio", "a gauge").set(0.125, labels={"c": 'x"\\y\n'})
        reg.gauge("t_big", "a gauge").set(float("inf"))
        h = reg.histogram("t_ms", "a histogram", buckets=(0.5, 1.0, 2.5))
        for v in (0.1, 0.75, 2.0, 9.0):
            h.observe(v, labels={"c": "a"})
        h.observe_window([0.3, 3.0], labels={"c": "b"})
        texts.append(reg.render())
    assert texts[0] == texts[1]
    parsed = parse_prometheus_text(texts[0])
    assert sample_value(parsed, "t_big") == float("inf")
    assert sample_value(parsed, "t_ratio", c='x"\\y\n') == 0.125


# ------------------------------------------- exposition over a stand-in engine
class _StandInEngine:
    """``metrics()`` / ``metrics_windows()`` / ``stats()`` as a serving
    engine answers them, from fixed numbers."""

    def __init__(self, rng):
        ints = {f: int(rng.integers(0, 1000)) for f in EngineMetrics._fields}
        floats = {f: float(rng.uniform(0, 50)) for f in EngineMetrics._fields}
        self._metrics = EngineMetrics(**{
            f: ints[f] if EngineMetrics.__annotations__[f] in (int, "int")
            else floats[f] for f in EngineMetrics._fields})
        self._windows = dict(latency_ms=rng.uniform(0.1, 300, 40),
                             hops=rng.integers(1, 64, 40).astype(float),
                             ios=rng.integers(1, 200, 40).astype(float),
                             fetch_wall_s=rng.uniform(1e-5, 0.1, 7))
        self._stats = {"docs": {"pages": 1667, "resident_pages": 417,
                                "base": {"disk_bytes": 6828032}},
                       "faq": {"pages": 12, "delta_live": 3, "note": "x"}}

    def metrics(self):
        return self._metrics

    def metrics_windows(self):
        return self._windows

    def stats(self):
        return self._stats


def test_serve_registry_maps_every_engine_field():
    """Every ``EngineMetrics`` field becomes a series, the windows become
    histograms and the per-collection stats become labelled gauges: the
    same text as the reference's ``serve_registry`` over the same source."""
    assert set(_ENGINE_FIELDS) == set(EngineMetrics._fields)
    src = _StandInEngine(np.random.default_rng(3))
    text = serve_registry(src).render()
    assert text == jax_serve_registry(src).render()
    parsed = parse_prometheus_text(text)
    m = src.metrics()
    for field, (suffix, _, _) in _ENGINE_FIELDS.items():
        assert sample_value(parsed, f"pageann_{suffix}") == pytest.approx(
            float(getattr(m, field))), field
    win = src.metrics_windows()
    assert sample_value(parsed, "pageann_request_latency_ms_count") == 40
    assert sample_value(parsed, "pageann_request_latency_ms_sum") == pytest.approx(
        win["latency_ms"].sum())
    assert sample_value(parsed, "pageann_request_hops_bucket", le="+Inf") == 40
    assert sample_value(parsed, "pageann_fetch_wall_seconds_count") == 7
    assert sample_value(parsed, "pageann_collection_pages", collection="docs") == 1667
    assert sample_value(parsed, "pageann_collection_disk_bytes",
                        collection="docs") == 6828032
    assert sample_value(parsed, "pageann_collection_delta_live",
                        collection="faq") == 3
    # a second registry in another namespace, on a shared registry object
    reg = MetricsRegistry()
    serve_registry(src, namespace="other", registry=reg)
    assert sample_value(parse_prometheus_text(reg.render()),
                        "other_requests_total") == m.requests


def test_metrics_server_scrape_endpoints():
    src = _StandInEngine(np.random.default_rng(5))
    reg = serve_registry(src)
    with MetricsServer(reg, source=src) as srv:
        assert srv.port > 0 and srv.url.endswith(str(srv.port))
        with urllib.request.urlopen(f"{srv.url}/healthz", timeout=10) as r:
            assert r.status == 200 and r.read() == b"ok\n"
        with urllib.request.urlopen(f"{srv.url}/metrics", timeout=10) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/plain")
            parsed = parse_prometheus_text(r.read().decode())
        assert sample_value(parsed, "pageann_requests_total") == src.metrics().requests
        with urllib.request.urlopen(f"{srv.url}/stats", timeout=10) as r:
            doc = json.loads(r.read().decode())
        assert doc["metrics"]["requests"] == src.metrics().requests
        assert doc["collections"]["docs"]["base"]["disk_bytes"] == 6828032
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{srv.url}/nope", timeout=10)


def test_metrics_server_reports_a_wedged_source():
    class Wedged:
        def metrics(self):
            raise RuntimeError("engine lock held")

    with MetricsServer(MetricsRegistry(), source=Wedged()) as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{srv.url}/healthz", timeout=10)
        assert e.value.code == 503


def test_report_cli_renders_chrome_trace(tmp_path, capsys):
    tr = Tracer(clock=lambda: 0.0)
    tr.add("device_dispatch", 0.0, 0.010, cat="engine", track="engine")
    tr.add("queue_wait", 0.0, 0.002, track="req-1")
    path = tmp_path / "trace.json"
    tr.save(str(path))
    assert report_mod.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "device_dispatch" in out and "queue_wait" in out
    assert out == jreport.render_trace(json.loads(path.read_text()))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"neither": 1}))
    assert report_mod.main([str(bad)]) == 2


# ------------------------------------------------------- per-hop profiling
def _flips(jindex, q) -> np.ndarray:
    planes = np.array(jindex.lsh.planes)
    want = np.asarray(jlsh.hash_codes(jnp.asarray(q), jnp.asarray(planes)))
    got = tlsh.hash_codes(torch.as_tensor(q), torch.as_tensor(planes)).numpy()
    return np.nonzero((got.view(np.uint32) != want).any(1))[0]


def _params(index, adaptive):
    p = SearchParams.from_config(index.cfg)
    if adaptive:
        p = p.replace(adaptive=AdaptiveParams(patience=2))
    return JParams.from_json(p.to_json()), p


def _assert_trail_equal(tt, jt, keep) -> None:
    for field in ("pages", "ios", "cache_hits", "active", "stall"):
        np.testing.assert_array_equal(getattr(tt, field)[keep],
                                      np.asarray(getattr(jt, field))[keep],
                                      err_msg=field)
    w_t, w_j = tt.worst_topk[keep], np.asarray(jt.worst_topk)[keep]
    np.testing.assert_array_equal(np.isinf(w_t), np.isinf(w_j))
    fin = np.isfinite(w_j)
    np.testing.assert_allclose(w_t[fin], w_j[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("adaptive", [False, True], ids=["plain", "patience2"])
@pytest.mark.parametrize("mode", [MemoryMode.HYBRID.value, MemoryMode.MEM_ALL.value])
@pytest.mark.parametrize("filtered", [False, True], ids=["all", "sel0.1"])
def test_profile_trail_matches_the_reference(mode, adaptive, filtered):
    jindex, directory = metadata_artifact(mode)
    tindex = load_pageann(directory, device="cpu")
    q = dataset()[1]
    keep = np.setdiff1d(np.arange(len(q)), _flips(jindex, q))
    pj, pt = _params(tindex, adaptive)
    kw_t = kw_j = {}
    if filtered:
        le = float(np.quantile(np.asarray(dataset()[2]["score"]), 0.1))
        kw_t, kw_j = dict(filter=Num("score").le(le)), dict(filter=JNum("score").le(le))
    rt, tt = tindex.profile(q, K, params=pt, **kw_t)
    rj, jt = jindex.profile(q, K, params=pj, **kw_j)
    _assert_trail_equal(tt, jt, keep)
    for field in ("ids", "ios", "hops", "cache_hits"):
        np.testing.assert_array_equal(getattr(rt, field)[keep],
                                      np.asarray(getattr(rj, field))[keep])
    # the profile is the search, bit for bit, with the trail kept
    want = tindex.search(q, K, params=pt, **kw_t)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(rt, field), getattr(want, field),
                                      err_msg=field)
    # trail invariants: deltas sum to the totals, frozen hops record nothing
    np.testing.assert_array_equal(tt.active.sum(1), rt.hops)
    np.testing.assert_array_equal(tt.ios.sum(1), rt.ios)
    np.testing.assert_array_equal(tt.cache_hits.sum(1), rt.cache_hits)
    assert (tt.pages[~tt.active] == PAD).all()
    assert (tt.ios[~tt.active] == 0).all()
    assert tt.pages.shape == (len(q), pt.max_hops, pt.io_batch)
    if not adaptive:
        assert (tt.stall == 0).all()
    else:
        assert (tt.stall[np.arange(len(q)), rt.hops - 1] <= 2).all()


def test_profile_saves_json_that_both_report_clis_render(tmp_path, capsys):
    """A profile saved by either package renders in both packages' CLIs,
    to the same text."""
    jindex, directory = metadata_artifact(MemoryMode.HYBRID.value)
    tindex = load_pageann(directory, device="cpu")
    q = dataset()[1][:4]
    paths = tmp_path / "port.json", tmp_path / "ref.json"
    tindex.profile(q, k=K, save=str(paths[0]))
    jindex.profile(q, k=K, save=str(paths[1]))
    for path in paths:
        doc = json.loads(path.read_text())
        assert doc["kind"] == "pageann_profile" and len(doc["ids"]) == 4
        assert report_mod.main([str(path), "--queries", "2"]) == 0
        ours = capsys.readouterr().out
        assert jreport.main([str(path), "--queries", "2"]) == 0
        assert capsys.readouterr().out == ours
        assert "query 1: hops=" in ours and "query 2:" not in ours
    assert set(json.loads(paths[0].read_text())) == set(
        json.loads(paths[1].read_text()))


def test_profile_rejects_streamed_index():
    _, directory = metadata_artifact(MemoryMode.HYBRID.value)
    streamed = load_pageann(directory, device="cpu", memory_budget=0.25)
    with pytest.raises(ValueError, match="streamed"):
        streamed.profile(dataset()[1][:2])


def test_fetcher_emits_spans_into_the_tracer():
    """A tracer attached to the streamed tier's fetcher gets one
    ``page_fetch`` span per hop's read, with the pages it requested and
    missed; a disabled one gets nothing."""
    _, directory = metadata_artifact(MemoryMode.HYBRID.value)
    streamed = load_pageann(directory, device="cpu", memory_budget=0.25)
    q = dataset()[1]
    streamed.fetcher.tracer = Tracer(enabled=False)
    streamed.search(q, k=K)
    assert len(streamed.fetcher.tracer) == 0
    tr = Tracer()
    streamed.fetcher.tracer = tr
    streamed.fetcher.reset_stats()
    streamed.search(q, k=K)
    stats = streamed.fetch_stats()
    spans = tr.spans()
    assert len(spans) == len(stats["wall_window"]) > 0
    assert {(s.name, s.cat, s.track) for s in spans} == {
        ("page_fetch", "host-fetch", "host-fetch")}
    assert sum(s.args["misses"] for s in spans) == stats["pages_fetched"]
    assert sum(s.args["requested"] for s in spans) == (
        stats["pages_fetched"] + stats["fetch_hits"])
    assert all(s.dur >= 0.0 for s in spans)
    assert "page_fetch" in report_mod.render_trace(json.loads(tr.to_chrome_json()))


def test_obs_package_exports_the_reference_names():
    import repro.obs as jobs
    import repro_torch.obs as tobs

    assert tobs.__all__ == jobs.__all__
    assert isinstance(tobs.NULL_TRACER, Tracer) and not tobs.NULL_TRACER.enabled


# ------------------------------------------ over the port's serving engine
class _FakeClock:
    """Deterministic monotonic clock; tests advance ``.t`` explicitly."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _clocked_backend(clock, latencies_s, hops_list, ios=3):
    """Per-dispatch backend: advances the fake clock by the next latency
    (so a request's latency is that delta at batch_size=1) and reports the
    next scripted hop count."""
    lat_it = iter(latencies_s)
    hop_it = iter(hops_list)

    def fn(q, k, params):
        clock.t += next(lat_it)
        b = q.shape[0]
        return SearchResult(
            ids=np.zeros((b, k), np.int32),
            dists=np.zeros((b, k), np.float32),
            ios=np.full((b,), ios, np.int32),
            hops=np.full((b,), next(hop_it), np.int32),
            cache_hits=np.zeros((b,), np.int32),
        )

    return fn


def test_latency_and_hops_quantiles_match_numpy_oracle():
    rng = np.random.default_rng(7)
    lat_s = rng.uniform(0.001, 0.2, size=100)
    hops = rng.integers(1, 40, size=100)
    clock = _FakeClock()
    eng = BatchingEngine(_clocked_backend(clock, lat_s, hops), dim=4,
                         batch_size=1, clock=clock)
    for _ in range(100):
        eng.submit(np.zeros(4, np.float32)).result(timeout=30)
    m = eng.metrics()
    lat_ms = lat_s * 1e3
    assert m.requests == 100 and m.batches == 100
    assert m.latency_ms_mean == pytest.approx(lat_ms.mean())
    assert m.latency_ms_p50 == pytest.approx(np.percentile(lat_ms, 50))
    assert m.latency_ms_p99 == pytest.approx(np.percentile(lat_ms, 99))
    assert m.mean_hops == pytest.approx(hops.mean())
    assert m.p99_hops == pytest.approx(np.percentile(hops, 99))
    assert m.mean_ios == 3.0 and m.p99_ios == 3.0
    win = eng.metrics_windows()
    np.testing.assert_allclose(win["latency_ms"], lat_ms)
    np.testing.assert_array_equal(win["hops"], hops)
    eng.close()


def test_latency_window_evicts_oldest_at_overflow():
    window, total = 16, 50
    lat_s = np.linspace(0.001, 0.05, total)
    hops = np.arange(1, total + 1)
    clock = _FakeClock()
    eng = BatchingEngine(_clocked_backend(clock, lat_s, hops), dim=4,
                         batch_size=1, clock=clock, latency_window=window)
    for _ in range(total):
        eng.submit(np.zeros(4, np.float32)).result(timeout=30)
    m = eng.metrics()
    assert m.requests == total
    tail_ms = lat_s[-window:] * 1e3
    assert m.latency_ms_mean == pytest.approx(tail_ms.mean())
    assert m.latency_ms_p50 == pytest.approx(np.percentile(tail_ms, 50))
    assert m.latency_ms_p99 == pytest.approx(np.percentile(tail_ms, 99))
    assert m.mean_hops == pytest.approx(hops[-window:].mean())
    win = eng.metrics_windows()
    assert len(win["latency_ms"]) == window
    np.testing.assert_allclose(win["latency_ms"], tail_ms)
    eng.close()


def test_early_exit_accounting_against_resolved_max_hops():
    hops = [3, 10, 10, 7, 10, 1]
    clock = _FakeClock()
    eng = BatchingEngine(batch_size=1, clock=clock)
    eng.add_collection(
        "c", _clocked_backend(clock, [0.001] * len(hops), hops), dim=4,
        default_k=5, resolve_fn=lambda k, p: SearchParams(k=k, max_hops=10))
    for _ in range(len(hops)):
        eng.submit(np.zeros(4, np.float32), collection="c").result(timeout=30)
    assert eng.metrics().early_exits == 3
    eng.close()


def test_serve_registry_reconciles_with_engine_metrics():
    """The port's engine behind the port's ``serve_registry``: every series
    agrees with ``metrics()``; and the reference's engine, fed the same
    scripted backend under the same fake clock, renders the same text."""
    rng = np.random.default_rng(3)
    n = 40
    lat_s = rng.uniform(0.001, 0.05, size=n)
    hops = rng.integers(1, 30, size=n)
    texts = []
    for eng_cls, registry in ((BatchingEngine, serve_registry),
                              (JEngine, jax_serve_registry)):
        clock = _FakeClock()
        eng = eng_cls(_clocked_backend(clock, lat_s, hops), dim=4,
                      batch_size=1, clock=clock)
        for _ in range(n):
            eng.submit(np.zeros(4, np.float32)).result(timeout=30)
        texts.append(registry(eng).render())
        if eng_cls is BatchingEngine:
            m = eng.metrics()
        eng.close()
    assert texts[0] == texts[1]
    parsed = parse_prometheus_text(texts[0])
    assert sample_value(parsed, "pageann_requests_total") == m.requests == n
    assert sample_value(parsed, "pageann_batches_total") == m.batches
    assert sample_value(parsed, "pageann_early_exits_total") == m.early_exits
    assert sample_value(parsed, "pageann_compile_misses_total") == (
        m.compile_misses)
    assert sample_value(parsed, "pageann_latency_ms_p99") == pytest.approx(
        m.latency_ms_p99)
    assert sample_value(parsed, "pageann_mean_hops") == pytest.approx(
        m.mean_hops)
    assert sample_value(parsed, "pageann_collections") == 1
    assert sample_value(parsed, "pageann_request_latency_ms_count") == n
    assert sample_value(parsed, "pageann_request_latency_ms_sum") == (
        pytest.approx((lat_s * 1e3).sum()))
    assert sample_value(parsed, "pageann_request_hops_bucket", le="+Inf") == n
    for field, (suffix, _, _) in _ENGINE_FIELDS.items():
        assert sample_value(parsed, f"pageann_{suffix}") == pytest.approx(
            float(getattr(m, field))), field


def test_metrics_server_scrapes_a_real_engine():
    clock = _FakeClock()
    eng = BatchingEngine(_clocked_backend(clock, [0.002] * 5, [4] * 5),
                         dim=4, batch_size=1, clock=clock)
    for _ in range(5):
        eng.submit(np.zeros(4, np.float32)).result(timeout=30)
    with MetricsServer(serve_registry(eng), source=eng) as srv:
        with urllib.request.urlopen(f"{srv.url}/healthz", timeout=10) as r:
            assert r.status == 200 and r.read() == b"ok\n"
        with urllib.request.urlopen(f"{srv.url}/metrics", timeout=10) as r:
            parsed = parse_prometheus_text(r.read().decode())
        assert sample_value(parsed, "pageann_requests_total") == 5
        with urllib.request.urlopen(f"{srv.url}/stats", timeout=10) as r:
            doc = json.loads(r.read().decode())
        assert doc["metrics"]["requests"] == 5
    eng.close()


def _span_tuples(tracer):
    return [(s.name, s.cat, s.track, s.ts, s.dur,
             json.dumps(s.args, sort_keys=True, default=str))
            for s in tracer.spans()]


def test_engine_emits_expected_span_phases():
    """The engine's phases, tracks and nesting, and the reference engine's
    exact spans under the same fake clock and backend."""
    traces = []
    for eng_cls, tracer_cls in ((BatchingEngine, Tracer), (JEngine, JTracer)):
        clock = _FakeClock()
        tr = tracer_cls(clock=clock)
        eng = eng_cls(_clocked_backend(clock, [0.004] * 4, [5] * 4), dim=4,
                      batch_size=2, clock=clock, tracer=tr)
        futs = [eng.submit(np.zeros(4, np.float32)) for _ in range(4)]
        for f in futs:
            f.result(timeout=30)
        eng.close()
        traces.append(tr)
    tr = traces[0]
    assert _span_tuples(tr) == _span_tuples(traces[1])
    names = {s.name for s in tr.spans()}
    assert {"submit", "queue_wait", "batch_assemble", "compile",
            "device_dispatch", "demux", "request"} <= names
    reqs = [s for s in tr.spans() if s.name == "request"]
    assert sorted(s.track for s in reqs) == ["req-1", "req-2", "req-3",
                                             "req-4"]
    dispatches = [s for s in tr.spans() if s.name == "device_dispatch"]
    assert [d.args["compiled"] for d in dispatches] == [True, False]
    assert sum(s.name == "compile" for s in tr.spans()) == 1
    for s in reqs:
        assert s.dur * 1e3 == pytest.approx(s.args["latency_ms"])


def test_engine_spans_over_a_real_index():
    """An engine over a port index with the tracer on: every phase is in
    the trace, each request's span encloses its queue wait and the
    dispatch that served it, and the first dispatch of a signature carries
    the compile span."""
    _, directory = metadata_artifact(MemoryMode.HYBRID.value)
    index = load_pageann(directory, device="cpu")
    q = dataset()[1]
    tr = Tracer()
    eng = BatchingEngine.from_index(index, k=K, batch_size=4, tracer=tr)
    rows = eng.search(q)
    want = index.search(q, k=K)
    np.testing.assert_array_equal(np.stack([r.result.ids for r in rows]),
                                  want.ids)
    eng.search(q[:4])                       # a warm signature: no compile
    eng.close()
    spans = tr.spans()
    assert {"submit", "queue_wait", "batch_assemble", "compile",
            "device_dispatch", "demux", "request"} <= {s.name for s in spans}
    dispatches = [s for s in spans if s.name == "device_dispatch"]
    assert [d.args["compiled"] for d in dispatches] == [True, False, False]
    assert sum(s.name == "compile" for s in spans) == 1
    by_batch = {d.args["batch_index"]: d for d in dispatches}
    for req in (s for s in spans if s.name == "request"):
        d = by_batch[req.args["batch_index"]]
        wait = next(s for s in spans
                    if s.name == "queue_wait" and s.track == req.track)
        assert req.ts <= wait.ts and wait.ts + wait.dur <= d.ts
        assert d.ts + d.dur <= req.ts + req.dur + 1e-9
