"""The port's serving layer (``repro_torch.serve``) against the JAX
package's, on the CPU.

The engine, service, HTTP frontend and semantic cache cases of
``tests/test_serve_engine.py``, ``test_serve_service.py``,
``test_serve_http.py`` and ``test_semantic_cache.py``, case for case, over
the port (the reference's ``shard_search``, ops-routing and dedup cases
belong to the search and its tests). Where both packages can run the same
thing, the port is held to the reference: an engine over a JAX-built index
and one over the port's load of the same artifact return the same ids, ios
and hops (distances ``allclose`` at rtol = atol = 1e-5) and count the same
compile-cache hits, misses and executables; a database saved by either
package loads in the other; engine writes over the port's
``MutableIndex`` give the reference's results. The indexes are the
reference's serving fixtures, built once by the JAX package and loaded by
the port (``torch_jax_artifacts.serve_artifacts``).
"""
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MutableIndex as JMutable
from repro.core import SearchParams as JParams
from repro.core import baselines as jbl
from repro.core.vamana import brute_force_knn
from repro.data.pipeline import query_vectors
from repro.serve import BatchingEngine as JEngine
from repro.serve import VectorService as JService
from repro_torch.core import (
    DiskANNIndex,
    IndexFormatError,
    MemoryMode,
    MutableIndex,
    PageANNConfig,
    PageANNIndex,
    SearchParams,
    load_pageann,
)
from repro_torch.core import persist
from repro_torch.core.search import SearchResult
from repro_torch.obs import parse_prometheus_text, sample_value
from repro_torch.serve import (
    BatchingEngine,
    HttpFrontend,
    SemanticCache,
    TokenBucket,
    VectorService,
)
from repro_torch.serve.compile_cache import CompileCache, geometry_of
from torch_jax_artifacts import D, N_SERVE, serve_artifacts, serve_cfg_kwargs

# six test workers share the host's cores; the port's small searches gain
# nothing from more intra-op threads than one
torch.set_num_threads(1)

CPU = "cpu"
K = 10


def _jax_cfg():
    from repro.core import PageANNConfig as JConfig

    return JConfig(**dict(serve_cfg_kwargs(), build_rounds=1))


def _cfg(**kw) -> PageANNConfig:
    base = dict(serve_cfg_kwargs(), memory_mode=MemoryMode.HYBRID)
    base.update(kw)
    return PageANNConfig(**base)


@pytest.fixture(scope="module")
def corpus_a():
    return serve_artifacts()[0][0]


@pytest.fixture(scope="module")
def corpus_b():
    return serve_artifacts()[0][1]


@pytest.fixture(scope="module")
def jax_indexes():
    return serve_artifacts()[1]


@pytest.fixture(scope="module")
def index_a():
    return load_pageann(serve_artifacts()[2][0], device=CPU)


@pytest.fixture(scope="module")
def index_b():
    return load_pageann(serve_artifacts()[2][1], device=CPU)


@pytest.fixture()
def queries(corpus_a):
    return query_vectors(corpus_a, 6, seed=3)


def _ids(rows):
    return np.stack([np.asarray(r.result.ids) for r in rows])


def _field(rows, name):
    return np.stack([np.asarray(getattr(r.result, name)) for r in rows])


def _assert_rows_equal(got, want, atol=1e-5):
    """Port engine rows against reference engine rows (row by row: the
    requests may differ in k)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("ids", "ios", "hops", "cache_hits"):
            np.testing.assert_array_equal(getattr(g.result, name),
                                          np.asarray(getattr(w.result, name)),
                                          err_msg=name)
        np.testing.assert_allclose(g.result.dists, np.asarray(w.result.dists),
                                   rtol=1e-5, atol=atol)
    assert [r.batch_index for r in got] == [r.batch_index for r in want]
    assert [r.batch_size for r in got] == [r.batch_size for r in want]


def _toy_search_fn(seen_shapes, seen_knobs=None):
    """Deterministic per-row backend: row i's ids encode round(q[i, 0]).
    It answers with torch tensors, which the engine brings back as numpy."""

    def fn(q, k, params):
        seen_shapes.append(np.asarray(q).shape)
        if seen_knobs is not None:
            seen_knobs.append((k, params))
        q = torch.as_tensor(np.asarray(q))
        b = q.shape[0]
        tag = torch.round(q[:, :1]).to(torch.int32)
        return SearchResult(
            ids=tag + torch.arange(k, dtype=torch.int32)[None],
            dists=q.sum(1)[:, None] + torch.arange(k, dtype=torch.float32)[None],
            ios=torch.full((b,), 2, dtype=torch.int32),
            hops=torch.ones((b,), dtype=torch.int32),
            cache_hits=torch.zeros((b,), dtype=torch.int32),
        )

    return fn


# ================================================================== engine
def test_batching_and_demux_order():
    shapes = []
    eng = BatchingEngine(_toy_search_fn(shapes), dim=4, batch_size=4)
    futs = [eng.submit(np.full(4, i, np.float32)) for i in range(11)]
    eng.flush()
    rows = [f.result(timeout=30) for f in futs]
    for i, r in enumerate(rows):
        assert isinstance(r.result.ids, np.ndarray)
        assert r.result.ids[0] == i
        np.testing.assert_allclose(r.result.dists[0], 4.0 * i)
        assert r.latency_ms >= 0.0
    assert [r.batch_index for r in rows] == [0] * 4 + [1] * 4 + [2] * 3
    assert [r.batch_size for r in rows] == [4] * 8 + [3] * 3
    m = eng.metrics()
    assert m.requests == 11 and m.batches == 3
    assert m.mean_ios == 2.0


def test_ragged_batch_is_padded_to_fixed_shape():
    shapes = []
    eng = BatchingEngine(_toy_search_fn(shapes), dim=6, batch_size=8)
    futs = [eng.submit(np.full(6, 1.0 + i, np.float32)) for i in range(3)]
    eng.flush()
    rows = [f.result(timeout=30) for f in futs]
    assert shapes == [(8, 6)]
    for i, r in enumerate(rows):
        assert r.result.ids[0] == 1 + i
        assert r.batch_size == 3
    assert eng.metrics().padded_fraction == pytest.approx(5 / 8)


def test_timeout_flush_without_explicit_flush():
    eng = BatchingEngine(
        _toy_search_fn([]), dim=4, batch_size=64, timeout_ms=30.0
    )
    fut = eng.submit(np.zeros(4, np.float32))
    assert fut.result(timeout=30).batch_size == 1
    eng.close()


def test_backend_failure_reaches_every_future():
    def boom(q, k, params):
        raise RuntimeError("backend down")

    eng = BatchingEngine(boom, dim=4, batch_size=2)
    futs = [eng.submit(np.zeros(4, np.float32)) for _ in range(3)]
    eng.flush()
    for f in futs:
        with pytest.raises(RuntimeError, match="backend down"):
            f.result(timeout=5)


def test_engine_from_index_matches_direct_search(index_a, corpus_a):
    q = query_vectors(corpus_a, 9, seed=3)
    want = index_a.search(q, k=5)
    eng = BatchingEngine.from_index(index_a, k=5, batch_size=4)
    futs = [eng.submit(row) for row in q]
    eng.flush()
    rows = [f.result(timeout=120) for f in futs]
    np.testing.assert_array_equal(_ids(rows), want.ids)
    np.testing.assert_array_equal(_field(rows, "dists"), want.dists)
    assert eng.metrics().requests == 9


def test_per_request_k_binning_and_param_groups():
    shapes, knobs = [], []
    eng = BatchingEngine(
        _toy_search_fn(shapes, knobs), dim=4, batch_size=4,
        default_k=5, k_bins=(5, 8),
    )
    wide = SearchParams(k=5, beam_width=128)
    futs = [eng.submit(np.full(4, i, np.float32)) for i in range(4)]
    f_small = eng.submit(np.full(4, 9.0, np.float32), k=3)
    f_eight = eng.submit(np.full(4, 7.0, np.float32), k=7)
    f_wide = eng.submit(np.full(4, 5.0, np.float32), params=wide)
    f_tall = eng.submit(np.full(4, 6.0, np.float32), k=12)
    eng.flush()
    for i, f in enumerate(futs):
        assert f.result(timeout=30).result.ids.shape == (5,)
        assert f.result(timeout=30).result.ids[0] == i
    assert f_small.result(timeout=30).result.ids.shape == (3,)
    np.testing.assert_array_equal(f_small.result(timeout=30).result.ids,
                                  9 + np.arange(3))
    assert f_eight.result(timeout=30).result.ids.shape == (7,)
    assert f_wide.result(timeout=30).result.ids.shape == (5,)
    assert f_tall.result(timeout=30).result.ids.shape == (12,)
    assert sorted(k for k, _ in knobs) == [5, 5, 5, 8, 12]
    assert sum(1 for _, p in knobs if p is wide) == 1
    assert eng.metrics().requests == 8


def test_timer_survives_other_groups_size_dispatch():
    eng = BatchingEngine(
        _toy_search_fn([]), dim=4, batch_size=2, timeout_ms=30.0, default_k=3
    )
    slow = eng.submit(np.zeros(4, np.float32))
    for _ in range(2):
        eng.submit(np.ones(4, np.float32), k=8)
    assert slow.result(timeout=5).batch_size == 1
    eng.close()


def test_one_timer_dispatch_at_a_time():
    """A backend slower than the timeout (as the port's host-bound search
    is on the card): requests that arrive while a timer dispatch runs wait
    for it and go out together in the next one, so timer dispatches never
    overlap and the batches grow with the backend's latency."""
    shapes, live, most = [], [0], [0]
    lock = threading.Lock()
    toy = _toy_search_fn(shapes)

    def slow(q, k, params):
        with lock:
            live[0] += 1
            most[0] = max(most[0], live[0])
        time.sleep(0.04)
        with lock:
            live[0] -= 1
        return toy(q, k, params)

    eng = BatchingEngine(slow, dim=4, batch_size=64, timeout_ms=2.0,
                         default_k=3)
    futs = []
    for i in range(30):
        futs.append(eng.submit(np.full(4, i, np.float32)))
        time.sleep(0.003)
    rows = [f.result(timeout=30) for f in futs]
    eng.close()
    assert [int(r.result.ids[0]) for r in rows] == list(range(30))
    assert most[0] == 1
    assert eng.metrics().batches < 10, eng.metrics().batches


def test_sparse_group_not_starved_by_steady_traffic():
    eng = BatchingEngine(
        _toy_search_fn([]), dim=4, batch_size=2, timeout_ms=100.0, default_k=3
    )
    resolved_at = []
    t0 = time.perf_counter()
    slow = eng.submit(np.zeros(4, np.float32), k=5)
    slow.add_done_callback(
        lambda _: resolved_at.append(time.perf_counter() - t0))
    for _ in range(10):
        for _ in range(2):
            eng.submit(np.ones(4, np.float32))
        time.sleep(0.05)
    slow.result(timeout=5)
    eng.close()
    assert resolved_at and resolved_at[0] < 0.35, resolved_at


def test_drained_groups_do_not_accumulate():
    eng = BatchingEngine(_toy_search_fn([]), dim=4, batch_size=1)
    for k in range(1, 30):
        eng.submit(np.zeros(4, np.float32), k=k).result(timeout=30)
    assert len(eng._pending) == 0
    eng.close()


def test_params_k_respected_without_k_kwarg():
    knobs = []
    eng = BatchingEngine(
        _toy_search_fn([], knobs), dim=4, batch_size=1, default_k=3
    )
    fut = eng.submit(np.zeros(4, np.float32), params=SearchParams(k=7))
    assert fut.result(timeout=30).result.ids.shape == (7,)
    assert knobs[0][0] == 7
    eng.close()


def test_per_request_params_match_direct_search(index_a, corpus_a):
    q = query_vectors(corpus_a, 3, seed=5)
    params = SearchParams(k=4, beam_width=16, lsh_entries=4, max_hops=48)
    want = index_a.search(q, params=params)
    eng = BatchingEngine.from_index(index_a, k=4, batch_size=8)
    rows = eng.search(q, params=params)
    np.testing.assert_array_equal(_ids(rows), want.ids)
    np.testing.assert_array_equal(_field(rows, "ios"), want.ios)


def test_submit_routes_to_named_collection():
    shapes_a, shapes_b = [], []
    eng = BatchingEngine(batch_size=2)
    eng.add_collection("a", _toy_search_fn(shapes_a), dim=4, default_k=3)
    eng.add_collection("b", _toy_search_fn(shapes_b), dim=6, default_k=2)
    assert eng.collections() == ("a", "b")
    fa = [eng.submit(np.full(4, i, np.float32), collection="a")
          for i in range(2)]
    fb = eng.submit(np.full(6, 7.0, np.float32), collection="b")
    eng.flush()
    for i, f in enumerate(fa):
        r = f.result(timeout=30)
        assert r.result.ids.shape == (3,) and r.result.ids[0] == i
    assert fb.result(timeout=30).result.ids.shape == (2,)
    assert fb.result(timeout=30).result.ids[0] == 7
    assert shapes_a == [(2, 4)] and shapes_b == [(2, 6)]
    m = eng.metrics()
    assert m.requests == 3 and m.collections == 2
    eng.close()


def test_collection_routing_errors():
    eng = BatchingEngine(batch_size=2)
    with pytest.raises(RuntimeError, match="no collections"):
        eng.submit(np.zeros(4, np.float32))
    eng.add_collection("a", _toy_search_fn([]), dim=4)
    eng.add_collection("b", _toy_search_fn([]), dim=4)
    with pytest.raises(KeyError, match="'c'"):
        eng.submit(np.zeros(4, np.float32), collection="c")
    with pytest.raises(ValueError, match="multiple collections"):
        eng.submit(np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="dim"):
        eng.submit(np.zeros(5, np.float32), collection="a")
    with pytest.raises(ValueError, match="already exists"):
        eng.add_collection("a", _toy_search_fn([]), dim=4)
    eng.remove_collection("b")
    assert eng.collections() == ("a",)
    fut = eng.submit(np.zeros(4, np.float32))
    eng.flush()
    assert fut.result(timeout=30)
    with pytest.raises(KeyError):
        eng.remove_collection("b")
    eng.close()


def test_backend_failure_isolated_to_its_group():
    def boom(q, k, params):
        raise RuntimeError("backend down")

    eng = BatchingEngine(batch_size=2)
    eng.add_collection("bad", boom, dim=4)
    eng.add_collection("good", _toy_search_fn([]), dim=4, default_k=3)
    wide = SearchParams(k=3, beam_width=128)
    f_bad = [eng.submit(np.zeros(4, np.float32), collection="bad")
             for _ in range(3)]
    f_good = [eng.submit(np.full(4, float(i), np.float32), collection="good")
              for i in range(3)]
    f_wide = eng.submit(np.full(4, 5.0, np.float32), collection="good",
                        params=wide)
    eng.flush()
    for f in f_bad:
        with pytest.raises(RuntimeError, match="backend down"):
            f.result(timeout=5)
    for i, f in enumerate(f_good):
        assert f.result(timeout=5).result.ids[0] == i
    assert f_wide.result(timeout=5).result.ids.shape == (3,)
    again = eng.submit(np.full(4, 9.0, np.float32), collection="good")
    eng.flush()
    assert again.result(timeout=5).result.ids[0] == 9
    assert eng.metrics().requests == 5
    eng.close()


def test_engine_context_manager_and_idempotent_close():
    with BatchingEngine(_toy_search_fn([]), dim=4, batch_size=8) as eng:
        fut = eng.submit(np.zeros(4, np.float32))
    assert fut.result(timeout=5).batch_size == 1
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.zeros(4, np.float32))
    eng.close()
    eng.close()


def test_qps_zero_wall_is_zero_not_inf():
    eng = BatchingEngine(
        _toy_search_fn([]), dim=4, batch_size=1, clock=lambda: 42.0
    )
    eng.submit(np.zeros(4, np.float32)).result(timeout=30)
    m = eng.metrics()
    assert m.requests == 1
    assert m.qps == 0.0 and np.isfinite(m.qps)
    eng.close()


def test_compile_cache_shared_across_same_geometry_collections():
    fn = _toy_search_fn([])
    eng = BatchingEngine(batch_size=2)
    eng.add_collection("a", fn, dim=4, default_k=3)
    eng.add_collection("b", fn, dim=4, default_k=3)
    eng.search(np.zeros((2, 4), np.float32), collection="a")
    m0 = eng.metrics()
    assert (m0.compile_misses, m0.compile_hits) == (1, 0)
    eng.search(np.zeros((2, 4), np.float32), collection="b")
    m1 = eng.metrics()
    assert m1.compile_misses == 1 and m1.compile_hits == 1
    assert m1.compiled_executables == 1
    eng.search(np.zeros((2, 4), np.float32), collection="b",
               params=SearchParams(k=3, beam_width=128))
    assert eng.metrics().compiled_executables == 2
    eng.close()


def test_deadline_expiry_sheds_with_timeout_error():
    eng = BatchingEngine(_toy_search_fn([]), dim=4, batch_size=8,
                         timeout_ms=None)
    futs = [eng.submit(np.zeros(4, np.float32), deadline_ms=0.01)
            for _ in range(2)]
    time.sleep(0.05)
    eng.flush()
    for f in futs:
        with pytest.raises(TimeoutError, match="deadline"):
            f.result(timeout=5)
    m = eng.metrics()
    assert m.sheds == 2 and m.requests == 0
    eng.close()


def test_generous_deadline_completes_normally():
    eng = BatchingEngine(_toy_search_fn([]), dim=4, batch_size=2)
    futs = [eng.submit(np.zeros(4, np.float32), deadline_ms=60_000.0)
            for _ in range(2)]
    for f in futs:
        assert f.result(timeout=10).batch_size == 2
    assert eng.metrics().sheds == 0
    eng.close()


def test_deadline_fires_via_timer_without_flush():
    eng = BatchingEngine(_toy_search_fn([]), dim=4, batch_size=64,
                         timeout_ms=None)
    fut = eng.submit(np.zeros(4, np.float32), deadline_ms=20.0)
    with pytest.raises(TimeoutError):
        fut.result(timeout=10)
    assert eng.metrics().sheds == 1
    eng.close()


def test_expired_and_live_coexist_in_one_group():
    eng = BatchingEngine(_toy_search_fn([]), dim=4, batch_size=4,
                         timeout_ms=None)
    doomed = eng.submit(np.zeros(4, np.float32), deadline_ms=5.0)
    time.sleep(0.03)
    live = eng.submit(np.ones(4, np.float32) * 3)
    eng.flush()
    with pytest.raises(TimeoutError):
        doomed.result(timeout=5)
    r = live.result(timeout=5)
    assert r.batch_size == 1
    assert int(r.result.ids[0]) == 3
    m = eng.metrics()
    assert m.sheds == 1 and m.requests == 1
    eng.close()


def test_deadline_validation():
    eng = BatchingEngine(_toy_search_fn([]), dim=4, batch_size=2)
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="deadline_ms"):
            eng.submit(np.zeros(4, np.float32), deadline_ms=bad)
    eng.close()


def test_priority_weighted_dispatch_order():
    order = []

    def tagged(tag):
        base = _toy_search_fn([])

        def fn(q, k, params):
            order.append(tag)
            return base(q, k, params)

        return fn

    eng = BatchingEngine(tagged("default"), dim=4, batch_size=64,
                         timeout_ms=None)
    eng.add_collection("hi", tagged("hi"), dim=4, priority=50.0)
    eng.add_collection("lo", tagged("lo"), dim=4, priority=0.5)
    lo = eng.submit(np.zeros(4, np.float32), collection="lo")
    time.sleep(0.01)
    hi = eng.submit(np.zeros(4, np.float32), collection="hi")
    eng.flush()
    eng.flush()
    hi.result(timeout=5), lo.result(timeout=5)
    assert order == ["hi", "lo"]
    eng.close()


def test_priority_validation():
    eng = BatchingEngine(_toy_search_fn([]), dim=4, batch_size=2)
    with pytest.raises(ValueError, match="priority"):
        eng.add_collection("bad", _toy_search_fn([]), dim=4, priority=0.0)
    eng.close()


def test_concurrent_submitters_get_their_own_rows():
    """Four threads submit interleaved requests with a short switch
    interval: every future resolves to its own query's row, and no request
    is lost or served twice."""
    import sys

    eng = BatchingEngine(_toy_search_fn([]), dim=4, batch_size=8,
                         timeout_ms=5.0)
    results = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(t):
            futs = [(i, eng.submit(np.full(4, t * 1000 + i, np.float32)))
                    for i in range(100)]
            results[t] = [(i, f.result(timeout=30)) for i, f in futs]

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    eng.close()
    for t, rows in results.items():
        for i, r in rows:
            assert int(r.result.ids[0]) == t * 1000 + i
    assert eng.metrics().requests == 400


# ------------------------------------------------ against the reference
def _dispatch_sequence(eng, q, *, collections, params):
    """One fixed mix of submits: two k bins, an explicit params group, two
    collections, ragged flushes."""
    futs = []
    for i, row in enumerate(q):
        col = collections[i % len(collections)]
        futs.append(eng.submit(row, collection=col))
        if i % 3 == 0:
            futs.append(eng.submit(row, k=3, collection=col))
    eng.flush()
    futs += [eng.submit(row, params=params, collection=collections[0])
             for row in q[:3]]
    eng.flush()
    return [f.result(timeout=120) for f in futs]


def test_engine_matches_the_reference_engine_on_one_artifact(
        index_a, index_b, jax_indexes, corpus_a):
    """Port engine over the port's loads, reference engine over the JAX
    indexes that saved them: the same rows for the same dispatch sequence,
    and the same compile-cache hits, misses and executables (the second
    same-geometry collection adds no miss in either)."""
    q = query_vectors(corpus_a, 10, seed=7)
    engines = []
    for eng_cls, (a, b), params in (
            (BatchingEngine, (index_a, index_b), SearchParams(
                k=K, beam_width=32, lsh_entries=8, max_hops=24)),
            (JEngine, jax_indexes, JParams(
                k=K, beam_width=32, lsh_entries=8, max_hops=24))):
        eng = eng_cls(batch_size=4, k_bins=(5, 10))
        eng.add_collection("a", index=a, default_k=K)
        rows = [_dispatch_sequence(eng, q, collections=("a",),
                                   params=params)]
        m_a = eng.metrics()
        eng.add_collection("b", index=b, default_k=K)
        rows.append(_dispatch_sequence(eng, q, collections=("b", "a"),
                                       params=params))
        engines.append((rows, m_a, eng.metrics()))
        eng.close()
    (got, ga, gm), (want, wa, wm) = engines
    for g, w in zip(got, want):
        _assert_rows_equal(g, w)
    for fields in ("compile_hits", "compile_misses", "compiled_executables",
                   "requests", "batches", "padded_fraction", "mean_ios",
                   "early_exits", "collections"):
        assert getattr(ga, fields) == getattr(wa, fields), fields
        assert getattr(gm, fields) == getattr(wm, fields), fields
    assert gm.compile_misses == ga.compile_misses      # b compiled nothing


def test_engine_writes_over_a_port_mutable_index_match_the_reference(
        index_b, jax_indexes, corpus_a, corpus_b):
    """Inserts, deletes and searches through the port's engine over a
    ``MutableIndex`` of the port's load, and through the reference's engine
    over one of the JAX index: the same ids back from each write and the
    same search results; a deleted id never comes back."""
    fresh = corpus_a[:40]
    q = np.concatenate([query_vectors(corpus_b, 6, seed=9), fresh[:8]])
    out = []
    for eng in (BatchingEngine.from_index(MutableIndex(index_b), k=K,
                                          batch_size=4),
                JEngine.from_index(JMutable(jax_indexes[1]), k=K,
                                   batch_size=4)):
        new_ids = eng.insert(fresh)
        removed = eng.delete(np.concatenate([new_ids[:5], np.arange(10)]))
        rows = eng.search(q)
        out.append((np.asarray(new_ids), removed, rows, eng.metrics()))
        eng.close()
    (ti, tr, trows, tm), (ji, jr, jrows, jm) = out
    np.testing.assert_array_equal(ti, ji)
    assert tr == jr == 15
    # the delta tier's expanded-form L2 is held to 1e-6 (max|q|^2 +
    # max|x|^2), as in test_torch_delta (ROADMAP C1)
    sq = [float((a.astype(np.float64) ** 2).sum(1).max())
          for a in (q, np.concatenate([corpus_b, fresh]))]
    _assert_rows_equal(trows, jrows, atol=1e-6 * sum(sq))
    dead = np.concatenate([ti[:5], np.arange(10)])
    assert not np.isin(_ids(trows), dead).any()
    # the live inserts among the queries find themselves first
    np.testing.assert_array_equal(_ids(trows)[11:, 0], ti[5:8])
    assert (tm.inserts, tm.deletes) == (jm.inserts, jm.deletes) == (40, 15)


def test_streamed_collection_fetcher_gets_the_engine_tracer(tmp_path):
    """A collection loaded under a memory budget hands the engine's tracer
    to its page fetcher: the dispatch's host reads show as spans."""
    from repro_torch.obs import Tracer

    index = load_pageann(serve_artifacts()[2][0], device=CPU,
                         memory_budget=0.25)
    tr = Tracer()
    eng = BatchingEngine(batch_size=4, tracer=tr)
    eng.add_collection("s", index=index)
    assert index.fetcher.tracer is tr
    eng.search(query_vectors(serve_artifacts()[0][0], 4, seed=2))
    names = {s.name for s in tr.spans()}
    assert "device_dispatch" in names and "page_fetch" in names
    assert eng.metrics().pages_fetched > 0
    eng.close()


# ================================================================= service
def test_routing_matches_direct_search(index_a, index_b, queries):
    with VectorService(device=CPU, batch_size=4) as svc:
        svc.create_collection("a", index_a)
        svc.create_collection("b", index_b)
        assert svc.list_collections() == ("a", "b")
        futs = [svc.submit("a" if i % 2 == 0 else "b", q, k=5)
                for i, q in enumerate(queries)]
        svc.flush()
        rows = [f.result(timeout=120) for f in futs]
    np.testing.assert_array_equal(_ids(rows[0::2]),
                                  index_a.search(queries[0::2], k=5).ids)
    np.testing.assert_array_equal(_ids(rows[1::2]),
                                  index_b.search(queries[1::2], k=5).ids)


def test_bit_identical_to_independent_engines(index_a, index_b, queries):
    with VectorService(device=CPU, batch_size=4) as svc:
        svc.create_collection("a", index_a, k=5)
        rows_a = svc.search("a", queries)
        m_after_a = svc.metrics()
        svc.create_collection("b", index_b, k=5)
        rows_b = svc.search("b", queries)
        m_after_b = svc.metrics()
    with BatchingEngine.from_index(index_a, k=5, batch_size=4) as eng_a:
        solo_a = eng_a.search(queries)
    with BatchingEngine.from_index(index_b, k=5, batch_size=4) as eng_b:
        solo_b = eng_b.search(queries)
    for rows, solo in ((rows_a, solo_a), (rows_b, solo_b)):
        for field in ("ids", "dists", "ios", "hops", "cache_hits"):
            np.testing.assert_array_equal(_field(rows, field),
                                          _field(solo, field), err_msg=field)
    assert m_after_a.compile_misses > 0
    assert m_after_b.compile_misses == m_after_a.compile_misses
    assert m_after_b.compiled_executables == m_after_a.compiled_executables
    assert m_after_b.compile_hits > m_after_a.compile_hits


def test_same_geometry_keys_equal_distinct_differ(index_a, index_b, corpus_a):
    ga, gb = geometry_of(index_a), geometry_of(index_b)
    assert ga == gb
    small = PageANNIndex.build(corpus_a[:300], _cfg(), device=CPU)
    assert geometry_of(small) != ga
    # a mutable index or a baseline is keyed by its own identity
    m = MutableIndex(index_a)
    assert geometry_of(m) == geometry_of(m) != geometry_of(MutableIndex(index_a))
    assert geometry_of(m)[0] == "unshared"


def test_create_from_config_builds(corpus_a, queries):
    with VectorService(device=CPU, batch_size=4) as svc:
        handle = svc.create_collection("built", _cfg(), corpus_a, k=5)
        assert handle.index.device.type == "cpu"
        assert _ids(handle.search(queries)).shape == (len(queries), 5)
    with pytest.raises(ValueError, match="needs vectors"):
        VectorService(device=CPU).create_collection("x", _cfg())


def test_handles_and_registry(index_a):
    svc = VectorService(device=CPU, batch_size=2)
    h = svc.create_collection("a", index_a)
    assert h.name == "a" and h.index is index_a
    assert svc.collection("a").index is index_a
    assert "a" in svc and len(svc) == 1 and list(svc) == ["a"]
    with pytest.raises(KeyError):
        svc.collection("nope")
    with pytest.raises(ValueError, match="already exists"):
        svc.create_collection("a", index_a)
    with pytest.raises(TypeError, match="VectorIndex"):
        svc.create_collection("bad", object())
    svc.close()


@pytest.mark.parametrize("name", ["", "-x", ".hidden", "a/b", "a b",
                                  "x" * 65, 7])
def test_invalid_collection_names(index_a, name):
    with VectorService(device=CPU) as svc:
        with pytest.raises(ValueError, match="collection name"):
            svc.create_collection(name, index_a)


def test_drop_dispatches_pending_then_unroutes(index_a, index_b, queries):
    with VectorService(device=CPU, batch_size=64) as svc:
        svc.create_collection("a", index_a, k=4)
        svc.create_collection("b", index_b, k=4)
        fut = svc.submit("a", queries[0])
        svc.drop("a")
        np.testing.assert_array_equal(fut.result(timeout=120).result.ids,
                                      index_a.search(queries[:1], k=4).ids[0])
        assert svc.list_collections() == ("b",)
        with pytest.raises(KeyError):
            svc.submit("a", queries[0])
        with pytest.raises(KeyError):
            svc.drop("a")
        assert _ids(svc.search("b", queries[:2])).shape == (2, 4)


def test_writes_route_to_mutable_collection(index_a, index_b, queries):
    with VectorService(device=CPU, batch_size=4) as svc:
        svc.create_collection("frozen", index_a, k=3)
        svc.create_collection("mut", MutableIndex(index_b), k=3)
        new_ids = svc.insert("mut", queries[:2])
        assert new_ids.shape == (2,)
        rows = svc.search("mut", queries[:2], k=1)
        np.testing.assert_array_equal(_ids(rows)[:, 0], new_ids)
        assert svc.delete("mut", new_ids) == 2
        with pytest.raises(RuntimeError, match="insert"):
            svc.insert("frozen", queries[:1])
        with pytest.raises(RuntimeError, match="delete"):
            svc.delete("frozen", [0])
        with pytest.raises(RuntimeError, match="compact"):
            svc.compact("frozen")
        m = svc.metrics()
        assert m.inserts == 2 and m.deletes == 2


def test_baseline_collection_serves_its_direct_search(corpus_a, queries):
    """A DiskANN collection on the shared core: the engine's rows are its
    direct search's; it takes no filter and no writes."""
    disk = DiskANNIndex.build(corpus_a, _cfg(build_rounds=1), device=CPU)
    with VectorService(device=CPU, batch_size=4) as svc:
        svc.create_collection("disk", disk, k=5)
        rows = svc.search("disk", queries)
        with pytest.raises(RuntimeError, match="insert"):
            svc.insert("disk", queries[:1])
        assert svc.stats()["disk"]["num_vectors"] == N_SERVE
    want = disk.search(queries, k=5)
    for field in want._fields:
        np.testing.assert_array_equal(_field(rows, field),
                                      getattr(want, field), err_msg=field)
    assert geometry_of(disk)[0] == "unshared"


def test_database_round_trip(tmp_path, index_a, index_b, queries):
    db = str(tmp_path / "db")
    with VectorService(device=CPU, batch_size=4) as svc:
        svc.create_collection("alpha", index_a, k=5)
        svc.create_collection("beta", MutableIndex(index_b), k=5)
        svc.insert("beta", queries[:1])
        want_a = _ids(svc.search("alpha", queries))
        want_b = _ids(svc.search("beta", queries))
        svc.save(db)
    assert persist.is_database_dir(db)
    assert sorted(persist.read_db_manifest(db)["collections"]) == [
        "alpha", "beta"]
    with VectorService.load(db, device=CPU, batch_size=4) as svc2:
        assert svc2.list_collections() == ("alpha", "beta")
        assert isinstance(svc2.collection("beta").index, MutableIndex)
        np.testing.assert_array_equal(
            _ids(svc2.search("alpha", queries, k=5)), want_a)
        np.testing.assert_array_equal(
            _ids(svc2.search("beta", queries, k=5)), want_b)


def test_database_round_trip_across_packages(tmp_path, index_a, index_b,
                                             jax_indexes, corpus_a, queries):
    """A database saved by the reference's service (PageANN, a dirty
    mutable index, a DiskANN baseline) loads in the port's, and one saved
    by the port's loads in the reference's: every collection answers as
    it did before the save."""
    ja, jb = jax_indexes
    jdisk = jbl.DiskANNIndex.build(corpus_a[:300], _jax_cfg())
    with JService(batch_size=4) as svc:
        svc.create_collection("alpha", ja, k=5)
        svc.create_collection("beta", JMutable(jb), k=5)
        svc.create_collection("gamma", jdisk, k=5)
        svc.insert("beta", queries[:2])
        want = {n: _ids(svc.search(n, queries)) for n in svc}
        svc.save(str(tmp_path / "from_jax"))
    loaded = persist.load_database(str(tmp_path / "from_jax"), device=CPU)
    assert isinstance(loaded["beta"], MutableIndex)
    assert isinstance(loaded["gamma"], DiskANNIndex)
    with VectorService.load(str(tmp_path / "from_jax"), device=CPU,
                            batch_size=4) as svc:
        for name, ids in want.items():
            np.testing.assert_array_equal(_ids(svc.search(name, queries,
                                                          k=5)), ids)

    tdisk = DiskANNIndex.from_data(
        np.asarray(jdisk.data.x), np.asarray(jdisk.data.nbrs),
        np.asarray(jdisk.data.codebooks), device=CPU)
    with VectorService(device=CPU, batch_size=4) as svc:
        svc.create_collection("alpha", index_a, k=5)
        svc.create_collection("beta", MutableIndex(index_b), k=5)
        svc.create_collection("gamma", tdisk, k=5)
        svc.insert("beta", queries[:2])
        want = {n: _ids(svc.search(n, queries)) for n in svc}
        svc.save(str(tmp_path / "from_torch"))
    with JService.load(str(tmp_path / "from_torch"), batch_size=4) as svc:
        for name, ids in want.items():
            np.testing.assert_array_equal(_ids(svc.search(name, queries,
                                                          k=5)), ids)


def test_attach_registers_saved_artifact(tmp_path, index_a, queries):
    art = str(tmp_path / "idx")
    index_a.save(art)
    with VectorService(device=CPU, batch_size=4) as svc:
        svc.attach("fromdisk", art, k=5)
        got = _ids(svc.search("fromdisk", queries))
    np.testing.assert_array_equal(got, index_a.search(queries, k=5).ids)


def test_db_manifest_format_errors(tmp_path, index_a):
    db = str(tmp_path / "db")
    persist.save_database({"only": index_a}, db)
    path = os.path.join(db, persist.DB_MANIFEST)
    with open(path) as f:
        doc = json.load(f)
    doc["version"] = persist.DB_VERSION + 1
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(IndexFormatError, match="upgrade"):
        persist.load_database(db, device=CPU)
    with open(path, "w") as f:
        f.write("{ not json")
    with pytest.raises(IndexFormatError, match="not valid JSON"):
        persist.load_database(db, device=CPU)
    os.remove(path)
    with pytest.raises(FileNotFoundError):
        persist.load_database(db, device=CPU)
    assert not persist.is_database_dir(db)


def test_db_manifest_rejects_tampered_paths(tmp_path, index_a):
    db = str(tmp_path / "db")
    persist.save_database({"ok": index_a}, db)
    path = os.path.join(db, persist.DB_MANIFEST)
    with open(path) as f:
        doc = json.load(f)
    doc["collections"]["ok"] = "../../somewhere/else"
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(IndexFormatError, match="unexpected path"):
        persist.load_database(db, device=CPU)


def test_db_manifest_rejects_wrong_format(tmp_path, index_a):
    art = str(tmp_path / "idx")
    index_a.save(art)
    with open(os.path.join(art, persist.DB_MANIFEST), "w") as f:
        json.dump(dict(format="something.else", version=1, collections={}), f)
    with pytest.raises(IndexFormatError, match="not a repro.vector_database"):
        persist.read_db_manifest(art)


def test_context_manager_and_idempotent_close(index_a):
    with VectorService(device=CPU, batch_size=2) as svc:
        svc.create_collection("a", index_a)
    with pytest.raises(RuntimeError, match="closed"):
        svc.create_collection("b", index_a)
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit("a", np.zeros(D, np.float32))
    svc.close()
    svc.close()


def test_explicit_shared_compile_cache(index_a, index_b, queries):
    cache = CompileCache()
    with VectorService(device=CPU, batch_size=4, compile_cache=cache) as s1:
        s1.create_collection("a", index_a, k=5)
        s1.search("a", queries)
    misses_after_s1 = cache.stats().misses
    assert misses_after_s1 > 0
    with VectorService(device=CPU, batch_size=4, compile_cache=cache) as s2:
        s2.create_collection("b", index_b, k=5)
        s2.search("b", queries)
    assert cache.stats().misses == misses_after_s1
    assert cache.stats().hits > 0


def test_service_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VectorService()


# ==================================================================== http
@pytest.fixture()
def served(index_a):
    with VectorService(device=CPU, batch_size=16, timeout_ms=5.0) as svc:
        svc.create_collection("wiki", index_a, k=K)
        with HttpFrontend(svc, port=0, max_inflight=4) as fe:
            yield svc, fe


def _post(url, doc, timeout=60.0):
    req = urllib.request.Request(
        url, json.dumps(doc).encode(), {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url, timeout=30.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def test_search_batch_matches_direct(served, corpus_a):
    svc, fe = served
    q = query_vectors(corpus_a, 6, seed=3)
    truth = brute_force_knn(corpus_a, q, K)
    code, doc, _ = _post(fe.url + "/search", {
        "collection": "wiki", "queries": q.tolist(), "k": K})
    assert code == 200 and doc["shed"] == 0
    ids = np.array([r["ids"] for r in doc["results"]])
    assert ids.shape == (6, K)
    hits = sum(len(set(map(int, r)) & set(map(int, t)))
               for r, t in zip(ids, truth))
    assert hits / truth.size >= 0.8
    direct = np.array([np.asarray(rr.result.ids).reshape(-1)
                       for rr in svc.search("wiki", q, k=K)])
    assert np.array_equal(ids, direct)
    np.testing.assert_array_equal(ids, svc.index_of("wiki").search(q, k=K).ids)


def test_single_query_form(served, corpus_a):
    _, fe = served
    code, doc, _ = _post(fe.url + "/search", {
        "collection": "wiki", "query": corpus_a[7].tolist()})
    assert code == 200
    assert isinstance(doc["results"], dict)
    assert doc["results"]["ids"][0] == 7


def test_collections_healthz_stats(served):
    _, fe = served
    code, body = _get(fe.url + "/collections")
    assert code == 200
    assert {"name": "wiki", "dim": D} in json.loads(body)["collections"]
    code, body = _get(fe.url + "/healthz")
    assert code == 200 and body == b"ok\n"
    code, body = _get(fe.url + "/stats")
    stats = json.loads(body)
    assert code == 200
    assert "metrics" in stats and "wiki" in stats["collections"]


def test_metrics_exposition_covers_http_and_engine(served, corpus_a):
    svc, fe = served
    _post(fe.url + "/search", {"collection": "wiki",
                               "query": corpus_a[0].tolist()})
    code, body = _get(fe.url + "/metrics")
    assert code == 200
    parsed = parse_prometheus_text(body.decode())
    assert sample_value(parsed, "pageann_http_requests_total",
                        route="/search", code="200") >= 1
    assert sample_value(parsed, "pageann_requests_total") >= 1
    assert sample_value(parsed, "pageann_sheds_total") == 0
    m = svc.metrics()
    assert sample_value(parsed, "pageann_requests_total") == m.requests
    assert sample_value(parsed, "pageann_batches_total") == m.batches


def test_validation_errors(served, corpus_a):
    _, fe = served
    url = fe.url
    assert _post(url + "/search", {"queries": [[0.0] * D]})[0] == 400
    assert _post(url + "/search", {"collection": "nope",
                                   "queries": [[0.0] * D]})[0] == 404
    assert _post(url + "/search", {"collection": "wiki"})[0] == 400
    assert _post(url + "/search", {"collection": "wiki",
                                   "queries": []})[0] == 400
    assert _post(url + "/search", {"collection": "wiki",
                                   "queries": [[1.0, 2.0]]})[0] == 400
    assert _post(url + "/nope", {})[0] == 404
    assert _post(url + "/insert", {"collection": "wiki",
                                   "vectors": [corpus_a[0].tolist()]})[0] == 400
    assert _post(url + "/delete", {"collection": "wiki", "ids": [1]})[0] == 400
    req = urllib.request.Request(url + "/search", b"{not json",
                                 {"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400


def test_rate_limit_429_with_retry_after(index_a):
    with VectorService(device=CPU, batch_size=16, timeout_ms=5.0) as svc:
        svc.create_collection("wiki", index_a, k=K)
        with HttpFrontend(svc, port=0, rate_limits={"wiki": (0.001, 2.0)}) as fe:
            q = {"collection": "wiki", "query": [0.0] * D}
            codes, headers = [], []
            for _ in range(4):
                c, _, h = _post(fe.url + "/search", q)
                codes.append(c)
                headers.append(h)
            assert codes == [200, 200, 429, 429]
            assert int(headers[2]["Retry-After"]) >= 1
            _, body = _get(fe.url + "/metrics")
            parsed = parse_prometheus_text(body.decode())
            assert sample_value(parsed, "pageann_http_rejected_total",
                                reason="ratelimit") == 2


def test_inflight_cap_503(served, corpus_a):
    _, fe = served
    for _ in range(4):
        assert fe._inflight.acquire(blocking=False)
    try:
        code, doc, _ = _post(fe.url + "/search", {
            "collection": "wiki", "query": corpus_a[0].tolist()})
        assert code == 503 and "overloaded" in doc["error"]
    finally:
        for _ in range(4):
            fe._inflight.release()
    code, _, _ = _post(fe.url + "/search", {
        "collection": "wiki", "query": corpus_a[0].tolist()})
    assert code == 200
    _, body = _get(fe.url + "/metrics")
    parsed = parse_prometheus_text(body.decode())
    assert sample_value(parsed, "pageann_http_rejected_total",
                        reason="inflight") == 1


def test_deadline_504_counts_engine_sheds(served, corpus_a):
    _, fe = served
    code, doc, _ = _post(fe.url + "/search", {
        "collection": "wiki", "queries": corpus_a[:4].tolist(),
        "deadline_ms": 0.001})
    assert code == 504
    _, body = _get(fe.url + "/metrics")
    parsed = parse_prometheus_text(body.decode())
    assert sample_value(parsed, "pageann_sheds_total") == 4
    assert sample_value(parsed, "pageann_http_rejected_total",
                        reason="deadline") == 1


def test_service_healthy_after_sheds(served, corpus_a):
    _, fe = served
    code, _, _ = _post(fe.url + "/search", {
        "collection": "wiki", "queries": corpus_a[:2].tolist(),
        "deadline_ms": 0.001})
    assert code == 504
    code, doc, _ = _post(fe.url + "/search", {
        "collection": "wiki", "queries": corpus_a[:2].tolist()})
    assert code == 200 and doc["shed"] == 0
    assert all(r is not None for r in doc["results"])


def test_http_writes_to_a_mutable_collection(index_b, corpus_b):
    """``/insert`` and ``/delete`` over the port's ``MutableIndex``: the
    inserted vector is found, the deleted one never comes back."""
    with VectorService(device=CPU, batch_size=4, timeout_ms=5.0) as svc:
        svc.create_collection("mut", MutableIndex(index_b), k=3)
        with HttpFrontend(svc, port=0) as fe:
            v = (corpus_b[3] + 0.01).tolist()
            code, doc, _ = _post(fe.url + "/insert", {
                "collection": "mut", "vectors": [v]})
            assert code == 200 and len(doc["ids"]) == 1
            new_id = doc["ids"][0]
            _, doc, _ = _post(fe.url + "/search", {"collection": "mut",
                                                  "query": v})
            assert new_id in doc["results"]["ids"]
            code, doc, _ = _post(fe.url + "/delete", {
                "collection": "mut", "ids": [new_id, 3]})
            assert code == 200 and doc["removed"] == 2
            _, doc, _ = _post(fe.url + "/search", {"collection": "mut",
                                                  "query": v})
            assert not {new_id, 3} & set(doc["results"]["ids"])


def test_token_bucket_refill_and_burst():
    t = [0.0]
    b = TokenBucket(rate=2.0, burst=4.0, clock=lambda: t[0])
    assert [b.try_acquire() for _ in range(5)] == [True] * 4 + [False]
    assert b.retry_after_s() == pytest.approx(0.5)
    t[0] += 1.0
    assert b.try_acquire() and b.try_acquire() and not b.try_acquire()
    t[0] += 100.0
    assert [b.try_acquire() for _ in range(5)] == [True] * 4 + [False]


def test_token_bucket_validation():
    with pytest.raises(ValueError):
        TokenBucket(rate=0.0, burst=1.0)
    with pytest.raises(ValueError):
        TokenBucket(rate=1.0, burst=0.0)


# ========================================================== semantic cache
def _vec(*xs):
    return np.asarray(xs, np.float32)


def _rot(deg):
    r = np.deg2rad(deg)
    return _vec(np.cos(r), np.sin(r))


def test_constructor_validation():
    with pytest.raises(ValueError, match="cosine"):
        SemanticCache(threshold=1.5)
    with pytest.raises(ValueError, match="capacity"):
        SemanticCache(capacity=0)
    with pytest.raises(ValueError, match="ttl"):
        SemanticCache(ttl=0)


def test_threshold_hit_and_miss():
    c = SemanticCache(threshold=np.cos(np.deg2rad(10)))
    c.put("s", _rot(0), "answer")
    assert c.get("s", _rot(5)) == "answer"
    assert c.get("s", _rot(45)) is None
    assert c.get("s", 100.0 * _rot(5)) == "answer"
    s = c.stats()
    assert (s.hits, s.misses, s.entries) == (2, 1, 1)


def test_best_match_wins_not_first():
    c = SemanticCache(threshold=0.9)
    c.put("s", _rot(0), "a")
    c.put("s", _rot(20), "b")
    assert c.get("s", _rot(19)) == "b"


def test_scope_isolation():
    c = SemanticCache(threshold=0.9)
    c.put(("docs", 10, None, None), _rot(0), "ten")
    assert c.get(("docs", 5, None, None), _rot(0)) is None
    assert c.get(("docs", 10, None, None), _rot(0)) == "ten"


def test_lru_eviction_and_hit_refresh():
    c = SemanticCache(threshold=0.99, capacity=2)
    c.put("a", _rot(0), "A")
    c.put("b", _rot(90), "B")
    assert c.get("a", _rot(0)) == "A"
    c.put("c", _rot(180), "C")
    assert c.get("b", _rot(90)) is None
    assert c.get("a", _rot(0)) == "A"
    assert c.get("c", _rot(180)) == "C"
    assert c.stats().evictions == 1
    assert len(c) == 2


def test_ttl_expiry_with_fake_clock():
    now = [0.0]
    c = SemanticCache(threshold=0.9, ttl=10.0, clock=lambda: now[0])
    c.put("s", _rot(0), "fresh")
    now[0] = 9.0
    assert c.get("s", _rot(0)) == "fresh"
    now[0] = 11.0
    assert c.get("s", _rot(0)) is None
    s = c.stats()
    assert s.evictions == 1 and s.entries == 0


def test_invalidate_predicate_and_all():
    c = SemanticCache(threshold=0.9)
    c.put(("docs", 1), _rot(0), "d")
    c.put(("docs", 2), _rot(0), "d2")
    c.put(("wiki", 1), _rot(0), "w")
    assert c.invalidate(lambda s: s[0] == "docs") == 2
    assert c.get(("wiki", 1), _rot(0)) == "w"
    assert c.invalidate() == 1
    assert len(c) == 0
    assert c.stats().invalidations == 3


def test_zero_norm_embeddings_bypass():
    c = SemanticCache(threshold=0.9)
    c.put("s", _vec(0.0, 0.0), "never")
    assert len(c) == 0
    assert c.get("s", _vec(0.0, 0.0)) is None
    c.put("s", _vec(np.inf, 1.0), "never")
    assert len(c) == 0


class FakeIndex:
    """Deterministic VectorIndex stand-in: row i's ids encode
    round(q[i, 0]); counts dispatched searches."""

    dim = 4

    def __init__(self):
        self.searches = 0
        self.next_id = 100

    def search(self, queries, k=None, params=None, *, filter=None,
               filter_params=None):
        self.searches += 1
        q = np.asarray(queries)
        b, kk = q.shape[0], k or 3
        tag = np.round(q[:, :1]).astype(np.int64)
        z = np.zeros((b,), np.int32)
        return SearchResult(ids=tag + np.arange(kk)[None],
                            dists=np.zeros((b, kk), np.float32),
                            ios=z, hops=z, cache_hits=z)

    def insert(self, vectors, ids=None, *, metadata=None):
        n = len(np.asarray(vectors))
        out = np.arange(self.next_id, self.next_id + n)
        self.next_id += n
        return out

    def delete(self, ids):
        return len(np.asarray(ids).reshape(-1))

    def compact(self):
        return True


def _query(tag):
    v = np.zeros(4, np.float32)
    v[0] = tag
    v[1] = 1.0
    return v


def test_service_serves_repeats_from_cache():
    idx = FakeIndex()
    with VectorService(device=CPU, batch_size=4,
                       semantic_cache=SemanticCache(threshold=0.999)) as svc:
        svc.create_collection("docs", idx, k=3)
        first = svc.submit("docs", _query(7))
        svc.flush()
        r1 = first.result()
        assert not r1.cached
        dispatched = idx.searches
        r2 = svc.submit("docs", _query(7)).result()
        assert r2.cached and r2.batch_index == -1
        assert idx.searches == dispatched
        np.testing.assert_array_equal(r1.result.ids, r2.result.ids)
        m = svc.metrics()
        assert m.semantic_hits == 1 and m.semantic_misses == 1


def test_cache_scopes_split_by_k_and_filter():
    with VectorService(device=CPU, batch_size=4,
                       semantic_cache=SemanticCache(threshold=0.999)) as svc:
        svc.create_collection("docs", FakeIndex(), k=3)
        svc.submit("docs", _query(1), k=3)
        svc.flush()
        fut = svc.submit("docs", _query(1), k=2)
        svc.flush()
        assert not fut.result().cached


def test_writes_invalidate_cached_answers():
    idx = FakeIndex()
    with VectorService(device=CPU, batch_size=4,
                       semantic_cache=SemanticCache(threshold=0.999)) as svc:
        svc.create_collection("docs", idx, k=3)
        svc.submit("docs", _query(5))
        svc.flush()
        assert svc.submit("docs", _query(5)).result().cached
        svc.insert("docs", np.ones((1, 4), np.float32))
        fut = svc.submit("docs", _query(5))
        svc.flush()
        assert not fut.result().cached
        assert svc.metrics().semantic_invalidations >= 1
        assert svc.submit("docs", _query(5)).result().cached
        svc.delete("docs", [100])
        fut = svc.submit("docs", _query(5))
        svc.flush()
        assert not fut.result().cached
        assert svc.submit("docs", _query(5)).result().cached
        assert svc.compact("docs")
        fut = svc.submit("docs", _query(5))
        svc.flush()
        assert not fut.result().cached


def test_in_flight_miss_does_not_cache_across_a_write():
    idx = FakeIndex()
    cache = SemanticCache(threshold=0.999)
    with VectorService(device=CPU, batch_size=64, semantic_cache=cache) as svc:
        svc.create_collection("docs", idx, k=3)
        fut = svc.submit("docs", _query(9))
        svc.insert("docs", np.ones((1, 4), np.float32))
        svc.flush()
        fut.result()
        assert len(cache) == 0
        replay = svc.submit("docs", _query(9))
        svc.flush()
        assert not replay.result().cached


def test_no_cache_service_unchanged():
    idx = FakeIndex()
    with VectorService(device=CPU, batch_size=4) as svc:
        svc.create_collection("docs", idx, k=3)
        svc.submit("docs", _query(2))
        svc.flush()
        fut = svc.submit("docs", _query(2))
        svc.flush()
        assert not fut.result().cached
        m = svc.metrics()
        assert m.semantic_hits == 0 and m.semantic_misses == 0


def test_cache_hits_equal_the_real_index_answer(index_a, queries):
    """Over a real port index: a repeated query is served from the cache
    with exactly the engine's first answer."""
    with VectorService(device=CPU, batch_size=4,
                       semantic_cache=SemanticCache(threshold=0.999)) as svc:
        svc.create_collection("a", index_a, k=5)
        first = svc.search("a", queries)
        again = svc.search("a", queries)
    assert not any(r.cached for r in first) and all(r.cached for r in again)
    np.testing.assert_array_equal(_ids(again), _ids(first))
    np.testing.assert_array_equal(_ids(first), index_a.search(queries, k=5).ids)


def test_serve_package_exports_the_reference_names():
    import repro.serve as jserve
    import repro_torch.serve as tserve

    assert sorted(tserve.__all__) == sorted(jserve.__all__)
    from repro.serve.engine import EngineMetrics as JMetrics
    from repro_torch.serve.engine import EngineMetrics

    assert EngineMetrics._fields == JMetrics._fields
