"""The port's mutable index (repro_torch.core.delta) against the JAX package's.

A JAX-built base (``torch_jax_artifacts.delta_base_artifact``: 800 of 1,000
vectors at d = 32, with a metadata schema, in HYBRID and MEM_ALL) is wrapped
by both packages' ``MutableIndex``; the same inserts, upserts and deletes go
to both, and both search the same queries.

Tolerance. The delta tier scores with the expanded form ``(|q|^2 - 2 q.x) +
|x|^2``, whose rounding error grows with the norms, not with the distance
(ROADMAP C1: a self-match comes out near -4e-6, not 0). Distances are held
to rtol = 1e-5 and atol = 1e-6 * (max|q|^2 + max|x|^2), about 16 float32
ulps of the largest norms; ids must be equal wherever the gap between
neighbouring ranked distances exceeds that atol, and the count of queries
whose ids differ at all is reported and expected to be 0 on these fixtures.
ios, hops and cache hits are integers and must be equal.
"""
import json
import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core import DeltaParams as JDeltaParams
from repro.core import MutableIndex as JMutable
from repro.core import Num as JNum
from repro.core import Tag as JTag
from repro.core import load_index as jax_load_index
from repro.core.delta import DeltaTier as JDeltaTier
from repro.core.delta import scan_delta as jax_scan_delta
from repro.core.search import merge_topk_streams as jax_merge
from repro_torch.core import (
    DeltaParams,
    DeltaTier,
    MemoryMode,
    MutableIndex,
    MutableVectorIndex,
    Num,
    PageANNIndex,
    Tag,
    VectorIndex,
    load_index,
    load_pageann,
    recall_at_k,
)
from repro_torch.core.delta import scan_delta
from repro_torch.core.search import merge_topk_streams
from repro_torch.core.vamana import brute_force_knn
from torch_jax_artifacts import N_BASE, N_DELTA, delta_base_artifact, delta_dataset

# six test workers share the host's cores; the port's small searches gain
# nothing from more intra-op threads than one
torch.set_num_threads(1)

K = 10
PAD = -1
FIELDS = ("ids", "dists", "ios", "hops", "cache_hits")
MODES = [MemoryMode.HYBRID.value, MemoryMode.MEM_ALL.value]
UPSERT_IDS = np.arange(100, 110)


def _upsert_vectors():
    x = delta_dataset()[0]
    rng = np.random.default_rng(5)
    return (x[UPSERT_IDS] + 0.3 * rng.standard_normal(
        (UPSERT_IDS.size, x.shape[1]))).astype(np.float32)


def _atol(*arrays) -> float:
    """1e-6 times the sum of the largest squared norms on each side."""
    return 1e-6 * sum(float((a * a).sum(-1).max()) for a in arrays)


def _cols(rows):
    meta = delta_dataset()[2]
    return {f: [col[i] for i in rows] for f, col in meta.items()}


def _writes(m) -> None:
    """The write sequence both packages get: inserts with metadata (every
    fourth with the unseen tag "es"), base deletes, delta deletes, and ten
    upserts of base ids."""
    x = delta_dataset()[0]
    m.insert(x[N_BASE:950], ids=np.arange(N_BASE, 950),
             metadata=_cols(range(N_BASE, 950)))
    m.delete(np.arange(0, 25))
    m.insert(x[950:], ids=np.arange(950, N_DELTA),
             metadata=_cols(range(950, N_DELTA)))
    m.delete([803, 970])                       # delta rows die too
    m.insert(_upsert_vectors(), ids=UPSERT_IDS,
             metadata={"lang": ["es"] * UPSERT_IDS.size,
                       "score": [0.5] * UPSERT_IDS.size})


def _assert_same(got, want, *, atol: float) -> None:
    """Port result vs reference result under the module's tolerance."""
    ids_t, ids_j = np.asarray(got.ids), np.asarray(want.ids)
    d_t, d_j = np.asarray(got.dists), np.asarray(want.dists)
    assert ids_t.shape == ids_j.shape
    with np.errstate(invalid="ignore"):
        gap = np.diff(d_j, axis=1)
    apart = np.ones(d_j.shape, bool)
    apart[:, 1:] &= gap > atol
    apart[:, :-1] &= gap > atol
    np.testing.assert_array_equal(ids_t[apart], ids_j[apart])
    differ = int((ids_t != ids_j).any(1).sum())
    assert differ == 0, f"ids differ for {differ} of {len(ids_t)} queries"
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=atol)
    for f in ("ios", "hops", "cache_hits"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)


def _assert_equal(got, want) -> None:
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.fixture(scope="module", params=MODES)
def bases(request):
    """(JAX base index, the port's load of its artifact, the directory)."""
    jindex, directory = delta_base_artifact(request.param)
    return jindex, load_pageann(directory, device="cpu"), directory


@pytest.fixture(scope="module")
def hybrid_base():
    jindex, directory = delta_base_artifact(MemoryMode.HYBRID.value)
    return jindex, load_pageann(directory, device="cpu"), directory


def _pair(bases, **kw):
    jindex, tbase, _ = bases
    kw.setdefault("auto_compact", False)
    return JMutable(jindex, **kw), MutableIndex(tbase, **kw)


# -------------------------------------------------------------- delta tier
def test_delta_tier_scan_matches_the_reference_and_brute_force():
    """Growth, upsert and kill on both packages' tiers; the scans agree and
    the port's equals a float64 brute force in order."""
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((37, 32)).astype(np.float32)
    ids = np.arange(100, 137)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    tiers = JDeltaTier(32, capacity=8), DeltaTier(32, capacity=8, device="cpu")
    for tier in tiers:
        tier.insert(vecs, ids)                 # forces a buffer grow
        tier.insert(2 * vecs[:3], ids[:3])     # upserts kill the old rows
        assert tier.kill([104, 999]) == 1      # unknown ids ignored
    for k in (7, 64):                          # 64 > the padded rows
        want_ids, want_d = jax_scan_delta(tiers[0].snapshot(), q, k)
        got_ids, got_d = scan_delta(tiers[1].snapshot(), q, k)
        assert got_ids.shape == np.asarray(want_ids).shape
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_allclose(got_d, want_d, rtol=1e-5,
                                   atol=_atol(q, 2 * vecs))
    live = np.ones(37, bool)
    live[[0, 1, 2, 4]] = False
    rows = np.concatenate([np.flatnonzero(live), [0, 1, 2]])
    all_v = np.concatenate([vecs[live], 2 * vecs[:3]])
    d2 = ((q[:, None, :].astype(np.float64) - all_v[None]) ** 2).sum(-1)
    want = np.argsort(d2, axis=1)[:, :7]
    got_ids, _ = scan_delta(tiers[1].snapshot(), q, 7)
    np.testing.assert_array_equal(got_ids, ids[rows][want])


def test_snapshot_is_isolated_from_later_writes():
    """An old snapshot scans its own contents. The self-match distance is
    held to the expanded form's tolerance, not to 0 (ROADMAP C1)."""
    tier = DeltaTier(32, device="cpu")
    rng = np.random.default_rng(1)
    v1 = rng.standard_normal((4, 32)).astype(np.float32)
    tier.insert(v1, np.arange(4))
    snap = tier.snapshot()
    tier.insert(rng.standard_normal((30, 32)).astype(np.float32),
                np.arange(100, 130))
    tier.kill([0, 1, 2, 3])
    ids, d = scan_delta(snap, v1[:1], 4)
    assert set(ids[0].tolist()) == {0, 1, 2, 3}
    assert ids[0, 0] == 0
    assert abs(float(d[0, 0])) <= _atol(v1, v1)


def test_delta_tier_refuses_bad_ids():
    tier = DeltaTier(32, device="cpu")
    v = np.eye(32, dtype=np.float32)[:2]
    with pytest.raises(ValueError, match="duplicate"):
        tier.insert(v, [8, 8])
    with pytest.raises(ValueError, match="non-negative"):
        tier.insert(v[:1], [-3])
    with pytest.raises(ValueError, match="int32"):
        tier.insert(v[:1], [2**31])


@pytest.mark.parametrize("case", ["interleave", "base_delta_tie", "all_ties"])
def test_merge_topk_streams_breaks_ties_as_the_reference(case):
    """On equal distances the lower column wins: a base hit beats a delta
    hit, and +inf rows keep their order and come out as PAD."""
    inf = np.inf
    ids_a, d_a, ids_b, d_b, k = {
        "interleave": ([[0, 1, PAD]], [[0.1, 0.5, inf]],
                       [[10, 11]], [[0.2, inf]], 4),
        "base_delta_tie": ([[0, 1, 2], [3, 4, PAD]],
                           [[0.1, 0.3, 0.3], [0.2, 0.2, inf]],
                           [[10, 11], [12, 13]], [[0.1, 0.3], [0.2, inf]], 4),
        "all_ties": ([[5, PAD, PAD]], [[inf, inf, inf]],
                     [[7, 8]], [[inf, inf]], 3),
    }[case]
    arrays = [np.asarray(ids_a, np.int32), np.asarray(d_a, np.float32),
              np.asarray(ids_b, np.int32), np.asarray(d_b, np.float32)]
    want_ids, want_d = jax_merge(*arrays, k=k)
    got_ids, got_d = merge_topk_streams(*(torch.as_tensor(a) for a in arrays),
                                        k=k)
    assert got_ids.dtype == torch.int32
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    if case == "interleave":
        np.testing.assert_array_equal(got_ids.numpy(), [[0, 10, 1, PAD]])


# ---------------------------------------------------------- unified search
def test_pure_read_path_is_the_base_search(bases):
    _, q, _ = delta_dataset()
    jm, tm = _pair(bases)
    assert isinstance(tm, MutableVectorIndex) and isinstance(tm, VectorIndex)
    got = tm.search(q, k=K)
    _assert_equal(got, bases[1].search(q, k=K))
    _assert_same(got, jm.search(q, k=K), atol=_atol(q, delta_dataset()[0]))


def test_writes_give_the_reference_results(bases):
    """Inserts, base and delta deletes and upserts: equal ids, ios, hops and
    cache hits, distances within the stated tolerance; no deleted id comes
    back, and every upserted id is found at its new vector."""
    x, q, _ = delta_dataset()
    jm, tm = _pair(bases)
    for m in (jm, tm):
        _writes(m)
    assert tm.stats.tombstones == jm.stats.tombstones
    assert tm.stats.delta_live == jm.stats.delta_live
    assert tm.num_live == jm.num_live
    atol = _atol(q, x, _upsert_vectors())
    got = tm.search(q, k=K)
    _assert_same(got, jm.search(q, k=K), atol=atol)
    _assert_equal(tm.search(q, k=K, impl="plain"), got)
    deleted = np.concatenate([np.arange(25), [803, 970]])
    assert not np.isin(got.ids, deleted).any()
    up = tm.search(_upsert_vectors(), k=1)
    np.testing.assert_array_equal(up.ids[:, 0], UPSERT_IDS)
    assert (np.abs(up.dists[:, 0]) <= atol).all()
    old = tm.search(x[UPSERT_IDS], k=K)        # the ids' old places
    _assert_same(old, jm.search(x[UPSERT_IDS], k=K), atol=atol)


def test_delete_heavy_results_stay_full_and_live(bases):
    _, q, _ = delta_dataset()
    jm, tm = _pair(bases)
    deleted = np.arange(0, 120)                # > one oversample bucket
    assert tm.delete(deleted) == jm.delete(deleted) == 120
    assert tm.delete(deleted) == 0             # idempotent
    res = tm.search(q, k=K)
    assert (res.ids >= 0).all()                # never fewer than k live
    assert not np.isin(res.ids, deleted).any()
    assert np.isfinite(res.dists).all()
    _assert_same(res, jm.search(q, k=K), atol=_atol(q, delta_dataset()[0]))


@pytest.mark.parametrize("name", ["unseen_tag", "tag_and_num", "num"])
def test_filter_applies_to_both_tiers(bases, name):
    """A predicate masks base members in the page scan and delta rows on
    the host; an inserted tag value the base never saw ("es") is
    filterable before any compaction."""
    x, q, meta = delta_dataset()
    expr, jexpr = {
        "unseen_tag": (Tag("lang") == "es", JTag("lang") == "es"),
        "tag_and_num": ((Tag("lang") == "en") & Num("score").le(0.5),
                        (JTag("lang") == "en") & JNum("score").le(0.5)),
        "num": (Num("score").le(0.3), JNum("score").le(0.3)),
    }[name]
    jm, tm = _pair(bases)
    for m in (jm, tm):
        _writes(m)
    assert tm.vocab["lang"][-1] == "es" and tm.vocab == jm.vocab
    got = tm.search(q, k=K, filter=expr)
    _assert_same(got, jm.search(q, k=K, filter=jexpr),
                 atol=_atol(q, x, _upsert_vectors()))
    # every returned id passes: its metadata as last written
    lang, score = list(meta["lang"]), list(meta["score"])
    for i in UPSERT_IDS:
        lang[i], score[i] = "es", 0.5
    ok = {"unseen_tag": lambda i: lang[i] == "es",
          "tag_and_num": lambda i: lang[i] == "en" and score[i] <= 0.5,
          "num": lambda i: score[i] <= 0.3}[name]
    found = got.ids[got.ids >= 0]
    assert found.size and all(ok(int(i)) for i in found)
    if name == "unseen_tag":
        assert (found >= N_BASE).any() and np.isin(found, UPSERT_IDS).any()


# -------------------------------------------------------------- lifecycle
def test_dirty_save_load_crosses_packages(bases, tmp_path):
    """A dirty index saved by either package loads in the other: the port's
    load of the reference's artifact equals the port's own index bit for
    bit, and the reference's load of the port's artifact returns the
    reference's ids."""
    _, q, _ = delta_dataset()
    jm, tm = _pair(bases)
    for m in (jm, tm):
        _writes(m)
    want_t, want_j = tm.search(q, k=K), jm.search(q, k=K)

    tm.save(str(tmp_path / "port.mutable"))
    jm.save(str(tmp_path / "jax.mutable"))
    own = load_index(str(tmp_path / "port.mutable"), device="cpu")
    assert type(own) is MutableIndex and own.generation == 0
    assert own.stats.tombstones == tm.stats.tombstones
    _assert_equal(own.search(q, k=K), want_t)
    from_jax = MutableIndex.load(str(tmp_path / "jax.mutable"), device="cpu")
    _assert_equal(from_jax.search(q, k=K), want_t)
    assert from_jax.vocab == tm.vocab
    from_port = jax_load_index(str(tmp_path / "port.mutable"))
    np.testing.assert_array_equal(np.asarray(from_port.search(q, k=K).ids),
                                  np.asarray(want_j.ids))
    # and the reloaded index keeps taking writes
    own.insert(np.full((1, q.shape[1]), 9.0, np.float32))
    assert own.search(np.full((1, q.shape[1]), 9.0, np.float32), k=1).ids[0, 0] \
        == N_DELTA


def test_budgeted_load_equals_resident(bases, tmp_path):
    _, q, _ = delta_dataset()
    _, tm = _pair(bases)
    _writes(tm)
    tm.save(str(tmp_path / "idx.mutable"))
    resident = MutableIndex.load(str(tmp_path / "idx.mutable"), device="cpu")
    streamed = MutableIndex.load(str(tmp_path / "idx.mutable"), device="cpu",
                                 memory_budget=0.25)
    assert streamed.base.fetcher is not None
    assert streamed.base.stats.resident_pages < streamed.base.stats.pages
    want = resident.search(q, k=K)
    _assert_equal(want, tm.search(q, k=K))
    _assert_equal(streamed.search(q, k=K), want)
    filt = Tag("lang") == "es"
    _assert_equal(streamed.search(q, k=K, filter=filt),
                  resident.search(q, k=K, filter=filt))
    assert streamed.fetch_stats()["pages_fetched"] > 0


def test_load_index_kinds(hybrid_base, tmp_path):
    """``load_index`` opens the ported kinds; the baseline kinds go to the
    baseline loader, which refuses a memory budget (they have no page
    tier), and a PageANN artifact relabelled ``"sharded"`` (no shard count,
    no ``shards.npz``) goes to the sharded store's loader, which fails on it
    as the reference's does."""
    _, tbase, directory = hybrid_base
    assert isinstance(load_index(directory, device="cpu"), PageANNIndex)
    fake = tmp_path / "baseline"
    shutil.copytree(directory, fake)
    for kind, err, match in (
            ("diskann", ValueError, "memory_budget is not supported"),
            ("starling", ValueError, "memory_budget is not supported"),
            ("sharded", None, None)):
        doc = json.loads((fake / "manifest.json").read_text())
        doc["kind"] = kind
        (fake / "manifest.json").write_text(json.dumps(doc))
        if err is None:
            with pytest.raises(Exception) as want:
                jax_load_index(str(fake), memory_budget=0.5)
            err = want.type
        with pytest.raises(err, match=match):
            load_index(str(fake), device="cpu", memory_budget=0.5)
    with pytest.raises(ValueError, match="int32"):
        MutableIndex(tbase, base_ids=np.arange(N_BASE) + 2**31)


# -------------------------------------------------------------- compaction
def test_compact_equals_fresh_build_and_the_reference_recall(hybrid_base,
                                                            tmp_path):
    """An insert past ``compact_fraction`` compacts: the port's rebuilt base
    equals its own fresh build over the merged set (every field), the
    persisted artifact is swapped with its generation bumped, and the
    port's recall is within 0.005 of the reference's compaction."""
    x, q, _ = delta_dataset()
    kw = dict(params=DeltaParams(compact_fraction=0.25), auto_compact=True)
    jkw = dict(params=JDeltaParams(compact_fraction=0.25), auto_compact=True)
    jindex, tbase, _ = hybrid_base
    tm, jm = MutableIndex(tbase, **kw), JMutable(jindex, **jkw)
    art = str(tmp_path / "idx.mutable")
    tm.save(art)
    deleted = np.arange(10, 60)
    for m in (tm, jm):
        m.delete(deleted)
        m.insert(x[N_BASE:950], ids=np.arange(N_BASE, 950))   # 150/750
        assert m.generation == 0
        m.insert(x[950:], ids=np.arange(950, N_DELTA))      # 200/750 > 0.25
        assert m.generation == 1
        assert m.stats.tombstones == 0 and m.stats.delta_live == 0
    assert not tm.compact()                     # nothing left to fold
    with open(os.path.join(art, "manifest.json")) as f:
        doc = json.load(f)
    assert doc["generation"] == 1 and doc["delta_rows"] == 0
    assert not [p for p in os.listdir(tmp_path) if ".tmp" in p or ".old" in p]

    live = np.ones(N_DELTA, bool)
    live[deleted] = False
    rows = np.flatnonzero(live)
    fresh = PageANNIndex.build(x[rows], tbase.cfg, device="cpu")
    want = fresh.search(q, k=K)
    got = tm.search(q, k=K)
    np.testing.assert_array_equal(
        got.ids, np.where(want.ids >= 0, rows[np.maximum(want.ids, 0)], PAD))
    for f in ("dists", "ios", "hops", "cache_hits"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    _assert_equal(MutableIndex.load(art, device="cpu").search(q, k=K), got)
    truth = rows[brute_force_knn(x[rows], q, K)]
    r_port = recall_at_k(got.ids, truth)
    r_jax = recall_at_k(np.asarray(jm.search(q, k=K).ids), truth)
    assert abs(r_port - r_jax) <= 0.005, (r_port, r_jax)


def test_searches_in_threads_across_compaction_all_complete(hybrid_base):
    """Searches running while another thread compacts all complete, and each
    sees one consistent state: ids from the old or the new generation."""
    x, _, _ = delta_dataset()
    _, tbase, _ = hybrid_base
    m = MutableIndex(tbase, auto_compact=False)
    m.insert(x[N_BASE:], ids=np.arange(N_BASE, N_DELTA))
    errors, results = [], []
    stop = threading.Event()

    def searcher(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            rows = x[rng.integers(0, N_DELTA, 2)]
            try:
                results.append(m.search(rows, k=5).ids)
            except Exception as e:      # noqa: BLE001 — collected for assert
                errors.append(e)

    threads = [threading.Thread(target=searcher, args=(s,)) for s in range(2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)                # more interleavings
    for t in threads:
        t.start()
    try:
        for gen in (1, 2):
            m.insert(np.full((2, x.shape[1]), 50.0 + gen, np.float32),
                     ids=np.array([5000 + 2 * gen, 5001 + 2 * gen]))
            assert m.compact()
            assert m.generation == gen
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert results
    universe = set(range(N_DELTA)) | {5002, 5003, 5004, 5005}
    for ids in results:
        for row in ids:
            found = row[row >= 0].tolist()
            assert set(found) <= universe
            assert len(set(found)) == len(found)
