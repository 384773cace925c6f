"""The port's streamed page tier against the JAX package's.

A JAX-built artifact (``torch_jax_artifacts``) is loaded by both packages
under a memory budget: the same pages must be pinned, and the streamed
search must give the reference's ids, ios, hops and cache hits (distances
within rtol = atol = 1e-5). Within the port, the streamed search must equal
the fully resident one bit for bit. The fetcher's counters are compared
only within the port: a finished query is frozen in the port and fetches
nothing, where the reference's vmapped loop keeps fetching for it.
"""
import json
import os
import shutil
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MemoryBudget as JBudget
from repro.core import load_index as jax_load_index
from repro.core import lsh as jlsh
from repro.core import stream as jstream
from repro_torch.core import (
    MemoryBudget,
    MemoryMode,
    PageFetcher,
    SearchParams,
    load_pageann,
)
from repro_torch.core import lsh as tlsh
from repro_torch.core import persist
from repro_torch.core import stream as tstream
from repro_torch.kernels import _build
from repro_torch.obs import Tracer
from torch_jax_artifacts import dataset, metadata_artifact

# six test workers share the host's cores; the port's small searches gain
# nothing from more intra-op threads than one
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("ids", "dists", "ios", "hops", "cache_hits")


@pytest.fixture(scope="module", params=[m.value for m in MemoryMode])
def artifact(request):
    return metadata_artifact(request.param)


def _sign_flips(jindex, q) -> np.ndarray:
    """Queries whose packed LSH code differs between the two packages (a
    projection within rounding of zero): their entry sets may differ."""
    planes = np.array(jindex.lsh.planes)
    want = np.asarray(jlsh.hash_codes(jnp.asarray(q), jnp.asarray(planes)))
    got = tlsh.hash_codes(torch.as_tensor(q), torch.as_tensor(planes)).numpy()
    return np.nonzero((got.view(np.uint32) != want).any(1))[0]


# ------------------------------------------------------------ PageFetcher
def test_fetcher_pad_and_shapes():
    recs = np.arange(4 * 2 * 8, dtype=np.float32).reshape(4, 2, 8)
    f = PageFetcher(recs)
    out = f(np.array([[2, tstream.PAD], [0, 3]]))
    assert out.shape == (2, 2, 2, 8)
    np.testing.assert_array_equal(out[0, 0], recs[2])
    np.testing.assert_array_equal(out[0, 1], np.zeros((2, 8), np.float32))
    np.testing.assert_array_equal(out[1, 0], recs[0])
    # into a caller's buffer: the first ids.size records, PAD rows zeroed
    buf = np.full((5, 2, 8), 7.0, np.float32)
    got = f(np.array([3, tstream.PAD, 1]), out=buf)
    assert got.shape == (3, 2, 8) and np.shares_memory(got, buf)
    np.testing.assert_array_equal(buf[:3], np.stack([recs[3], 0 * recs[0], recs[1]]))
    np.testing.assert_array_equal(buf[3:], 7.0)
    with pytest.raises(ValueError, match="rows"):
        PageFetcher(np.zeros((4, 8), np.float32))
    with pytest.raises(ValueError, match="stage_pages"):
        PageFetcher(recs, stage_pages=0)


@pytest.mark.parametrize("impl", ["plain", None], ids=["plain", "native"])
def test_fetcher_lru_eviction_and_counters_match_the_reference(impl):
    """A 1-page staging cache changes only the hit/miss split, never the
    records; both packages count the same hits and misses, through the
    plain loop and through the compiled routine."""
    rng = np.random.default_rng(0)
    recs = rng.standard_normal((6, 2, 8)).astype(np.float32)
    for stage in (1, 3, tstream.DEFAULT_STAGE_PAGES):
        t, j = PageFetcher(recs, stage_pages=stage), jstream.PageFetcher(recs, stage_pages=stage)
        for _ in range(20):
            ids = rng.integers(-1, 6, size=rng.integers(0, 5))
            np.testing.assert_array_equal(t(ids, impl=impl), j(ids))
            for key in ("pages_fetched", "fetch_hits"):
                assert t.fetch_stats()[key] == j.fetch_stats()[key]
    f = PageFetcher(recs, stage_pages=1)
    for pid in rng.integers(0, 6, size=64):
        np.testing.assert_array_equal(f(np.array([pid]), impl=impl)[0], recs[pid])
    fs = f.fetch_stats()
    assert fs["pages_fetched"] + fs["fetch_hits"] == 64
    assert fs["pages_fetched"] >= 6                   # capacity-1 thrashing
    assert len(fs["wall_window"]) == 64 and fs["fetch_wall_s"] >= 0.0
    f.reset_stats()
    assert f.fetch_stats() == dict(
        pages_fetched=0, fetch_hits=0, fetch_wall_s=0.0, wall_window=())


def _native_or_skip():
    if _build.host_library() is None:
        pytest.skip("no C++ compiler on this host: the fetcher reads through "
                    "its plain loop only")


def _pair(recs, stage):
    """A fetcher on each path over the same records."""
    _native_or_skip()
    return tuple(PageFetcher(recs, stage_pages=stage) for _ in range(2))


def _counts(f):
    fs = f.fetch_stats()
    return fs["pages_fetched"], fs["fetch_hits"]


def test_the_compiled_fetch_is_loaded_where_a_compiler_is():
    """On a host with a C++ compiler the routine is built and loaded, and
    every read of a float32 page file goes through it; the span says so."""
    if not any(shutil.which(name) for name in _build.CXX_NAMES):
        pytest.skip("no C++ compiler on this host")
    assert _build.host_library() is not None
    assert _build.host_library_path().exists()
    recs = np.arange(4 * 2 * 8, dtype=np.float32).reshape(4, 2, 8)
    f = PageFetcher(recs)
    tr = Tracer()
    f.tracer = tr
    f(np.array([1, tstream.PAD]))
    f.read(np.array([2]), out=np.empty((3, 2, 8), np.float32))
    wide = np.empty((1, 2, 8), np.float64)    # through a float32 buffer
    np.testing.assert_array_equal(f(np.array([3]), out=wide), recs[3:4])
    assert [s.args["native"] for s in tr.spans()] == [1, 1, 1]
    assert [s.args["requested"] for s in tr.spans()] == [1, 1, 1]


@pytest.mark.parametrize("stage", [1, 3, 7, tstream.DEFAULT_STAGE_PAGES])
def test_the_compiled_fetch_equals_the_plain_loop(stage):
    """Records bit for bit and counters equal, call after call, on one
    staging cache each: PAD ids, leading batch axes, duplicates within a
    call, more distinct pages in one call than the cache holds, fresh
    arrays and a caller's buffer whose rows past the call stay as they
    were."""
    rng = np.random.default_rng(stage)
    recs = rng.standard_normal((40, 3, 16)).astype(np.float32)
    native, plain = _pair(recs, stage)
    shapes = [(0,), (5,), (2, 7), (3, 2, 4), (60,), (1, 90)]
    for i in range(60):
        shape = shapes[i % len(shapes)]
        ids = rng.integers(-1, 40, size=shape)
        if ids.size > 2:
            ids.flat[1] = ids.flat[0]            # a duplicate in one call
        if i % 2:
            got, got_m = native.read(ids)
            want, want_m = plain.read(ids, impl="plain")
        else:
            bufs = [np.full((ids.size + 3, 3, 16), 9.0, np.float32)
                    for _ in range(2)]
            got, got_m = native.read(ids, out=bufs[0])
            want, want_m = plain.read(ids, out=bufs[1], impl="plain")
            assert np.shares_memory(got, bufs[0]) or not ids.size
            np.testing.assert_array_equal(bufs[0][ids.size:], 9.0)
            np.testing.assert_array_equal(bufs[0], bufs[1])
        assert got.shape == want.shape == ids.shape + (3, 16)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert got_m == want_m and _counts(native) == _counts(plain)
    assert native._path == "native" and plain._path == "plain"


def test_the_compiled_fetch_takes_concurrent_readers():
    """Readers in several threads share one staging cache: every record
    is right and every request is counted once, as a hit or a miss."""
    _native_or_skip()
    rng = np.random.default_rng(5)
    recs = rng.standard_normal((64, 2, 8)).astype(np.float32)
    f = PageFetcher(recs, stage_pages=8)
    batches = [rng.integers(-1, 64, size=50) for _ in range(6 * 40)]
    bad = []

    def worker(part):
        for ids in part:
            got = f(ids)
            want = np.where((ids >= 0)[:, None, None], recs[ids], 0.0)
            if not np.array_equal(got, want):
                bad.append(ids)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(batches[k::6],))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    misses, hits = _counts(f)
    asked = np.concatenate(batches)
    assert misses + hits == int((asked >= 0).sum())
    assert misses >= len(np.unique(asked[asked >= 0]))
    assert len(f.fetch_stats()["wall_window"]) == len(batches)


def test_the_fetch_paths_refuse_what_they_cannot_take(monkeypatch):
    """Bad ``impl``, ids past the file, and a switch of path on one fetcher
    raise; float64 records, and a host with no compiler, take the plain
    loop."""
    _native_or_skip()
    recs = np.arange(4 * 2 * 8, dtype=np.float32).reshape(4, 2, 8)
    f = PageFetcher(recs)
    with pytest.raises(ValueError, match="impl"):
        f(np.array([1]), impl="kernel")
    with pytest.raises(IndexError, match="out of bounds"):
        f(np.array([1, 4]))
    assert _counts(f) == (0, 0)
    f(np.array([1]))
    with pytest.raises(ValueError, match="native"):   # one cache a fetcher
        f(np.array([1]), impl="plain")
    wide = PageFetcher(recs.astype(np.float64))
    assert wide._lib is None
    np.testing.assert_array_equal(wide(np.array([3, -1])),
                                  np.stack([recs[3], 0 * recs[0]]))
    monkeypatch.setattr(_build, "host_library", lambda: None)
    g = PageFetcher(recs)
    tr = Tracer()
    g.tracer = tr
    np.testing.assert_array_equal(g(np.array([2])), recs[2:3])
    assert g._lib is None and tr.spans()[0].args["native"] == 0


# ----------------------------------------------------------- MemoryBudget
@pytest.mark.parametrize("budget", ["fraction", "bytes", "one_page"])
def test_budgeted_load_pins_the_reference_pages(artifact, budget):
    """``one_page``: one byte, ``MemoryBudget(bytes=1)``, resolves to the
    floor of one resident page in both packages."""
    _, directory = artifact
    doc = persist.read_manifest(directory)
    pages = doc["pages"]
    spec = {"fraction": 0.25,
            "bytes": int(pages * 0.3) * doc["page_record_bytes"] + 17,
            "one_page": 1}[budget]
    tindex = load_pageann(directory, device="cpu", memory_budget=spec)
    jindex = jax_load_index(directory, memory_budget=JBudget.parse(spec))
    np.testing.assert_array_equal(tindex.store.resident_map.numpy(),
                                  np.asarray(jindex.store.resident_map))
    np.testing.assert_array_equal(tindex.store.recs.numpy(),
                                  np.asarray(jindex.store.recs))
    assert tindex.memory_budget == MemoryBudget.parse(spec)
    assert tindex.stats.resident_pages == jindex.stats.resident_pages < pages
    if budget == "one_page":
        assert tindex.stats.resident_pages == 1
    assert tindex.stats.resident_bytes == jindex.stats.resident_bytes
    assert isinstance(tindex.fetcher, PageFetcher)
    # a budget that covers every page loads fully resident, with no fetcher
    whole = load_pageann(directory, device="cpu", memory_budget=1.0)
    assert whole.fetcher is None and whole.store.resident_map is None
    assert whole.stats.resident_pages == pages


# ------------------------------------------------------------ search
# a quarter of the pages resident, and one resident page (one byte: the
# floor), where nearly every page is read through the fetcher
STREAM_BUDGETS = {"fraction": MemoryBudget(fraction=0.25),
                  "one_page": MemoryBudget(bytes=1)}


@pytest.mark.parametrize("budget", list(STREAM_BUDGETS))
def test_streamed_search_matches_the_reference(artifact, budget,
                                               record_property):
    """ids, ios, hops and cache hits equal the reference's streamed search
    at the same budget, distances within TOL, and every field equals the
    port's resident search."""
    jindex, directory = artifact
    _, q, _ = dataset()
    flips = _sign_flips(jindex, q)
    record_property("sign_flip_queries", flips.tolist())
    assert len(flips) <= 1
    keep = np.setdiff1d(np.arange(len(q)), flips)
    spec = STREAM_BUDGETS[budget]
    rj = jax_load_index(directory, memory_budget=JBudget(
        fraction=spec.fraction, bytes=spec.bytes)).search(q, k=10)
    tindex = load_pageann(directory, device="cpu", memory_budget=spec)
    if budget == "one_page":
        assert tindex.stats.resident_pages == 1
    rt = tindex.search(q, k=10)
    for field in ("ids", "ios", "hops", "cache_hits"):
        np.testing.assert_array_equal(getattr(rt, field)[keep],
                                      np.asarray(getattr(rj, field))[keep],
                                      err_msg=field)
    np.testing.assert_allclose(rt.dists[keep], np.asarray(rj.dists)[keep], **TOL)
    assert tindex.fetch_stats()["pages_fetched"] > 0
    want = load_pageann(directory, device="cpu").search(q, k=10)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(rt, field), getattr(want, field),
                                      err_msg=field)


def test_streamed_search_equals_resident_bit_for_bit(artifact, tmp_path):
    _, directory = artifact
    _, q, _ = dataset()
    resident = load_pageann(directory, device="cpu")
    streamed = load_pageann(directory, device="cpu", memory_budget=0.25)
    assert resident.fetch_stats() == dict(pages_fetched=0, fetch_hits=0,
                                          fetch_wall_s=0.0)
    want, got = resident.search(q, k=10), streamed.search(q, k=10)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                      err_msg=field)
    fs = streamed.fetch_stats()
    assert fs["pages_fetched"] > 0 and len(fs["wall_window"]) > 0
    # a second operating point through the same fetcher and staging buffer
    p = SearchParams(k=5, beam_width=32, io_batch=3, max_hops=6, lsh_entries=4)
    want, got = resident.search(q, params=p), streamed.search(q, params=p)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    # re-saving a streamed index writes the whole page file and its budget
    out = str(tmp_path / "resaved")
    streamed.save(out)
    assert open(os.path.join(out, persist.PAGES_BIN), "rb").read() == \
        open(os.path.join(directory, persist.PAGES_BIN), "rb").read()
    doc = json.load(open(os.path.join(out, persist.MANIFEST)))
    assert doc["residency"] == dict(
        memory_budget=MemoryBudget(fraction=0.25).to_json(),
        resident_pages=streamed.stats.resident_pages,
        total_pages=streamed.stats.pages)
    again = load_pageann(out, device="cpu")
    np.testing.assert_array_equal(again.page_order, streamed.page_order)
    np.testing.assert_array_equal(again.search(q, k=10).ids,
                                  resident.search(q, k=10).ids)

