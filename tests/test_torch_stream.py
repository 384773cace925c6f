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


def test_fetcher_lru_eviction_and_counters_match_the_reference():
    """A 1-page staging cache changes only the hit/miss split, never the
    records; both packages count the same hits and misses."""
    rng = np.random.default_rng(0)
    recs = rng.standard_normal((6, 2, 8)).astype(np.float32)
    for stage in (1, 3, tstream.DEFAULT_STAGE_PAGES):
        t, j = PageFetcher(recs, stage_pages=stage), jstream.PageFetcher(recs, stage_pages=stage)
        for _ in range(20):
            ids = rng.integers(-1, 6, size=rng.integers(0, 5))
            np.testing.assert_array_equal(t(ids), j(ids))
            for key in ("pages_fetched", "fetch_hits"):
                assert t.fetch_stats()[key] == j.fetch_stats()[key]
    f = PageFetcher(recs, stage_pages=1)
    for pid in rng.integers(0, 6, size=64):
        np.testing.assert_array_equal(f(np.array([pid]))[0], recs[pid])
    fs = f.fetch_stats()
    assert fs["pages_fetched"] + fs["fetch_hits"] == 64
    assert fs["pages_fetched"] >= 6                   # capacity-1 thrashing
    assert len(fs["wall_window"]) == 64 and fs["fetch_wall_s"] >= 0.0
    f.reset_stats()
    assert f.fetch_stats() == dict(
        pages_fetched=0, fetch_hits=0, fetch_wall_s=0.0, wall_window=())


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

