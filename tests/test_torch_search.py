"""The port's query path (repro_torch.core.search) against the JAX package's.

An index is built and saved by the JAX package in each MemoryMode; the port
loads the artifact (``load_pageann(device="cpu")``) and both search the same
queries. Integer outputs must be equal and distances ``allclose``
(rtol = atol = 1e-5), except for queries whose LSH code differs between
the frameworks: a projection within rounding of zero can flip a sign bit
and change the entry set. Those queries are reported by index and exempt.
"""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MemoryMode as JMode
from repro.core import PageANNConfig as JConfig
from repro.core import PageANNIndex as JIndex
from repro.core import SearchParams as JParams
from repro.core import load_index as jax_load_index
from repro.core import lsh as jlsh
from repro.core import search as jsearch
from repro.data.pipeline import clustered_vectors, query_vectors
from repro_torch.core import (
    IndexFormatError,
    MemoryMode,
    PageANNIndex,
    SearchParams,
    Tag,
    index_from_arrays,
    load_pageann,
    persist,
)
from repro_torch.core import lsh as tlsh
from repro_torch.core import search as tsearch

# six test workers share the host's cores; the port's small tensors gain
# nothing from more intra-op threads than one
torch.set_num_threads(1)

N, D, Q = 1500, 32, 40
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(**kw):
    base = dict(
        dim=D, graph_degree=16, build_beam=32, pq_subspaces=8,
        lsh_sample=512, lsh_entries=8, beam_width=64, max_hops=48,
        memory_mode=JMode.HYBRID,
    )
    base.update(kw)
    return JConfig(**base)


@pytest.fixture(scope="module")
def dataset():
    x = clustered_vectors(N, D, num_clusters=32, seed=0)
    q = query_vectors(x, Q, seed=1)
    return x, q


@pytest.fixture(scope="module", params=list(JMode), ids=lambda m: m.value)
def saved(request, dataset, tmp_path_factory):
    """(JAX index, its artifact directory). HYBRID also warms a page cache,
    so the cached-page path and its counters are compared too."""
    x, q = dataset
    mode = request.param
    if mode == JMode.HYBRID:
        index = JIndex.build(x, _cfg(cache_pages=8), warmup_queries=q[:20])
    else:
        index = JIndex.build(x, _cfg(memory_mode=mode))
    directory = str(tmp_path_factory.mktemp(f"jax_{mode.value}"))
    index.save(directory)
    return index, directory


def _sign_flips(jindex, q) -> np.ndarray:
    """Queries whose packed LSH code differs between the two packages."""
    planes = np.array(jindex.lsh.planes)
    want = np.asarray(jlsh.hash_codes(jnp.asarray(q), jnp.asarray(planes)))
    got = tlsh.hash_codes(torch.as_tensor(q), torch.as_tensor(planes)).numpy()
    return np.nonzero((got.view(np.uint32) != want).any(1))[0]


def _assert_same_results(rj, rt, exempt=()):
    keep = np.setdiff1d(np.arange(len(rj.ids)), exempt)
    for field in ("ids", "ios", "hops", "cache_hits"):
        np.testing.assert_array_equal(
            np.asarray(getattr(rt, field))[keep],
            np.asarray(getattr(rj, field))[keep], err_msg=field)
    np.testing.assert_allclose(np.asarray(rt.dists)[keep],
                               np.asarray(rj.dists)[keep], **TOL)


def test_jax_built_index_searches_identically(saved, dataset, record_property):
    jindex, directory = saved
    _, q = dataset
    tindex = load_pageann(directory, device="cpu")
    flips = _sign_flips(jindex, q)
    record_property("sign_flip_queries", flips.tolist())
    print(f"{jindex.cfg.memory_mode.value}: sign-flip queries {flips.tolist()}")
    assert len(flips) <= 2
    rj = jindex.search(q, k=10)
    rt = tindex.search(q, k=10)
    _assert_same_results(rj, rt, flips)
    if jindex.cfg.cache_pages:
        assert np.asarray(rt.cache_hits).sum() > 0
    # a second operating point over the same loaded index
    p = dict(k=5, beam_width=32, io_batch=3, max_hops=6, lsh_entries=4)
    _assert_same_results(jindex.search(q, params=JParams(**p)),
                         tindex.search(q, params=SearchParams(**p)), flips)


def test_index_from_arrays_matches_load(saved, dataset):
    jindex, directory = saved
    _, q = dataset
    loaded = load_pageann(directory, device="cpu")
    doc = persist.read_manifest(directory)
    with np.load(os.path.join(directory, persist.ARRAYS_NPZ)) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["recs"] = np.fromfile(
        os.path.join(directory, persist.PAGES_BIN), np.float32
    ).reshape(doc["pages"], doc["record_rows"], doc["record_lanes"])
    built = index_from_arrays(persist.config_from_json(doc["config"]), arrays, "cpu")
    a, b = loaded.search(q, k=10), built.search(q, k=10)
    for field in a._fields:
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    np.testing.assert_array_equal(
        built.lsh.sample_codes.numpy().view(np.uint32),
        np.asarray(jindex.lsh.sample_codes))


def test_port_saved_artifact_reloads_in_both_packages(saved, dataset, tmp_path):
    jindex, directory = saved
    _, q = dataset
    tindex = load_pageann(directory, device="cpu")
    out = str(tmp_path / "port")
    tindex.save(out)
    assert open(os.path.join(out, persist.PAGES_BIN), "rb").read() == \
        open(os.path.join(directory, persist.PAGES_BIN), "rb").read()
    again = load_pageann(out, device="cpu")
    back = jax_load_index(out)
    rt, ra, rj = tindex.search(q, k=10), again.search(q, k=10), back.search(q, k=10)
    np.testing.assert_array_equal(ra.ids, rt.ids)
    np.testing.assert_array_equal(np.asarray(rj.ids), np.asarray(jindex.search(q, k=10).ids))
    assert again.stats.pages == jindex.stats.pages


# ------------------------------------------------------------ transitions
def _random_states(rng, nq, beam, pages, cap, k=4):
    ids = rng.integers(0, pages * cap, (nq, beam)).astype(np.int32)
    d = rng.integers(0, 6, (nq, beam)).astype(np.float32)   # many ties
    ids[rng.random((nq, beam)) < 0.2] = -1
    d[ids < 0] = np.inf
    d[rng.random((nq, beam)) < 0.1] = np.inf
    vis = rng.random((nq, beam)) < 0.3
    pvis = rng.random((nq, pages)) < 0.3
    # lanes with fewer schedulable pages than io_batch: the slot-0 quirk
    ids[0, 2:] = -1
    d[0, 2:] = np.inf
    vis[0, :] = False
    d[1, :] = np.inf
    return ids, d, vis, pvis


@pytest.mark.parametrize("io_batch,beam,pages", [
    (1, 16, 7), (3, 16, 7), (5, 16, 7),
    (5, 1024, 300),    # a filtered search's widened beam
], ids=["1", "3", "5", "5-beam1024"])
def test_select_batch_matches_jax_including_slot0_quirk(io_batch, beam, pages):
    rng = np.random.default_rng(io_batch)
    nq, cap = 12, 3
    ids, d, vis, pvis = _random_states(rng, nq, beam, pages, cap)
    zeros = np.zeros(nq, np.int32)
    tstate = tsearch.BeamState(
        torch.as_tensor(ids), torch.as_tensor(d), torch.as_tensor(vis),
        torch.as_tensor(pvis), torch.full((nq, 4), -1, dtype=torch.int32),
        torch.full((nq, 4), float("inf")), *(torch.as_tensor(zeros) for _ in range(3)))
    tnew, tbatch = tsearch.select_batch(tstate, capacity=cap, io_batch=io_batch)
    quirk = 0
    for i in range(nq):
        js = jsearch.BeamState(
            jnp.asarray(ids[i]), jnp.asarray(d[i]), jnp.asarray(vis[i]),
            jnp.asarray(pvis[i]), jnp.full((4,), -1, jnp.int32),
            jnp.full((4,), jnp.inf), jnp.int32(0), jnp.int32(0), jnp.int32(0))
        jnew, jbatch = jsearch.select_batch(js, capacity=cap, io_batch=io_batch)
        np.testing.assert_array_equal(tbatch[i].numpy(), np.asarray(jbatch))
        np.testing.assert_array_equal(tnew.cand_vis[i].numpy(), np.asarray(jnew.cand_vis))
        np.testing.assert_array_equal(tnew.page_vis[i].numpy(), np.asarray(jnew.page_vis))
        quirk += int((np.asarray(jbatch) < 0).any())
    assert quirk >= 1           # a quirk lane really was exercised
    # the input state is not modified
    np.testing.assert_array_equal(tstate.cand_vis.numpy(), vis)
    np.testing.assert_array_equal(tstate.page_vis.numpy(), pvis)


def test_top_k_and_dedup_break_ties_like_lax():
    rng = np.random.default_rng(7)
    d = rng.integers(0, 4, (6, 50)).astype(np.float32)
    d[rng.random((6, 50)) < 0.3] = np.inf
    ids = rng.integers(-1, 10, (6, 50)).astype(np.int32)
    vals, idx = tsearch._top_k_merge(torch.as_tensor(d), 20)
    masked = tsearch._mask_dups_keep_first(torch.as_tensor(ids), torch.as_tensor(d))
    for i in range(6):
        jv, ji = jsearch._top_k_merge(jnp.asarray(d[i]), 20)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals[i].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(
            masked[i].numpy(),
            np.asarray(jsearch._mask_dups_keep_first(jnp.asarray(ids[i]), jnp.asarray(d[i]))))


def test_frozen_lanes_do_not_change(saved, dataset):
    """A lane whose loop condition is false keeps its state, as under
    vmap: searching a query alone or inside a batch gives the same result."""
    _, directory = saved
    _, q = dataset
    tindex = load_pageann(directory, device="cpu")
    batch = tindex.search(q, k=10)
    for i in (0, 7, Q - 1):
        one = tindex.search(q[i:i + 1], k=10)
        for field in batch._fields:
            np.testing.assert_array_equal(getattr(one, field)[0], getattr(batch, field)[i])


# ------------------------------------------------------------ refusals
def test_filters_and_budgets_refuse_what_the_reference_refuses(saved, dataset, tmp_path):
    """Filtered search needs a schema, and a manifest that declares one
    needs its metadata sidecar; a memory budget loads a streamed index."""
    _, directory = saved
    _, q = dataset
    tindex = load_pageann(directory, device="cpu")
    with pytest.raises(ValueError, match="no MetadataSchema"):
        tindex.search(q, filter=Tag("lang") == "en")
    assert load_pageann(directory, device="cpu", memory_budget=0.5).fetcher is not None
    copy = str(tmp_path / "schema")
    shutil.copytree(directory, copy)
    doc = json.load(open(os.path.join(copy, persist.MANIFEST)))
    doc["schema"] = {"tags": [], "numerics": []}
    json.dump(doc, open(os.path.join(copy, persist.MANIFEST), "w"))
    with pytest.raises(IndexFormatError, match="sidecar is missing"):
        load_pageann(copy, device="cpu")


def test_unreadable_artifacts_raise_index_format_error(saved, tmp_path):
    _, directory = saved
    trunc = str(tmp_path / "trunc")
    shutil.copytree(directory, trunc)
    path = os.path.join(trunc, persist.PAGES_BIN)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 4096)
    with pytest.raises(IndexFormatError, match="truncated"):
        load_pageann(trunc, device="cpu")
    ahead = str(tmp_path / "ahead")
    shutil.copytree(directory, ahead)
    doc = json.load(open(os.path.join(ahead, persist.MANIFEST)))
    doc["version"] = persist.VERSION + 1
    json.dump(doc, open(os.path.join(ahead, persist.MANIFEST), "w"))
    with pytest.raises(IndexFormatError, match="newer"):
        load_pageann(ahead, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_pageann(directory)          # the default device is the GPU


def test_port_build_searches_in_every_mode(dataset):
    """The port's own build -> search -> recall in each MemoryMode."""
    from repro.core.vamana import brute_force_knn

    from repro_torch.core import PageANNConfig, recall_at_k

    x, q = dataset
    x, q = x[:800], q[:20]
    truth = brute_force_knn(x, q, 10)
    for mode in MemoryMode:
        cfg = PageANNConfig(dim=D, graph_degree=12, build_beam=24,
                            build_rounds=1, pq_subspaces=8, lsh_sample=256,
                            lsh_entries=8, beam_width=48, max_hops=32,
                            memory_mode=mode)
        index = PageANNIndex.build(x, cfg, device="cpu")
        res = index.search(q, k=10)
        assert recall_at_k(res.ids, truth) >= 0.9, mode
        assert (res.ios <= res.hops * cfg.io_batch).all()
        assert (res.ios + res.cache_hits >= res.hops).all()

