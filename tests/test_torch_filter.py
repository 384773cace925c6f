"""The port's filtered search against the JAX package's.

A JAX index built with a metadata schema in each MemoryMode
(``torch_jax_artifacts``) is saved and loaded by the port, and both search
the same queries under the same predicates: ids, ios and hops must be equal
(distances within rtol = atol = 1e-5), and every returned id must pass the
predicate. Within the port, the reference's invariants hold bit for bit:
``filter=None`` on a metadata build equals a metadata-free build, and a
streamed filtered search equals the resident one.
"""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MemoryMode as JMode
from repro.core import MetadataSchema as JSchema
from repro.core import Num as JNum
from repro.core import PageANNConfig as JConfig
from repro.core import PageANNIndex as JIndex
from repro.core import SearchParams as JParams
from repro.core import Tag as JTag
from repro.core import filter as jfilter
from repro.core import load_index as jax_load_index
from repro.core import lsh as jlsh
from repro_torch.core import (
    FilterExpr,
    IndexFormatError,
    MemoryMode,
    MetadataSchema,
    Num,
    PageANNConfig,
    PageANNIndex,
    Tag,
    load_pageann,
    persist,
)
from repro_torch.core import filter as tfilter
from repro_torch.core import lsh as tlsh
from repro_torch.data.pipeline import clustered_vectors, query_vectors
from torch_jax_artifacts import NUMERICS, TAGS, cfg_kwargs, dataset, metadata_artifact

# six test workers share the host's cores; the port's small searches gain
# nothing from more intra-op threads than one
torch.set_num_threads(1)

K = 10
PAD = -1
TOL = dict(rtol=1e-5, atol=1e-5)
SCHEMA = MetadataSchema(tags=TAGS, numerics=NUMERICS)


def _score_le(sel):
    scores = np.asarray(dataset()[2]["score"])
    return float(np.quantile(scores, sel))


# (name, port expression, reference expression)
EXPRS = {
    "sel0.5": lambda: (Num("score").le(_score_le(0.5)), JNum("score").le(_score_le(0.5))),
    "sel0.1": lambda: (Num("score").le(_score_le(0.1)), JNum("score").le(_score_le(0.1))),
    "sel0.01": lambda: (Num("score").le(_score_le(0.01)), JNum("score").le(_score_le(0.01))),
    "tag_and_num": lambda: ((Tag("lang") == "en") & Num("score").le(0.5),
                            (JTag("lang") == "en") & JNum("score").le(0.5)),
    "unknown_tag": lambda: (Tag("lang") == "klingon", JTag("lang") == "klingon"),
}


@pytest.fixture(scope="module", params=[m.value for m in MemoryMode])
def loaded(request):
    """(JAX index, its directory, the port's load of it)."""
    jindex, directory = metadata_artifact(request.param)
    return jindex, directory, load_pageann(directory, device="cpu")


def _passes(index, ids, expr) -> np.ndarray:
    cf, _ = index.compiled_filter(expr)
    ok = tfilter.filter_mask_np(cf, index.meta_host.tags, index.meta_host.nums)
    return np.where(ids >= 0, ok[np.maximum(ids, 0)], True)


def _assert_equal(got, want, fields):
    for field in fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                      err_msg=field)


@pytest.mark.parametrize("name", list(EXPRS))
def test_filtered_search_matches_the_reference(loaded, name):
    jindex, _, tindex = loaded
    _, q, _ = dataset()
    texpr, jexpr = EXPRS[name]()
    planes = np.array(jindex.lsh.planes)
    flips = np.nonzero((tlsh.hash_codes(torch.as_tensor(q), torch.as_tensor(planes))
                        .numpy().view(np.uint32)
                        != np.asarray(jlsh.hash_codes(jnp.asarray(q), jnp.asarray(planes))))
                       .any(1))[0]
    assert len(flips) <= 1
    keep = np.setdiff1d(np.arange(len(q)), flips)
    rj = jindex.search(q, K, filter=jexpr)
    rt = tindex.search(q, K, filter=texpr)
    assert tindex.compiled_filter(texpr)[1] == jindex.compiled_filter(jexpr)[1]
    for field in ("ids", "ios", "hops"):
        np.testing.assert_array_equal(getattr(rt, field)[keep],
                                      np.asarray(getattr(rj, field))[keep],
                                      err_msg=field)
    np.testing.assert_allclose(rt.dists[keep], np.asarray(rj.dists)[keep], **TOL)
    assert _passes(tindex, rt.ids, texpr).all()
    if name == "unknown_tag":
        assert (rt.ids == PAD).all() and np.isinf(rt.dists).all()
    else:
        assert (rt.ids[:, 0] >= 0).all()


def test_streamed_filtered_search_equals_resident_bit_for_bit(loaded):
    _, directory, tindex = loaded
    _, q, _ = dataset()
    streamed = load_pageann(directory, device="cpu", memory_budget=0.25)
    assert streamed.fetcher is not None and streamed.schema == SCHEMA
    for sel in (0.5, 0.01):
        expr = Num("score").le(_score_le(sel)) & Tag("lang").isin("en", "de")
        _assert_equal(streamed.search(q, K, filter=expr),
                      tindex.search(q, K, filter=expr),
                      ("ids", "dists", "ios", "hops", "cache_hits"))


# MEM_ALL at capacity 1 with a tag per owner, as the LM-width RAG index
# has it (d = 2048 there): each member spans several 128-lane rows, every
# neighbour code lies in memory, so a filtered hop runs the members-only
# masked page scan
WIDE_N, WIDE_D = 400, 256
AGENTS = ("support", "research")


@pytest.fixture(scope="module")
def wide_memall(tmp_path_factory):
    """(JAX MEM_ALL index at capacity 1 over WIDE_N x WIDE_D vectors with an
    ``agent`` tag, its saved directory, the queries, the owners)."""
    x = clustered_vectors(WIDE_N, WIDE_D, num_clusters=16, seed=3)
    q = query_vectors(x, 8, seed=4)
    owners = np.random.default_rng(5).choice(
        [*AGENTS, "shared"], WIDE_N).tolist()
    cfg = JConfig(dim=WIDE_D, graph_degree=12, build_beam=24, pq_subspaces=8,
                  lsh_sample=256, lsh_entries=8, beam_width=48, max_hops=48,
                  page_capacity=1, memory_mode=JMode.MEM_ALL)
    jindex = JIndex.build(x, cfg, schema=JSchema(tags=("agent",)),
                          metadata={"agent": owners})
    jindex.warm_cache(np.asarray(q), params=JParams.from_config(cfg))
    directory = str(tmp_path_factory.mktemp("wide") / "idx.mem_all")
    jindex.save(directory)
    return jindex, directory, q, np.asarray(owners)


@pytest.mark.parametrize("agent", AGENTS)
def test_memall_capacity_one_tag_views_match_the_reference(wide_memall, agent):
    """Each agent's view ``Tag("agent").isin(agent, "shared")``: ids, ios
    and hops equal the reference's (distances within rtol = atol = 1e-5),
    every returned document lies in the view, and a search streamed at a
    0.25 budget equals the resident one bit for bit."""
    jindex, directory, q, owners = wide_memall
    tindex = load_pageann(directory, device="cpu")
    assert tindex.stats.capacity == 1
    assert tindex.data.page_recs.shape[1] * 128 >= 2 * WIDE_D
    planes = np.array(jindex.lsh.planes)
    flips = np.nonzero((tlsh.hash_codes(torch.as_tensor(q), torch.as_tensor(planes))
                        .numpy().view(np.uint32)
                        != np.asarray(jlsh.hash_codes(jnp.asarray(q), jnp.asarray(planes))))
                       .any(1))[0]
    assert len(flips) <= 1
    keep = np.setdiff1d(np.arange(len(q)), flips)
    texpr, jexpr = Tag("agent").isin(agent, "shared"), JTag("agent").isin(agent, "shared")
    rj = jindex.search(q, K, filter=jexpr)
    rt = tindex.search(q, K, filter=texpr)
    for field in ("ids", "ios", "hops"):
        np.testing.assert_array_equal(getattr(rt, field)[keep],
                                      np.asarray(getattr(rj, field))[keep],
                                      err_msg=field)
    np.testing.assert_allclose(rt.dists[keep], np.asarray(rj.dists)[keep], **TOL)
    assert (rt.ids[:, 0] >= 0).all()
    assert set(owners[rt.ids[rt.ids >= 0]]) <= {agent, "shared"}
    assert _passes(tindex, rt.ids, texpr).all()
    streamed = load_pageann(directory, device="cpu", memory_budget=0.25)
    assert streamed.fetcher is not None
    _assert_equal(streamed.search(q, K, filter=texpr), rt,
                  ("ids", "dists", "ios", "hops", "cache_hits"))


def test_no_filter_is_bit_identical_to_metadata_free_build():
    x, q, meta = dataset()
    n = 600
    cfg = PageANNConfig(**dict(cfg_kwargs(MemoryMode.HYBRID.value),
                               memory_mode=MemoryMode.HYBRID, build_rounds=1))
    plain = PageANNIndex.build(x[:n], cfg, device="cpu")
    with_meta = PageANNIndex.build(
        x[:n], cfg, schema=SCHEMA,
        metadata=[{"lang": meta["lang"][i], "score": meta["score"][i]}
                  for i in range(n)], device="cpu")
    _assert_equal(with_meta.search(q, K), plain.search(q, K),
                  ("ids", "dists", "ios", "hops", "cache_hits"))
    assert with_meta.metadata_by_original_id() == {
        "lang": meta["lang"][:n], "score": [float(np.float32(v)) for v in meta["score"][:n]]}
    assert plain.metadata_by_original_id() is None
    expr = Tag("lang") == "de"
    res = with_meta.search(q, K, filter=expr)
    assert _passes(with_meta, res.ids, expr).all()
    with pytest.raises(ValueError, match="no MetadataSchema"):
        plain.search(q, K, filter=expr)
    with pytest.raises(ValueError, match="requires a schema"):
        PageANNIndex.build(x[:n], cfg, metadata=meta, device="cpu")


def test_port_saved_metadata_index_filters_identically_in_the_reference(tmp_path):
    jindex, directory = metadata_artifact(MemoryMode.HYBRID.value)
    tindex = load_pageann(directory, device="cpu")
    _, q, _ = dataset()
    out = str(tmp_path / "port_saved")
    tindex.save(out)
    back = jax_load_index(out)
    assert back.schema.to_json() == SCHEMA.to_json() and back.vocab == jindex.vocab
    jexpr = (JTag("lang") == "fr") & JNum("score").ge(0.2)
    want, got = jindex.search(q, K, filter=jexpr), back.search(q, K, filter=jexpr)
    for field in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)))
    again = load_pageann(out, device="cpu")
    texpr = (Tag("lang") == "fr") & Num("score").ge(0.2)
    _assert_equal(again.search(q, K, filter=texpr), tindex.search(q, K, filter=texpr),
                  ("ids", "dists", "ios", "hops"))


def test_corrupt_metadata_raises_index_format_error(loaded, tmp_path):
    _, directory, _ = loaded

    def copy(name):
        d = str(tmp_path / name)
        shutil.copytree(directory, d)
        return d

    def manifest(d, edit):
        path = os.path.join(d, persist.MANIFEST)
        doc = json.load(open(path))
        edit(doc)
        json.dump(doc, open(path, "w"))

    d = copy("garbage")
    open(os.path.join(d, persist.META_NPZ), "wb").write(b"not a zip file")
    with pytest.raises(IndexFormatError, match="unreadable"):
        load_pageann(d, device="cpu")
    d = copy("no_sidecar")
    os.remove(os.path.join(d, persist.META_NPZ))
    with pytest.raises(IndexFormatError, match="meta.npz"):
        load_pageann(d, device="cpu")
    d = copy("no_schema")
    manifest(d, lambda doc: doc.pop("schema"))
    with pytest.raises(IndexFormatError, match="schema"):
        load_pageann(d, device="cpu")
    d = copy("bad_shape")
    with np.load(os.path.join(d, persist.META_NPZ)) as z:
        tags, nums = z["tags"], z["nums"]
    np.savez(os.path.join(d, persist.META_NPZ), tags=tags[:, :0], nums=nums)
    with pytest.raises(IndexFormatError, match="shape"):
        load_pageann(d, device="cpu")
    d = copy("missing_array")
    np.savez(os.path.join(d, persist.META_NPZ), tags=tags)
    with pytest.raises(IndexFormatError, match="missing arrays"):
        load_pageann(d, device="cpu")
    d = copy("garbled")
    manifest(d, lambda doc: doc.__setitem__("schema", {"tags": 13}))
    with pytest.raises(IndexFormatError):
        load_pageann(d, device="cpu")


def test_filter_module_matches_the_reference():
    """Masks over random metadata, compiled forms and error messages."""
    rng = np.random.default_rng(3)
    tags = rng.integers(-1, 4, (200, 2)).astype(np.int32)
    nums = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    nums[rng.random((200, 3)) < 0.1] = np.nan
    schema = dict(tags=("a", "b"), numerics=("x", "y", "z"))
    vocab = {"a": ("p", "q", "r", "s"), "b": ("u", "v", "w", "x")}
    cases = [
        (Tag("a").isin("p", "s") & Num("y").between(-0.5, 0.25),
         JTag("a").isin("p", "s") & JNum("y").between(-0.5, 0.25)),
        (Tag("b") == "v", JTag("b") == "v"),
        (Num("x").ge(0.0) & Num("z").le(0.5), JNum("x").ge(0.0) & JNum("z").le(0.5)),
        (Tag("a") == "nope", JTag("a") == "nope"),
    ]
    for texpr, jexpr in cases:
        tcf = tfilter.compile_filter(texpr, MetadataSchema(**schema), vocab)
        jcf = jfilter.compile_filter(jexpr, jfilter.MetadataSchema(**schema), vocab)
        assert (tcf.tag_clauses, tcf.num_clauses, tcf.empty) == \
            (jcf.tag_clauses, jcf.num_clauses, jcf.empty)
        want = np.asarray(jfilter.filter_mask(jcf, jnp.asarray(tags), jnp.asarray(nums)))
        got = tfilter.filter_mask(tcf, torch.as_tensor(tags), torch.as_tensor(nums))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tfilter.filter_mask_np(tcf, tags, nums), want)
    bad = Tag("nope").isin("x") & Tag("x").isin("y") & Num("a").ge(0)
    with pytest.raises(ValueError) as t_err:
        tfilter.compile_filter(bad, MetadataSchema(**schema), vocab)
    with pytest.raises(ValueError) as j_err:
        jfilter.compile_filter(
            JTag("nope").isin("x") & JTag("x").isin("y") & JNum("a").ge(0),
            jfilter.MetadataSchema(**schema), vocab)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="at least one clause"):
        FilterExpr()
