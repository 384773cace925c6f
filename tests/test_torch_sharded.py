"""The port's sharding against the JAX package's, on the CPU.

``repro_torch.dist.ShardedPageStore`` (host fan-out and mesh fan-out),
``repro_torch.core.distributed`` (partition, stacking, the mesh search),
``core.search.shard_search``, ``launch.mesh`` and the ``mesh=`` keyword of
the PageANN index, the mutable index, the engine and the service, held to
the reference at its own sizes (``tests/test_scaleout.py``'s 600 x 32 and
``tests/test_baselines_and_dist.py``'s ragged 130 x 16 over 4 shards):
sharded artifacts built by either package load in the other and give
equal ids, ios, hops and cache hits, distances within rtol = atol = 1e-5;
the port's recall is at most 0.02 below its unsharded build. The
reference's mesh path needs several devices, so it runs in a subprocess
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` that loads the
saved artifacts and dumps its results (nothing is built there); the port's
CPU meshes name the CPU several times. ``shard_search`` equals
``batch_search`` bit for bit, a ragged split included.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import MemoryMode as JMode
from repro.core import MutableIndex as JMutable
from repro.core import PageANNConfig as JConfig
from repro.core import PageANNIndex as JIndex
from repro.core import SearchParams as JParams
from repro.core import persist as jpersist
from repro.core.vamana import brute_force_knn
from repro.data.pipeline import clustered_vectors, query_vectors
from repro.dist import ShardedPageStore as JStore
from repro.dist import shard_params_for as j_shard_params_for
from repro.core.distributed import partition_vectors as j_partition_vectors
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.serve import BatchingEngine as JEngine
from repro.serve import VectorService as JService
from repro_torch.core import (
    IndexFormatError,
    MemoryMode,
    MutableIndex,
    Num,
    PageANNConfig,
    PageANNIndex,
    SearchParams,
    load_index,
    load_pageann,
    recall_at_k,
)
from repro_torch.core import distributed as dist
from repro_torch.core import search as search_mod
from repro_torch.dist import ShardedPageStore, shard_params_for
from repro_torch.dist.sharded import SHARDS_NPZ
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_mesh
from repro_torch.serve import BatchingEngine, VectorService
from torch_jax_artifacts import metadata_artifact
from torch_jax_artifacts import dataset as metadata_dataset

# six test workers share the host's cores; the port's small searches gain
# nothing from more intra-op threads than one
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
N, D, K = 600, 32, 10
MODES = ("disk_only", "hybrid", "mem_all")
# the ragged case of tests/test_baselines_and_dist.py: 130 vectors over 4
# shards (33/33/32/32), k = 64 above the smallest shard's pool
RAGGED_N, RAGGED_D, RAGGED_K = 130, 16, 64
RAGGED_CFG = dict(dim=RAGGED_D, graph_degree=8, build_beam=16, pq_subspaces=4,
                  lsh_sample=64, lsh_entries=4, beam_width=64, max_hops=32,
                  memory_mode="hybrid")
RAGGED_PARAMS = dict(k=RAGGED_K, beam_width=64, io_batch=4, max_hops=32,
                     lsh_entries=4)


def cfg_kwargs(mode: str) -> dict:
    return dict(dim=D, graph_degree=12, build_beam=24, pq_subspaces=8,
                lsh_sample=256, lsh_entries=8, beam_width=48, max_hops=48,
                memory_mode=mode)


def jcfg(mode: str, **kw) -> JConfig:
    return JConfig(**dict(cfg_kwargs(mode), memory_mode=JMode(mode), **kw))


def tcfg(mode: str, **kw) -> PageANNConfig:
    return PageANNConfig(**dict(cfg_kwargs(mode), memory_mode=MemoryMode(mode),
                                **kw))


def cpu_mesh(data: int, model: int) -> Mesh:
    return make_mesh((data, model), ("data", "model"), devices=[CPU] * (data * model))


@pytest.fixture(scope="module")
def corpus():
    return clustered_vectors(N, D, num_clusters=16, seed=0)


@pytest.fixture(scope="module")
def queries(corpus):
    return query_vectors(corpus, 12, seed=3)


@pytest.fixture(scope="module")
def truth(corpus, queries):
    return brute_force_knn(corpus, queries, K)


@pytest.fixture(scope="module")
def jax_stores(corpus, tmp_path_factory):
    """(mode, shards) -> (JAX-built store, its saved directory), built on
    first use."""
    root = tmp_path_factory.mktemp("jax_stores")
    cache = {}

    def get(mode: str, shards: int):
        if (mode, shards) not in cache:
            store = JStore.build(corpus, jcfg(mode), num_shards=shards)
            directory = str(root / f"{mode}-{shards}")
            store.save(directory)
            cache[mode, shards] = (store, directory)
        return cache[mode, shards]

    return get


@pytest.fixture(scope="module")
def ragged(tmp_path_factory):
    """The ragged JAX-built store, its directory and queries."""
    x = clustered_vectors(RAGGED_N, RAGGED_D, num_clusters=8, seed=0)
    cfg = JConfig(**dict(RAGGED_CFG, memory_mode=JMode.HYBRID))
    store = JStore.build(x, cfg, num_shards=4)
    directory = str(tmp_path_factory.mktemp("ragged") / "store")
    store.save(directory)
    return store, directory, x, query_vectors(x, 8, seed=1)


@pytest.fixture(scope="module")
def jax_index(corpus, tmp_path_factory):
    """One unsharded JAX-built HYBRID index and its saved directory."""
    index = JIndex.build(corpus, jcfg("hybrid"))
    directory = str(tmp_path_factory.mktemp("jax_index") / "idx")
    index.save(directory)
    return index, directory


@pytest.fixture(scope="module")
def index(jax_index):
    return load_pageann(jax_index[1], device=CPU)


def _assert_matches_reference(got, want, *, exact_dists=False):
    for name in ("ids", "ios", "hops", "cache_hits"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    if exact_dists:
        np.testing.assert_array_equal(got.dists, np.asarray(want.dists))
    else:
        np.testing.assert_allclose(got.dists, np.asarray(want.dists),
                                   rtol=1e-5, atol=1e-5)


def _assert_equal(got, want):
    for name in got._fields:
        a = np.asarray(getattr(got, name))
        b = np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# ------------------------------------------------------------ pure Python
@pytest.mark.parametrize("n,shards,seed", [(600, 2, 0), (600, 4, 0),
                                           (130, 4, 0), (1001, 3, 7),
                                           (5, 8, 1)])
def test_partition_vectors_equals_the_reference(n, shards, seed):
    x = np.zeros((n, 2), np.float32)
    got = dist.partition_vectors(x, shards, seed)
    want = j_partition_vectors(x, shards, seed)
    assert len(got) == len(want) == shards
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("base", [
    dict(k=10, beam_width=64, max_hops=64, io_batch=8, lsh_entries=12),
    dict(k=10, beam_width=48, max_hops=48, io_batch=5, lsh_entries=8),
    dict(k=64, beam_width=64, max_hops=32, io_batch=4, lsh_entries=4),
    dict(k=5, beam_width=200, max_hops=20, io_batch=2, lsh_entries=30),
], ids=["scaleout", "suite", "ragged", "wide"])
def test_shard_params_for_equals_the_reference(base, shards):
    got = shard_params_for(SearchParams(**base), shards)
    want = j_shard_params_for(JParams(**base), shards)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


# ------------------------------------------------------------- the mesh
def test_mesh_is_a_frozen_value():
    a = cpu_mesh(2, 1)
    assert a == cpu_mesh(2, 1) and hash(a) == hash(cpu_mesh(2, 1))
    assert a != cpu_mesh(1, 2) and len({a, cpu_mesh(2, 1)}) == 1
    assert a.shape == {"data": 2, "model": 1} and a.size == 2
    assert a.distinct_devices == 1 and a.devices.shape == (2, 1)
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.dims = (1, 2)
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), devices=[CPU] * 3)
    with pytest.raises(ValueError, match="repeated axis"):
        make_mesh((1, 1), ("data", "data"), devices=[CPU])


def test_meshes_default_to_the_card():
    """Without ``devices`` a mesh is made of CUDA devices, and the host
    mesh lives on the card unless the CPU is asked for: with no card both
    raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh((2, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    assert make_host_mesh(CPU).flat == (torch.device(CPU),)


# ------------------------------------------------------ artifacts, both ways
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_reference_store_loads_in_the_port(jax_stores, queries, mode, shards):
    """A store the JAX package built and saved loads through the port's
    ``load_index``; its host fan-out gives the reference's ids, ios, hops
    and cache hits, and its stats the reference's."""
    jstore, directory = jax_stores(mode, shards)
    store = load_index(directory, device=CPU)
    assert isinstance(store, ShardedPageStore)
    assert store.num_shards == shards and store.cfg.memory_mode.value == mode
    for a, b in zip(store.parts, jstore.parts):
        np.testing.assert_array_equal(a, b)
    _assert_matches_reference(store.search(queries, k=K),
                              jstore.search(queries, k=K))
    assert store.stats == jstore.stats
    assert store.fetch_stats() == jstore.fetch_stats()


@pytest.mark.parametrize("mode,shards", [("disk_only", 2), ("hybrid", 2),
                                         ("mem_all", 2), ("hybrid", 4)])
def test_port_store_loads_in_the_reference_at_the_unsharded_recall(
        corpus, queries, truth, tmp_path, mode, shards):
    """A store the port built and saved loads in the JAX package, and the
    two searches agree; the port's recall is at most 0.02 below its
    unsharded build (``tests/test_scaleout.py``'s gate)."""
    store = ShardedPageStore.build(corpus, tcfg(mode), shards, device=CPU)
    directory = str(tmp_path / "store")
    store.save(directory)
    jstore = jpersist.load_index(directory)
    assert isinstance(jstore, JStore) and jstore.num_shards == shards
    got = store.search(queries, k=K)
    _assert_matches_reference(got, jstore.search(queries, k=K))
    again = load_index(directory, device=CPU).search(queries, k=K)
    _assert_equal(again, got)
    base = PageANNIndex.build(corpus, tcfg(mode), device=CPU)
    r_base = recall_at_k(base.search(queries, k=K).ids, truth)
    r_shard = recall_at_k(got.ids, truth)
    assert r_shard >= r_base - 0.02, (r_shard, r_base)


def test_search_returns_global_ids(corpus, jax_stores):
    """Corpus rows as queries: the nearest neighbour of x[i] is i itself,
    which holds only if the shard-local ids were translated."""
    store = load_index(jax_stores("hybrid", 2)[1], device=CPU)
    ids = store.search(corpus[:16], k=K).ids
    assert ids.dtype == np.int64 and ids.max() < N
    assert (ids[:, 0] == np.arange(16)).mean() >= 0.9
    for row in ids:
        row = row[row >= 0]
        assert len(set(row.tolist())) == len(row)
    cat = np.concatenate(store.parts)
    np.testing.assert_array_equal(np.sort(cat), np.arange(N))


def assert_same_error(got: type, want: type) -> None:
    """The port raised what the reference raised: the same builtin type,
    or the port's class of the same name (its ``IndexFormatError``)."""
    if want.__module__ == "builtins":
        assert got is want, (got, want)
    else:
        assert got.__name__ == want.__name__, (got, want)


def _rewrite(directory, case: str) -> None:
    """Damage a saved sharded store the way ``case`` names."""
    man = os.path.join(directory, "manifest.json")
    if case == "missing_npz":
        os.remove(os.path.join(directory, SHARDS_NPZ))
        return
    with open(man) as f:
        doc = json.load(f)
    if case == "bad_num_shards":
        doc["num_shards"] = 0
    elif case == "no_num_shards":
        del doc["num_shards"]
    with open(man, "w") as f:
        json.dump(doc, f)


@pytest.mark.parametrize("case", ["plain_artifact", "bad_num_shards",
                                  "no_num_shards", "missing_npz"])
def test_load_rejects_what_the_reference_rejects(jax_stores, jax_index,
                                                 tmp_path, case):
    """``ShardedPageStore.load`` refuses a PageANN artifact
    (``tests/test_scaleout.py``), a bad or missing shard count and a
    missing ``shards.npz`` with the reference's exception type."""
    import shutil

    if case == "plain_artifact":
        directory = jax_index[1]
    else:
        directory = str(tmp_path / "store")
        shutil.copytree(jax_stores("hybrid", 2)[1], directory)
        _rewrite(directory, case)
    with pytest.raises(Exception) as want:
        JStore.load(directory)
    with pytest.raises(Exception) as got:
        ShardedPageStore.load(directory, device=CPU)
    assert_same_error(got.type, want.type)
    if case in ("plain_artifact", "bad_num_shards", "missing_npz"):
        assert got.type is IndexFormatError


# ------------------------------------------------------------ mesh paths
_REFERENCE_MESH = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
import numpy as np
from repro.core import compat, persist
from repro.core.config import SearchParams

spec = json.loads(sys.argv[1])
for case in spec:
    store = persist.load_index(case["dir"])
    mesh = compat.make_mesh(tuple(case["mesh"]), ("data", "model"))
    params = SearchParams(**case["params"]) if case["params"] else None
    q = np.load(case["queries"])
    res = store.search(q, k=case["k"], params=params, mesh=mesh)
    np.savez(case["out"], **{f: np.asarray(getattr(res, f))
                             for f in res._fields})
print("ok")
"""


@pytest.fixture(scope="module")
def reference_mesh(jax_stores, ragged, queries, tmp_path_factory):
    """The reference's ``_mesh_search`` on three saved stores, in one
    subprocess with four host devices: name -> its SearchResult arrays."""
    root = tmp_path_factory.mktemp("reference_mesh")
    qfile = str(root / "q.npy")
    np.save(qfile, queries)
    rfile = str(root / "ragged_q.npy")
    np.save(rfile, ragged[3])
    cases = {
        "hybrid-2x2": dict(dir=jax_stores("hybrid", 2)[1], mesh=[2, 2],
                           k=K, params=None, queries=qfile),
        "mem_all-2x1": dict(dir=jax_stores("mem_all", 2)[1], mesh=[2, 1],
                            k=K, params=None, queries=qfile),
        "hybrid-4x1": dict(dir=jax_stores("hybrid", 4)[1], mesh=[4, 1],
                           k=K, params=None, queries=qfile),
        "ragged-4x1": dict(dir=ragged[1], mesh=[4, 1], k=RAGGED_K,
                           params=RAGGED_PARAMS, queries=rfile),
    }
    for name, case in cases.items():
        case["out"] = str(root / f"{name}.npz")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", ""),
           "HOME": os.environ.get("HOME", str(root)), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE_MESH, json.dumps(list(cases.values()))],
        capture_output=True, text=True, timeout=400, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return {name: dict(np.load(case["out"])) for name, case in cases.items()}


@pytest.mark.parametrize("name", ["hybrid-2x2", "mem_all-2x1", "hybrid-4x1",
                                  "ragged-4x1"])
def test_mesh_path_equals_the_reference_and_the_host_fan_out(
        reference_mesh, jax_stores, ragged, queries, name):
    """The port's mesh path on a CPU mesh of the same shape gives the
    reference's mesh results (hops and cache hits zeros in both), and equals
    the port's own host fan-out in ids, distances and ios exactly."""
    mode, shape = name.split("-")
    data, model = (int(v) for v in shape.split("x"))
    if mode == "ragged":
        directory, q, k = ragged[1], ragged[3], RAGGED_K
        params = SearchParams(**RAGGED_PARAMS)
    else:
        directory, q, k, params = jax_stores(mode, data)[1], queries, K, None
    store = load_index(directory, device=CPU)
    got = store.search(q, k=k, params=params, mesh=cpu_mesh(data, model))
    want = search_mod.SearchResult(**reference_mesh[name])
    _assert_matches_reference(got, want)
    assert not got.hops.any() and not got.cache_hits.any()
    host = store.search(q, k=k, params=params)
    for field in ("ids", "dists", "ios"):
        np.testing.assert_array_equal(getattr(got, field), getattr(host, field),
                                      err_msg=field)
    assert host.hops.min() > 0


def test_ragged_shards_never_surface_pad(ragged):
    """130 vectors over 4 shards, k = 64: every shard is padded to the
    largest one's page count, and no pad slot ranks. A merged row holds as
    many real ids as the shards found candidates, up to k; PAD only trails,
    never with a finite distance, and every real id is a valid global id."""
    _, directory, x, q = ragged
    store = load_index(directory, device=CPU)
    params = SearchParams(**RAGGED_PARAMS)
    sh = store.to_sharded_index()
    fn, placement = dist.make_sharded_search(
        cpu_mesh(4, 1), store.cfg, sh.capacity, RAGGED_K,
        params=shard_params_for(params, 4))
    assert placement == ((torch.device(CPU),),) * 4
    ids, tag, d, _ = (t.numpy() for t in fn(sh.data, torch.as_tensor(q)))
    local = dist.translate_ids(sh, ids, tag)
    pad = local == -1
    assert not (pad & np.isfinite(d)).any()
    assert not ((ids >= 0) & pad).any()
    for row in pad:
        assert not (row[:-1] & ~row[1:]).any()      # PAD only trails
    got = store.search(q, params=params, mesh=cpu_mesh(4, 1))
    assert ((got.ids >= 0) | (got.ids == -1)).all() and got.ids.max() < RAGGED_N
    found = sum((s.search(q, params=shard_params_for(params, 4)).ids >= 0).sum(1)
                for s in store.shards)
    np.testing.assert_array_equal((got.ids >= 0).sum(1),
                                  np.minimum(found, RAGGED_K))
    truth = brute_force_knn(x, q, 10)
    assert recall_at_k(got.ids[:, :10], truth) >= 0.9


def test_build_sharded_index_translates_to_global_ids(ragged):
    """``build_sharded_index`` stacks shards over their global id slices,
    so ``translate_ids`` of the mesh search's (ids, tags) gives global ids
    directly: the store's mesh search over the same partition, exactly. A
    mesh whose axes are not ("data", "model") is refused."""
    _, _, x, q = ragged
    cfg = PageANNConfig(**dict(RAGGED_CFG, memory_mode=MemoryMode.HYBRID))
    sh = dist.build_sharded_index(x, cfg, 4, device=CPU)
    params = SearchParams(**RAGGED_PARAMS)
    fn, _ = dist.make_sharded_search(cpu_mesh(4, 1), cfg, sh.capacity,
                                     RAGGED_K, params=shard_params_for(params, 4))
    ids, tag, d, ios = (t.numpy() for t in fn(sh.data, torch.as_tensor(q)))
    store = ShardedPageStore.build(x, cfg, 4, device=CPU)
    want = store.search(q, params=params, mesh=cpu_mesh(4, 1))
    np.testing.assert_array_equal(dist.translate_ids(sh, ids, tag), want.ids)
    np.testing.assert_array_equal(d, want.dists)
    np.testing.assert_array_equal(ios, want.ios)
    bad = make_mesh((4, 1), ("shards", "model"), devices=[CPU] * 4)
    with pytest.raises(ValueError, match="mesh axes"):
        dist.make_sharded_search(bad, cfg, sh.capacity, RAGGED_K)


def test_stack_shards_pads_as_the_reference(ragged):
    """The stacked layout of ragged shards equals the reference's array for
    array: pad pages with member_count 0 and PAD neighbours, identity
    residency, memory codes and mask padded to max_pages * capacity,
    cached pages padded with the sentinel, new_to_old PAD-filled."""
    jstore, directory, _, _ = ragged
    got = load_index(directory, device=CPU).to_sharded_index()
    want = jstore.to_sharded_index()
    assert got.capacity == want.capacity
    np.testing.assert_array_equal(got.new_to_old, want.new_to_old)
    for name in search_mod.SearchData._fields:
        a = getattr(got.data, name).numpy()
        b = np.asarray(getattr(want.data, name))
        if b.dtype == np.uint32:
            b = b.view(np.int32)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_one_device_listed_twice_holds_one_copy_of_each_shard(
        jax_stores, queries, monkeypatch):
    """A shard placed on the device its stack already lives on is a view
    of the stack, not a copy, and two shards never share storage."""
    store = load_index(jax_stores("hybrid", 2)[1], device=CPU)
    sh = store.to_sharded_index()
    seen = []
    real = search_mod.batch_search

    def spy(q, data, *a, **kw):
        seen.append(data)
        return real(q, data, *a, **kw)

    fn, _ = dist.make_sharded_search(cpu_mesh(2, 2), store.cfg, sh.capacity, K)
    monkeypatch.setattr(search_mod, "batch_search", spy)
    fn(sh.data, torch.as_tensor(queries))
    assert len(seen) == 4                     # 2 shards x 2 query blocks
    for s, shard in zip((0, 1, 0, 1), seen):
        for t, stacked in zip(shard, sh.data):
            assert t.data_ptr() == stacked[s].data_ptr()


def test_mesh_rejects_a_data_axis_of_another_size(jax_stores, queries):
    store = load_index(jax_stores("hybrid", 2)[1], device=CPU)
    jstore = jax_stores("hybrid", 2)[0]
    with pytest.raises(ValueError, match="data axis is 1"):
        jstore.search(queries, k=K, mesh=j_host_mesh())
    with pytest.raises(ValueError, match="data axis is 1"):
        store.search(queries, k=K, mesh=cpu_mesh(1, 2))


# ----------------------------------------------------------- shard_search
@pytest.mark.parametrize("shape,nq", [((1, 1), 7), ((1, 3), 7), ((2, 2), 7),
                                      ((1, 3), 2), ((2, 1), 12)])
def test_shard_search_equals_batch_search(index, corpus, shape, nq):
    """The query batch split over the mesh (a ragged split included: 7
    queries over 3 devices run as 3, 3 and 1) gives ``batch_search``'s
    results bit for bit, as the reference's
    ``test_shard_search_parity_on_1device_mesh`` requires of its own."""
    q = torch.as_tensor(query_vectors(corpus, nq, seed=2))
    params = index.resolve_params(K, None)
    kw = dict(capacity=index.store.capacity,
              mode=index.cfg.memory_mode.value)
    want = search_mod.batch_search(q, index.data, params, **kw)
    got = search_mod.shard_search(q, index.data, params, mesh=cpu_mesh(*shape),
                                  **kw)
    for field in search_mod.SearchResult._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field
    if shape == (1, 1):
        again = search_mod.shard_search(q, index.data, params, **kw)
        for a, b in zip(again, want):
            assert torch.equal(a, b)


def test_index_search_with_a_mesh_matches_the_reference(index, jax_index,
                                                        queries):
    """``PageANNIndex.search(mesh=)`` equals the search without one; the
    reference's ``search(mesh=)`` on its 1-device host mesh gives the same
    ids, ios and hops."""
    want = index.search(queries, k=K)
    for mesh in (make_host_mesh(CPU), cpu_mesh(1, 3)):
        _assert_equal(index.search(queries, k=K, mesh=mesh), want)
    _assert_matches_reference(index.search(queries, k=K, mesh=cpu_mesh(2, 1)),
                              jax_index[0].search(queries, k=K,
                                                  mesh=j_host_mesh()))


def test_filtered_search_through_a_mesh():
    """A filter rides ``shard_search`` (the metadata columns replicated with
    the index): equal to the filtered search without a mesh, and to the
    reference's filtered ``search(mesh=)``."""
    from repro.core import Num as JNum

    jidx, directory = metadata_artifact("hybrid")
    _, q, _ = metadata_dataset()
    idx = load_pageann(directory, device=CPU)
    want = idx.search(q, k=K, filter=Num("score").le(0.3))
    got = idx.search(q, k=K, filter=Num("score").le(0.3), mesh=cpu_mesh(1, 3))
    _assert_equal(got, want)
    _assert_matches_reference(
        got, jidx.search(q, k=K, filter=JNum("score").le(0.3),
                         mesh=j_host_mesh()))


def test_streamed_indexes_refuse_a_mesh(jax_index, jax_stores, queries):
    """A memory-budgeted PageANN index refuses a mesh, as the reference's
    does. A budgeted sharded store's host fan-out equals the resident one
    exactly, and its mesh path refuses too (the reference stacks the
    resident part of each shard's pages and reads the wrong records)."""
    idx = load_pageann(jax_index[1], device=CPU, memory_budget=0.25)
    assert idx.fetcher is not None
    with pytest.raises(ValueError, match="streamed"):
        idx.search(queries, k=K, mesh=make_host_mesh(CPU))
    directory = jax_stores("hybrid", 2)[1]
    budgeted = load_index(directory, device=CPU, memory_budget=0.25)
    assert all(s.fetcher is not None for s in budgeted.shards)
    _assert_equal(budgeted.search(queries, k=K),
                  load_index(directory, device=CPU).search(queries, k=K))
    assert budgeted.fetch_stats()["pages_fetched"] > 0
    with pytest.raises(ValueError, match="memory budget"):
        budgeted.search(queries, k=K, mesh=cpu_mesh(2, 1))


def test_mutable_search_with_a_mesh_equals_without(index, jax_index, corpus,
                                                   queries):
    """``MutableIndex.search(mesh=)`` passes the mesh to its base search:
    equal to the search without it, with inserts and deletes pending, and
    to the reference's ``search(mesh=)`` over the same writes."""
    fresh = corpus[:30] + 0.01
    tm, jm = MutableIndex(index), JMutable(jax_index[0])
    for m in (tm, jm):
        m.insert(fresh, ids=np.arange(N, N + 30))
        m.delete(np.arange(40, 60))
    q = np.concatenate([queries, fresh[:4]])
    want = tm.search(q, k=K)
    for mesh in (make_host_mesh(CPU), cpu_mesh(1, 2)):
        _assert_equal(tm.search(q, k=K, mesh=mesh), want)
    _assert_matches_reference(tm.search(q, k=K, mesh=make_host_mesh(CPU)),
                              jm.search(q, k=K, mesh=j_host_mesh()))


# ------------------------------------------------------- engine, service
def _sequence(eng, q, collections):
    """A fixed mix: each collection in turn, two k bins, a ragged flush."""
    futs = []
    for i, row in enumerate(q):
        col = collections[i % len(collections)]
        futs.append(eng.submit(row, collection=col))
        if i % 3 == 0:
            futs.append(eng.submit(row, k=3, collection=col))
    eng.flush()
    return [f.result(timeout=120) for f in futs]


_COUNTERS = ("compile_hits", "compile_misses", "compiled_executables",
             "requests", "batches", "collections")


def test_engine_with_a_mesh_counts_as_the_reference(index, jax_index, corpus):
    """One index registered plain and with a mesh: the mesh is part of the
    compile-cache geometry in both packages (a second executable), so the
    same dispatch sequence counts the reference's hits, misses and
    executables; every row equals the direct search."""
    q = query_vectors(corpus, 10, seed=7)
    out = []
    for eng_cls, idx, mesh in ((BatchingEngine, index, make_host_mesh(CPU)),
                               (JEngine, jax_index[0], j_host_mesh())):
        eng = eng_cls(batch_size=4, k_bins=(5, 10))
        eng.add_collection("plain", index=idx, default_k=K)
        eng.add_collection("mesh", index=idx, default_k=K, mesh=mesh)
        rows = _sequence(eng, q, ("plain", "mesh"))
        out.append((rows, eng.metrics()))
        eng.close()
        one = eng_cls.from_index(idx, k=K, batch_size=4, mesh=mesh)
        solo = one.search(q)
        one.close()
        out.append((solo, None))
    (got, gm), (got_solo, _), (want, wm), (want_solo, _) = out
    for fields in _COUNTERS:
        assert getattr(gm, fields) == getattr(wm, fields), fields
    for g, w in zip(got + got_solo, want + want_solo):
        for name in ("ids", "ios", "hops", "cache_hits"):
            np.testing.assert_array_equal(getattr(g.result, name),
                                          np.asarray(getattr(w.result, name)))
    direct = index.search(q, k=K)
    for i, r in enumerate(got_solo):
        np.testing.assert_array_equal(r.result.ids, direct.ids[i])
        np.testing.assert_array_equal(r.result.dists, direct.dists[i])


def test_service_with_a_mesh_and_a_sharded_store(index, jax_index, jax_stores,
                                                 queries):
    """Collections created and attached with ``mesh=`` (a PageANN index
    and a sharded store) and a sharded store attached from disk: every
    result equals the direct search, the compile-cache counters equal the
    reference service's for the same sequence, and the sharded store's
    dict stats pass through as the reference's do."""
    jstore, sdir = jax_stores("hybrid", 2)
    store = load_index(sdir, device=CPU)
    out = []
    for svc, host in ((VectorService(device=CPU, batch_size=4),
                       make_host_mesh(CPU)),
                      (JService(batch_size=4), j_host_mesh())):
        with svc:
            svc.create_collection("made", index if svc.__class__ is VectorService
                                  else jax_index[0], k=K, mesh=host)
            svc.attach("attached", jax_index[1], k=K, mesh=host)
            svc.attach("sharded", sdir, k=K)
            rows = {name: svc.search(name, queries)
                    for name in ("made", "attached", "sharded")}
            out.append((rows, svc.metrics(), svc.stats()))
    (got, gm, gstats), (want, wm, wstats) = out
    for fields in _COUNTERS:
        assert getattr(gm, fields) == getattr(wm, fields), fields
    assert gstats["sharded"] == wstats["sharded"] == jstore.stats
    direct = {"made": index.search(queries, k=K),
              "attached": index.search(queries, k=K),
              "sharded": store.search(queries, k=K)}
    for name, rows in got.items():
        for field in ("ids", "dists", "ios", "hops", "cache_hits"):
            np.testing.assert_array_equal(
                np.stack([getattr(r.result, field) for r in rows]),
                getattr(direct[name], field), err_msg=f"{name}.{field}")
        for g, w in zip(rows, want[name]):
            np.testing.assert_array_equal(g.result.ids, np.asarray(w.result.ids))
    with VectorService(device=CPU, batch_size=4) as svc:
        svc.create_collection("fleet", store, k=K, mesh=cpu_mesh(2, 1))
        rows = svc.search("fleet", queries)
    want = store.search(queries, k=K, mesh=cpu_mesh(2, 1))
    for field in ("ids", "dists", "ios", "hops"):
        np.testing.assert_array_equal(
            np.stack([getattr(r.result, field) for r in rows]),
            getattr(want, field), err_msg=field)
