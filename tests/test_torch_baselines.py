"""The port's DiskANN and Starling baselines (``repro_torch.core.baselines``)
against the JAX package's, on the CPU (the kernels' plain versions).

The fixture is the reference test's (``tests/test_baselines_and_dist.py``):
2,000 x 32 clustered vectors, a degree-16 Vamana graph, 8 x 256 PQ
codebooks, 20 queries. Both packages search the same graph and codebooks:
ids, ios and hops must be equal, distances ``allclose`` at rtol = atol =
1e-5 (the frameworks reduce in another order). Artifacts are read across
packages in both directions. The Starling page accounting reproduces the
reference's scatter, which keeps the last write of a repeated page index,
so a batch with a pick on page 0 followed by an empty slot leaves page 0
unvisited; one case is built so that this changes the ios.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbl
from repro.core import pq as jpq
from repro.core.config import PageANNConfig as JConfig
from repro.core.page_graph import group_pages as jgroup_pages
from repro.core.vamana import brute_force_knn, build_vamana, medoid
from repro.data.pipeline import clustered_vectors, query_vectors
from repro_torch.core import baselines as tbl
from repro_torch.core import load_index, recall_at_k
from repro_torch.core.config import PageANNConfig, SearchParams
from repro_torch.core.search import PAD
from repro_torch.kernels import ops
from repro_torch.kernels import page_scan as page_scan_k

# six test workers share the host's cores; the port's small searches gain
# nothing from more intra-op threads than one
torch.set_num_threads(1)

RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    x = clustered_vectors(2000, 32, num_clusters=32, seed=0)
    q = query_vectors(x, 20, seed=1)
    truth = brute_force_knn(x, q, 10)
    nbrs = build_vamana(x, degree=16, beam=32, seed=0)
    books = np.asarray(jpq.train_pq(x, 8, 256, 8))
    page_of = jgroup_pages(x, nbrs, capacity=8, h=2).page_of
    return x, q, truth, nbrs, books, page_of


def _layout(setup, kind):
    """(page_of, vectors_per_page) of a layout: DiskANN in id order (the
    default 4 KB pages, or 8 vectors a page), Starling grouped."""
    page_of = setup[5]
    return {"diskann": (None, None), "diskann-vpp8": (None, 8),
            "starling": (page_of, None)}[kind]


def _both(setup, kind, page_of=None, vpp=None):
    """(JAX data, JAX search fn, port index) over the same graph/books."""
    x, _, _, nbrs, books, _ = setup
    jdata = jbl.make_baseline_data(x, nbrs, books, page_of=page_of,
                                   vectors_per_page=vpp)
    cls = tbl.StarlingIndex if kind == "starling" else tbl.DiskANNIndex
    fn = jbl.starling_search if kind == "starling" else jbl.diskann_search
    index = cls.from_data(x, nbrs, books, page_of=page_of,
                          vectors_per_page=vpp, device="cpu")
    return jdata, fn, index


def _assert_same(got, want):
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    np.testing.assert_array_equal(got.ios, np.asarray(want.ios))
    np.testing.assert_array_equal(got.hops, np.asarray(want.hops))
    np.testing.assert_allclose(got.dists, np.asarray(want.dists),
                               rtol=RTOL, atol=ATOL)


# (beam, io_batch, max_hops): the defaults; two that stop at max_hops; an
# io batch wider than the beam (exhausted picks mark slot 0)
KNOBS = [(64, 5, 64), (32, 3, 8), (16, 4, 4), (8, 12, 64)]


@pytest.mark.parametrize("beam,io_batch,max_hops", KNOBS)
@pytest.mark.parametrize("kind", ["diskann", "diskann-vpp8", "starling"])
def test_search_equals_the_reference(setup, kind, beam, io_batch, max_hops):
    _, q, _, _, _, _ = setup
    page_of, vpp = _layout(setup, kind)
    jdata, fn, index = _both(setup, kind.split("-")[0], page_of, vpp)
    np.testing.assert_array_equal(index.data.codes.numpy(),
                                  np.asarray(jdata.codes))
    assert int(index.data.entry) == int(jdata.entry)
    want = fn(jnp.asarray(q), jdata, beam=beam, k=10, max_hops=max_hops,
              io_batch=io_batch)
    got = index.search(q, params=SearchParams(
        k=10, beam_width=beam, io_batch=io_batch, max_hops=max_hops))
    _assert_same(got, want)
    assert (got.cache_hits == 0).all()
    if max_hops < 16:
        assert (got.hops == max_hops).any()


@pytest.fixture(scope="module")
def wide():
    """The chip smoke's width and code size at a CPU-sized depth: 1,500 x
    128 vectors, a degree-16 graph, 16 x 256 PQ codebooks (16-byte codes),
    50 queries."""
    x = clustered_vectors(1500, 128, num_clusters=32, seed=3)
    q = query_vectors(x, 50, seed=4)
    nbrs = build_vamana(x, degree=16, beam=32, seed=0)
    books = np.asarray(jpq.train_pq(x, 16, 256, 8))
    page_of = jgroup_pages(x, nbrs, capacity=6, h=2).page_of
    return x, q, nbrs, books, page_of


@pytest.mark.parametrize("beam", [64, 128])
@pytest.mark.parametrize("kind", ["diskann", "starling"])
def test_search_equals_the_reference_at_d128_m16(wide, kind, beam):
    """The smoke's default point and beam 128 at d = 128, M = 16, where the
    card showed DiskANN's recall@10 below the reference test's 0.85 floor:
    the same graph and codebooks give the reference's ids, ios and hops."""
    x, q, nbrs, books, page_of = wide
    page_of = page_of if kind == "starling" else None
    jdata = jbl.make_baseline_data(x, nbrs, books, page_of=page_of)
    fn = jbl.starling_search if kind == "starling" else jbl.diskann_search
    cls = tbl.StarlingIndex if kind == "starling" else tbl.DiskANNIndex
    index = cls.from_data(x, nbrs, books, page_of=page_of, device="cpu")
    want = fn(jnp.asarray(q), jdata, beam=beam, k=10)
    _assert_same(index.search(q, params=SearchParams(beam_width=beam)), want)


def test_recall_and_starling_reads_fewer_pages(setup):
    """The reference test's bounds: recall@10 >= 0.85 for DiskANN, >= 0.8
    for Starling, and Starling's grouped layout reads fewer unique pages
    than DiskANN's per-node reads at the same traversal."""
    _, q, truth, _, _, page_of = setup
    disk = _both(setup, "diskann", None, 8)[2].search(q)
    star = _both(setup, "starling", page_of, None)[2].search(q)
    assert recall_at_k(disk.ids, truth) >= 0.85
    assert recall_at_k(star.ids, truth) >= 0.8
    assert star.ios.mean() < disk.ios.mean()
    np.testing.assert_array_equal(star.ids, disk.ids)   # one traversal


def test_page_zero_keeps_the_references_last_write(setup):
    """Relabel the entry's page as page 0: the first hop picks the entry and
    then an empty slot, whose scatter writes page 0's old bit back, so a
    later pick on page 0 reads it again. The port counts those reads as the
    reference does, so the relabelled layout costs more ios than the same
    grouping under other page ids, with the same traversal."""
    x, q, _, _, _, page_of = setup
    pe = page_of[medoid(x)]
    assert pe != 0
    swapped = page_of.copy()
    swapped[page_of == pe], swapped[page_of == 0] = 0, pe
    ios = []
    for layout in (page_of, swapped):
        jdata, fn, index = _both(setup, "starling", layout, None)
        got = index.search(q)
        _assert_same(got, fn(jnp.asarray(q), jdata))
        ios.append(int(got.ios.sum()))
    assert ios[1] > ios[0], ios


def _serial_page_reads(page_vis, pages, ok):
    """The reference's page accounting for one lane, step by step: the
    dedup loop, then a scatter whose last write to an index wins."""
    b = len(pages)
    seen = np.full(b, PAD)
    first = np.zeros(b, bool)
    for j in range(b):
        dup = (seen == pages[j]).any()
        first[j] = ok[j] and not page_vis[pages[j]] and not dup
        seen[j] = pages[j] if ok[j] else PAD
    idx = np.where(ok, pages, 0)
    vals = page_vis[idx] | ok
    out = page_vis.copy()
    for i, v in zip(idx, vals):
        out[i] = v
    return int(first.sum()), out


def test_page_reads_equal_a_serial_scatter():
    """``_page_reads`` against the reference's loop and last-write scatter
    on seeded batches: ok slots a prefix, pages with repeats and page 0
    often, some pages visited before."""
    rng = np.random.default_rng(0)
    nq, n, b = 64, 6, 5
    pages = rng.integers(0, 4, (nq, b))
    n_ok = rng.integers(0, b + 1, nq)
    ok = np.arange(b)[None, :] < n_ok[:, None]
    vis = rng.random((nq, n + 1)) < 0.3
    vis[:, n] = False
    s = tbl._State(*(None,) * 4, torch.as_tensor(vis.copy()), *(None,) * 4)
    rows = torch.arange(nq)[:, None].expand(nq, b)
    got = tbl._page_reads(s, rows, torch.as_tensor(pages), torch.as_tensor(ok))
    for i in range(nq):
        want_io, want_vis = _serial_page_reads(vis[i, :n], pages[i], ok[i])
        assert int(got[i]) == want_io, i
        np.testing.assert_array_equal(s.page_vis[i, :n].numpy(), want_vis)


def test_picks_equal_sequential_argmins():
    """``_pick`` (one stable sort) against io_batch serial argmins over a
    beam with ties, PAD slots, INF and already expanded candidates."""
    rng = np.random.default_rng(1)
    nq, beam = 200, 12
    ids = rng.integers(0, 50, (nq, beam)).astype(np.int32)
    ids[rng.random((nq, beam)) < 0.2] = PAD
    d = rng.integers(0, 6, (nq, beam)).astype(np.float32)
    d[rng.random((nq, beam)) < 0.15] = np.inf
    vis = rng.random((nq, beam)) < 0.3
    for b in (1, 5, 12, 15):
        batch, ok, got_vis = tbl._pick(torch.as_tensor(ids), torch.as_tensor(d),
                                       torch.as_tensor(vis), b)
        for i in range(nq):
            cv = vis[i].copy()
            want = []
            for _ in range(b):
                masked = np.where(cv | (ids[i] == PAD), np.inf, d[i])
                slot = int(np.argmin(masked))
                good = np.isfinite(masked[slot])
                cv[slot] = True
                want.append(ids[i, slot] if good else PAD)
            np.testing.assert_array_equal(batch[i].numpy(), want)
            np.testing.assert_array_equal(ok[i].numpy(), np.array(want) >= 0)
            np.testing.assert_array_equal(got_vis[i].numpy(), cv)


@pytest.mark.parametrize("kind", ["diskann", "starling"])
def test_artifacts_cross_packages_both_ways(setup, tmp_path, kind):
    """A JAX-saved baseline loads in the port (``load_index``) and searches
    as the reference does; a port-saved one loads in the JAX package
    (``load_baseline``) and does the same; the arrays are equal."""
    _, q, _, _, _, _ = setup
    page_of, vpp = _layout(setup, kind)
    jdata, fn, index = _both(setup, kind, page_of, vpp)
    jcls = jbl.StarlingIndex if kind == "starling" else jbl.DiskANNIndex
    want = fn(jnp.asarray(q), jdata)

    jcls(jdata).save(str(tmp_path / "from_jax"))
    loaded = load_index(str(tmp_path / "from_jax"), device="cpu")
    assert type(loaded) is type(index) and loaded.kind == kind
    _assert_same(loaded.search(q), want)
    for name, t in loaded.data._asdict().items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jdata, name)))

    index.save(str(tmp_path / "from_torch"))
    back = jbl.load_baseline(str(tmp_path / "from_torch"))
    assert type(back) is jcls
    for name, t in index.data._asdict().items():
        a = np.asarray(getattr(back.data, name))
        assert a.dtype == t.numpy().dtype, name
        np.testing.assert_array_equal(a, t.numpy())
    _assert_same(index.search(q), back.search(q))
    assert dict(back.stats.__dict__) == dict(index.stats.__dict__)
    with pytest.raises(ValueError, match="memory_budget"):
        load_index(str(tmp_path / "from_torch"), device="cpu",
                   memory_budget=0.5)


def test_build_against_the_reference_build(setup):
    """``DiskANNIndex.build`` / ``StarlingIndex.build`` on the same seed as
    the reference's builds. The port's Vamana graph and PQ codebooks match
    the reference's statistically, not bit for bit (``test_torch_core``),
    so the builds are held to recall within 0.02 of the reference's and to
    the same id-order pages; the Starling layout of one graph is the
    reference's exactly."""
    x, q, _, _, _, _ = setup
    x, q = x[:1000], q
    truth = brute_force_knn(x, q, 10)
    kw = dict(dim=32, graph_degree=12, build_beam=24, build_rounds=1,
              pq_subspaces=8, pq_iters=6)
    tcfg, jcfg = PageANNConfig(**kw), JConfig(**kw)
    disk = tbl.DiskANNIndex.build(x, tcfg, device="cpu")
    jdisk = jbl.DiskANNIndex.build(x, jcfg)
    np.testing.assert_array_equal(disk.data.page_of.numpy(),
                                  np.asarray(jdisk.data.page_of))
    assert int(disk.data.entry) == int(jdisk.data.entry)
    assert disk.data.nbrs.shape == jdisk.data.nbrs.shape
    assert disk.data.codebooks.shape == jdisk.data.codebooks.shape
    rt = recall_at_k(disk.search(q).ids, truth)
    rj = recall_at_k(np.asarray(jdisk.search(q).ids), truth)
    assert rt >= rj - 0.02, (rt, rj)
    nbrs = disk.data.nbrs.numpy()
    np.testing.assert_array_equal(
        tbl.StarlingIndex._layout(x, nbrs, tcfg),
        jbl.StarlingIndex._layout(x, nbrs, jcfg))
    star = tbl.StarlingIndex.build(x, tcfg, device="cpu")
    np.testing.assert_array_equal(star.data.nbrs.numpy(), nbrs)
    assert recall_at_k(star.search(q).ids, truth) >= rj - 0.02
    assert star.search(q).ios.mean() < disk.search(q).ios.mean()


@pytest.mark.parametrize("d", [32, 128])
def test_rerank_runs_page_gather_at_capacity_one(d):
    """The rerank views the vectors as (N, 1, d) pages: ``page_gather_l2``
    scores them in the difference form, and its launch plan (one warp an
    item, ``members_threads``) holds at capacity 1."""
    rng = np.random.default_rng(d)
    x = torch.as_tensor(rng.standard_normal((300, d)).astype(np.float32))
    q = torch.as_tensor(rng.standard_normal((1000, d)).astype(np.float32))
    ids = torch.as_tensor(rng.integers(0, 300, (1000, 5)))
    got = ops.page_gather_l2(x.view(300, 1, d), ids, q)
    assert got.shape == (1000, 5, 1)
    want = ((x[ids] - q[:, None, :]) ** 2).sum(-1)
    torch.testing.assert_close(got[:, :, 0], want, rtol=0, atol=0)
    for items in (1, 5, 1000 * 5, 64 * 5):
        threads = page_scan_k.members_threads(items)
        assert threads % 32 == 0 and 32 <= threads <= 256


def test_entry_points_default_to_the_gpu(setup, monkeypatch):
    x, _, _, nbrs, books, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tbl.DiskANNIndex.from_data(x, nbrs, books),
                 lambda: tbl.make_baseline_data(x, nbrs, books),
                 lambda: tbl.StarlingIndex.build(x[:50], PageANNConfig(
                     dim=32, pq_subspaces=8))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
