"""The port's build stages (repro_torch.core) against the JAX package's.

Each stage gets the same seeded numpy inputs in both packages; where a
stage's inputs come from an earlier stage, both get the same (the JAX
package's) so differences cannot compound. Exact where the arithmetic is
the same; PQ codes may differ on expanded-norm near-ties (counted), and the
Vamana adjacency is reported as a share of identical rows with no floor,
because one near-tie early in the sequential prune changes every later step.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.core import layout as jlayout
from repro.core import lsh as jlsh
from repro.core import page_graph as jpg
from repro.core import persist as jpersist
from repro.core import pq as jpq
from repro.core import vamana as jvamana
from repro.core.index import PageANNIndex as JaxIndex
from repro.core.index import recall_at_k as jax_recall
from repro.data import pipeline as jpipeline
from repro_torch.core import config as tconfig
from repro_torch.core import layout as tlayout
from repro_torch.core import lsh as tlsh
from repro_torch.core import page_graph as tpg
from repro_torch.core import persist as tpersist
from repro_torch.core import pq as tpq
from repro_torch.core import vamana as tvamana
from repro_torch.core.index import PageANNIndex, recall_at_k
from repro_torch.data import pipeline as tpipeline

# six test workers share the host's cores; the port's small tensors gain
# nothing from more intra-op threads than one
torch.set_num_threads(1)

N, D = 1200, 32


@pytest.fixture(scope="module")
def data():
    x = jpipeline.clustered_vectors(N, D, num_clusters=16, seed=0)
    q = jpipeline.query_vectors(x, 40, seed=1)
    return x, q


@pytest.fixture(scope="module")
def graph(data):
    x, _ = data
    return jvamana.build_vamana(x, degree=12, beam=24, rounds=1, seed=0)


# ------------------------------------------------------------ leaf modules
def test_config_is_a_copy_of_the_reference():
    for name in ("AdaptiveParams", "SearchParams", "MemoryBudget",
                 "DeltaParams", "FilterParams", "PageANNConfig"):
        j, t = getattr(jconfig, name), getattr(tconfig, name)
        def fields(cls):
            return [(f.name, getattr(f.default, "value", f.default))
                    for f in dataclasses.fields(cls)]

        assert fields(j) == fields(t), name
    for mode in tconfig.MemoryMode:
        jc = jconfig.PageANNConfig(dim=96, memory_mode=jconfig.MemoryMode(mode.value))
        tc = tconfig.PageANNConfig(dim=96, memory_mode=mode)
        assert jc.resolve_capacity() == tc.resolve_capacity()
        assert jpersist.config_to_json(jc) == tpersist.config_to_json(tc)
        assert tpersist.config_from_json(jpersist.config_to_json(jc)) == tc
    jp = jconfig.resolve_search_params(jconfig.SearchParams(), 7, None)
    tp = tconfig.resolve_search_params(tconfig.SearchParams(), 7, None)
    assert jp.to_json() == tp.to_json()


def test_vector_generators_are_bit_identical():
    for n, d, c, seed in ((500, 32, 8, 0), (300, 200, 64, 3)):
        xj = jpipeline.clustered_vectors(n, d, num_clusters=c, seed=seed)
        xt = tpipeline.clustered_vectors(n, d, num_clusters=c, seed=seed)
        np.testing.assert_array_equal(xj, xt)
        np.testing.assert_array_equal(jpipeline.query_vectors(xj, 17, seed=seed + 1),
                                      tpipeline.query_vectors(xt, 17, seed=seed + 1))


# ------------------------------------------------------------ LSH
def test_pack_bits_word_for_word():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (50, 128)).astype(np.uint32)
    bits[0] = 1                               # every word 0xFFFFFFFF
    bits[1, 31::32] = 1                       # sign bit of every word
    want = np.asarray(jlsh.pack_bits(jnp.asarray(bits)))
    got = tlsh.pack_bits(torch.as_tensor(bits.astype(np.int64))).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), want)


def test_hash_codes_word_for_word_and_sign_flips_reported(record_property):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((300, 64)).astype(np.float32)
    planes = rng.standard_normal((64, 64)).astype(np.float32)
    want = np.asarray(jlsh.hash_codes(jnp.asarray(x), jnp.asarray(planes)))
    got = tlsh.hash_codes(torch.as_tensor(x), torch.as_tensor(planes)).numpy()
    flipped = np.nonzero((got.view(np.uint32) != want).any(1))[0]
    record_property("sign_flip_rows", flipped.tolist())
    # a flip needs a projection within float32 rounding of zero
    proj = x @ planes
    for r in flipped:
        assert np.abs(proj[r]).min() < 1e-4, (r, np.abs(proj[r]).min())
    assert len(flipped) <= 2


def test_build_lsh_same_planes_samples_and_codes(data):
    x, _ = data
    codes = np.random.default_rng(2).integers(0, 256, (len(x), 8)).astype(np.uint8)
    j = jlsh.build_lsh(x, codes, bits=64, sample=256, seed=5)
    t = tlsh.build_lsh(x, codes, bits=64, sample=256, seed=5, device="cpu")
    np.testing.assert_array_equal(np.asarray(j.planes), t.planes.numpy())
    np.testing.assert_array_equal(np.asarray(j.sample_ids), t.sample_ids.numpy())
    np.testing.assert_array_equal(np.asarray(j.sample_pq), t.sample_pq.numpy())
    np.testing.assert_array_equal(np.asarray(j.sample_codes),
                                  t.sample_codes.numpy().view(np.uint32))
    assert j.memory_bytes == t.memory_bytes


@pytest.mark.parametrize("words", [1, 2, 4])
def test_hamming_distance_equal_sign_bit_included(words):
    """Exact: the port's int32 words hold the reference's uint32 bit
    patterns, and a set sign bit counts as one bit."""
    rng = np.random.default_rng(words)
    codes = rng.integers(0, 2**32, (64, words), dtype=np.uint64).astype(np.uint32)
    codes[0] = 0xFFFFFFFF
    codes[1] = 0x80000000
    codes[2] = 0
    for qcode in (codes[5], codes[0], codes[1],
                  np.full(words, 0x7FFFFFFF, np.uint32)):
        want = np.asarray(jlsh.hamming_distance(jnp.asarray(codes),
                                                jnp.asarray(qcode)))
        got = tlsh.hamming_distance(torch.as_tensor(codes.view(np.int32)),
                                    torch.as_tensor(qcode.view(np.int32)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits,top_t", [(32, 8), (64, 16)])
def test_lsh_query_equal_on_forced_ties(data, bits, top_t):
    """``LSHIndex.query``: ids and Hamming distances equal to the
    reference's. The sample holds each vector three times, so every
    distance is tied at least three ways and the order within a tie
    (the lower sample first, ``jnp.argsort``'s stable order) decides
    which ids fill the last places."""
    x, q = data
    xt = np.repeat(x[:200], 3, axis=0)
    codes = np.random.default_rng(3).integers(0, 256, (len(xt), 8)).astype(np.uint8)
    j = jlsh.build_lsh(xt, codes, bits=bits, sample=300, seed=4)
    t = tlsh.build_lsh(xt, codes, bits=bits, sample=300, seed=4, device="cpu")
    np.testing.assert_array_equal(np.asarray(j.sample_codes),
                                  t.sample_codes.numpy().view(np.uint32))
    cut_ties = 0
    for qi in list(q[:20]) + list(xt[:5]):
        jids, jham = j.query(jnp.asarray(qi), top_t)
        tids, tham = t.query(torch.as_tensor(qi), top_t)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(tham.numpy(), np.asarray(jham))
        full = np.asarray(jlsh.hamming_distance(j.sample_codes,
                                                jlsh.hash_codes(
                                                    jnp.asarray(qi)[None],
                                                    j.planes)[0]))
        last = np.asarray(jham)[-1]
        cut_ties += int((full == last).sum() > (np.asarray(jham) == last).sum())
    assert cut_ties > 0      # some top-T cut runs through a tie


# ------------------------------------------------------------ page graph
def test_grouping_edges_and_page_records_identical(data, graph):
    """Given the same Vamana adjacency, page grouping, page edges, id
    reassignment and the packed record bytes are identical."""
    x, _ = data
    cfg_j = jconfig.PageANNConfig(dim=D, pq_subspaces=8)
    cfg_t = tconfig.PageANNConfig(dim=D, pq_subspaces=8)
    cap = cfg_t.resolve_capacity()
    gj = jpg.group_pages(x, graph, cap, 2)
    gt = tpg.group_pages(x, graph, cap, 2)
    for f in ("pages", "page_of", "slot_of"):
        np.testing.assert_array_equal(getattr(gj, f), getattr(gt, f))
    ej = jpg.derive_page_edges(x, graph, gj, 48)
    et = tpg.derive_page_edges(x, graph, gt, 48)
    np.testing.assert_array_equal(ej, et)
    assert jpg.page_graph_stats(ej) == tpg.page_graph_stats(et)

    codes = np.random.default_rng(3).integers(0, 256, (len(x), 8)).astype(np.uint8)
    for mode in tconfig.MemoryMode:
        sj = jlayout.pack_pages(x, gj, ej, codes, dataclasses.replace(
            cfg_j, memory_mode=jconfig.MemoryMode(mode.value)))
        st = tlayout.pack_pages(x, gt, et, codes,
                                dataclasses.replace(cfg_t, memory_mode=mode),
                                device="cpu")
        assert np.asarray(sj.recs).tobytes() == st.recs.numpy().tobytes()
        for f in ("member_count", "nbr_ids", "nbr_count"):
            np.testing.assert_array_equal(np.asarray(getattr(sj, f)),
                                          getattr(st, f).numpy())
        for f in ("vecs", "nbr_codes", "new_to_old", "old_to_new"):
            np.testing.assert_array_equal(getattr(sj, f), getattr(st, f))
        assert sj.logical_page_bytes(cfg_j) == st.logical_page_bytes(cfg_t)
        assert sj.padded_tile_bytes() == st.padded_tile_bytes()
        recs = st.recs.numpy()
        np.testing.assert_array_equal(
            tlayout.unpack_member_vectors(recs, cap, D), st.vecs)
        if mode != tconfig.MemoryMode.MEM_ALL:
            np.testing.assert_array_equal(
                tlayout.unpack_neighbor_codes(recs, cap, D, 48, 8), st.nbr_codes)


@pytest.mark.parametrize("d,cap", [(200, 3), (16, 9)])
def test_pack_page_records_bytes_identical_both_packings(d, cap):
    rng = np.random.default_rng(d)
    vecs = rng.standard_normal((5, cap, d)).astype(np.float32)
    codes = rng.integers(0, 256, (5, 12, 4)).astype(np.uint8)
    assert jlayout.pack_page_records(vecs, codes).tobytes() == \
        tlayout.pack_page_records(vecs, codes).tobytes()


# ------------------------------------------------------------ PQ
def test_pq_lut_matches(data):
    x, q = data
    books = np.array(jpq.train_pq(x, 8, 256, 4, seed=0))
    got = tpq.pq_lut(torch.as_tensor(q), torch.as_tensor(books)).numpy()
    for i in range(len(q)):
        np.testing.assert_allclose(
            got[i], np.asarray(jpq.pq_lut(jnp.asarray(q[i]), jnp.asarray(books))),
            rtol=1e-5, atol=1e-5)


def test_pq_encode_equal_apart_from_counted_near_ties(data, record_property):
    x, _ = data
    books = np.array(jpq.train_pq(x, 8, 256, 4, seed=0))
    want = np.asarray(jpq.pq_encode(jnp.asarray(x), jnp.asarray(books)))
    got = tpq.pq_encode(torch.as_tensor(x), torch.as_tensor(books)).numpy()
    diff = np.argwhere(got != want)
    record_property("pq_code_mismatches", len(diff))
    dsub = D // 8
    for n, j in diff:
        sub = x[n, j * dsub:(j + 1) * dsub]
        dj = ((sub - books[j, want[n, j]]) ** 2).sum()
        dt = ((sub - books[j, got[n, j]]) ** 2).sum()
        assert abs(dj - dt) <= 1e-4 * max(1.0, dj), (n, j, dj, dt)
    assert len(diff) <= 0.001 * got.size


@pytest.mark.parametrize("lead", [(40,), (3, 7), ()])
def test_adc_distance_matches_reference(lead):
    """rtol = atol = 1e-5: the M selected entries are summed in another
    order than jnp's."""
    rng = np.random.default_rng(len(lead))
    lut = rng.random((8, 256)).astype(np.float32) * 10
    codes = rng.integers(0, 256, lead + (8,)).astype(np.uint8)
    want = np.asarray(jpq.adc_distance(jnp.asarray(codes), jnp.asarray(lut)))
    got = tpq.adc_distance(torch.as_tensor(codes), torch.as_tensor(lut))
    assert got.dtype == torch.float32 and tuple(got.shape) == lead
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pq_decode_bit_for_bit(data):
    """A gather: equal bit for bit."""
    x, _ = data
    books = np.array(jpq.train_pq(x, 8, 256, 4, seed=0))
    codes = np.asarray(jpq.pq_encode(jnp.asarray(x), jnp.asarray(books)))
    want = np.asarray(jpq.pq_decode(jnp.asarray(codes), jnp.asarray(books)))
    got = tpq.pq_decode(torch.as_tensor(codes), torch.as_tensor(books)).numpy()
    assert got.shape == (N, D)
    np.testing.assert_array_equal(got, want)


def test_train_pq_codebooks_quantize_as_well_as_the_reference(data):
    """The k-means seeds come from different generators, so codebooks
    match only statistically: the quantisation error of the port's books
    is within 5% of the reference's on the same data."""
    x, _ = data

    def mse(books):
        codes = np.asarray(jpq.pq_encode(jnp.asarray(x), jnp.asarray(books)))
        rec = np.asarray(jpq.pq_decode(jnp.asarray(codes), jnp.asarray(books)))
        return float(((rec - x) ** 2).sum(1).mean())

    bj = jpq.train_pq(x, 8, 256, 6, seed=0)
    bt = tpq.train_pq(x, 8, 256, 6, seed=0, device="cpu")
    assert bt.shape == bj.shape and bt.dtype == np.float32
    np.testing.assert_array_equal(
        bt, tpq.train_pq(x, 8, 256, 6, seed=0, device="cpu"))
    assert mse(bt) <= 1.05 * mse(bj), (mse(bt), mse(bj))


def test_train_pq_same_seed_same_books_and_codes_match_the_reference(
        data, record_property):
    """Two same-seed trainings give the same codebooks, and the reference
    encodes with the port's books as the port does: equal codes apart from
    counted expanded-norm near-ties (0 on this fixture)."""
    x, _ = data
    bt = tpq.train_pq(x, 8, 256, 4, seed=0, device="cpu")
    np.testing.assert_array_equal(
        bt, tpq.train_pq(x, 8, 256, 4, seed=0, device="cpu"))
    want = np.asarray(jpq.pq_encode(jnp.asarray(x), jnp.asarray(bt)))
    got = tpq.pq_encode(torch.as_tensor(x), torch.as_tensor(bt)).numpy()
    diff = np.argwhere(got != want)
    record_property("pq_code_mismatches", len(diff))
    dsub = D // 8
    for n, j in diff:
        sub = x[n, j * dsub:(j + 1) * dsub]
        dj = ((sub - bt[j, want[n, j]]) ** 2).sum()
        dt = ((sub - bt[j, got[n, j]]) ** 2).sum()
        assert abs(dj - dt) <= 1e-4 * max(1.0, dj), (n, j, dj, dt)
    assert len(diff) <= 0.001 * got.size


@pytest.mark.parametrize("ksub", [16, 256])
def test_kmeans_sums_each_centroid_serially_in_row_order(data, ksub):
    """A Lloyd step's centroid sums are a serial float32 sum over the
    members in row order (numpy's unbuffered ``add.at``): no atomic adds,
    so the card's sums do not depend on scheduling. Exact."""
    import inspect

    x, _ = data
    xsub = x[:, :4].copy()
    init = np.random.default_rng(ksub).permutation(len(xsub))[:ksub]
    got = tpq._kmeans_1sub(torch.as_tensor(xsub), torch.as_tensor(init),
                           ksub=ksub, iters=1).numpy()
    cents = xsub[init]
    assign = tpq._sq_dists(torch.as_tensor(xsub),
                           torch.as_tensor(cents)).argmin(1).numpy()
    sums = np.zeros_like(cents)
    np.add.at(sums, assign, xsub)
    counts = np.bincount(assign, minlength=ksub).astype(np.float32)
    want = np.where(counts[:, None] > 0,
                    sums / np.maximum(counts, 1)[:, None], cents)
    np.testing.assert_array_equal(got, want)
    src = inspect.getsource(tpq._kmeans_1sub)
    assert not any(op in src for op in ("index_add", "scatter_add", "index_put"))


# ------------------------------------------------------------ Vamana
def test_greedy_search_batch_matches(data, graph):
    x, _ = data
    pts = np.arange(0, N, 37)
    start = jvamana.medoid(x)
    assert start == tvamana.medoid(x)
    ij, dj = jvamana._greedy_search_batch(
        jnp.asarray(x), jnp.asarray(graph), jnp.asarray(x[pts]), start,
        beam=24, iters=12)
    it, dt = tvamana._greedy_search_batch(
        torch.as_tensor(x), torch.as_tensor(graph), torch.as_tensor(x[pts]),
        start, beam=24, iters=12)
    same = (np.asarray(ij) == it.numpy()).all(1)
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_allclose(dt.numpy()[same], np.asarray(dj)[same],
                               rtol=1e-5, atol=1e-5)


def test_robust_prune_and_ground_truth_identical(data):
    x, q = data
    rng = np.random.default_rng(4)
    for p in (0, 5, 77):
        ids = rng.integers(-1, N, 200).astype(np.int32)
        d = ((x[np.maximum(ids, 0)] - x[p]) ** 2).sum(-1)
        d[rng.random(200) < 0.1] = np.inf
        for alpha in (1.0, 1.2):
            np.testing.assert_array_equal(
                jvamana.robust_prune(p, ids, d, x, 12, alpha),
                tvamana.robust_prune(p, ids, d, x, 12, alpha))
    np.testing.assert_array_equal(jvamana.brute_force_knn(x, q, 10),
                                  tvamana.brute_force_knn(x, q, 10))


def test_build_vamana_same_seed_share_of_identical_rows(data, graph, record_property):
    x, _ = data
    got = tvamana.build_vamana(x, degree=12, beam=24, rounds=1, seed=0,
                               device="cpu")
    assert got.shape == graph.shape and got.dtype == np.int32
    valid = got != tvamana.PAD
    assert (got[valid] >= 0).all() and (got[valid] < N).all()
    assert not (got == np.arange(N)[:, None]).any()      # no self loops
    assert valid.sum(1).min() >= 1
    share = float((got == graph).all(1).mean())
    record_property("identical_adjacency_rows", share)
    print(f"identical adjacency rows: {share:.4f}")


# ------------------------------------------------------------ end to end
def test_build_recall_within_0_005_of_the_jax_build(data):
    x, q = data
    truth = jvamana.brute_force_knn(x, q, 10)
    kw = dict(dim=D, graph_degree=12, build_beam=24, build_rounds=1,
              pq_subspaces=8, lsh_sample=256, lsh_entries=8, beam_width=48,
              max_hops=32)
    ji = JaxIndex.build(x, jconfig.PageANNConfig(**kw))
    ti = PageANNIndex.build(x, tconfig.PageANNConfig(**kw), device="cpu")
    rj = jax_recall(ji.search(q, k=10).ids, truth)
    rt = recall_at_k(ti.search(q, k=10).ids, truth)
    assert rt >= rj - 0.005, (rt, rj)
    assert ti.stats.pages == ti.store.num_pages
    assert ti.stats.capacity == ji.stats.capacity
    assert ti.stats.padded_tile_bytes == ji.stats.padded_tile_bytes


@pytest.fixture(scope="module")
def jax_artifact(data, tmp_path_factory):
    """(the reference's HYBRID index over ``data``, its saved directory)."""
    x, _ = data
    cfg = jconfig.PageANNConfig(dim=D, graph_degree=12, build_beam=24,
                                build_rounds=1, pq_subspaces=8,
                                lsh_sample=256, lsh_entries=8)
    ji = JaxIndex.build(x, cfg)
    directory = str(tmp_path_factory.mktemp("core") / "idx.pageann")
    ji.save(directory)
    return ji, directory


def test_is_index_dir_equal(jax_artifact, tmp_path):
    _, directory = jax_artifact
    empty = tmp_path / "empty"
    empty.mkdir()
    a_file = tmp_path / "manifest.json"
    a_file.write_text("{}")
    for path in (directory, str(empty), str(a_file), str(tmp_path / "none")):
        assert tpersist.is_index_dir(path) == jpersist.is_index_dir(path)
    assert tpersist.is_index_dir(directory)


def test_reassigned_codes_equal_on_a_store_carried_across(data, jax_artifact):
    """Equal: a store the reference built, loaded by the port, encoded with
    the reference's disk codebooks (pad slots encode the zero vector)."""
    x, _ = data
    ji, directory = jax_artifact
    ti = tpersist.load_pageann(directory, device="cpu")
    books = np.asarray(ji.tier.disk_codebooks)
    want = jlayout.reassigned_codes(x, ji.store, books)
    got = tlayout.reassigned_codes(x, ti.store, books, device="cpu")
    assert got.dtype == np.uint8
    assert got.shape == (ji.store.num_pages * ji.store.capacity, 8)
    np.testing.assert_array_equal(got, want)


_CFG = tconfig.PageANNConfig(dim=D, pq_subspaces=8)
_X = np.zeros((10, D), np.float32)
_CODES = np.zeros((10, 8), np.uint8)


@pytest.mark.parametrize("call", [
    lambda: PageANNIndex.build(_X, _CFG),
    lambda: tvamana.build_vamana(_X, degree=4, beam=8, rounds=1),
    lambda: tpq.train_pq(_X, 8, 4, 1),
    lambda: tlsh.build_lsh(_X, _CODES, bits=32, sample=4),
    lambda: tlayout.pack_pages(_X, None, None, None, _CFG),
    lambda: tlayout.build_memory_tier(_CODES, np.zeros((8, 4, 4)), np.zeros(
        (8, 4, 4)), tconfig.MemoryMode.HYBRID),
], ids=["index_build", "build_vamana", "train_pq", "build_lsh", "pack_pages",
        "build_memory_tier"])
def test_entry_points_default_to_the_gpu(call, monkeypatch):
    """Every entry point that places state on a device defaults to the GPU:
    with no CUDA device the default raises before any work instead of
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_cuda_entry_points_pin_full_fp32(monkeypatch):
    """Resolving a CUDA device turns TF32 off for matrix products and
    convolutions, so distances on the card keep the reference's FP32."""
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cuda").type == "cuda"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert resolve_device("cpu").type == "cpu"
