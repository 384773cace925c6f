"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one. The module
imports no JAX, so it runs on a GPU host that has only PyTorch (the seeded
page-scan inputs below are shared with ``test_torch_kernels.py``):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance for the float kernels: rtol 1e-5, atol 1e-4, because the kernel
sums in another order than the plain version; ``hamming`` and
``hamming_topk`` are exact, and so
are a staged record against the same record read by page id and the
members-only scores against the ADC variant's (every variant sums a member
in one order). ``pq_lut`` is held to its plain version at rtol = atol =
1e-5 and equals a serial float32 sum exactly. ``l2_distance`` computes the
expanded form
``(|q|^2 - 2 q.x) + |x|^2``, whose rounding error scales with the norms:
it is held to rtol 1e-5 and atol 1e-6 (max|q|^2 + max|x|^2).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.layout import pack_page_records
from repro_torch.kernels import ops

# (pages, capacity, dim, neighbours per page, PQ subspaces, pages per hop)
PAGE_CASES = [
    (7, 4, 16, 12, 4, 3),
    (23, 28, 32, 48, 8, 5),     # the test-suite geometry, d = 32
    (11, 5, 128, 48, 16, 8),    # d == full lane width
    (5, 3, 200, 12, 4, 4),      # d > 128: vectors span 2 record rows
    (4, 6, 384, 16, 8, 2),
    (50, 6, 128, 48, 16, 16),   # large b: a block loops over page chunks
    (9, 5, 18, 20, 6, 3),       # M outside 4/8/16; q rows not 16-byte aligned
]
# capacities above a warp's 32 lanes, at d = 32 / 128 / 200: the
# members-only kernel scores them in passes of 32
WIDE_CASES = [
    (6, 40, 32, 12, 4, 3),
    (5, 33, 128, 12, 4, 3),
    (4, 34, 200, 12, 8, 2),
]
# queries per hop: one, a few (late hops of a frozen batch), fewer than the
# card's SMs, and more
NQ_CASES = [1, 3, 64, 300]


def page_inputs(p, cap, d, rp, m, b, nq=3):
    """Packed records (p, rows, 128), page ids (nq, b), queries (nq, d) and
    ADC tables (nq, m, 256), all from one seed."""
    rng = np.random.default_rng(p * 100 + cap)
    vecs = rng.standard_normal((p, cap, d)).astype(np.float32)
    codes = rng.integers(0, 256, (p, rp, m)).astype(np.uint8)
    recs = pack_page_records(vecs, codes)
    ids = rng.integers(0, p, (nq, b)).astype(np.int32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    lut = rng.standard_normal((nq, m, 256)).astype(np.float32)
    return recs, ids, q, lut


# (queries, vectors, dim) for l2_distance: edge tiles on both axes, d below,
# at and above one 32-wide slab, and the delta scan's d = 128
L2_CASES = [(3, 5, 7), (70, 130, 32), (64, 64, 128), (33, 257, 200)]


def l2_inputs(nq, n, d):
    """Clustered-looking (Q, d) queries and (N, d) vectors from one seed,
    with query 0 equal to vector 0 (a self-match)."""
    rng = np.random.default_rng(nq * 1000 + n + d)
    center = rng.standard_normal(d).astype(np.float32)
    x = (center + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    q = (center + 0.3 * rng.standard_normal((nq, d))).astype(np.float32)
    q[0] = x[0]
    return q, x


def l2_atol(q, x) -> float:
    """The expanded form's tolerance: 1e-6 (max|q|^2 + max|x|^2)."""
    q, x = (np.asarray(a, np.float64) for a in (q, x))
    return 1e-6 * float((q * q).sum(-1).max() + (x * x).sum(-1).max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nq", NQ_CASES)
@pytest.mark.parametrize("adc", [True, False], ids=["adc", "members"])
@pytest.mark.parametrize("p,cap,d,rp,m,b", PAGE_CASES)
def test_page_scan_kernel_matches_plain(cuda, p, cap, d, rp, m, b, adc, nq):
    recs, ids, q, lut = (torch.as_tensor(a).to(cuda)
                         for a in page_inputs(p, cap, d, rp, m, b, nq=nq))
    kw = dict(capacity=cap, dim=d, rp=rp, compute_adc=adc)
    name = "page_scan" if adc else "page_scan_members"
    before = ops.launch_counts()[name]
    got = ops.page_scan(recs, ids, q, lut, **kw)
    assert ops.launch_counts()[name] == before + 1
    want = ops.page_scan(recs, ids, q, lut, impl="plain", **kw)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    if adc:
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("nq", NQ_CASES)
@pytest.mark.parametrize("source", ["ids", "staged"])
@pytest.mark.parametrize("adc", [True, False], ids=["adc", "members"])
@pytest.mark.parametrize("p,cap,d,rp,m,b", PAGE_CASES)
def test_masked_and_staged_page_scans_match_plain(cuda, p, cap, d, rp, m, b,
                                                 adc, source, nq):
    """The masked variants (filtered search) and the staged ones (streamed
    tier) against their plain versions; a staged record scores exactly
    like the same record read by page id."""
    recs, ids, q, lut = (torch.as_tensor(a).to(cuda)
                         for a in page_inputs(p, cap, d, rp, m, b, nq=nq))
    rng = np.random.default_rng(p + cap)
    mask = torch.as_tensor(
        (rng.random((nq, b, cap)) < 0.5).astype(np.float32)).to(cuda)
    mask[0, 0, 0] = float("nan")              # NaN fails the test, as > 0
    staged = recs[ids.long()].contiguous()
    kw = dict(capacity=cap, dim=d, rp=rp, compute_adc=adc)
    for member_mask in (mask, None):
        if source == "ids":
            run = lambda impl=None: ops.page_scan(          # noqa: E731
                recs, ids, q, lut, member_mask=member_mask, impl=impl, **kw)
        else:
            run = lambda impl=None: ops.page_scan_recs(     # noqa: E731
                staged, q, lut, member_mask=member_mask, impl=impl, **kw)
        name = ("page_scan" + ("_recs" if source == "staged" else "")
                + ("" if adc else "_members")
                + ("_masked" if member_mask is not None else ""))
        before = ops.launch_counts()[name]
        got = run()
        assert ops.launch_counts()[name] == before + 1
        want = run("plain")
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
        if adc:
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)
        if member_mask is not None:
            assert torch.isinf(got[0][~(mask > 0)]).all()
        by_id = ops.page_scan(recs, ids, q, lut, member_mask=member_mask, **kw)
        assert torch.equal(got[0], by_id[0])
        if adc:
            assert torch.equal(got[1], by_id[1])


@pytest.mark.cuda
@pytest.mark.parametrize("adc,override", [
    (True, dict(pages_per_block=1)), (True, dict(pages_per_block=3)),
    (True, dict(pages_per_block=16, pages_per_chunk=1)),
    (True, dict(threads=128)), (True, dict(threads=64)),
    (True, dict(threads=256)),
    (False, dict(threads=64)), (False, dict(threads=256))], ids=str)
@pytest.mark.parametrize("p,cap,d,rp,m,b", PAGE_CASES)
def test_page_scan_plans_score_bit_for_bit_alike(cuda, monkeypatch, p, cap, d,
                                                 rp, m, b, adc, override):
    """Any launch plan (pages per block and per chunk, threads) gives the
    same bits: the plan only changes which block sums what, not the sums."""
    from repro_torch.kernels import page_scan as page_scan_k

    recs, ids, q, lut = (torch.as_tensor(a).to(cuda)
                         for a in page_inputs(p, cap, d, rp, m, b, nq=64))
    mask = torch.as_tensor(np.random.default_rng(p).random((64, b, cap)) < 0.5
                           ).float().to(cuda)
    kw = dict(capacity=cap, dim=d, rp=rp, compute_adc=adc, member_mask=mask)
    want = ops.page_scan(recs, ids, q, lut, **kw)
    plan = page_scan_k.launch_plan
    monkeypatch.setattr(page_scan_k, "launch_plan",
                        lambda *a, **k: plan(*a, **k, **override))
    for got in (ops.page_scan(recs, ids, q, lut, **kw),
                ops.page_scan_recs(recs[ids.long()].contiguous(), q, lut, **kw)):
        assert torch.equal(got[0], want[0])
        if adc:
            assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["ids", "staged"])
@pytest.mark.parametrize("p,cap,d,rp,m,b", PAGE_CASES + WIDE_CASES)
def test_members_only_scores_equal_the_adc_variants(cuda, p, cap, d, rp, m, b,
                                                    source):
    """On the same records (which hold code rows) the members-only kernel
    scores every member bit for bit like the ADC one; a staged record like
    the same record by page id; masked members, NaN masks included, score
    +inf exactly where the mask is not > 0."""
    recs, ids, q, lut = (torch.as_tensor(a).to(cuda)
                         for a in page_inputs(p, cap, d, rp, m, b, nq=64))
    rng = np.random.default_rng(p + cap + 1)
    mask = torch.as_tensor(
        (rng.random((64, b, cap)) < 0.5).astype(np.float32)).to(cuda)
    mask[0, 0, 0] = float("nan")
    mask[1, 0, 0] = -1.0
    staged = recs[ids.long()].contiguous()
    for member_mask in (None, mask):
        kw = dict(capacity=cap, dim=d, rp=rp, member_mask=member_mask)

        def run(adc, impl=None):
            if source == "staged":
                return ops.page_scan_recs(staged, q, lut, compute_adc=adc,
                                          impl=impl, **kw)
            return ops.page_scan(recs, ids, q, lut, compute_adc=adc,
                                 impl=impl, **kw)

        md, nd = run(False)
        assert nd is None
        assert torch.equal(md, run(True)[0])
        assert torch.equal(md, ops.page_scan(recs, ids, q, lut,
                                             compute_adc=False, **kw)[0])
        torch.testing.assert_close(md, run(False, "plain")[0], rtol=1e-5,
                                   atol=1e-4)
        if member_mask is not None:
            assert torch.equal(torch.isinf(md), ~(mask > 0))
        else:
            assert torch.isfinite(md).all()


@pytest.mark.cuda
def test_streamed_and_filtered_search_on_the_card(cuda, tmp_path):
    """Streamed search equals resident search exactly on the card, with and
    without a filter, and goes through the staged kernel."""
    from repro_torch.core import (MemoryMode, MetadataSchema, Num, PageANNConfig,
                                  PageANNIndex, Tag, load_pageann)
    from repro_torch.data.pipeline import clustered_vectors, query_vectors

    x = clustered_vectors(600, 32, num_clusters=8, seed=0)
    q = query_vectors(x, 64, seed=1)
    rng = np.random.default_rng(7)
    meta = {"lang": rng.choice(["en", "de", "fr"], 600).tolist(),
            "score": rng.uniform(0.0, 1.0, 600).tolist()}
    cfg = PageANNConfig(dim=32, graph_degree=12, build_beam=24, build_rounds=1,
                        pq_subspaces=8, lsh_sample=256, lsh_entries=8,
                        beam_width=48, max_hops=48, memory_mode=MemoryMode.HYBRID)
    index = PageANNIndex.build(
        x, cfg, schema=MetadataSchema(tags=("lang",), numerics=("score",)),
        metadata=meta, device=cuda)
    index.save(str(tmp_path / "idx"))
    resident = load_pageann(str(tmp_path / "idx"), device=cuda)
    streamed = load_pageann(str(tmp_path / "idx"), device=cuda, memory_budget=0.25)
    for expr in (None, Num("score").le(0.1), (Tag("lang") == "en") & Num("score").le(0.5)):
        ops.reset_launch_counts()
        got = streamed.search(q, k=10, filter=expr)
        counts = ops.launch_counts()
        want = resident.search(q, k=10, filter=expr)
        for field in got._fields:
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        suffix = "" if expr is None else "_masked"
        assert counts["page_scan_recs" + suffix] > 0 and counts["page_scan" + suffix] > 0
        plain = streamed.search(q, k=10, filter=expr, impl="plain")
        assert (plain.ids == got.ids).all(1).mean() >= 0.95
    assert streamed.fetch_stats()["pages_fetched"] > 0


@pytest.mark.cuda
def test_pq_adc_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    for shape in ((64, 240, 32), (64, 16, 16), (3, 1000, 8)):
        nq, n, m = shape
        codes = torch.as_tensor(rng.integers(0, 256, shape).astype(np.uint8)).to(cuda)
        lut = torch.as_tensor(rng.random((nq, m, 256)).astype(np.float32)).to(cuda)
        torch.testing.assert_close(ops.pq_adc(codes, lut),
                                   ops.pq_adc(codes, lut, impl="plain"),
                                   rtol=1e-5, atol=1e-4)


# rows a query for pq_adc_gather: one, the entry estimates' 16, the
# HYBRID re-score's 240, 257 (a thread with two rows); M from 8 to 33 (16-byte
# code rows and byte rows), K below 256, (9, 17): a table of 153 floats goes
# by the plain copy loop
GATHER_N = [1, 16, 240, 257]
GATHER_MK = [(8, 256), (16, 256), (32, 256), (33, 200), (32, 100), (9, 17)]


def adc_serial(table, ids, lut):
    """The kernel's sum in numpy: one float32 accumulator a row, adding
    lut[q, j, min(code, K - 1)] for j = 0 .. M-1 in order."""
    codes = np.minimum(table[ids], lut.shape[2] - 1).astype(np.int64)
    qi = np.arange(len(ids))[:, None]
    acc = np.zeros(ids.shape, np.float32)
    for j in range(table.shape[1]):
        acc = acc + lut[qi, j, codes[:, :, j]]
    return acc


def _misaligned(t, cuda):
    """A copy of ``t`` on the card whose data starts one element past an
    allocation's start (not 16-byte aligned)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", GATHER_MK)
@pytest.mark.parametrize("n", GATHER_N)
def test_pq_adc_gather_kernel_matches_plain(cuda, n, m, k):
    """The fused gather against its plain version (rtol 1e-5, atol 1e-4:
    the plain version sums in another order) and bit for bit against a
    serial float32 sum, the pre-gathered ``pq_adc`` kernel, int32 and
    strided ids, and misaligned tables (the byte and plain-loop paths).
    Each call is one ``pq_adc`` launch and nothing else."""
    rng = np.random.default_rng(n * 100 + m + k)
    nq, r = 37, 500
    table = rng.integers(0, k, (r, m)).astype(np.uint8)
    ids = rng.integers(0, r, (nq, n + 3))
    lut = rng.random((nq, m, k)).astype(np.float32)
    want = adc_serial(table, ids[:, :n], lut)
    tt, tl = (torch.as_tensor(a).to(cuda) for a in (table, lut))
    wide = torch.as_tensor(ids).to(cuda)
    ti = wide[:, :n].contiguous()
    before = ops.launch_counts()
    got = ops.pq_adc_gather(tt, ti, tl)
    after = ops.launch_counts()
    assert after["pq_adc"] == before["pq_adc"] + 1
    assert {k_: v for k_, v in after.items() if k_ != "pq_adc"} == \
        {k_: v for k_, v in before.items() if k_ != "pq_adc"}
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    torch.testing.assert_close(got, ops.pq_adc_gather(tt, ti, tl, impl="plain"),
                               rtol=1e-5, atol=1e-4)
    for other in (ops.pq_adc(tt[ti], tl),
                  ops.pq_adc_gather(tt, ti.to(torch.int32), tl),
                  ops.pq_adc_gather(tt, wide[:, :n], tl),
                  ops.pq_adc_gather(_misaligned(tt, cuda), ti, tl),
                  ops.pq_adc_gather(tt, ti, _misaligned(tl, cuda))):
        assert torch.equal(other, got)


@pytest.mark.cuda
def test_pq_adc_kernel_clamps_codes_to_k(cuda):
    """Codes at or past K read the table's last column, in both entry
    points (exact against the serial sum)."""
    rng = np.random.default_rng(9)
    table = rng.integers(0, 256, (300, 32)).astype(np.uint8)
    ids = rng.integers(0, 300, (50, 240))
    lut = rng.random((50, 32, 100)).astype(np.float32)
    want = adc_serial(table, ids, lut)
    tt, ti, tl = (torch.as_tensor(a).to(cuda) for a in (table, ids, lut))
    np.testing.assert_array_equal(ops.pq_adc_gather(tt, ti, tl).cpu().numpy(), want)
    np.testing.assert_array_equal(ops.pq_adc(tt[ti], tl).cpu().numpy(), want)


# (queries, d, M, K) for pq_lut: the cells' tables (d = 128 and 192, M = 16
# and 32), the RAG path's d = 2048 (a codebook staged in chunks), one query,
# queries that leave a tile part-filled, and K that is not a multiple of 4
LUT_CASES = [(1000, 128, 16, 256), (1000, 128, 32, 256), (1000, 192, 16, 256),
             (1000, 192, 32, 256), (300, 2048, 16, 256), (300, 2048, 32, 256),
             (1, 128, 16, 256), (37, 192, 32, 256), (70, 96, 8, 100),
             (5, 24, 3, 17)]


def lut_serial(q, books):
    """The kernel's sums in numpy: for j = 0 .. dsub-1 in order, the
    float32 difference, its float32 square, and a float32 running sum."""
    m, k, dsub = books.shape
    qs = q.reshape(q.shape[0], m, 1, dsub)
    acc = np.zeros((q.shape[0], m, k), np.float32)
    for j in range(dsub):
        t = qs[..., j] - books[None, :, :, j]
        acc = acc + t * t
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("nq,d,m,k", LUT_CASES)
def test_pq_lut_kernel_matches_plain(cuda, nq, d, m, k):
    """The tables against the plain formula (rtol = atol = 1e-5: PyTorch's
    reduction sums in another order) and bit for bit against a serial
    float32 sum; each call is one ``pq_lut`` launch and nothing else."""
    rng = np.random.default_rng(nq * 7 + d + m + k)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    books = rng.standard_normal((m, k, d // m)).astype(np.float32)
    tq, tb = torch.as_tensor(q).to(cuda), torch.as_tensor(books).to(cuda)
    before = ops.launch_counts()
    got = ops.pq_lut(tq, tb)
    after = ops.launch_counts()
    assert after["pq_lut"] == before["pq_lut"] + 1
    assert {n: v for n, v in after.items() if n != "pq_lut"} == \
        {n: v for n, v in before.items() if n != "pq_lut"}
    assert got.shape == (nq, m, k) and got.dtype == torch.float32
    torch.testing.assert_close(got, ops.pq_lut(tq, tb, impl="plain"),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.cpu().numpy(), lut_serial(q, books))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 32])
def test_pq_lut_kernel_allocates_nothing_but_its_output(cuda, m):
    """At a cell's batch (10,000 queries, d = 192) the device memory grows
    by the (Q, M, K) tables and at most 1 MiB more: no (Q, M, K, dsub)
    intermediate exists."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    q = torch.randn((10_000, 192), generator=gen, device=cuda)
    books = torch.randn((m, 256, 192 // m), generator=gen, device=cuda)
    ops.pq_lut(q[:8], books)           # the library is loaded, not timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    out = ops.pq_lut(q, books)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated(cuda) - base
    assert out.numel() * 4 <= grew <= out.numel() * 4 + 2**20


@pytest.mark.cuda
def test_hamming_kernel_matches_plain_exactly(cuda):
    rng = np.random.default_rng(1)
    for s, w, nq in ((1024, 2, 64), (300, 5, 7)):
        c = torch.as_tensor(rng.integers(-2**31, 2**31, (s, w)).astype(np.int32)).to(cuda)
        qc = torch.as_tensor(rng.integers(-2**31, 2**31, (nq, w)).astype(np.int32)).to(cuda)
        assert torch.equal(ops.hamming(c, qc), ops.hamming(c, qc, impl="plain"))


def _words(rng, *shape):
    return rng.integers(-2**31, 2**31, shape).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("s,w", [(1024, 1), (1023, 2), (301, 3), (33, 5),
                                 (6, 2), (1030, 4)])
def test_hamming_kernel_matches_plain_on_any_shape_and_alignment(cuda, s, w):
    """4 samples a thread with 16-byte loads and stores, and the scalar
    paths: S % 4 != 0, W other than 2, a code view 4 bytes off alignment."""
    rng = np.random.default_rng(s + w)
    qc = torch.as_tensor(_words(rng, 37, w)).to(cuda)
    buf = torch.as_tensor(_words(rng, s * w + 1)).to(cuda)
    for c in (buf[:-1].view(s, w), buf[1:].view(s, w)):   # aligned, offset
        assert c.is_contiguous()
        assert torch.equal(ops.hamming(c, qc), ops.hamming(c, qc, impl="plain"))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 15, 16, 17, "S/2", "S"])
@pytest.mark.parametrize("s,w,nq", [(1024, 2, 1000), (1000, 2, 64), (33, 1, 5),
                                    (300, 3, 7), (77, 5, 3), (2, 2, 2),
                                    (1030, 2, 9), (4100, 2, 5)])
@pytest.mark.parametrize("kind", ["ties", "random"])
def test_hamming_topk_kernel_equals_plain_exactly(cuda, kind, s, w, nq, t):
    """The fused sweep and stable top-T against the plain sweep and stable
    sort: values and indices equal, with runs of equal values across the
    t-th place (``ties``: every code one of 3 patterns), S not a multiple
    of 32, and the main path's Q = 1,000 x S = 1,024. A warp keeps its
    first 4 chunks of 32 samples (S <= 1,024) and scores the rest again in
    each pass: S = 1,030 and 4,100 with t = S / 2 and S place entries from
    those chunks."""
    t = {"S": s, "S/2": max(1, s // 2)}.get(t, t)
    t = min(t, s)
    rng = np.random.default_rng(s * 7 + w + nq)
    if kind == "ties":
        codes = _words(rng, 3, w)[rng.integers(0, 3, s)]
    else:
        codes = _words(rng, s, w)
    c = torch.as_tensor(codes).to(cuda)
    qc = torch.as_tensor(_words(rng, nq, w)).to(cuda)
    before = ops.launch_counts()["hamming"]
    vals, idx = ops.hamming_topk(c, qc, t)
    assert ops.launch_counts()["hamming"] == before + 1
    want = ops.hamming_topk(c, qc, t, impl="plain")
    assert torch.equal(vals, want[0]) and torch.equal(idx, want[1])
    if kind == "ties" and s >= 300 and t < s:
        # runs of ~S/3 equal values: the t-th place splits one in every row
        sweep = ops.hamming(c, qc)
        at_t = torch.sort(sweep, dim=1, stable=True).values[:, t - 1:t + 1]
        assert torch.equal(at_t[:, 0], at_t[:, 1])


@pytest.mark.cuda
def test_hamming_topk_kernel_refuses_t_above_the_sample(cuda):
    c = torch.zeros((8, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="t = 9"):
        ops.hamming_topk(c, c[:3], 9)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,n,d", L2_CASES + [(1000, 4096, 128)])
def test_l2_distance_kernel_matches_plain(cuda, nq, n, d):
    q, x = (torch.as_tensor(a).to(cuda) for a in l2_inputs(nq, n, d))
    before = ops.launch_counts()["l2_distance"]
    got = ops.l2_distance(q, x)
    assert ops.launch_counts()["l2_distance"] == before + 1
    want = ops.l2_distance(q, x, impl="plain")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=l2_atol(q.cpu(), x.cpu()))
    assert abs(float(got[0, 0])) <= l2_atol(q.cpu(), x.cpu())
    # a bf16 caller is cast to f32 in the wrapper
    got16 = ops.l2_distance(q.bfloat16(), x.bfloat16())
    want16 = ops.l2_distance(q.bfloat16().float(), x.bfloat16().float(),
                             impl="plain")
    torch.testing.assert_close(got16, want16, rtol=1e-5,
                               atol=l2_atol(q.cpu(), x.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("nq,n,d", L2_CASES + [(1000, 4096, 128)])
def test_l2_distance_keep_kernel_matches_plain(cuda, nq, n, d):
    """The keep mask in the epilogue: +inf exactly where keep is false, the
    unmasked bits elsewhere, the plain version within the expanded form's
    tolerance, a self-match exactly 0; the 4-byte copy path (a misaligned
    x) gives the same bits."""
    q, x = (torch.as_tensor(a).to(cuda) for a in l2_inputs(nq, n, d))
    keep = torch.as_tensor(np.random.default_rng(n + d).random(n) < 0.6).to(cuda)
    keep[0] = True
    before = ops.launch_counts()["l2_distance"]
    got = ops.l2_distance(q, x, keep)
    assert ops.launch_counts()["l2_distance"] == before + 1
    full = ops.l2_distance(q, x)
    assert torch.equal(got, torch.where(keep[None, :], full, float("inf")))
    torch.testing.assert_close(got, ops.l2_distance(q, x, keep, impl="plain"),
                               rtol=1e-5, atol=l2_atol(q.cpu(), x.cpu()))
    assert float(got[0, 0]) == 0.0
    assert torch.equal(ops.l2_distance(q, _misaligned(x, cuda), keep), got)


@pytest.mark.cuda
def test_delta_scan_kernel_equals_the_separate_mask_pass(cuda):
    """The delta scan through the masked kernel gives the bits of the
    distances, then ``where(keep, d, inf)``, then the stable sort."""
    q, x = (torch.as_tensor(a).to(cuda) for a in l2_inputs(200, 4096, 128))
    rng = np.random.default_rng(5)
    live = torch.as_tensor(rng.random(4096) < 0.5).to(cuda)
    mask = torch.as_tensor(rng.random(4096) < 0.5).to(cuda)
    for m in (None, mask):
        keep = live if m is None else live & m
        d = torch.where(keep[None, :], ops.l2_distance(q, x), float("inf"))
        vals, idx = torch.sort(d, dim=-1, stable=True)
        dists, slots = ops.delta_scan(q, x, live, 10, mask=m)
        assert torch.equal(dists, vals[:, :10])
        assert torch.equal(slots, idx[:, :10].to(torch.int32))


@pytest.mark.cuda
def test_train_pq_is_deterministic_on_the_card(cuda):
    """Two same-seed PQ trainings on the card give the same codebooks bit
    for bit (the k-means sums are a segment sum, no atomic adds)."""
    from repro_torch.core import pq
    from repro_torch.data.pipeline import clustered_vectors

    x = clustered_vectors(20_000, 64, num_clusters=32, seed=3)
    books = pq.train_pq(x, 16, 256, 8, seed=0, device=cuda)
    np.testing.assert_array_equal(books, pq.train_pq(x, 16, 256, 8, seed=0,
                                                     device=cuda))
    codes = pq.pq_encode(torch.as_tensor(x).to(cuda),
                         torch.as_tensor(books).to(cuda))
    assert torch.equal(codes, pq.pq_encode(torch.as_tensor(x).to(cuda),
                                           torch.as_tensor(books).to(cuda)))


@pytest.mark.cuda
@pytest.mark.parametrize("p,cap,d,b", [(7, 4, 16, 3), (1667, 6, 128, 5),
                                       (5, 3, 200, 4), (4, 30, 384, 2)])
def test_page_gather_l2_kernel_matches_plain(cuda, p, cap, d, b):
    rng = np.random.default_rng(p + cap + d)
    pages = torch.as_tensor(rng.standard_normal((p, cap, d)).astype(np.float32)).to(cuda)
    ids = torch.as_tensor(rng.integers(0, p, (64, b)).astype(np.int32)).to(cuda)
    q = torch.as_tensor(rng.standard_normal((64, d)).astype(np.float32)).to(cuda)
    before = ops.launch_counts()["page_gather_l2"]
    got = ops.page_gather_l2(pages, ids, q)
    assert ops.launch_counts()["page_gather_l2"] == before + 1
    torch.testing.assert_close(got, ops.page_gather_l2(pages, ids, q, impl="plain"),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1, 2, 3, 5, 6, 7, 8])
@pytest.mark.parametrize("d", [32, 100, 128, 200, 256])
def test_page_gather_l2_kernel_any_width_and_capacity(cuda, d, cap):
    """Every d (below, at and above 128, not a multiple of 32) and capacity
    1-8, at Q = 1 (one block of one warp) and Q = 300; ids outside [0, P)
    score the clamped page, as an XLA gather reads it."""
    rng = np.random.default_rng(d * 10 + cap)
    p = 13
    pages = torch.as_tensor(rng.standard_normal((p, cap, d)).astype(np.float32)).to(cuda)
    for nq in (1, 300):
        ids = rng.integers(-3, p + 3, (nq, 5)).astype(np.int32)
        q = torch.as_tensor(rng.standard_normal((nq, d)).astype(np.float32)).to(cuda)
        got = ops.page_gather_l2(pages, torch.as_tensor(ids).to(cuda), q)
        clamped = torch.as_tensor(np.clip(ids, 0, p - 1)).to(cuda)
        torch.testing.assert_close(
            got, ops.page_gather_l2(pages, clamped, q, impl="plain"),
            rtol=1e-5, atol=1e-4)
        assert torch.equal(got, ops.page_gather_l2(pages, clamped, q))


@pytest.mark.cuda
@pytest.mark.parametrize("cap,d", [(6, 128), (7, 128), (28, 32), (5, 100),
                                   (3, 200), (8, 256), (33, 128), (40, 32)])
def test_page_gather_l2_kernel_equals_page_scan_members_bit_for_bit(cuda, cap, d):
    """One member sum (csrc/member_l2.cuh) in both kernels: on the same
    vectors, packed into records for page_scan, the scores are equal."""
    rng = np.random.default_rng(cap * 1000 + d)
    vecs = rng.standard_normal((19, cap, d)).astype(np.float32)
    codes = rng.integers(0, 256, (19, 12, 4)).astype(np.uint8)
    recs = torch.as_tensor(pack_page_records(vecs, codes)).to(cuda)
    ids = torch.as_tensor(rng.integers(0, 19, (300, 5)).astype(np.int32)).to(cuda)
    q = torch.as_tensor(rng.standard_normal((300, d)).astype(np.float32)).to(cuda)
    md, _ = ops.page_scan(recs, ids, q, None, capacity=cap, dim=d, rp=12,
                          compute_adc=False)
    assert torch.equal(ops.page_gather_l2(torch.as_tensor(vecs).to(cuda), ids, q), md)


@pytest.mark.cuda
def test_page_gather_l2_kernel_equals_page_scan_members(cuda):
    """On the same vectors the two kernels run the same per-member sum."""
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((50, 6, 128)).astype(np.float32)
    codes = rng.integers(0, 256, (50, 48, 16)).astype(np.uint8)
    recs = torch.as_tensor(pack_page_records(vecs, codes)).to(cuda)
    ids = torch.as_tensor(rng.integers(0, 50, (64, 5)).astype(np.int32)).to(cuda)
    q = torch.as_tensor(rng.standard_normal((64, 128)).astype(np.float32)).to(cuda)
    md, _ = ops.page_scan(recs, ids, q, None, capacity=6, dim=128, rp=48,
                          compute_adc=False)
    got = ops.page_gather_l2(torch.as_tensor(vecs).to(cuda), ids, q)
    assert torch.equal(got, md)


@pytest.mark.cuda
def test_delta_scan_kernel_matches_plain(cuda):
    q, x = (torch.as_tensor(a).to(cuda) for a in l2_inputs(200, 4096, 128))
    rng = np.random.default_rng(4)
    live = torch.as_tensor(rng.random(4096) < 0.5).to(cuda)
    mask = torch.as_tensor(rng.random(4096) < 0.5).to(cuda)
    for m in (None, mask):
        d, s = ops.delta_scan(q, x, live, 10, mask=m)
        dp, sp = ops.delta_scan(q, x, live, 10, mask=m, impl="plain")
        torch.testing.assert_close(d, dp, rtol=1e-5, atol=l2_atol(q.cpu(), x.cpu()))
        assert (s == sp).all(1).float().mean() >= 0.99
        keep = live if m is None else live & m
        assert keep[s.long()].all()


@pytest.mark.cuda
def test_mutable_index_on_the_card(cuda, tmp_path):
    """Insert, delete, search (kernels and plain versions), save and load of
    a mutable index on the card; the delta scan goes through l2_distance."""
    from repro_torch.core import (MemoryMode, MutableIndex, PageANNConfig,
                                  PageANNIndex)
    from repro_torch.data.pipeline import clustered_vectors, query_vectors

    x = clustered_vectors(700, 32, num_clusters=8, seed=0)
    q = query_vectors(x, 64, seed=1)
    cfg = PageANNConfig(dim=32, graph_degree=12, build_beam=24, build_rounds=1,
                        pq_subspaces=8, lsh_sample=256, lsh_entries=8,
                        beam_width=48, max_hops=48, memory_mode=MemoryMode.HYBRID)
    m = MutableIndex(PageANNIndex.build(x[:600], cfg, device=cuda),
                     auto_compact=False)
    m.insert(x[600:], ids=np.arange(600, 700))
    m.delete(np.arange(0, 30))
    ops.reset_launch_counts()
    got = m.search(q, k=10)
    assert ops.launch_counts()["l2_distance"] == 1
    plain = m.search(q, k=10, impl="plain")
    assert (got.ids == plain.ids).all(1).mean() >= 0.95
    assert not np.isin(got.ids, np.arange(30)).any()
    m.save(str(tmp_path / "idx.mutable"))
    loaded = MutableIndex.load(str(tmp_path / "idx.mutable"), device=cuda)
    for field in got._fields:
        np.testing.assert_array_equal(getattr(loaded.search(q, k=10), field),
                                      getattr(got, field))


@pytest.fixture(scope="module")
def card_index():
    """A small HYBRID index built on the card, and its queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.core import MemoryMode, PageANNConfig, PageANNIndex
    from repro_torch.data.pipeline import clustered_vectors, query_vectors

    x = clustered_vectors(1500, 32, num_clusters=16, seed=0)
    cfg = PageANNConfig(dim=32, graph_degree=12, build_beam=24, build_rounds=1,
                        pq_subspaces=8, lsh_sample=256, lsh_entries=8,
                        beam_width=48, max_hops=48, memory_mode=MemoryMode.HYBRID)
    return PageANNIndex.build(x, cfg, device="cuda"), query_vectors(x, 200, seed=1)


@pytest.mark.cuda
def test_search_builds_its_tables_in_pq_lut(card_index):
    """A HYBRID search launches ``pq_lut`` once a table (disk and in-memory)
    and the profiled search does the same; the plain route launches none."""
    index, q = card_index
    ops.reset_launch_counts()
    index.search(q, k=10)
    assert ops.launch_counts()["pq_lut"] == 2
    ops.reset_launch_counts()
    index.profile(q)
    assert ops.launch_counts()["pq_lut"] == 2
    ops.reset_launch_counts()
    index.search(q, k=10, impl="plain")
    assert ops.launch_counts()["pq_lut"] == 0


ADAPTIVE_CASES = [dict(patience=1), dict(patience=2, epsilon=0.05),
                  dict(entry_slack_bits=0, min_entries=1),
                  dict(patience=2, entry_slack_bits=2, min_entries=4)]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", ADAPTIVE_CASES, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_adaptive_search_through_the_kernels_matches_plain(card_index, tmp_path, kw):
    """Adaptive search through the kernels against the plain versions on
    the card: ids, ios and hops equal for at least 99% of queries (the
    float kernels sum in another order, so a near tie may go the other
    way); ``AdaptiveParams()`` is the plain search exactly; streamed equals
    resident exactly."""
    from repro_torch.core import AdaptiveParams, PageANNIndex, SearchParams

    index, q = card_index
    base = SearchParams.from_config(index.cfg)
    p = base.replace(adaptive=AdaptiveParams(**kw))
    ops.reset_launch_counts()
    got = index.search(q, params=p)
    counts = ops.launch_counts()
    assert counts["hamming"] == 1 and counts["page_scan"] > 0 and counts["pq_adc"] > 0
    plain = index.search(q, params=p, impl="plain")
    same = ((got.ids == plain.ids).all(1) & (got.ios == plain.ios)
            & (got.hops == plain.hops))
    assert same.mean() >= 0.99
    want = index.search(q, params=base)
    off = index.search(q, params=base.replace(adaptive=AdaptiveParams()))
    for field in want._fields:
        np.testing.assert_array_equal(getattr(off, field), getattr(want, field))
    if "entry_slack_bits" not in kw:
        assert (got.hops <= want.hops).all() and (got.ios <= want.ios).all()
    index.save(str(tmp_path / "idx"))
    streamed = PageANNIndex.load(str(tmp_path / "idx"), device="cuda",
                                 memory_budget=0.25)
    again = streamed.search(q, params=p)
    for field in got._fields:
        np.testing.assert_array_equal(getattr(again, field), getattr(got, field))


@pytest.mark.cuda
@pytest.mark.parametrize("slack,min_entries", [(0, 1), (2, 4), (64, 1)])
def test_hamming_topk_values_select_the_entries(card_index, slack, min_entries):
    """The routing's top-T values as entry selection reads them: the kernel's
    equal the plain version's exactly, and so the seeded beam does (ids
    exactly, estimates within the float tolerance)."""
    from repro_torch.core import pq
    from repro_torch.core.lsh import hash_codes
    from repro_torch.core.search import init_state

    index, q = card_index
    data = index.data
    qt = torch.as_tensor(q).cuda()
    t = index.cfg.lsh_entries
    qcode = hash_codes(qt, data.lsh_planes)
    vals, idx = ops.hamming_topk(data.lsh_codes, qcode, t)
    pvals, pidx = ops.hamming_topk(data.lsh_codes, qcode, t, impl="plain")
    assert vals.dtype == torch.int32
    assert torch.equal(vals, pvals) and torch.equal(idx, pidx)
    assert (vals[:, 1:] >= vals[:, :-1]).all()
    lut = pq.pq_lut(qt, data.disk_codebooks)
    kw = dict(beam=48, k=10, entries=t, entry_slack=slack,
              min_entries=min_entries, patience=2)
    got = init_state(qt, data, lut, **kw)
    want = init_state(qt, data, lut, impl="plain", **kw)
    assert torch.equal(got.cand_ids, want.cand_ids)
    torch.testing.assert_close(got.cand_d, want.cand_d, rtol=1e-5, atol=1e-4)
    kept = (got.cand_ids[:, :t] >= 0).sum(1)
    assert (kept >= min_entries).all()
    if slack == 0:
        assert (kept < t).any()
    assert torch.isinf(got.frontier).all() and (got.stall == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("patience", [None, 2])
def test_profile_equals_search_on_the_card(card_index, patience):
    from repro_torch.core import AdaptiveParams, SearchParams

    index, q = card_index
    p = SearchParams.from_config(index.cfg).replace(
        adaptive=None if patience is None else AdaptiveParams(patience=patience))
    want = index.search(q, params=p)
    got, trail = index.profile(q, params=p)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(trail.active.sum(1), got.hops)
    np.testing.assert_array_equal(trail.ios.sum(1), got.ios)
    np.testing.assert_array_equal(trail.cache_hits.sum(1), got.cache_hits)
    assert (trail.pages[~trail.active] == -1).all()
    last = trail.worst_topk[np.arange(len(q)), got.hops - 1]
    np.testing.assert_array_equal(last, got.dists[:, -1])
    if patience is None:
        assert not trail.stall.any()


@pytest.fixture(scope="module")
def card_baselines():
    """DiskANN and Starling over one Vamana graph built on the card, and
    their queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.core import DiskANNIndex, PageANNConfig, StarlingIndex
    from repro_torch.data.pipeline import clustered_vectors, query_vectors

    x = clustered_vectors(1500, 32, num_clusters=16, seed=0)
    cfg = PageANNConfig(dim=32, graph_degree=16, build_beam=32, build_rounds=1,
                        pq_subspaces=8)
    disk = DiskANNIndex.build(x, cfg, device="cuda")
    nbrs = disk.data.nbrs.cpu().numpy()
    star = StarlingIndex.from_data(
        x, nbrs, disk.data.codebooks.cpu().numpy(),
        page_of=StarlingIndex._layout(x, nbrs, cfg), device="cuda")
    return disk, star, query_vectors(x, 200, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["diskann", "starling"])
@pytest.mark.parametrize("beam,io_batch,max_hops", [(64, 5, 64), (16, 4, 4)])
def test_baseline_search_through_the_kernels_matches_plain(
        card_baselines, tmp_path, kind, beam, io_batch, max_hops):
    """The baselines' estimates (``pq_adc``) and rerank (``page_gather_l2``
    at capacity 1) through the kernels against the plain versions on the
    card: ids equal for >= 99% of queries, ios and hops equal; a save and
    ``load_index`` on the card give the same results exactly."""
    from repro_torch.core import SearchParams, load_index

    disk, star, q = card_baselines
    index = disk if kind == "diskann" else star
    p = SearchParams(k=10, beam_width=beam, io_batch=io_batch,
                     max_hops=max_hops)
    ops.reset_launch_counts()
    got = index.search(q, params=p)
    counts = ops.launch_counts()
    assert counts["pq_adc"] > 0 and counts["page_gather_l2"] > 0
    plain = index.search(q, params=p, impl="plain")
    assert (got.ids == plain.ids).all(1).mean() >= 0.99
    np.testing.assert_array_equal(got.ios, plain.ios)
    np.testing.assert_array_equal(got.hops, plain.hops)
    np.testing.assert_allclose(got.dists, plain.dists, rtol=1e-5, atol=1e-4)
    index.save(str(tmp_path / kind))
    again = load_index(str(tmp_path / kind), device="cuda").search(q, params=p)
    for field in got._fields:
        np.testing.assert_array_equal(getattr(again, field), getattr(got, field))


@pytest.mark.cuda
def test_service_serves_baseline_and_pageann_collections_on_the_card(
        card_baselines, card_index):
    """A ``VectorService`` on the card over a DiskANN and a PageANN
    collection: every request's result equals its collection's direct
    search; the baseline dispatches launch ``page_gather_l2``."""
    from repro_torch.serve import VectorService

    disk, _, q = card_baselines
    index, qp = card_index
    with VectorService(device="cuda", batch_size=16) as svc:
        svc.create_collection("disk", disk, k=10)
        svc.create_collection("page", index, k=10)
        ops.reset_launch_counts()
        rows_d = svc.search("disk", q[:40])
        assert ops.launch_counts()["page_gather_l2"] > 0
        rows_p = svc.search("page", qp[:40])
    for rows, idx, qq in ((rows_d, disk, q[:40]), (rows_p, index, qp[:40])):
        want = idx.search(qq, k=10)
        for field in ("ids", "ios", "hops"):
            np.testing.assert_array_equal(
                np.stack([getattr(r.result, field) for r in rows]),
                getattr(want, field))


@pytest.fixture(scope="module")
def card_store():
    """A 2-shard ``ShardedPageStore`` built on the card over the
    ``card_index`` data, and its queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.core import MemoryMode, PageANNConfig
    from repro_torch.data.pipeline import clustered_vectors, query_vectors
    from repro_torch.dist import ShardedPageStore

    x = clustered_vectors(1500, 32, num_clusters=16, seed=0)
    cfg = PageANNConfig(dim=32, graph_degree=12, build_beam=24, build_rounds=1,
                        pq_subspaces=8, lsh_sample=256, lsh_entries=8,
                        beam_width=48, max_hops=48, memory_mode=MemoryMode.HYBRID)
    return ShardedPageStore.build(x, cfg, 2, device="cuda"), query_vectors(x, 200, seed=1)


@pytest.mark.cuda
def test_sharded_store_through_the_kernels_matches_plain(card_store, card_index,
                                                         tmp_path):
    """The host fan-out through the kernels against the plain versions (ids
    for >= 99% of queries, ios and hops exactly; one ``hamming`` launch a
    shard); the mesh fan-out on a mesh naming the card twice equals it
    (ids, ios, dists), with hops and cache hits 0; the query split of
    ``shard_search`` equals the plain search exactly; a save, ``load_index``
    and a 0.25 budget load equal it exactly."""
    from repro_torch.core import load_index
    from repro_torch.launch.mesh import make_host_mesh, make_mesh

    store, q = card_store
    ops.reset_launch_counts()
    got = store.search(q, k=10)
    counts = ops.launch_counts()
    assert counts["hamming"] == 2 and counts["page_scan"] > 0 and counts["pq_adc"] > 0
    plain = store.search(q, k=10, impl="plain")
    assert (got.ids == plain.ids).all(1).mean() >= 0.99
    np.testing.assert_array_equal(got.ios, plain.ios)
    np.testing.assert_array_equal(got.hops, plain.hops)
    np.testing.assert_allclose(got.dists, plain.dists, rtol=1e-5, atol=1e-4)
    mesh = make_mesh((2, 1), ("data", "model"), devices=["cuda:0"] * 2)
    assert mesh.distinct_devices == 1
    ops.reset_launch_counts()
    viamesh = store.search(q, k=10, mesh=mesh)
    assert ops.launch_counts()["hamming"] == 2
    for field in ("ids", "ios", "dists"):
        np.testing.assert_array_equal(getattr(viamesh, field), getattr(got, field))
    assert not viamesh.hops.any() and not viamesh.cache_hits.any()
    index, qp = card_index
    want = index.search(qp, k=10)
    for m in (make_host_mesh(), make_mesh((1, 2), ("data", "model"),
                                          devices=["cuda:0"] * 2)):
        again = index.search(qp, k=10, mesh=m)
        for field in want._fields:
            np.testing.assert_array_equal(getattr(again, field), getattr(want, field))
    store.save(str(tmp_path / "store"))
    for budget in (None, 0.25):
        loaded = load_index(str(tmp_path / "store"), device="cuda",
                            memory_budget=budget)
        again = loaded.search(q, k=10)
        for field in got._fields:
            np.testing.assert_array_equal(getattr(again, field), getattr(got, field))


@pytest.mark.cuda
def test_mesh_over_distinct_cards(card_store, card_index):
    """With two cards, each shard searches on its own card and each query
    block on its own replica: the results equal the one-card searches."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices for a mesh over distinct cards")
    from repro_torch.launch.mesh import make_mesh

    store, q = card_store
    spread = make_mesh((2, 1), ("data", "model"))
    assert spread.distinct_devices == 2
    want = store.search(q, k=10)
    got = store.search(q, k=10, mesh=spread)
    for field in ("ids", "ios", "dists"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    index, qp = card_index
    want = index.search(qp, k=10)
    got = index.search(qp, k=10, mesh=make_mesh((1, 2), ("data", "model")))
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


# ----------------------------------------------- the LM's width, d = 2048
# granite-3-2b's d_model: HYBRID capacity 1, a member spans 16 record rows,
# M = 8 code rows (examples/serve_rag.py's config), 48 neighbour columns
LM_PAGES, LM_CAP, LM_D, LM_RP, LM_M, LM_B = 40, 1, 2048, 48, 8, 5


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [1, 64, 1000])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("source", ["ids", "staged"])
@pytest.mark.parametrize("adc", [True, False], ids=["adc", "members"])
def test_page_scans_match_plain_at_d2048(cuda, adc, source, masked, nq):
    """Every page-scan variant at the LM's width and capacity 1 against its
    plain version; staged = by page id bit for bit, members-only = ADC."""
    recs, ids, q, lut = (torch.as_tensor(a).to(cuda) for a in page_inputs(
        LM_PAGES, LM_CAP, LM_D, LM_RP, LM_M, LM_B, nq=nq))
    assert recs.shape[1] == 24
    mask = None
    if masked:
        rng = np.random.default_rng(nq)
        mask = torch.as_tensor((rng.random((nq, LM_B, LM_CAP)) < 0.5)
                               .astype(np.float32)).to(cuda)
    kw = dict(capacity=LM_CAP, dim=LM_D, rp=LM_RP, compute_adc=adc,
              member_mask=mask)
    staged = recs[ids.long()].contiguous()

    def run(impl=None, adc_=adc):
        k = dict(kw, compute_adc=adc_)
        if source == "staged":
            return ops.page_scan_recs(staged, q, lut, impl=impl, **k)
        return ops.page_scan(recs, ids, q, lut, impl=impl, **k)

    name = ("page_scan" + ("_recs" if source == "staged" else "")
            + ("" if adc else "_members") + ("_masked" if masked else ""))
    before = ops.launch_counts()[name]
    got = run()
    assert ops.launch_counts()[name] == before + 1
    want = run("plain")
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    if adc:
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)
    by_id = ops.page_scan(recs, ids, q, lut, **kw)
    assert torch.equal(got[0], by_id[0])
    assert torch.equal(run(adc_=not adc)[0], got[0])


@pytest.mark.cuda
def test_pq_adc_hamming_l2_match_plain_at_d2048(cuda):
    """The retrieval's other kernels at the LM's shapes: the HYBRID re-score
    (M = 16 in-memory codes, b x Rp rows a query), the routing over a
    512-row LSH sample (T = 8), the delta scan of 1,000 inserted rows at
    d = 2048 (padded to 1,024, keep mask)."""
    rng = np.random.default_rng(2048)
    nq = 1000
    table = torch.as_tensor(rng.integers(0, 256, (2000, 16)).astype(np.uint8)).to(cuda)
    ids = torch.as_tensor(rng.integers(0, 2000, (nq, LM_B * LM_RP))).to(cuda)
    lut = torch.as_tensor(rng.random((nq, 16, 256)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(ops.pq_adc_gather(table, ids, lut),
                               ops.pq_adc_gather(table, ids, lut, impl="plain"),
                               rtol=1e-5, atol=1e-4)
    codes = torch.as_tensor(_words(rng, 512, 2)).to(cuda)
    qcodes = torch.as_tensor(_words(rng, nq, 2)).to(cuda)
    got = ops.hamming_topk(codes, qcodes, 8)
    want = ops.hamming_topk(codes, qcodes, 8, impl="plain")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    q, x = (torch.as_tensor(a).to(cuda) for a in l2_inputs(nq, 1024, LM_D))
    keep = torch.arange(1024, device=cuda) < 1000
    dist = ops.l2_distance(q, x, keep)
    torch.testing.assert_close(dist, ops.l2_distance(q, x, keep, impl="plain"),
                               rtol=1e-5, atol=l2_atol(q.cpu(), x.cpu()))
    assert float(dist[0, 0]) == 0.0
    assert torch.isinf(dist[:, 1000:]).all()


@pytest.mark.cuda
def test_two_layer_full_width_decode_on_the_card_matches_the_cpu(cuda):
    """granite-3-2b's full width cut to 2 layers, the same weights on the
    card and the CPU: 12 decode steps' logits within 1e-2 and the greedy
    tokens equal. cuBLAS and the CPU's BLAS sum in other orders; where k or
    v straddles a bf16 rounding boundary the KV cache element lands one
    bf16 step apart (0.5% of them on the H100), which moved logits of
    magnitude ~5 by up to 0.0033 (by 4.9e-6 with a float32 cache,
    tools/lm_cut_card_vs_cpu.py)."""
    import copy
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tf

    cut = dataclasses.replace(get_arch("granite-3-2b"), num_layers=2)
    cpu = tf.init_params(cut, torch.Generator().manual_seed(0), device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cut.vocab_size, (2, 12)), dtype=torch.int32)
    caches = [tf.init_cache(cut, 2, 12, device=d) for d in ("cpu", cuda)]
    for t in range(12):
        want, _ = tf.decode_step(cpu, caches[0], toks[:, t], t, cut)
        got, _ = tf.decode_step(card, caches[1], toks[:, t].to(cuda), t, cut)
        got = got.cpu()[:, :cut.vocab_size]
        want = want[:, :cut.vocab_size]
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
        assert torch.equal(got.argmax(-1), want.argmax(-1))


# ----------------------------------------------- recurrentgemma's d = 4096
# a member spans 32 record rows, the page 40 with its 8 code rows; the
# page scan stages one page a chunk (40 KB of shared memory with the query
# and its table)
D4096_PAGES = 40


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [1, 64, 1000])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("source", ["ids", "staged"])
@pytest.mark.parametrize("adc", [True, False], ids=["adc", "members"])
def test_page_scans_match_plain_at_d4096(cuda, adc, source, masked, nq):
    """Every page-scan variant at recurrentgemma-9b's width (capacity 1)
    against its plain version; staged = by page id bit for bit,
    members-only = ADC."""
    recs, ids, q, lut = (torch.as_tensor(a).to(cuda) for a in page_inputs(
        D4096_PAGES, LM_CAP, 4096, LM_RP, LM_M, LM_B, nq=nq))
    assert recs.shape[1] == 40
    mask = None
    if masked:
        rng = np.random.default_rng(nq + 1)
        mask = torch.as_tensor((rng.random((nq, LM_B, LM_CAP)) < 0.5)
                               .astype(np.float32)).to(cuda)
    kw = dict(capacity=LM_CAP, dim=4096, rp=LM_RP, compute_adc=adc,
              member_mask=mask)
    staged = recs[ids.long()].contiguous()

    def run(impl=None, adc_=adc):
        k = dict(kw, compute_adc=adc_)
        if source == "staged":
            return ops.page_scan_recs(staged, q, lut, impl=impl, **k)
        return ops.page_scan(recs, ids, q, lut, impl=impl, **k)

    got, want = run(), run("plain")
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    if adc:
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)
    assert torch.equal(got[0], ops.page_scan(recs, ids, q, lut, **kw)[0])
    assert torch.equal(run(adc_=not adc)[0], got[0])


@pytest.mark.cuda
def test_pq_adc_and_hamming_match_plain_at_d4096(cuda):
    """The d = 4096 retrieval's other on-path kernels (the re-score and the
    routing) at its shapes: 1,000 pages' M = 16 codes, 1,000 queries."""
    rng = np.random.default_rng(4096)
    nq = 1000
    table = torch.as_tensor(rng.integers(0, 256, (1000, 16)).astype(np.uint8)).to(cuda)
    ids = torch.as_tensor(rng.integers(0, 1000, (nq, LM_B * LM_RP))).to(cuda)
    lut = torch.as_tensor(rng.random((nq, 16, 256)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(ops.pq_adc_gather(table, ids, lut),
                               ops.pq_adc_gather(table, ids, lut, impl="plain"),
                               rtol=1e-5, atol=1e-4)
    codes = torch.as_tensor(_words(rng, 512, 2)).to(cuda)
    qcodes = torch.as_tensor(_words(rng, nq, 2)).to(cuda)
    got = ops.hamming_topk(codes, qcodes, 8)
    want = ops.hamming_topk(codes, qcodes, 8, impl="plain")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -------------------------------------- each family's cut, card against CPU
# 2 layers at full width (the hybrid: one (rec, rec, attn) block; the MoE:
# 8 of arctic's 128 experts, two full layers being 107 GB), the same
# weights on the card and the CPU: 12 decode steps' logits within 1e-2 and
# the greedy tokens equal (the encoder: its forward's logits and argmax).
# As for granite above, cuBLAS and the CPU's BLAS sum in other orders and
# the bf16 KV cache can land one bf16 step apart
@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["mamba2-370m", "recurrentgemma-9b",
                                     "hubert-xlarge", "qwen2-vl-72b",
                                     "arctic-480b"])
def test_family_cut_on_the_card_matches_the_cpu(cuda, arch_id):
    import copy
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tf

    full = get_arch(arch_id)
    if full.family == "hybrid":
        cut = dataclasses.replace(full, num_layers=3, tail_pattern=())
    else:
        cut = dataclasses.replace(full, num_layers=2)
    if full.family == "moe":
        cut = dataclasses.replace(cut, num_experts=8)
    cpu = tf.init_params(cut, torch.Generator().manual_seed(0), device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(1)
    if not cut.is_decoder:
        embeds = torch.as_tensor(rng.standard_normal((2, 32, 512)),
                                 dtype=torch.float32)
        want, _ = tf.forward_train(cpu, {"embeds": embeds}, cut)
        got, _ = tf.forward_train(card, {"embeds": embeds.to(cuda)}, cut)
        got, want = got.cpu()[..., :cut.vocab_size], want[..., :cut.vocab_size]
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        return
    toks = torch.as_tensor(rng.integers(0, cut.vocab_size, (2, 12)),
                           dtype=torch.int32)
    caches = [tf.init_cache(cut, 2, 12, device=d) for d in ("cpu", cuda)]
    for t in range(12):
        p3 = torch.full((3, 2, 1), t, dtype=torch.int32) if cut.mrope else None
        want, _ = tf.decode_step(cpu, caches[0], toks[:, t], t, cut, p3)
        got, _ = tf.decode_step(card, caches[1], toks[:, t].to(cuda), t, cut,
                                None if p3 is None else p3.to(cuda))
        got = got.cpu()[:, :cut.vocab_size]
        want = want[:, :cut.vocab_size]
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
        assert torch.equal(got.argmax(-1), want.argmax(-1))


# ------------------------------------------------------------- training ----
def _train_copy(state, device):
    """A copy of a TrainState on ``device``."""
    import copy

    from repro_torch import tree as T
    from repro_torch.train.step import TrainState

    opt = state.opt_state
    return TrainState(copy.deepcopy(state.params).to(device),
                      type(opt)(*T.map(lambda t: t.to(device, copy=True),
                                       tuple(opt))),
                      state.step.to(device, copy=True))


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["granite-3-2b", "mamba2-370m",
                                     "recurrentgemma-9b", "kimi-k2-1t-a32b",
                                     "qwen2-vl-72b", "hubert-xlarge"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch_id):
    """Two steps of 2 microbatches (SMOKE config, the same state and
    batches): loss and grad norm within 1e-5 relative (bf16 parameters:
    1e-2)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_arch(arch_id, smoke=True)
    shape = ShapeConfig("t", 32, 4, "train", num_microbatches=2)
    cpu = init_train_state(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    card = _train_copy(cpu, cuda)
    step = make_train_step(cfg, shape)
    rel = 1e-2 if cfg.param_dtype == "bfloat16" else 1e-5
    pipe = TokenPipeline(cfg, shape)
    for i in range(2):
        cpu, want = step(cpu, pipe.batch(i))
        card, got = step(card, pipe.batch(i))
        for k in ("loss", "grad_norm"):
            assert abs(float(got[k]) - float(want[k])) <= rel * abs(
                float(want[k])), (i, k)
    assert int(card.step) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_on_the_card_match_the_cpu(cuda, name):
    """The same parameters and gradients (a Stack of 3 layers, an expert
    stack, a vector stack, an unstacked rank-3 leaf), three steps:
    parameters and state within 1e-6."""
    from repro_torch import tree as T
    from repro_torch.optim import make_optimizer

    def tree(device):
        r = np.random.default_rng(1)

        def a(*shape):
            return torch.tensor(r.standard_normal(shape),
                                dtype=torch.float32, device=device)

        return {"embed": a(64, 32),
                "layers": {"w": T.Stack(a(32, 48) for _ in range(3)),
                           "we": T.Stack(a(4, 32, 16) for _ in range(3)),
                           "scale": T.Stack(a(32) for _ in range(3))},
                "tail": {"wq": a(32, 4, 8)}}

    opt = make_optimizer(name, 0.01)
    out = {}
    for device in ("cpu", cuda):
        params, grads = tree(device), T.map(
            lambda x: T.Stack(t * 0.5 for t in x) if isinstance(x, T.Stack)
            else x * 0.5, tree(device))
        state = opt.init(params)
        for _ in range(3):
            params, state, _ = opt.update(grads, state, params)
        out[device] = (T.layer_leaves(params),
                       T.layer_leaves(tuple(state)[1:]))
    for got, want in zip(out[cuda], out["cpu"]):
        for a, b in zip(got, want, strict=True):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_bf16_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """kimi-k2's SMOKE TrainState (bf16 parameters) after a step on the
    card: saved, restored into a fresh state on the card and one on the
    CPU, every leaf equal bit for bit."""
    from repro_torch import tree as T
    from repro_torch.checkpoint import checkpointing as ckpt
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_arch("kimi-k2-1t-a32b", smoke=True)
    shape = ShapeConfig("t", 16, 4, "train")
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    state, _ = make_train_step(cfg, shape)(state,
                                           TokenPipeline(cfg, shape).batch(0))
    ckpt.save(str(tmp_path), 1, state)
    for device in (cuda, "cpu"):
        target = init_train_state(cfg, torch.Generator().manual_seed(9),
                                  device=device)
        ckpt.restore(str(tmp_path), 1, target)
        got, want = T.layer_leaves(target), T.layer_leaves(state)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            assert torch.equal(a.cpu(), b.cpu())
    assert state.params.embed.dtype == torch.bfloat16


@pytest.mark.cuda
def test_serve_rag_example_same_ids_on_the_card_and_the_cpu(cuda, tmp_path):
    """``examples/serve_rag_torch.py``'s retrieval at SMOKE width over one
    collection, built on the CPU and saved once, attached on the card and
    on the CPU: the same ids for every request, with a masked page scan,
    ``pq_adc`` and ``hamming`` launched on the card."""
    import contextlib
    import copy
    import importlib.util
    import io
    from pathlib import Path

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import MetadataSchema, PageANNIndex
    from repro_torch.models import transformer as tf

    path = Path(__file__).resolve().parents[1] / "examples" / "serve_rag_torch.py"
    spec = importlib.util.spec_from_file_location("serve_rag_torch", path)
    rag = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rag)
    arch = get_arch("granite-3-2b", smoke=True)
    model = tf.init_params(arch, torch.Generator().manual_seed(0), device="cpu")
    tokens, owners, requests = rag.corpus(arch.vocab_size, 300)
    docs = rag.embed(model, tokens)
    index = PageANNIndex.build(docs, rag.index_config(docs.shape[1]),
                               schema=MetadataSchema(tags=("agent",)),
                               metadata={"agent": owners}, device="cpu")
    index.save(str(tmp_path / "docs"))
    out = {}
    for device in ("cpu", cuda):
        on = model if device == "cpu" else copy.deepcopy(model).to(device)
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            out[str(device)] = rag.retrieve_and_decode(
                on, arch, tokens, owners, device=device, requests=requests,
                index_dir=str(tmp_path / "docs"))
        launches = ops.launch_counts()
    np.testing.assert_array_equal(out["cuda"]["ids"], out["cpu"]["ids"])
    assert out["cuda"]["cached"] == 4
    assert launches.get("page_scan_masked", 0) + launches.get(
        "page_scan_recs_masked", 0) > 0, launches
    assert launches.get("pq_adc", 0) > 0 and launches.get("hamming", 0) > 0
