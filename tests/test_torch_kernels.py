"""The port's kernels (repro_torch.kernels) against the JAX package's.

On the CPU every ``ops`` call dispatches to the plain PyTorch version; those
are held against ``repro.kernels.ref`` (the jnp oracles) and against the
Pallas kernels run with ``interpret=True``, on the same seeded inputs. The
CUDA kernels themselves are held against the plain versions in
``test_torch_cuda.py`` (marked ``cuda``, skipped without a card; it imports
no JAX so it runs on a GPU host) and by ``chip_smoke.py`` at the main
path's shapes.
"""
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pq as jpq
from repro.core.search import _top_k_merge as jax_top_k_merge
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import record_layout as jlayout
from repro.kernels.hamming import hamming as pallas_hamming
from repro.kernels.l2dist import l2_distance as pallas_l2_distance
from repro.kernels.page_gather import page_gather_l2 as pallas_page_gather_l2
from repro.kernels.page_scan import page_scan as pallas_page_scan
from repro.kernels.page_scan import page_scan_recs as pallas_page_scan_recs
from repro.kernels.pq_adc import pq_adc as pallas_pq_adc
from repro_torch.core import pq as tpq
from repro_torch.kernels import _build, ops
from repro_torch.kernels import hamming as hamming_k
from repro_torch.kernels import l2_distance as l2_distance_k
from repro_torch.kernels import page_gather as page_gather_k
from repro_torch.kernels import page_scan as page_scan_k
from repro_torch.kernels import pq_adc as pq_adc_k
from repro_torch.kernels import pq_lut as pq_lut_k
from repro_torch.kernels import record_layout as tlayout
from repro_torch.kernels import ref as tref
from test_torch_cuda import L2_CASES, PAGE_CASES, l2_atol, l2_inputs
from test_torch_cuda import page_inputs as _page_inputs

# six test workers share the host's cores; the port's small tensors gain
# nothing from more intra-op threads than one
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- page_scan
@pytest.mark.parametrize("adc", [True, False], ids=["adc", "members"])
@pytest.mark.parametrize("p,cap,d,rp,m,b", PAGE_CASES)
def test_page_scan_plain_matches_jax_ref_and_pallas(p, cap, d, rp, m, b, adc):
    recs, ids, q, lut = _page_inputs(p, cap, d, rp, m, b)
    md, nd = ops.page_scan(
        torch.as_tensor(recs), torch.as_tensor(ids), torch.as_tensor(q),
        torch.as_tensor(lut), capacity=cap, dim=d, rp=rp, compute_adc=adc,
    )
    assert md.shape == (len(q), b, cap)
    assert (nd is None) == (not adc)
    kw = dict(capacity=cap, dim=d, rp=rp, compute_adc=adc)
    for i in range(len(q)):
        args = (jnp.asarray(recs), jnp.asarray(ids[i]), jnp.asarray(q[i]),
                jnp.asarray(lut[i]))
        for md_j, nd_j in (jref.page_scan_ref(*args, **kw),
                           pallas_page_scan(*args, **kw, interpret=True)):
            np.testing.assert_allclose(md[i].numpy(), np.asarray(md_j), **TOL)
            if adc:
                np.testing.assert_allclose(nd[i].numpy(), np.asarray(nd_j), **TOL)
            else:
                assert nd_j is None


@pytest.mark.parametrize("variant", ["masked", "recs", "recs_masked"])
@pytest.mark.parametrize("adc", [True, False], ids=["adc", "members"])
@pytest.mark.parametrize("p,cap,d,rp,m,b", PAGE_CASES)
def test_masked_and_staged_plain_match_jax_ref_and_pallas(p, cap, d, rp, m, b,
                                                          adc, variant):
    """The filtered (masked) and streamed (staged) page scans: members whose
    mask is <= 0 score +inf at the same positions, the rest within 1e-5."""
    recs, ids, q, lut = _page_inputs(p, cap, d, rp, m, b)
    rng = np.random.default_rng(p + cap + d)
    masked = variant != "recs"
    mask = (rng.random((len(q), b, cap)) < 0.5).astype(np.float32) if masked else None
    kw = dict(capacity=cap, dim=d, rp=rp, compute_adc=adc)
    tmask = None if mask is None else torch.as_tensor(mask)
    if variant.startswith("recs"):
        staged = recs[ids]
        md, nd = ops.page_scan_recs(torch.as_tensor(staged), torch.as_tensor(q),
                                    torch.as_tensor(lut), member_mask=tmask, **kw)
    else:
        md, nd = ops.page_scan(torch.as_tensor(recs), torch.as_tensor(ids),
                               torch.as_tensor(q), torch.as_tensor(lut),
                               member_mask=tmask, **kw)
    if masked:
        np.testing.assert_array_equal(np.isinf(md.numpy()), mask <= 0)
    for i in range(len(q)):
        jmask = None if mask is None else jnp.asarray(mask[i])
        common = (jnp.asarray(q[i]), jnp.asarray(lut[i]))
        if variant.startswith("recs"):
            args = (jnp.asarray(staged[i]),) + common
            outs = (jref.page_scan_recs_ref(*args, **kw, member_mask=jmask),
                    pallas_page_scan_recs(*args, **kw, member_mask=jmask,
                                          interpret=True))
        else:
            args = (jnp.asarray(recs), jnp.asarray(ids[i])) + common
            outs = (jref.page_scan_ref(*args, **kw, member_mask=jmask),
                    pallas_page_scan(*args, **kw, member_mask=jmask,
                                     interpret=True))
        for md_j, nd_j in outs:
            np.testing.assert_allclose(md[i].numpy(), np.asarray(md_j), **TOL)
            if adc:
                np.testing.assert_allclose(nd[i].numpy(), np.asarray(nd_j), **TOL)


def test_page_scan_recs_ref_is_page_scan_on_gathered_records():
    recs, ids, q, lut = _page_inputs(9, 6, 24, 10, 8, 4)
    recs_t, ids_t = torch.as_tensor(recs), torch.as_tensor(ids)
    kw = dict(capacity=6, dim=24, rp=10)
    a = tref.page_scan_ref(recs_t, ids_t, torch.as_tensor(q), torch.as_tensor(lut), **kw)
    b = tref.page_scan_recs_ref(recs_t[ids_t.long()], torch.as_tensor(q),
                                torch.as_tensor(lut), **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ------------------------------------------------------------- pq_adc
@pytest.mark.parametrize("nq,n,m,k", [(3, 130, 8, 256), (2, 240, 32, 256),
                                      (4, 16, 16, 256), (1, 7, 4, 64)])
def test_pq_adc_plain_matches_jax_ref_and_pallas(nq, n, m, k):
    rng = np.random.default_rng(n + m)
    codes = rng.integers(0, k, (nq, n, m)).astype(np.uint8)
    lut = rng.standard_normal((nq, m, k)).astype(np.float32)
    out = ops.pq_adc(torch.as_tensor(codes), torch.as_tensor(lut)).numpy()
    assert out.shape == (nq, n) and out.dtype == np.float32
    for i in range(nq):
        c, t = jnp.asarray(codes[i]), jnp.asarray(lut[i])
        np.testing.assert_allclose(out[i], np.asarray(jref.pq_adc_ref(c, t)), **TOL)
        np.testing.assert_allclose(
            out[i], np.asarray(pallas_pq_adc(c, t, interpret=True)), **TOL)


# (queries, rows a query, table rows, M, K) for pq_adc_gather: the entry
# estimates (16 x 16), the HYBRID re-score (240 x 32), M not a multiple of
# 16, K below 256
GATHER_CASES = [(3, 16, 50, 16, 256), (2, 240, 300, 32, 256),
                (4, 257, 90, 33, 200), (5, 1, 7, 8, 17), (1, 30, 40, 9, 64)]


@pytest.mark.parametrize("id_dtype", ["int32", "int64"])
@pytest.mark.parametrize("nq,n,r,m,k", GATHER_CASES)
def test_pq_adc_gather_plain_is_pq_adc_on_gathered_codes(nq, n, r, m, k,
                                                          id_dtype):
    """``pq_adc_gather`` equals ``pq_adc`` on ``table[ids]`` bit for bit,
    and the JAX ``ops.pq_adc`` (its reference on the CPU) on the same
    gathered codes within rtol = atol = 1e-5 (sums in another order)."""
    rng = np.random.default_rng(nq * 100 + n + m)
    table = rng.integers(0, k, (r, m)).astype(np.uint8)
    ids = rng.integers(0, r, (nq, n)).astype(id_dtype)
    lut = rng.standard_normal((nq, m, k)).astype(np.float32)
    tt, ti, tl = (torch.as_tensor(a) for a in (table, ids, lut))
    got = ops.pq_adc_gather(tt, ti, tl)
    assert got.shape == (nq, n) and got.dtype == torch.float32
    assert torch.equal(got, tref.pq_adc_gather_ref(tt, ti, tl))
    assert torch.equal(got, ops.pq_adc(tt[ti.long()], tl))
    for i in range(nq):
        want = jops.pq_adc(jnp.asarray(table[ids[i]]), jnp.asarray(lut[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), **TOL)


def test_pq_adc_gather_takes_strided_ids():
    """The entry estimates pass the first T columns of a sorted (Q, S)
    index matrix, a view whose rows are S apart."""
    rng = np.random.default_rng(5)
    table = torch.as_tensor(rng.integers(0, 256, (64, 16)).astype(np.uint8))
    ids = torch.as_tensor(rng.integers(0, 64, (4, 40)))
    lut = torch.as_tensor(rng.random((4, 16, 256)).astype(np.float32))
    view = ids[:, :16]
    assert not view.is_contiguous()
    assert torch.equal(ops.pq_adc_gather(table, view, lut),
                       ops.pq_adc_gather(table, view.contiguous(), lut))


@pytest.mark.parametrize("nq,n,m,k", [(1000, 240, 32, 256), (1000, 16, 16, 256),
                                      (3, 1000, 8, 256), (2, 5000, 8, 64),
                                      (7, 1, 4, 16), (5, 33, 33, 200)])
def test_pq_adc_launch_plan_scores_every_row_once(nq, n, m, k):
    """One block a query up to MAX_ROWS rows, threads the rows in whole
    warps (at most MAX_THREADS); walking the grid as the kernel does
    (block -> query and first row, thread -> rows first + tid + j threads)
    scores every (query, row) exactly once."""
    plan = pq_adc_k.launch_plan(nq, n, m, k)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= pq_adc_k.MAX_THREADS
    assert plan.grid == nq * plan.chunks and plan.smem_bytes == m * k * 4
    assert plan.rows_per_block <= pq_adc_k.MAX_ROWS
    if n <= pq_adc_k.MAX_ROWS:
        assert plan.chunks == 1
    seen = []
    for blk in range(plan.grid):
        qi, first = blk // plan.chunks, (blk % plan.chunks) * plan.rows_per_block
        last = min(n, first + plan.rows_per_block)
        for tid in range(plan.threads):
            seen += [(qi, i) for i in range(first + tid, last, plan.threads)]
    assert sorted(seen) == [(i, j) for i in range(nq) for j in range(n)]


def test_pq_adc_launch_plan_sizes_the_block_to_the_rows():
    # the HYBRID re-score (b x Rp = 240 rows): 8 warps; the entry
    # estimates (T = 16): one warp, not 256 threads with 240 idle
    assert pq_adc_k.launch_plan(1000, 240, 32, 256)[:2] == (1000, 256)
    assert pq_adc_k.launch_plan(1000, 16, 16, 256)[:2] == (1000, 32)
    assert pq_adc_k.launch_plan(1000, 16, 16, 256).smem_bytes == 16 * 1024


# ------------------------------------------------------------- pq_lut
@pytest.mark.parametrize("nq,d,m,k", [(5, 32, 8, 256), (3, 128, 16, 256),
                                      (2, 192, 32, 256), (4, 24, 3, 17)])
def test_pq_lut_on_cpu_is_the_plain_formula_bit_for_bit(nq, d, m, k):
    """CPU tensors take the plain version, ``core.pq.pq_lut``'s formula bit
    for bit, with or without ``impl="plain"``, and count no launch; the
    JAX reference's tables agree within rtol = atol = 1e-5."""
    rng = np.random.default_rng(nq * 10 + d + m)
    q = torch.as_tensor(rng.standard_normal((nq, d)).astype(np.float32))
    books = torch.as_tensor(rng.standard_normal((m, k, d // m)).astype(np.float32))
    ops.reset_launch_counts()
    got = ops.pq_lut(q, books)
    want = tpq.pq_lut(q, books)
    assert got.shape == (nq, m, k) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(ops.pq_lut(q, books, impl="plain"), want)
    assert torch.equal(tref.pq_lut_ref(q, books), want)
    assert not any(ops.launch_counts().values())
    for i in range(nq):
        np.testing.assert_allclose(
            got[i].numpy(),
            np.asarray(jpq.pq_lut(jnp.asarray(q[i].numpy()),
                                  jnp.asarray(books.numpy()))), **TOL)
    with pytest.raises(ValueError, match="impl"):
        ops.pq_lut(q, books, impl="cuda")


@pytest.mark.parametrize("q_shape,q_dtype,b_shape,b_dtype,match", [
    ((4, 32), torch.float64, (8, 256, 4), torch.float32, "float32"),
    ((4, 32), torch.float32, (8, 256, 4), torch.float16, "float32"),
    ((4, 8, 4), torch.float32, (8, 256, 4), torch.float32, r"\(Q, d\)"),
    ((4, 32), torch.float32, (256, 32), torch.float32, r"\(M, K, dsub\)"),
    ((4, 30), torch.float32, (8, 256, 4), torch.float32, "split"),
    ((4, 32), torch.float32, (8, 256, 4), torch.float32, "CUDA"),
])
def test_pq_lut_kernel_wrapper_refuses_what_it_cannot_take(
        q_shape, q_dtype, b_shape, b_dtype, match):
    """Wrong dtype, rank or width, or tensors off the card: the wrapper
    raises before it touches the library."""
    q = torch.zeros(q_shape, dtype=q_dtype)
    books = torch.zeros(b_shape, dtype=b_dtype)
    with pytest.raises(ValueError, match=match):
        pq_lut_k.pq_lut(q, books)


@pytest.mark.parametrize("nq,m,k,dsub,sms", [
    (10_000, 16, 256, 8, 132), (10_000, 32, 256, 4, 132),
    (10_000, 16, 256, 12, 132), (10_000, 32, 256, 6, 132),
    (1000, 16, 256, 128, 132), (1000, 32, 256, 64, 132), (1, 16, 256, 8, 132),
    (37, 32, 256, 6, 132), (70, 8, 100, 12, 132), (5, 3, 17, 8, 132),
    (3, 2, 1024, 300, 132), (45, 2, 256, 60, 1), (300, 4, 64, 6, 2)])
def test_pq_lut_launch_plan_writes_every_entry_once(nq, m, k, dsub, sms):
    """Threads are whole rows of four k (at most MAX_THREADS); the shared
    memory stays in its budget; a block takes 32 queries at the cells'
    batch, fewer while the blocks would not fill two an SM; and, at the
    smaller shapes, walking the grid as the kernel does (block -> subspace
    and query tile, thread -> row and first k, pass i -> query i x rows +
    row) writes every (query, m, k) exactly once."""
    plan = pq_lut_k.launch_plan(nq, m, k, dsub, sms=sms)
    k4n = -(-k // 4)
    assert plan.threads == plan.rows * k4n <= pq_lut_k.MAX_THREADS
    assert plan.passes in (1, 2, 4, 8) and 1 <= plan.chunk <= dsub
    assert plan.smem_bytes <= pq_lut_k.SMEM_BUDGET
    tile = plan.rows * plan.passes
    assert plan.grid == m * -(-nq // tile)
    assert plan.passes == 1 or plan.grid >= 2 * sms
    if nq == 10_000:      # the cells: 32 queries a block, one chunk
        assert (tile, plan.chunk) == (32, dsub)
    if nq * m * k > 2_000_000:
        return
    hits = np.zeros((nq, m, k), np.int64)
    tid = np.arange(plan.threads)
    row, k0 = tid // k4n, 4 * (tid % k4n)
    for blk in range(plan.grid):
        sub, q0 = blk % m, (blk // m) * tile
        for i in range(plan.passes):
            qi = q0 + i * plan.rows + row
            for x in range(4):
                ok = (qi < nq) & (k0 + x < k)
                np.add.at(hits, (qi[ok], sub, k0[ok] + x), 1)
    assert (hits == 1).all()


def test_pq_lut_launch_plan_refuses_k_and_dsub_out_of_range():
    with pytest.raises(ValueError, match="K must be"):
        pq_lut_k.launch_plan(10, 16, 4 * pq_lut_k.MAX_THREADS + 1, 8)
    with pytest.raises(ValueError, match="dsub"):
        pq_lut_k.launch_plan(10, 16, 256, 0)


# ------------------------------------------------------------- hamming
@pytest.mark.parametrize("s,w,nq", [(512, 2, 3), (1024, 2, 2), (37, 1, 4), (9, 5, 1)])
def test_hamming_plain_matches_jax_ref_and_pallas_exactly(s, w, nq):
    rng = np.random.default_rng(s + w)
    codes = rng.integers(0, 2**32, (s, w), dtype=np.uint64).astype(np.uint32)
    qcodes = rng.integers(0, 2**32, (nq, w), dtype=np.uint64).astype(np.uint32)
    codes[0] = qcodes[0]                      # a zero distance
    codes[1] = ~qcodes[0]                     # the largest distance
    out = ops.hamming(torch.as_tensor(codes.view(np.int32)),
                      torch.as_tensor(qcodes.view(np.int32))).numpy()
    assert out.dtype == np.int32 and out.shape == (nq, s)
    assert out[0, 0] == 0 and out[0, 1] == 32 * w
    for i in range(nq):
        c, qc = jnp.asarray(codes), jnp.asarray(qcodes[i])
        np.testing.assert_array_equal(out[i], np.asarray(jref.hamming_ref(c, qc)))
        np.testing.assert_array_equal(
            out[i], np.asarray(pallas_hamming(c, qc, interpret=True)))


def hamming_topk_inputs(kind: str, s: int, w: int, nq: int = 2):
    """(S, W) codes and (Q, W) query codes as uint32, from one seed:
    ``ties``: every row one of 3 patterns (long runs of equal distances),
    ``equal``: one pattern for every row, ``random``: uniform bits."""
    rng = np.random.default_rng(s * 10 + w)

    def bits(*shape):
        return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)

    if kind == "ties":
        codes = bits(3, w)[rng.integers(0, 3, s)]
    elif kind == "equal":
        codes = np.repeat(bits(1, w), s, axis=0)
    else:
        codes = bits(s, w)
    return codes, bits(nq, w)


@pytest.mark.parametrize("t", ["1", "16", "S"])
@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("s", [1024, 300, 33])
@pytest.mark.parametrize("kind", ["ties", "equal", "random"])
def test_hamming_topk_plain_matches_jax_sweep_then_top_k(kind, s, w, t):
    """``hamming_topk`` is the reference's routing: the Hamming sweep (jnp
    oracle and Pallas kernel alike), the f32 cast and ``_top_k_merge``
    (``lax.top_k``: the lower sample first on ties). Values and indices
    equal."""
    t = s if t == "S" else int(t)
    codes, qcodes = hamming_topk_inputs(kind, s, w)
    vals, idx = ops.hamming_topk(torch.as_tensor(codes.view(np.int32)),
                                 torch.as_tensor(qcodes.view(np.int32)), t)
    assert vals.dtype == idx.dtype == torch.int32
    assert vals.shape == idx.shape == (2, t)
    for i in range(2):
        c, qc = jnp.asarray(codes), jnp.asarray(qcodes[i])
        for ham in (jref.hamming_ref(c, qc), pallas_hamming(c, qc, interpret=True)):
            jv, ji = jax_top_k_merge(ham.astype(jnp.float32), t)
            np.testing.assert_array_equal(vals[i].numpy(), np.asarray(jv))
            np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ji))


def test_hamming_topk_raises_where_t_exceeds_the_sample():
    codes, qcodes = (torch.as_tensor(a.view(np.int32))
                     for a in hamming_topk_inputs("random", 33, 2))
    assert ops.hamming_topk(codes, qcodes, 33)[0].shape == (2, 33)
    with pytest.raises(ValueError, match="t = 34"):
        ops.hamming_topk(codes, qcodes, 34)


def test_hamming_topk_dispatch_on_cpu_and_its_kernel_refuses_cpu_tensors():
    """CPU tensors take the plain version (no launch counted), only None
    and "plain" are routes, and the kernel wrapper rejects CPU tensors."""
    codes, qcodes = (torch.as_tensor(a.view(np.int32))
                     for a in hamming_topk_inputs("ties", 300, 2))
    ops.reset_launch_counts()
    got = ops.hamming_topk(codes, qcodes, 16)
    want = tref.hamming_topk_ref(codes, qcodes, 16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    plain = ops.hamming_topk(codes, qcodes, 16, impl="plain")
    assert torch.equal(plain[0], want[0]) and torch.equal(plain[1], want[1])
    assert not any(ops.launch_counts().values())
    for impl in ("cuda", "pallas", "kernel"):
        with pytest.raises(ValueError, match="impl"):
            ops.hamming_topk(codes, qcodes, 16, impl=impl)
    with pytest.raises(ValueError, match="CUDA"):
        hamming_k.hamming_topk(codes, qcodes, 16)


# ------------------------------------------------------------- l2_distance
@pytest.mark.parametrize("nq,n,d", L2_CASES)
def test_l2_distance_plain_matches_jax_ref_and_pallas(nq, n, d):
    """The expanded form: within rtol 1e-5 and atol 1e-6 (max|q|^2 +
    max|x|^2), since BLAS and XLA sum q.x in other orders (ROADMAP C1)."""
    q, x = l2_inputs(nq, n, d)
    out = ops.l2_distance(torch.as_tensor(q), torch.as_tensor(x)).numpy()
    assert out.shape == (nq, n) and out.dtype == np.float32
    tol = dict(rtol=1e-5, atol=l2_atol(q, x))
    jq, jx = jnp.asarray(q), jnp.asarray(x)
    np.testing.assert_allclose(out, np.asarray(jref.l2_distance_ref(jq, jx)), **tol)
    np.testing.assert_allclose(
        out, np.asarray(pallas_l2_distance(jq, jx, interpret=True)), **tol)
    exact = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    np.testing.assert_allclose(out, exact, **tol)


@pytest.mark.parametrize("nq,n,d", L2_CASES)
def test_l2_distance_keep_is_where_keep_l2_inf(nq, n, d):
    """``keep`` puts +inf in the columns it drops and leaves the rest bit
    for bit as without it; held against the JAX ``l2_distance`` with the
    same mask at the expanded form's tolerance."""
    q, x = l2_inputs(nq, n, d)
    keep = np.random.default_rng(n + d).random(n) < 0.6
    keep[0] = True
    tq, tx, tk = (torch.as_tensor(a) for a in (q, x, keep))
    got = ops.l2_distance(tq, tx, tk)
    assert torch.equal(got, torch.where(tk[None, :], ops.l2_distance(tq, tx),
                                        float("inf")))
    assert torch.equal(torch.isinf(got), ~tk[None, :].expand(nq, n))
    want = np.where(keep[None, :],
                    np.asarray(jops.l2_distance(jnp.asarray(q), jnp.asarray(x))),
                    np.inf)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=l2_atol(q, x))


# ------------------------------------------------------------- page_gather_l2
@pytest.mark.parametrize("p,cap,d,b", [(7, 4, 16, 3), (23, 6, 128, 5),
                                       (5, 3, 200, 4)])
def test_page_gather_l2_plain_matches_jax_ref_and_pallas(p, cap, d, b):
    rng = np.random.default_rng(p + cap + d)
    pages = rng.standard_normal((p, cap, d)).astype(np.float32)
    ids = rng.integers(0, p, (3, b)).astype(np.int32)
    q = rng.standard_normal((3, d)).astype(np.float32)
    out = ops.page_gather_l2(torch.as_tensor(pages), torch.as_tensor(ids),
                             torch.as_tensor(q)).numpy()
    assert out.shape == (3, b, cap)
    for i in range(3):
        args = jnp.asarray(pages), jnp.asarray(ids[i]), jnp.asarray(q[i])
        np.testing.assert_allclose(
            out[i], np.asarray(jref.page_gather_l2_ref(*args)), **TOL)
        np.testing.assert_allclose(
            out[i], np.asarray(pallas_page_gather_l2(*args, interpret=True)),
            **TOL)


def test_page_gather_l2_equals_the_member_scores_of_page_scan():
    """Both score sum((x - q)^2) over the same page vectors: page_scan reads
    them out of the packed records, page_gather_l2 from (P, cap, d)."""
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((9, 6, 32)).astype(np.float32)
    codes = rng.integers(0, 256, (9, 12, 4)).astype(np.uint8)
    from repro_torch.core.layout import pack_page_records

    recs = torch.as_tensor(pack_page_records(vecs, codes))
    ids = torch.as_tensor(rng.integers(0, 9, (4, 5)).astype(np.int32))
    q = torch.as_tensor(rng.standard_normal((4, 32)).astype(np.float32))
    md, _ = ops.page_scan(recs, ids, q, None, capacity=6, dim=32, rp=12,
                          compute_adc=False)
    got = ops.page_gather_l2(torch.as_tensor(vecs), ids, q)
    torch.testing.assert_close(got, md, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- delta_scan
@pytest.mark.parametrize("k", [1, 7, 40])
@pytest.mark.parametrize("masked", [False, True], ids=["live", "filtered"])
def test_delta_scan_matches_jax_ops_ref_and_pallas(k, masked):
    """The L2 kernel path, dead and filtered rows at +inf, the ascending
    top-k; ids equal, distances within the expanded form's tolerance."""
    rng = np.random.default_rng(k)
    c, d = 64, 32
    vecs = rng.standard_normal((c, d)).astype(np.float32)
    vecs[40:] = 0.0                             # padding rows past the count
    live = np.zeros(c, bool)
    live[:40] = rng.random(40) < 0.8
    q = np.concatenate([rng.standard_normal((5, d)).astype(np.float32),
                        vecs[:2]])              # two self-matches
    mask = (rng.random(c) < 0.6) if masked else None
    dists, slots = ops.delta_scan(
        torch.as_tensor(q), torch.as_tensor(vecs), torch.as_tensor(live), k,
        mask=None if mask is None else torch.as_tensor(mask))
    assert dists.shape == slots.shape == (7, k) and slots.dtype == torch.int32
    keep = live if mask is None else live & mask
    assert (np.isinf(dists.numpy()).sum(1) == max(0, k - keep.sum())).all()
    jm = None if mask is None else jnp.asarray(mask)
    for impl in ("ref", "pallas"):
        want_d, want_s = jops.delta_scan(
            jnp.asarray(q), jnp.asarray(vecs), jnp.asarray(live), k,
            mask=jm, impl=impl, interpret=True)
        fin = np.isfinite(np.asarray(want_d))
        np.testing.assert_array_equal(np.isfinite(dists.numpy()), fin)
        np.testing.assert_array_equal(slots.numpy()[fin], np.asarray(want_s)[fin])
        np.testing.assert_allclose(dists.numpy(), np.asarray(want_d), rtol=1e-5,
                                   atol=l2_atol(q, vecs))
    # +inf rows tie: stable order keeps them in row order, as lax.top_k does
    for row in range(7):
        inf_slots = slots[row][torch.isinf(dists[row])]
        assert torch.equal(inf_slots, torch.sort(inf_slots).values)


@pytest.mark.parametrize("masked", [False, True], ids=["live", "filtered"])
def test_delta_scan_equals_the_separate_mask_pass(masked):
    """The keep mask in ``l2_distance`` gives the bits of the earlier path:
    the distances, then ``where(live & mask, d, inf)``, then the stable
    sort."""
    q, x = l2_inputs(9, 300, 24)
    rng = np.random.default_rng(11)
    live = torch.as_tensor(rng.random(300) < 0.7)
    mask = torch.as_tensor(rng.random(300) < 0.5) if masked else None
    tq, tx = torch.as_tensor(q), torch.as_tensor(x)
    for k in (1, 10, 300):
        dists, slots = ops.delta_scan(tq, tx, live, k, mask=mask)
        keep = live if mask is None else live & mask
        d = torch.where(keep[None, :], tref.l2_distance_ref(tq, tx), float("inf"))
        vals, idx = torch.sort(d, dim=-1, stable=True)
        assert torch.equal(dists, vals[:, :k])
        assert torch.equal(slots, idx[:, :k].to(torch.int32))


# ------------------------------------------------------------- launch plan
def _plan_for(cfg, nq, b=None, **kw):
    """``launch_plan`` for a ``PageANNConfig``'s page geometry."""
    from repro_torch.core.config import MemoryMode

    adc = cfg.memory_mode != MemoryMode.MEM_ALL
    return page_scan_k.launch_plan(
        nq, cfg.io_batch if b is None else b, capacity=cfg.resolve_capacity(),
        dim=cfg.dim, rp=cfg.page_degree, m=cfg.pq_subspaces if adc else 0,
        k=cfg.pq_ksub if adc else 0, compute_adc=adc, **kw)


def _blocks_cover_every_page_once(plan, nq, b):
    """Walk the grid as the kernel does (block -> query and first page,
    then chunk by chunk): every (query, page) is scored exactly once."""
    groups = -(-b // plan.pages_per_block)
    seen = []
    for blk in range(plan.grid):
        qi, first = blk // groups, (blk % groups) * plan.pages_per_block
        last = min(b, first + plan.pages_per_block)
        for c0 in range(first, last, plan.pages_per_chunk):
            seen += [(qi, p) for p in range(c0, min(last, c0 + plan.pages_per_chunk))]
    return sorted(seen) == [(i, j) for i in range(nq) for j in range(b)]


def _warps_cover_every_item_once(plan, nq, b):
    """Walk a members-only grid as the kernel does (warp w of block blk
    scores item blk * warps + w, items past nq * b return): every
    (query, slot) item is scored exactly once."""
    warps = plan.threads // 32
    seen = [blk * warps + w for blk in range(plan.grid) for w in range(warps)]
    return sorted(i for i in seen if i < nq * b) == list(range(nq * b))


def test_launch_plan_main_path_is_one_chunk_of_five_pages_per_query():
    from repro_torch.core.config import MemoryMode, PageANNConfig

    cfg = PageANNConfig(dim=128, memory_mode=MemoryMode.HYBRID)
    plan = _plan_for(cfg, 1000)
    assert (plan.grid, plan.pages_per_block, plan.pages_per_chunk) == (1000, 5, 5)
    # query, table and the five pages' member rows: 512 + 16,384 + 15,360
    assert plan.smem_bytes == 32256 <= 48 * 1024
    assert plan.threads == 256               # 5 x 48 neighbour columns
    assert _blocks_cover_every_page_once(plan, 1000, 5)
    # members only (MEM_ALL): one warp per (query, page), four a block, no
    # shared memory; the 5,000 warps fit in one wave of 132 SMs
    plan = _plan_for(dataclasses.replace(cfg, memory_mode=MemoryMode.MEM_ALL), 1000)
    assert (plan.grid, plan.threads, plan.smem_bytes) == (1250, 128, 0)
    assert (plan.pages_per_block, plan.pages_per_chunk) == (4, 1)
    assert _warps_cover_every_item_once(plan, 1000, 5)


def test_launch_plan_chunks_large_pages_within_shared_memory():
    from repro_torch.core.config import MemoryMode, PageANNConfig

    cfg = PageANNConfig(dim=384, pq_subspaces=16, memory_mode=MemoryMode.HYBRID)
    plan = _plan_for(cfg, 1000, b=32)
    assert plan.pages_per_block == 32
    assert 1 <= plan.pages_per_chunk < 32    # the block loops over chunks
    assert plan.smem_bytes <= page_scan_k.SMEM_LIMIT
    assert _blocks_cover_every_page_once(plan, 1000, 32)
    # 30 members of d = 384 (46 KB a page) exceed a chunk: one page at a time
    plan = page_scan_k.launch_plan(10, 32, capacity=30, dim=384, rp=16, m=8,
                                   k=256, compute_adc=True)
    assert plan.pages_per_chunk == 1
    assert plan.smem_bytes == (30 * 3 * 128 + 8 * 256 + 384) * 4


@pytest.mark.parametrize("nq", [1, 3, 64, 131, 132, 300])
@pytest.mark.parametrize("b", [1, 5, 16])
def test_launch_plan_splits_pages_when_queries_are_few(nq, b):
    """Below one query per SM a query's pages spread over several blocks;
    from one per SM on, one block per query stages its table once."""
    plan = page_scan_k.launch_plan(nq, b, capacity=6, dim=128, rp=48, m=16,
                                   k=256, compute_adc=True, sms=132)
    if nq >= 132:
        assert plan.pages_per_block == b and plan.grid == nq
    else:
        assert plan.grid >= min(132, nq * b)
    assert plan.pages_per_chunk <= plan.pages_per_block
    assert _blocks_cover_every_page_once(plan, nq, b)


def test_launch_plan_raises_where_a_table_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        page_scan_k.launch_plan(8, 5, capacity=6, dim=128, rp=48, m=256,
                                k=256, compute_adc=True)
    # the same geometry without ADC needs no table and fits
    plan = page_scan_k.launch_plan(8, 5, capacity=6, dim=128, rp=48, m=0,
                                   k=0, compute_adc=False)
    assert plan.smem_bytes <= page_scan_k.SMEM_LIMIT
    # a members-only warp scores one page; threads alone sets a block's
    with pytest.raises(ValueError, match="one page a warp"):
        page_scan_k.launch_plan(8, 5, capacity=6, dim=128, rp=48, m=0, k=0,
                                compute_adc=False, pages_per_block=5)


@pytest.mark.parametrize("nq", [1, 64, 1000])
@pytest.mark.parametrize("dim", [32, 128, 200, 384])
@pytest.mark.parametrize("capacity", [1, 7, 33])
def test_members_plan_scores_every_item_once(capacity, dim, nq):
    """One warp per (query, slot) item, no shared memory, at most
    MAX_THREADS a block; fewer warps a block while blocks are fewer than
    the SMs; a threads override sets the warps and the grid follows."""
    kw = dict(capacity=capacity, dim=dim, rp=48, m=0, k=0,
              compute_adc=False, sms=132)
    plan = page_scan_k.launch_plan(nq, 5, **kw)
    for p in (plan, page_scan_k.launch_plan(nq, 5, threads=32, **kw),
              page_scan_k.launch_plan(nq, 5, threads=256, **kw)):
        assert p.threads % 32 == 0 and 32 <= p.threads <= page_scan_k.MAX_THREADS
        assert (p.smem_bytes, p.pages_per_chunk) == (0, 1)
        assert p.pages_per_block == p.threads // 32
        assert p.grid == -(-nq * 5 // p.pages_per_block)
        assert _warps_cover_every_item_once(p, nq, 5)
    assert plan.threads // 32 <= page_scan_k.MEMBERS_WARPS
    assert plan.grid >= min(132, nq * 5) or plan.threads == 32


@pytest.mark.parametrize("items", [1, 131, 264, 528, 5000])
def test_members_threads_is_the_members_plans_block(items):
    """``page_gather_l2`` takes its block size from ``members_threads``,
    the members-only scan's own choice: 4 warps, halved while the blocks
    are fewer than the SMs."""
    plan = page_scan_k.launch_plan(items, 1, capacity=6, dim=128, rp=48, m=0,
                                   k=0, compute_adc=False, sms=132)
    assert page_scan_k.members_threads(items, 132) == plan.threads
    assert page_scan_k.members_threads(items, 132) == {
        1: 32, 131: 32, 264: 64, 528: 128, 5000: 128}[items]


# ------------------------------------------------------------- dispatch
def test_record_layout_is_the_reference_geometry():
    for dim in (8, 16, 24, 32, 100, 128, 129, 200, 384):
        assert tlayout.vectors_per_row(dim) == jlayout.vectors_per_row(dim)
        assert tlayout.rows_per_vector(dim) == jlayout.rows_per_vector(dim)
        for cap in (1, 4, 6, 7, 27, 30):
            assert tlayout.member_rows(cap, dim) == jlayout.member_rows(cap, dim)
            for m in (0, 4, 16):
                assert tlayout.record_rows(cap, dim, m) == jlayout.record_rows(cap, dim, m)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    recs, ids, q, lut = _page_inputs(7, 4, 16, 12, 4, 3)
    ops.reset_launch_counts()
    t = [torch.as_tensor(a) for a in (recs, ids, q, lut)]
    got = ops.page_scan(*t, capacity=4, dim=16, rp=12)
    want = tref.page_scan_ref(*t, capacity=4, dim=16, rp=12)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    mask = torch.ones((3, 3, 4))
    got = ops.page_scan(*t, capacity=4, dim=16, rp=12, member_mask=mask)
    assert torch.equal(got[0], want[0])
    got = ops.page_scan_recs(t[0][t[1].long()], *t[2:], capacity=4, dim=16,
                             rp=12, member_mask=mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ops.pq_adc(torch.zeros((1, 3, 4), dtype=torch.uint8), t[3][:1])
    ops.hamming(torch.zeros((5, 2), dtype=torch.int32),
                torch.zeros((1, 2), dtype=torch.int32))
    ops.l2_distance(t[2], t[2])
    ops.page_gather_l2(torch.zeros((2, 4, 16)), t[1] % 2, t[2])
    ops.delta_scan(t[2], t[2], torch.ones(3, dtype=torch.bool), 2)
    ops.pq_lut(t[2], torch.zeros((4, 256, 4)))
    counts = ops.launch_counts()
    assert set(counts) == {
        "page_scan", "page_scan_members", "page_scan_masked",
        "page_scan_members_masked", "page_scan_recs", "page_scan_recs_members",
        "page_scan_recs_masked", "page_scan_recs_members_masked", "pq_adc",
        "hamming", "l2_distance", "page_gather_l2", "pq_lut"}
    assert not any(counts.values())


def test_kernel_route_refuses_cpu_tensors():
    """No fallback: the kernel wrappers reject CPU inputs before touching
    the library, and ``ops`` takes no route but the device's or "plain"."""
    recs, ids, q, lut = (torch.as_tensor(a) for a in _page_inputs(7, 4, 16, 12, 4, 3))
    for impl in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="impl"):
            ops.hamming(torch.zeros((2, 1), dtype=torch.int32),
                        torch.zeros((1, 1), dtype=torch.int32), impl=impl)
    with pytest.raises(ValueError, match="CUDA"):
        page_scan_k.page_scan(recs, ids, q, lut, capacity=4, dim=16, rp=12)
    with pytest.raises(ValueError, match="CUDA"):
        page_scan_k.page_scan_recs(recs[ids.long()], q, lut, capacity=4,
                                   dim=16, rp=12)
    with pytest.raises(ValueError, match="CUDA"):
        pq_adc_k.pq_adc(torch.zeros((1, 3, 4), dtype=torch.uint8), lut[:1])
    with pytest.raises(ValueError, match="CUDA"):
        hamming_k.hamming(torch.zeros((5, 2), dtype=torch.int32),
                          torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        l2_distance_k.l2_distance(q, q)
    with pytest.raises(ValueError, match="CUDA"):
        page_gather_k.page_gather_l2(torch.zeros((2, 4, 16)), ids % 2, q)


def test_fused_entry_points_take_the_plain_version_on_cpu_and_refuse_it():
    """``pq_adc_gather`` and the keep-masked ``l2_distance`` run their plain
    versions on CPU tensors and count no launch; their kernel wrappers
    refuse CPU tensors."""
    rng = np.random.default_rng(6)
    table = torch.as_tensor(rng.integers(0, 256, (20, 8)).astype(np.uint8))
    ids = torch.as_tensor(rng.integers(0, 20, (2, 5)))
    lut = torch.as_tensor(rng.random((2, 8, 256)).astype(np.float32))
    q = torch.as_tensor(rng.standard_normal((3, 16)).astype(np.float32))
    keep = torch.tensor([True, False, True])
    ops.reset_launch_counts()
    ops.pq_adc_gather(table, ids, lut)
    ops.l2_distance(q, q, keep)
    assert not any(ops.launch_counts().values())
    with pytest.raises(ValueError, match="CUDA"):
        pq_adc_k.pq_adc_gather(table, ids, lut)
    with pytest.raises(ValueError, match="CUDA"):
        l2_distance_k.l2_distance(q, q, keep)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """A host that cannot compile the kernels gets an error, never a
    silent switch to the plain versions."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert _build.library_path().parent == tmp_path
    assert _build.library_path().name.startswith("libpageann_kernels-")


def test_host_library_builds_once_and_is_optional(tmp_path, monkeypatch):
    """The host routines build once per source hash and are reused from
    then on, with or without a compiler; a host with neither a compiler
    nor a built library gets None (the fetcher's plain loop), and an
    explicit build there raises."""
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path)
    path = _build.host_library_path()
    assert path.parent == tmp_path
    assert path.name.startswith("libpageann_host-")
    if _build._cxx() is not None:
        built, seconds = _build.build_host()
        assert built == path and path.exists() and seconds > 0.0
        assert _build.build_host() == (path, 0.0)
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        assert _build.host_library.__wrapped__() is not None
        path.unlink()
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        _build.build_host()
    assert _build.host_library.__wrapped__() is None


def test_port_imports_no_jax_and_nothing_of_repro():
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)\b(?!_)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(files) > 10
    offenders = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files for m in pattern.finditer(f.read_text())
    ]
    assert not offenders, offenders
