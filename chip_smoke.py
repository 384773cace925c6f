#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card; 5-7 minutes

Drives the port alone (no JAX, nothing of ``src/repro``) through its user
entry points and checks each hand-written kernel against its plain PyTorch
version. Phases, one JSON line each:

  device    the card's name and power limit
  build     compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
  kernels   each kernel vs its plain version at the main path's shapes
            (and both record packings, d = 32 / 128 / 200), with times
  sift1m    the kernels on SIFT1M-size state: 1,000,000 vectors at d = 128
            in HYBRID pages (about 2 GB of records on the device)
  e2e       ``PageANNIndex.build`` -> ``search`` -> ``recall_at_k`` in
            HYBRID (the main path) and MEM_ALL (members-only page scan),
            once through the kernels and once through the plain versions

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line,
and last ``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero without the last line. It also exits non-zero when no
CUDA device is present or when it is run outside a checkout of the repo.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-4     # float kernels: the summation order differs
N_QUERIES = 1000            # one search batch, as a serving engine would send

KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "page_scan": ("src/repro_torch/kernels/csrc/page_scan.cu",
                  "src/repro/kernels/page_scan.py:296"),
    "page_scan_members": ("src/repro_torch/kernels/csrc/page_scan.cu",
                          "src/repro/kernels/page_scan.py:296"),
    "pq_adc": ("src/repro_torch/kernels/csrc/pq_adc.cu",
               "src/repro/kernels/pq_adc.py:34"),
    "hamming": ("src/repro_torch/kernels/csrc/hamming.cu",
                "src/repro/kernels/hamming.py:27"),
}


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


class Smoke:
    """Measurements shared across phases, keyed by kernel name."""

    def __init__(self, torch, seed: int):
        self.torch = torch
        self.seed = seed
        self.err = {name: 0.0 for name in KERNELS}
        self.rows: dict = {}

    # ---------------------------------------------------------------- timing
    def time_ms(self, fn, reps: int) -> float:
        """Device milliseconds per call of ``fn``.

        A wrapper call costs tens of microseconds on the host, longer than
        these kernels run, so back-to-back launches would time the host. A
        sleep kernel holds the stream while all ``reps`` calls are queued
        behind it; the events then bracket the calls' device work alone. If
        the sleep ran out before the queue was full, retry with a longer one.
        """
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        cycles = 50_000_000
        for _ in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            queued_in_time = not start.query()
            torch.cuda.synchronize()
            if queued_in_time:
                return start.elapsed_time(end) / reps
            cycles *= 4
        raise RuntimeError("could not queue the timed calls behind the sleep")

    def call_ms(self, fn, reps: int) -> float:
        """Host wall milliseconds per call, device work included: what the
        search loop pays for one call."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def compare(self, name: str, got, want, *, exact: bool = False) -> float:
        torch = self.torch
        torch.cuda.synchronize()
        if exact:
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: kernel and plain version differ")
            err = 0.0
        else:
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name}: kernel returned non-finite values")
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            err = float((got - want).abs().max())
        self.err[name] = max(self.err[name], err)
        return err


def _bound(bytes_: int, ops_: int) -> dict:
    """The least time the card could take: bytes moved over the memory
    rate or operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops_ / F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_, operations=ops_)


# ------------------------------------------------------------------ phases
def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return {"smi": smi}


def phase_build() -> None:
    from repro_torch.kernels import _build

    path, seconds = _build.build()
    _build.library()
    log = Path(str(path) + ".log")
    usage = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln] if log.exists() else []
    emit("build", seconds=seconds, library=str(path.relative_to(ROOT)),
         ptxas=usage)


def _geometry(cfg):
    from repro_torch.kernels import record_layout as rl

    cap = cfg.resolve_capacity()
    m = 0 if cfg.memory_mode.value == "mem_all" else cfg.pq_subspaces
    return cap, rl.record_rows(cap, cfg.dim, m), rl.member_rows(cap, cfg.dim), m


def _records_np(rng, pages, cap, dim, rp, m):
    from repro_torch.core.layout import pack_page_records

    vecs = rng.standard_normal((pages, cap, dim)).astype("float32")
    codes = rng.integers(0, 256, (pages, rp, m)).astype("uint8")
    return pack_page_records(vecs, codes)


def _page_scan_case(s: Smoke, recs, ids, q, lut, *, cap, dim, rp, m,
                    adc: bool, reps: int) -> dict:
    """Kernel vs plain version on one input, with times and the byte bound."""
    torch = s.torch
    from repro_torch.kernels import ops

    name = "page_scan" if adc else "page_scan_members"
    kw = dict(capacity=cap, dim=dim, rp=rp, compute_adc=adc)
    got = ops.page_scan(recs, ids, q, lut, **kw)
    want = ops.page_scan(recs, ids, q, lut, impl="plain", **kw)
    err = s.compare(name, got[0], want[0])

    # the kernel alone, on inputs already in its dtype; call_ms below times
    # the whole dispatch (the id cast included)
    from repro_torch.kernels import page_scan as page_scan_k

    ids32 = ids.to(torch.int32).contiguous()

    def kernel():
        return page_scan_k.page_scan(recs, ids32, q, lut if adc else None, **kw)

    def call():
        return ops.page_scan(recs, ids, q, lut, **kw)

    def plain():
        return ops.page_scan(recs, ids, q, lut, impl="plain", **kw)

    if adc:
        err = max(err, s.compare(name, got[1], want[1]))
    nq, b = ids.shape
    used_m = m if adc else 0
    # each distinct page's members (cap x dim floats) and, with ADC, the
    # rp columns of its M code rows; not the rows' padding lanes
    pages_read = int(torch.unique(ids).numel())
    bytes_ = (pages_read * (cap * dim + used_m * rp) * 4 + ids.numel() * 4
              + q.numel() * 4 + (lut.numel() * 4 if adc else 0)
              + nq * b * (cap + (rp if adc else 0)) * 4)
    ops_ = nq * b * (cap * dim * 3 + rp * used_m)
    return dict(
        name=name, dim=dim, q=nq, b=b, capacity=cap, max_abs_err=err,
        ms=s.time_ms(kernel, reps),
        call_ms=s.call_ms(call, reps),
        plain_ms=s.time_ms(plain, max(3, reps // 5)),
        **_bound(bytes_, ops_),
        library_ms=None,
    )


def _pq_adc_case(s: Smoke, codes, lut, reps: int) -> dict:
    torch = s.torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    got = ops.pq_adc(codes, lut)
    err = s.compare("pq_adc", got, ops.pq_adc(codes, lut, impl="plain"))
    nq, n, m = codes.shape
    k = lut.shape[2]
    # the yardstick: one embedding_bag over the flattened tables, each code
    # row a bag of M lookups (timed here only; the port never calls it)
    base = (torch.arange(nq, device=codes.device)[:, None, None] * m * k
            + torch.arange(m, device=codes.device)[None, None, :] * k)
    flat_idx = (base + codes.long()).reshape(nq * n, m)
    table = lut.reshape(nq * m * k, 1)
    lib = F.embedding_bag(flat_idx, table, mode="sum").reshape(nq, n)
    torch.testing.assert_close(lib, got, rtol=RTOL, atol=ATOL)
    bytes_ = codes.numel() + lut.numel() * 4 + nq * n * 4
    ops_ = nq * n * m
    return dict(
        name="pq_adc", q=nq, n=n, m=m, max_abs_err=err,
        ms=s.time_ms(lambda: ops.pq_adc(codes, lut), 50),
        call_ms=s.call_ms(lambda: ops.pq_adc(codes, lut), 50),
        plain_ms=s.time_ms(lambda: ops.pq_adc(codes, lut, impl="plain"), 10),
        **_bound(bytes_, ops_),
        library_ms=s.time_ms(
            lambda: F.embedding_bag(flat_idx, table, mode="sum"), 50),
    )


def _hamming_case(s: Smoke, codes, qcodes) -> dict:
    from repro_torch.kernels import ops

    got = ops.hamming(codes, qcodes)
    err = s.compare("hamming", got, ops.hamming(codes, qcodes, impl="plain"),
                    exact=True)
    (sn, w), nq = codes.shape, qcodes.shape[0]
    bytes_ = codes.numel() * 4 + qcodes.numel() * 4 + nq * sn * 4
    ops_ = nq * sn * w * 3
    return dict(
        name="hamming", q=nq, s=sn, w=w, max_abs_err=err,
        ms=s.time_ms(lambda: ops.hamming(codes, qcodes), 50),
        call_ms=s.call_ms(lambda: ops.hamming(codes, qcodes), 50),
        plain_ms=s.time_ms(lambda: ops.hamming(codes, qcodes, impl="plain"), 10),
        **_bound(bytes_, ops_),
        library_ms=None,
    )


def phase_kernels(s: Smoke, cfg_hybrid, cfg_memall, n_vectors: int,
                  n_queries: int) -> None:
    """Every kernel against its plain version at the shapes the main path
    hands it: a whole hop's (Q, b) page batch, the HYBRID re-score of
    b * Rp neighbours, the T entry estimates, the LSH sweep."""
    import dataclasses

    import numpy as np

    torch = s.torch
    dev = torch.device("cuda")
    rng = np.random.default_rng(s.seed)
    b = cfg_hybrid.io_batch
    rp = cfg_hybrid.page_degree
    cases = []
    # the main path (HYBRID, d = 128) and both packings on either side
    geoms = [
        (cfg_hybrid, True),
        (dataclasses.replace(cfg_hybrid, dim=32), True),
        (dataclasses.replace(cfg_hybrid, dim=200, pq_subspaces=8), True),
        (cfg_memall, False),
        (dataclasses.replace(cfg_memall, dim=32), False),
        (dataclasses.replace(cfg_memall, dim=200, pq_subspaces=8), False),
    ]
    for cfg, adc in geoms:
        cap, rows, _, m = _geometry(cfg)
        pages = -(-n_vectors // cap)
        recs = torch.as_tensor(_records_np(rng, pages, cap, cfg.dim, rp, m)).to(dev)
        assert recs.shape[1] == rows
        ids = torch.as_tensor(
            rng.integers(0, pages, (n_queries, b)).astype(np.int32)).to(dev)
        q = torch.as_tensor(
            rng.standard_normal((n_queries, cfg.dim)).astype(np.float32)).to(dev)
        lut = torch.as_tensor(rng.random(
            (n_queries, max(m, 1), cfg.pq_ksub)).astype(np.float32)).to(dev)
        row = _page_scan_case(s, recs, ids, q, lut, cap=cap, dim=cfg.dim,
                              rp=rp, m=m, adc=adc, reps=50)
        cases.append(row)
        if cfg is cfg_hybrid:
            s.rows["page_scan"] = row
        if cfg is cfg_memall:
            s.rows["page_scan_members"] = row
        del recs

    m_mem = 2 * cfg_hybrid.pq_subspaces
    n_mem = -(-n_vectors // 6) * 6
    mem_codes = torch.as_tensor(
        rng.integers(0, 256, (n_mem, m_mem)).astype(np.uint8)).to(dev)
    nids = torch.as_tensor(rng.integers(0, n_mem, (n_queries, b * rp))).to(dev)
    lut_mem = torch.as_tensor(
        rng.random((n_queries, m_mem, 256)).astype(np.float32)).to(dev)
    row = _pq_adc_case(s, mem_codes[nids].contiguous(), lut_mem, 50)
    s.rows["pq_adc"] = row
    cases.append(row)
    entries = cfg_hybrid.lsh_entries
    m_disk = cfg_hybrid.pq_subspaces
    codes = torch.as_tensor(rng.integers(
        0, 256, (n_queries, entries, m_disk)).astype(np.uint8)).to(dev)
    lut_disk = torch.as_tensor(
        rng.random((n_queries, m_disk, 256)).astype(np.float32)).to(dev)
    cases.append(_pq_adc_case(s, codes, lut_disk, 50))

    words = cfg_hybrid.lsh_bits // 32
    lsh = torch.as_tensor(rng.integers(
        -2**31, 2**31, (cfg_hybrid.lsh_sample, words)).astype(np.int32)).to(dev)
    qc = torch.as_tensor(rng.integers(
        -2**31, 2**31, (n_queries, words)).astype(np.int32)).to(dev)
    row = _hamming_case(s, lsh, qc)
    s.rows["hamming"] = row
    cases.append(row)
    for row in cases:
        emit("kernels", **row)


def phase_sift1m(s: Smoke, cfg_hybrid, cfg_memall) -> None:
    """The kernels over state of SIFT1M size: 1,000,000 vectors at d = 128,
    made on the device from the seed, one hop of Q = 1,024 x b = 5."""
    torch = s.torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(s.seed)
    n, nq, b = 1_000_000, 1024, cfg_hybrid.io_batch
    rp = cfg_hybrid.page_degree
    for cfg, adc in ((cfg_hybrid, True), (cfg_memall, False)):
        cap, rows, mrows, m = _geometry(cfg)
        pages = -(-n // cap)
        # d = 128: member i fills row i of the record; code rows follow
        recs = torch.zeros((pages, rows, 128), device=dev)
        recs[:, :mrows] = torch.randn((pages, mrows, 128), generator=gen, device=dev)
        if m:
            recs[:, mrows:mrows + m, :rp] = torch.randint(
                0, 256, (pages, m, rp), generator=gen, device=dev).float()
        ids = torch.randint(0, pages, (nq, b), generator=gen, device=dev,
                            dtype=torch.int32)
        q = torch.randn((nq, 128), generator=gen, device=dev)
        lut = torch.rand((nq, max(m, 1), 256), generator=gen, device=dev)
        row = _page_scan_case(s, recs, ids, q, lut, cap=cap, dim=128, rp=rp,
                              m=m, adc=adc, reps=20)
        emit("sift1m", pages=pages, record_bytes=recs.numel() * 4, **row)
        del recs
        torch.cuda.empty_cache()
    n_mem = -(-n // 6) * 6
    mem_codes = torch.randint(0, 256, (n_mem, 32), generator=gen, device=dev,
                              dtype=torch.uint8)
    nids = torch.randint(0, n_mem, (nq, b * rp), generator=gen, device=dev)
    lut = torch.rand((nq, 32, 256), generator=gen, device=dev)
    emit("sift1m", mem_codes_bytes=mem_codes.numel(),
         **_pq_adc_case(s, mem_codes[nids].contiguous(), lut, 20))
    words = cfg_hybrid.lsh_bits // 32
    lsh = torch.randint(-2**31, 2**31 - 1, (cfg_hybrid.lsh_sample, words),
                        generator=gen, device=dev, dtype=torch.int32)
    qc = torch.randint(-2**31, 2**31 - 1, (nq, words), generator=gen,
                       device=dev, dtype=torch.int32)
    emit("sift1m", **_hamming_case(s, lsh, qc))


def _profile_search(index, q) -> dict:
    """One more search under ``torch.profiler``: the device's busy time
    (kernels and copies on the card) against the wall clock, and the device
    work by name. The profiler slows the host, so its wall time is longer
    than an unprofiled search's; both shares are reported."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = index.search(q, k=10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    hops = max(1, int(res.hops.max()))
    return dict(
        profiled_wall_ms=wall * 1e3,
        device_busy_ms=busy if by_name else None,
        device_launches=sum(n for _, n in by_name.values()),
        top=[dict(name=name[:90], device_ms=ms, count=n)
             for name, (ms, n) in top],
        hops=hops,
    )


def run_e2e(cfg, n: int, n_queries: int, *, device: str, seed: int,
            label: str = "e2e") -> dict:
    """Build -> search -> recall through the port's entry points; then the
    same search through the plain versions, which must agree."""
    import dataclasses

    import numpy as np

    from repro_torch.core import PageANNIndex, recall_at_k
    from repro_torch.core.vamana import brute_force_knn
    from repro_torch.data.pipeline import clustered_vectors, query_vectors
    from repro_torch.kernels import ops

    x = clustered_vectors(n, cfg.dim, num_clusters=64, seed=seed)
    q = query_vectors(x, n_queries, seed=seed + 1)
    t0 = time.perf_counter()
    index = PageANNIndex.build(x, cfg, device=device)
    build_s = time.perf_counter() - t0
    truth = brute_force_knn(x, q, 10)

    def sync():
        if device == "cuda":
            import torch

            torch.cuda.synchronize()

    def timed(impl):
        t0 = time.perf_counter()
        out = index.search(q, k=10, impl=impl)
        sync()
        return out, time.perf_counter() - t0

    index.search(q, k=10)                     # warm-up: allocator, library
    index.search(q, k=10, impl="plain")
    sync()
    ops.reset_launch_counts()
    res, wall = timed(None)                   # the main path, counted
    launches = ops.launch_counts()
    plain, plain_wall = timed("plain")
    walls, plain_walls = [wall], [plain_wall]
    for order in ((None, "plain"), ("plain", None)) * 2:   # in turns
        for impl in order:
            (walls if impl is None else plain_walls).append(timed(impl)[1])

    profile = _profile_search(index, q) if device == "cuda" else None
    wall, plain_wall = float(np.median(walls)), float(np.median(plain_walls))
    if profile is not None and profile["device_busy_ms"] is not None:
        profile["device_idle_share"] = 1.0 - profile["device_busy_ms"] / (wall * 1e3)
        profile["host_ms_per_hop"] = wall * 1e3 / profile["hops"]

    recall = recall_at_k(res.ids, truth)
    agree = float((res.ids == plain.ids).all(1).mean())
    hops = float(res.hops.mean())
    out = dict(
        mode=cfg.memory_mode.value, n=n, dim=cfg.dim, queries=n_queries,
        build_s=build_s, stats=dataclasses.asdict(index.stats),
        qps=n_queries / wall, plain_qps=n_queries / plain_wall,
        search_s=wall, search_s_runs=walls, plain_search_s_runs=plain_walls,
        recall_at_10=recall,
        plain_recall_at_10=recall_at_k(plain.ids, truth),
        mean_ios=float(res.ios.mean()), mean_hops=hops,
        mean_cache_hits=float(res.cache_hits.mean()),
        ids_agree_share=agree,
        dists_max_abs_diff=float(np.abs(res.dists - plain.dists)[
            np.isfinite(res.dists)].max()),
        launches=launches,
        profile=profile,
        launches_per_hop={k: v / max(1.0, float(res.hops.max()))
                          for k, v in launches.items()},
    )
    emit(label, **out)
    if not (np.isfinite(res.dists[:, 0]).all() and res.ids.shape == (n_queries, 10)):
        raise AssertionError(f"{label}: malformed results")
    if agree < 0.99:
        raise AssertionError(f"{label}: kernel and plain paths agree on ids "
                             f"for only {agree:.4f} of queries")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # 10,000: the Vamana build's host-side prune takes 14-19 ms a vector on
    # the card's host, so 20,000 would not fit in 5 minutes
    ap.add_argument("--n", type=int, default=10_000,
                    help="vectors in each end-to-end build (HYBRID, MEM_ALL)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import MemoryMode, PageANNConfig

    t_start = time.perf_counter()
    smoke = Smoke(torch, args.seed)
    cfg_h = PageANNConfig(dim=128, build_rounds=1, memory_mode=MemoryMode.HYBRID)
    cfg_m = PageANNConfig(dim=128, build_rounds=1, memory_mode=MemoryMode.MEM_ALL)
    dev_info = phase_device(torch)
    phase_build()
    phase_kernels(smoke, cfg_h, cfg_m, args.n, N_QUERIES)
    phase_sift1m(smoke, cfg_h, cfg_m)
    torch.cuda.empty_cache()

    main_run = run_e2e(cfg_h, args.n, N_QUERIES, device="cuda",
                       seed=args.seed)
    if main_run["recall_at_10"] < 0.90:
        raise AssertionError(f"HYBRID recall@10 {main_run['recall_at_10']} < 0.90")
    memall = run_e2e(cfg_m, args.n, N_QUERIES, device="cuda",
                     seed=args.seed, label="e2e_memall")
    launches = dict(main_run["launches"])
    launches["page_scan_members"] = memall["launches"]["page_scan_members"]
    for name in ("page_scan", "pq_adc", "hamming"):
        if main_run["launches"][name] <= 0:
            raise AssertionError(f"{name} never launched on the HYBRID path")
    for name in ("page_scan_members", "pq_adc", "hamming"):
        if memall["launches"][name] <= 0:
            raise AssertionError(f"{name} never launched on the MEM_ALL path")

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = smoke.rows[name]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=smoke.err[name],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": rows}), flush=True)
    print(dev_info["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
