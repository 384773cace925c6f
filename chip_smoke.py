#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card; 15-18 minutes

Drives the port alone (no JAX, nothing of ``src/repro``) through its user
entry points and checks each hand-written kernel against its plain PyTorch
version. Phases, one JSON line each:

  device    the card's name and power limit
  build     compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
  kernels   each kernel vs its plain version at the main path's shapes
            (and both record packings, d = 32 / 128 / 200), with times;
            the masked (filtered) and staged (streamed) page-scan variants,
            all eight also at Q = 64; the members-only scores must equal
            the ADC variants' bit for bit on the same records
  sift1m    the kernels on SIFT1M-size state: 1,000,000 vectors at d = 128
            in HYBRID pages (about 2 GB of records on the device), and one
            streamed hop with 25% of those pages on the card and the rest
            read from a pages.bin memmap
  lm_serve  the dense decoder at granite-3-2b's full CONFIG (40 layers,
            d_model 2048, 2,635,237,376 f32 parameters) on the card:
            ``generate`` (batch 8, 32 prompt tokens prefilled token by
            token, 16 greedy) timed, one decode step profiled (launches,
            idle share) against its weights-read bound, prefill = decode
            within 2e-2, a 2-layer cut held to the CPU; 1,000 documents
            (mean token embeddings, d = 2048: HYBRID capacity 1) in a
            PageANN index and a two-collection database; the port's serving
            driver ``repro_torch.launch.serve.main`` over ``--index-dir``,
            ``--mutable`` (self-retrieval), ``--memory-budget 0.25`` (the
            resident run's ids) and ``--db-dir`` with routing, the semantic
            cache (every replay a hit), the metrics sidecar's self-check, a
            trace and the HTTP frontend; 1,000 queries through the kernels
            and the plain versions, resident, streamed and mutable (1,000
            inserts), with recall@10; ``page_scan``, ``page_scan_recs``,
            ``pq_adc``, ``hamming`` and ``l2_distance`` at these shapes
  lm_families  the MoE, SSM, hybrid, audio and VLM families at their
            CONFIG's full width, one model at a time: mamba2-370m (48
            layers), recurrentgemma-9b (38), hubert-xlarge (48, encoder),
            qwen2-vl-72b (8 of 80, M-RoPE positions on every step),
            arctic-480b (1 of 35, 128 experts, dense residual) and
            kimi-k2-1t-a32b (1 of 61, 384 experts, bf16 parameters), each
            depth cut printed under ``reduced``: ``generate`` timed and a
            step profiled against its weights-read bound (the encoder: a
            forward of 8 x 256 frames), prefill = decode within 2e-2 for
            the SSM and the hybrid; each family's 2-layer cut (the hybrid:
            one block; the MoE: 8 experts) held card against CPU; then
            recurrentgemma-9b's driver over 1,000 documents at d = 4096
            (HYBRID, capacity 1): ``--index-dir`` and ``--memory-budget
            0.25`` (equal ids), 1,000 queries through the kernels and the
            plain versions, resident and streamed, and the on-path
            kernels at these shapes
  e2e       ``PageANNIndex.build`` (with a seeded metadata schema) ->
            ``search`` -> ``recall_at_k`` in HYBRID (the main path, 10,000
            vectors) and MEM_ALL (members-only page scan, 5,000 vectors:
            half the depth, so the baselines' build fits the time), once
            through the kernels and once through the plain versions
  stream    each e2e index saved and reloaded under a 0.25 memory budget:
            the streamed search must equal the resident one exactly
  filter    filtered search at selectivities 0.5 / 0.1 / 0.01 and a
            conjunction, resident and streamed, kernels and plain, held to
            a post-filter brute force
  adaptive  each e2e index searched with ``AdaptiveParams``: early
            termination (patience 2, 4), entry selection (2 bits of slack,
            4 entries at least) and both, kernels and plain, resident and
            streamed (equal exactly), one filtered search at selectivity
            0.1 with patience 2; ``AdaptiveParams()`` must equal the plain
            search exactly, a setting with patience may not hop or read
            more than the same setting without it; in HYBRID, ``autotune``
            to recall 0.95 on a reloaded copy, saved and reloaded with the
            winner as its default params
  profile   ``index.profile`` against ``index.search`` (plain and patience
            2): equal results, a trail that sums to the totals, rendered
            by ``repro_torch.obs.report``; profiled against unprofiled time
  mutable   the HYBRID index wrapped in a ``MutableIndex``: 2,000 inserts
            (one unseen tag value), 100 upserts, 500 deletes; unified search
            through the kernels and the plain versions, unfiltered and
            filtered, held to a brute force over the live set; dirty save,
            load (resident and under the budget); then a compaction that
            an insert triggers on a 1,000-vector index
  baselines ``DiskANNIndex.build`` over the HYBRID e2e data and
            ``StarlingIndex.from_data`` on its graph and codebooks with
            ``group_pages``' layout, searched at the default SearchParams
            and at beam 128 through the kernels (``pq_adc`` estimates,
            ``page_gather_l2`` rerank) and the plain versions: ids equal
            for >= 99% of queries, ios and hops equal, recall@10 >= 0.85 at
            beam 128, Starling's mean ios below DiskANN's, a save and
            ``load_index`` equal exactly; printed beside PageANN's HYBRID
            recall, ios and QPS (the paper's comparison)
  serve     a ``VectorService`` over the HYBRID index (saved, attached),
            the DiskANN index and a ``MutableIndex`` over the HYBRID index,
            a ``BatchingEngine`` at batch 64: 1,000 requests from 4 threads
            equal to each collection's direct search; 300 more through a
            2 ms timeout and no flush (the timer's dispatches), equal as
            well, with their QPS and latency; the compile cache, 200
            inserts and 100 deletes, ``save_database`` / ``load_database``,
            ``HttpFrontend`` (20 searches, one ``/metrics`` scrape), every
            engine span phase; the engine's QPS and p50 / p99 latency
  sharded   ``ShardedPageStore.build`` over the HYBRID e2e data, 2 shards
            (one more Vamana build in all): the host fan-out through the
            kernels and the plain versions (ids >= 99%, ios and hops
            exactly) at the default SearchParams and at beam 128,
            recall@10 >= 0.85 at beam 128, each point's recall beside the
            unsharded index's and its QPS beside the unsharded QPS; the
            mesh fan-out on a (2, 1) mesh naming the card twice = the host
            fan-out (ids, ios, dists), hops and cache hits 0 (over two
            distinct cards too when there are two);
            ``index.search(mesh=)`` on (1, 1) and (1, 2) meshes = the
            search; save / ``load_index`` and a 0.25 budget per shard =
            the search; a ``VectorService`` over the store, its reload with
            the mesh and the HYBRID index with a mesh = each direct search;
            ``MutableIndex.search(mesh=)`` = without the mesh

The kernels phase also holds ``l2_distance`` (the delta scan, with and
without its keep mask) and ``page_gather_l2`` against their plain versions,
``pq_adc`` both as the path calls it (``pq_adc_gather``: the code rows read
by id inside the kernel) and on codes gathered first, and ``hamming`` both
as the path calls it (``hamming_topk``: the sweep and the routing's stable
top-T in one kernel, bit for bit against the distance kernel, a cast and a
stable sort, timed beside it) and alone (``ops.hamming``); the sift1m phase
runs one delta scan over 262,144 vectors and the re-score over 1,000,000
code rows. Each e2e search must launch ``hamming`` once and sort no (Q, S)
row of distances. The compaction must equal a fresh build of the merged set
in every array and search output. Each kernel's launches come from the path
it serves, counted from 0 just before that path's run: ``page_gather_l2``'s
from the DiskANN search (its exact rerank, where it is timed at the
baseline's shapes, (N, 1, d) pages), the distances alone from their own
entry point ``ops.hamming``, driven once in the kernels phase; each
row's ``launches_sharded`` from the sharded phase's counted host fan-out,
``launches_lm_serve`` from the lm_serve phase's four driver runs,
``lm_serve_d2048`` the kernel's time, bound and launches at that phase's
d = 2048 shapes (rows 1-5), and ``launches_lm_families`` /
``lm_families_d4096`` the same for the lm_families phase's two driver runs
and its d = 4096 searches (rows 1-4).
Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power
line, and last ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero without the last line. It also exits non-zero
when no CUDA device is present or when it is run outside a checkout of the
repo.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SCRATCH = ROOT / "build" / "smoke_tmp"   # temporary artifacts (gitignored)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
INF = float("inf")
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-4     # float kernels: the summation order differs
N_QUERIES = 1000            # one search batch, as a serving engine would send
# MEM_ALL's e2e vectors: half the main path's depth. The baselines' Vamana
# build costs as much as an e2e build (153-167 s against 139-171 s on the
# card's host), and with MEM_ALL at 10,000 the smoke took 493 s before that
# build was added: the extra one would take it past 9 minutes
N_MEMALL = 5000
BUDGET = 0.25               # the streamed tier: a quarter of the pages resident
SELECTIVITIES = (0.5, 0.1, 0.01)
MIN_RECALL = 0.90           # recall@10: HYBRID unfiltered, every filtered search,
                            # the mutable index over its live set
# l2_distance computes |q|^2 - 2 q.x + |x|^2: its rounding error scales with
# the squared norms, not with the distance (ROADMAP C1), so its atol is this
# factor times max|q|^2 + max|x|^2 (about 16 float32 ulps of the largest)
L2_ATOL_PER_NORM = 1e-6
N_INSERTS, N_UPSERTS, N_DELETES = 2000, 100, 500   # the mutable phase's writes
N_COMPACT_BASE = 1000       # the compaction's base: a build of its own
# the adaptive phase's settings (AdaptiveParams): early termination alone,
# entry selection alone, and both; a setting with patience is held to the
# hops and ios of the same setting without it (the plain search if none)
ADAPTIVE = {
    "patience2": dict(patience=2),
    "patience4": dict(patience=4),
    "slack2-min4": dict(entry_slack_bits=2, min_entries=4),
    "patience2-slack2-min4": dict(patience=2, entry_slack_bits=2, min_entries=4),
    "patience4-slack2-min4": dict(patience=4, entry_slack_bits=2, min_entries=4),
}
ADAPTIVE_NAME = {tuple(sorted(kw.items())): name for name, kw in ADAPTIVE.items()}
AUTOTUNE_RECALL = 0.95      # the adaptive phase's autotune target (HYBRID)

_CU = "src/repro_torch/kernels/csrc/page_scan.cu"
_PAGE_SCAN = "src/repro/kernels/page_scan.py:296"
_PAGE_SCAN_RECS = "src/repro/kernels/page_scan.py:179"

KERNELS = {
    # name: (source, the TPU kernel it replaces)
    "page_scan": (_CU, _PAGE_SCAN),
    "page_scan_members": (_CU, _PAGE_SCAN),
    "page_scan_masked": (_CU, _PAGE_SCAN),
    "page_scan_members_masked": (_CU, _PAGE_SCAN),
    "page_scan_recs": (_CU, _PAGE_SCAN_RECS),
    "page_scan_recs_members": (_CU, _PAGE_SCAN_RECS),
    "page_scan_recs_masked": (_CU, _PAGE_SCAN_RECS),
    "page_scan_recs_members_masked": (_CU, _PAGE_SCAN_RECS),
    "pq_adc": ("src/repro_torch/kernels/csrc/pq_adc.cu",
               "src/repro/kernels/pq_adc.py:34"),
    # the routing's sweep and stable top-T, one kernel (ops.hamming_topk)
    "hamming": ("src/repro_torch/kernels/csrc/hamming.cu",
                "src/repro/kernels/hamming.py:27"),
    # the sweep's distances alone (ops.hamming)
    "hamming_distances": ("src/repro_torch/kernels/csrc/hamming.cu",
                          "src/repro/kernels/hamming.py:27"),
    "l2_distance": ("src/repro_torch/kernels/csrc/l2_distance.cu",
                    "src/repro/kernels/l2dist.py:33"),
    "page_gather_l2": ("src/repro_torch/kernels/csrc/page_gather.cu",
                       "src/repro/kernels/page_gather.py:36"),
}


# the run each kernel's launch count comes from
PATHS = {
    "page_scan": "e2e", "pq_adc": "e2e", "hamming": "e2e",
    "page_scan_members": "e2e_memall",
    "page_scan_recs": "stream", "page_scan_recs_members": "stream_memall",
    "page_scan_masked": "filter", "page_scan_members_masked": "filter_memall",
    "page_scan_recs_masked": "filter (streamed)",
    "page_scan_recs_members_masked": "filter_memall (streamed)",
    "l2_distance": "mutable (the delta scan)",
    "page_gather_l2": "baselines (the DiskANN search's exact rerank)",
    "hamming_distances": "kernels (its only caller is ops.hamming)",
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

    def compare(self, name: str, got, want, *, exact: bool = False,
                atol: float = ATOL) -> float:
        torch = self.torch
        torch.cuda.synchronize()
        if exact:
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: kernel and plain version differ")
            err = 0.0
        else:
            # +inf only where a filter masked a member; equal positions
            if not torch.equal(torch.isfinite(got), torch.isfinite(want)) \
                    or torch.isnan(got).any():
                raise AssertionError(f"{name}: kernel's non-finite values "
                                     "differ from the plain version's")
            torch.testing.assert_close(got, want, rtol=RTOL, atol=atol)
            fin = torch.isfinite(got)
            err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
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


def _variant(adc: bool, masked: bool, staged: bool) -> str:
    return ("page_scan" + ("_recs" if staged else "")
            + ("" if adc else "_members") + ("_masked" if masked else ""))


def _page_scan_case(s: Smoke, recs, ids, q, lut, *, cap, dim, rp, m,
                    adc: bool, reps: int, masked: bool = False,
                    staged: bool = False) -> dict:
    """Kernel vs plain version on one input, with times and the byte bound.

    ``masked`` adds a filter mask passing about half the members;
    ``staged`` scores the records gathered into a (Q, b, rows, 128) batch,
    as the streamed tier hands them over, and must equal the by-id kernel
    bit for bit."""
    torch = s.torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import page_scan as page_scan_k

    name = _variant(adc, masked, staged)
    nq, b = ids.shape
    mask = None
    if masked:
        gen = torch.Generator(device=recs.device).manual_seed(s.seed + 1)
        mask = (torch.rand((nq, b, cap), generator=gen, device=recs.device)
                < 0.5).float()
    kw = dict(capacity=cap, dim=dim, rp=rp, compute_adc=adc, member_mask=mask)
    # the kernel alone on inputs already in its dtype (``kernel``), the
    # whole dispatch (``call``: the id cast included), the plain version
    ids32 = ids.to(torch.int32).contiguous()
    lut_k = lut if adc else None
    if staged:
        recs_b = recs[ids.long()].contiguous()

        def kernel():
            return page_scan_k.page_scan_recs(recs_b, q, lut_k, **kw)

        def call(impl=None):
            return ops.page_scan_recs(recs_b, q, lut, impl=impl, **kw)
    else:
        def kernel():
            return page_scan_k.page_scan(recs, ids32, q, lut_k, **kw)

        def call(impl=None):
            return ops.page_scan(recs, ids, q, lut, impl=impl, **kw)

    got, want = call(), call("plain")
    err = s.compare(name, got[0], want[0])
    if adc:
        err = max(err, s.compare(name, got[1], want[1]))
    if masked and not torch.equal(torch.isinf(got[0]), ~(mask > 0)):
        raise AssertionError(f"{name}: +inf is not exactly where the mask is 0")
    if staged:
        by_id = ops.page_scan(recs, ids, q, lut, **kw)
        if not (torch.equal(got[0], by_id[0])
                and (not adc or torch.equal(got[1], by_id[1]))):
            raise AssertionError(f"{name}: a staged record scores differently "
                                 "from the same record read by page id")
    used_m = m if adc else 0
    plan = page_scan_k.launch_plan(
        nq, b, capacity=cap, dim=dim, rp=rp, m=used_m,
        k=lut.shape[2] if adc else 0, compute_adc=adc,
        sms=torch.cuda.get_device_properties(recs.device).multi_processor_count)
    # each record's members (cap x dim floats) and, with ADC, the rp
    # columns of its M code rows, not the rows' padding lanes: once per
    # distinct page read by id, once per staged record (each is its own
    # copy in device memory)
    records = nq * b if staged else int(torch.unique(ids).numel())
    bytes_ = (records * (cap * dim + used_m * rp) * 4
              + (0 if staged else ids.numel() * 4)
              + q.numel() * 4 + (lut.numel() * 4 if adc else 0)
              + (mask.numel() * 4 if masked else 0)
              + nq * b * (cap + (rp if adc else 0)) * 4)
    ops_ = nq * b * (cap * dim * 3 + rp * used_m)
    return dict(
        name=name, dim=dim, q=nq, b=b, capacity=cap, max_abs_err=err,
        plan=plan._asdict(), ms=s.time_ms(kernel, reps),
        call_ms=s.call_ms(call, reps),
        plain_ms=s.time_ms(lambda: call("plain"), max(3, reps // 5)),
        **_bound(bytes_, ops_),
        library_ms=None,
    )


def _members_equal_adc(s: Smoke, recs, ids, q, lut, *, cap, dim, rp) -> None:
    """On records that hold code rows, the members-only scan's member scores
    equal the ADC scan's bit for bit (one per-member sum in both kernels),
    by page id and staged, masked and not; raises where they differ."""
    torch = s.torch
    from repro_torch.kernels import page_scan as page_scan_k

    nq, b = ids.shape
    gen = torch.Generator(device=recs.device).manual_seed(s.seed + 2)
    mask = (torch.rand((nq, b, cap), generator=gen, device=recs.device)
            < 0.5).float()
    recs_b = recs[ids.long()].contiguous()
    for mk in (None, mask):
        for staged in (False, True):
            def scan(adc):
                kw = dict(capacity=cap, dim=dim, rp=rp, compute_adc=adc,
                          member_mask=mk)
                if staged:
                    return page_scan_k.page_scan_recs(recs_b, q, lut, **kw)[0]
                return page_scan_k.page_scan(recs, ids, q, lut, **kw)[0]

            if not torch.equal(scan(False), scan(True)):
                raise AssertionError(
                    f"{_variant(False, mk is not None, staged)}: member "
                    f"scores differ from the ADC variant's at d = {dim}")


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


def _pq_adc_gather_case(s: Smoke, table, ids, lut, reps: int) -> dict:
    """``pq_adc_gather``, the path's call (each code row read by id inside
    the kernel), against its plain version and, bit for bit, against the
    ``pq_adc`` kernel on the codes gathered first; that unfused pair (a
    PyTorch gather, then the kernel) is timed beside it. No single PyTorch
    call computes the fused function, so ``library_ms`` is null; the
    pre-gathered case's ``embedding_bag`` is the yardstick of the sum."""
    torch = s.torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import pq_adc as pq_adc_k

    got = ops.pq_adc_gather(table, ids, lut)
    err = s.compare("pq_adc", got,
                    ops.pq_adc_gather(table, ids, lut, impl="plain"))
    if not torch.equal(got, ops.pq_adc(table[ids], lut)):
        raise AssertionError("pq_adc_gather: differs from the pq_adc kernel "
                             "on the same codes gathered first")
    nq, n = ids.shape
    m, k = table.shape[1], lut.shape[2]
    rows = int(torch.unique(ids).numel())
    plan = pq_adc_k.launch_plan(nq, n, m, k)
    # each query's table, each id, each distinct code row, the output
    bytes_ = lut.numel() * 4 + ids.numel() * ids.element_size() + rows * m \
        + nq * n * 4
    return dict(
        name="pq_adc", entry="pq_adc_gather", q=nq, n=n, m=m, k=k,
        table_rows=table.shape[0], distinct_rows=rows, max_abs_err=err,
        plan=plan._asdict(),
        blocks_per_sm=pq_adc_k.blocks_per_sm(plan.threads, plan.smem_bytes),
        ms=s.time_ms(lambda: ops.pq_adc_gather(table, ids, lut), reps),
        call_ms=s.call_ms(lambda: ops.pq_adc_gather(table, ids, lut), reps),
        gather_then_kernel_ms=s.time_ms(
            lambda: ops.pq_adc(table[ids], lut), reps),
        plain_ms=s.time_ms(
            lambda: ops.pq_adc_gather(table, ids, lut, impl="plain"),
            max(3, reps // 5)),
        **_bound(bytes_, nq * n * m),
        library_ms=None,
    )


def _hamming_case(s: Smoke, codes, qcodes) -> dict:
    """The sweep's distances alone (``ops.hamming``), exact against its
    plain version; its one counted call is the launch count of its path."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    got = ops.hamming(codes, qcodes)                  # the path, counted
    launches = ops.launch_counts()["hamming"]
    err = s.compare("hamming_distances", got,
                    ops.hamming(codes, qcodes, impl="plain"), exact=True)
    (sn, w), nq = codes.shape, qcodes.shape[0]
    bytes_ = codes.numel() * 4 + qcodes.numel() * 4 + nq * sn * 4
    ops_ = nq * sn * w * 3
    return dict(
        name="hamming_distances", entry="hamming", q=nq, s=sn, w=w,
        launches=launches, max_abs_err=err,
        ms=s.time_ms(lambda: ops.hamming(codes, qcodes), 50),
        call_ms=s.call_ms(lambda: ops.hamming(codes, qcodes), 50),
        plain_ms=s.time_ms(lambda: ops.hamming(codes, qcodes, impl="plain"), 10),
        **_bound(bytes_, ops_),
        library_ms=None,
    )


def _hamming_topk_case(s: Smoke, codes, qcodes, t: int) -> dict:
    """The routing as the path runs it (``ops.hamming_topk``: the sweep and
    its stable top-T in one kernel) against its plain version and, bit for
    bit, against the route it replaced: the distance kernel, the f32 cast,
    a stable ``torch.sort`` and the first t, timed beside it
    (``old_route_ms``). ``library_ms``: that stable sort alone on the
    precomputed distances. The bound counts the codes, the query codes and
    the (Q, t) values and indices once."""
    torch = s.torch
    from repro_torch.kernels import ops

    def old_route():
        d = ops.hamming(codes, qcodes).to(torch.float32)
        vals, idx = torch.sort(d, dim=-1, stable=True)
        return vals[:, :t], idx[:, :t]

    vals, idx = ops.hamming_topk(codes, qcodes, t)
    want = ops.hamming_topk(codes, qcodes, t, impl="plain")
    s.compare("hamming", vals, want[0], exact=True)
    s.compare("hamming", idx, want[1], exact=True)
    old_vals, old_idx = old_route()
    if not (torch.equal(vals.to(torch.float32), old_vals)
            and torch.equal(idx.long(), old_idx)):
        raise AssertionError("hamming_topk: differs from the distance kernel, "
                             "the cast and the stable sort")
    dist = ops.hamming(codes, qcodes).to(torch.float32)
    (sn, w), nq = codes.shape, qcodes.shape[0]
    bytes_ = codes.numel() * 4 + qcodes.numel() * 4 + 2 * nq * t * 4
    return dict(
        name="hamming", entry="hamming_topk", q=nq, s=sn, w=w, t=t,
        max_abs_err=0.0,
        ms=s.time_ms(lambda: ops.hamming_topk(codes, qcodes, t), 50),
        call_ms=s.call_ms(lambda: ops.hamming_topk(codes, qcodes, t), 50),
        old_route_ms=s.time_ms(old_route, 50),
        old_route_call_ms=s.call_ms(old_route, 50),
        plain_ms=s.time_ms(
            lambda: ops.hamming_topk(codes, qcodes, t, impl="plain"), 10),
        **_bound(bytes_, nq * sn * w * 3),
        library_ms=s.time_ms(
            lambda: torch.sort(dist, dim=-1, stable=True), 50),
    )


def l2_atol(q, x) -> float:
    """The expanded-form tolerance: L2_ATOL_PER_NORM (max|q|^2 + max|x|^2)."""
    return L2_ATOL_PER_NORM * float((q * q).sum(-1).max() + (x * x).sum(-1).max())


def _l2_bound(nq: int, n: int, d: int, keep: bool = False) -> dict:
    """Both inputs (and the keep mask) read once, the (Q, N) output written
    once; the product's 2 Q N d flops, the norms' 2 (Q + N) d and the
    epilogue's 3 Q N."""
    return _bound((nq * d + n * d + nq * n) * 4 + (n if keep else 0),
                  2 * nq * n * d + 2 * (nq + n) * d + 3 * nq * n)


def _l2_case(s: Smoke, q, x, reps: int, keep=None) -> dict:
    """``l2_distance`` (with the delta scan's ``keep`` mask when given)
    against its plain version, with the library call ``torch.cdist``
    (matrix-product mode, TF32 off; it also takes a square root and has no
    mask) timed beside it as the yardstick. With ``keep`` the masked output
    must be the unmasked one with +inf in the dropped columns."""
    torch = s.torch
    from repro_torch.kernels import l2_distance as l2_distance_k
    from repro_torch.kernels import ops

    atol = l2_atol(q, x)
    got = ops.l2_distance(q, x, keep)
    err = s.compare("l2_distance", got,
                    ops.l2_distance(q, x, keep, impl="plain"), atol=atol)
    if keep is not None and not torch.equal(
            got, torch.where(keep[None, :], ops.l2_distance(q, x), INF)):
        raise AssertionError("l2_distance: the keep mask changed more than "
                             "the dropped columns")

    def library():
        return torch.cdist(q, x, compute_mode="use_mm_for_euclid_dist")

    # the yardstick computes the same function up to its square root
    lib = library() ** 2
    if keep is not None:
        lib = torch.where(keep[None, :], lib, INF)
    torch.testing.assert_close(lib, got.clamp_min(0.0), rtol=1e-4, atol=4 * atol)
    (nq, d), n = q.shape, x.shape[0]
    return dict(
        name="l2_distance", q=nq, n=n, dim=d, keep=keep is not None, atol=atol,
        max_abs_err=err, blocks_per_sm=l2_distance_k.blocks_per_sm(),
        ms=s.time_ms(lambda: ops.l2_distance(q, x, keep), reps),
        call_ms=s.call_ms(lambda: ops.l2_distance(q, x, keep), reps),
        plain_ms=s.time_ms(lambda: ops.l2_distance(q, x, keep, impl="plain"),
                           reps),
        **_l2_bound(nq, n, d, keep is not None),
        library_ms=s.time_ms(library, reps),
    )


def _page_gather_case(s: Smoke, pages, ids, q, *, recs=None) -> dict:
    """``page_gather_l2`` on (P, cap, d) pages: its path (one call of
    ``ops.page_gather_l2``, counted), its plain version, and, given the
    packed ``recs`` of the same pages (HYBRID, d = 128: member i is row i
    of its record), ``page_scan``'s member scores, which must be equal bit
    for bit (one per-member reduction order in both kernels)."""
    torch = s.torch
    from repro_torch.kernels import ops

    _, cap, d = pages.shape
    ops.reset_launch_counts()
    got = ops.page_gather_l2(pages, ids, q)            # the path, counted
    launches = ops.launch_counts()["page_gather_l2"]
    err = s.compare("page_gather_l2", got,
                    ops.page_gather_l2(pages, ids, q, impl="plain"))
    if recs is not None:
        md, _ = ops.page_scan(recs, ids, q, None, capacity=cap, dim=d,
                              rp=1, compute_adc=False)
        if not torch.equal(got, md):
            raise AssertionError("page_gather_l2: member distances differ "
                                 "from page_scan's")
    nq, b = ids.shape
    distinct = int(torch.unique(ids).numel())
    return dict(
        name="page_gather_l2", q=nq, b=b, capacity=cap, dim=d,
        launches=launches, max_abs_err=err,
        ms=s.time_ms(lambda: ops.page_gather_l2(pages, ids, q), 50),
        call_ms=s.call_ms(lambda: ops.page_gather_l2(pages, ids, q), 50),
        plain_ms=s.time_ms(lambda: ops.page_gather_l2(pages, ids, q,
                                                      impl="plain"), 10),
        **_bound(distinct * cap * d * 4 + ids.numel() * 4 + q.numel() * 4
                 + nq * b * cap * 4, nq * b * cap * d * 3),
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
    from repro_torch.kernels import ops

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
        if adc:
            _members_equal_adc(s, recs, ids, q, lut, cap=cap, dim=cfg.dim,
                               rp=rp)
        if cfg is cfg_hybrid:
            # page_gather_l2 on the HYBRID page store (its row in the
            # kernels line comes from the baseline path's shapes)
            cases.append(_page_gather_case(
                s, recs[:, :cap, :].contiguous(), ids, q, recs=recs))
        if cfg is cfg_hybrid or cfg is cfg_memall:
            s.rows[row["name"]] = row
            # the filtered (masked) and streamed (staged) variants at the
            # same main-path shapes
            for masked, staged in ((True, False), (False, True), (True, True)):
                row = _page_scan_case(s, recs, ids, q, lut, cap=cap,
                                      dim=cfg.dim, rp=rp, m=m, adc=adc,
                                      reps=50, masked=masked, staged=staged)
                s.rows[row["name"]] = row
                cases.append(row)
        if cfg is cfg_hybrid or cfg is cfg_memall:
            # every variant at Q = 64: the late hops of a batch whose
            # finished lanes are frozen, and most hops of a filtered search
            for masked, staged in ((False, False), (True, False),
                                   (False, True), (True, True)):
                cases.append(_page_scan_case(
                    s, recs, ids[:64], q[:64], lut[:64], cap=cap, dim=cfg.dim,
                    rp=rp, m=m, adc=adc, reps=50, masked=masked,
                    staged=staged))
        del recs

    m_mem = 2 * cfg_hybrid.pq_subspaces
    n_mem = -(-n_vectors // 6) * 6
    mem_codes = torch.as_tensor(
        rng.integers(0, 256, (n_mem, m_mem)).astype(np.uint8)).to(dev)
    nids = torch.as_tensor(rng.integers(0, n_mem, (n_queries, b * rp))).to(dev)
    lut_mem = torch.as_tensor(
        rng.random((n_queries, m_mem, 256)).astype(np.float32)).to(dev)
    # the HYBRID re-score as the path calls it (the fused gather), then the
    # same sums on the codes gathered first
    row = _pq_adc_gather_case(s, mem_codes, nids, lut_mem, 50)
    s.rows["pq_adc"] = row
    cases.append(row)
    cases.append(_pq_adc_case(s, mem_codes[nids].contiguous(), lut_mem, 50))
    # the entry estimates: T rows of the LSH sample's codes a query, ids the
    # first T columns of a sorted (Q, S) index matrix, as the path has them
    entries = cfg_hybrid.lsh_entries
    m_disk = cfg_hybrid.pq_subspaces
    sample = cfg_hybrid.lsh_sample
    lsh_pq = torch.as_tensor(rng.integers(
        0, 256, (sample, m_disk)).astype(np.uint8)).to(dev)
    top = torch.sort(torch.as_tensor(rng.random((n_queries, sample))).to(dev),
                     dim=1).indices[:, :entries]
    lut_disk = torch.as_tensor(
        rng.random((n_queries, m_disk, 256)).astype(np.float32)).to(dev)
    cases.append(_pq_adc_gather_case(s, lsh_pq, top, lut_disk, 50))
    cases.append(_pq_adc_case(s, lsh_pq[top].contiguous(), lut_disk, 50))

    words = cfg_hybrid.lsh_bits // 32
    lsh = torch.as_tensor(rng.integers(
        -2**31, 2**31, (cfg_hybrid.lsh_sample, words)).astype(np.int32)).to(dev)
    qc = torch.as_tensor(rng.integers(
        -2**31, 2**31, (n_queries, words)).astype(np.int32)).to(dev)
    s.rows["hamming_distances"] = _hamming_case(s, lsh, qc)
    s.rows["hamming"] = _hamming_topk_case(s, lsh, qc, cfg_hybrid.lsh_entries)
    cases += [s.rows["hamming_distances"], s.rows["hamming"]]

    # l2_distance: the mutable phase's delta scan (its 2,100 rows padded to
    # C = 4,096) at d = 128, and d = 32 / 200 beside it; clustered inputs
    # with query 0 equal to row 0 (a self-match)
    c_pad = 4096
    for dim in (128, 32, 200):
        centers = rng.standard_normal((64, dim)).astype(np.float32)
        x = centers[rng.integers(0, 64, c_pad)] + 0.15 * rng.standard_normal(
            (c_pad, dim)).astype(np.float32)
        qv = x[rng.integers(0, c_pad, n_queries)] + 0.1 * rng.standard_normal(
            (n_queries, dim)).astype(np.float32)
        qv[0] = x[0]
        xt = torch.as_tensor(x.astype(np.float32)).to(dev)
        qt = torch.as_tensor(qv.astype(np.float32)).to(dev)
        row = _l2_case(s, qt, xt, 50)
        self_d = float(ops.l2_distance(qt[:1], xt[:1])[0, 0])
        if self_d != 0.0:
            raise AssertionError(f"l2_distance: a self-match scores {self_d}, "
                                 "not 0")
        row["self_match"] = self_d
        cases.append(row)
        if dim == 128:
            # the delta scan's call: about 90% of the rows live
            keep = torch.as_tensor(rng.random(c_pad) < 0.9).to(dev)
            keep[0] = True
            s.rows["l2_distance"] = _l2_case(s, qt, xt, 50, keep=keep)
            cases.append(s.rows["l2_distance"])
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
        if adc:
            for masked, staged in ((True, False), (False, True)):
                emit("sift1m", pages=pages, **_page_scan_case(
                    s, recs, ids, q, lut, cap=cap, dim=128, rp=rp, m=m,
                    adc=adc, reps=20, masked=masked, staged=staged))
            _streamed_hop(s, recs, ids, q, lut, cap=cap, rp=rp)
        del recs
        torch.cuda.empty_cache()
    n_mem = -(-n // 6) * 6
    mem_codes = torch.randint(0, 256, (n_mem, 32), generator=gen, device=dev,
                              dtype=torch.uint8)
    nids = torch.randint(0, n_mem, (nq, b * rp), generator=gen, device=dev)
    lut = torch.rand((nq, 32, 256), generator=gen, device=dev)
    emit("sift1m", mem_codes_bytes=mem_codes.numel(),
         **_pq_adc_gather_case(s, mem_codes, nids, lut, 20))
    emit("sift1m", mem_codes_bytes=mem_codes.numel(),
         **_pq_adc_case(s, mem_codes[nids].contiguous(), lut, 20))
    words = cfg_hybrid.lsh_bits // 32
    lsh = torch.randint(-2**31, 2**31 - 1, (cfg_hybrid.lsh_sample, words),
                        generator=gen, device=dev, dtype=torch.int32)
    qc = torch.randint(-2**31, 2**31 - 1, (nq, words), generator=gen,
                       device=dev, dtype=torch.int32)
    emit("sift1m", **_hamming_case(s, lsh, qc))
    emit("sift1m", **_hamming_topk_case(s, lsh, qc, cfg_hybrid.lsh_entries))
    del mem_codes, nids, lut
    torch.cuda.empty_cache()
    _sift1m_delta_scan(s, gen)


def _sift1m_delta_scan(s: Smoke, gen) -> None:
    """One delta scan at SIFT1M scale: a delta tier of a quarter of the
    base (``DeltaParams.compact_fraction``), 262,144 vectors at d = 128
    (134 MB, about 90% live), against 1,024 queries. The L2 kernel against
    its plain version and ``torch.cdist``, then the scan's top-10 through
    the kernel and through the plain version."""
    torch = s.torch
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    nq, c, d, k = 1024, 262_144, 128, 10
    x = torch.randn((c, d), generator=gen, device=dev)
    q = torch.randn((nq, d), generator=gen, device=dev)
    live = torch.rand((c,), generator=gen, device=dev) < 0.9
    row = _l2_case(s, q, x, 5, keep=live)
    dist, slots = ops.delta_scan(q, x, live, k)
    pdist, pslots = ops.delta_scan(q, x, live, k, impl="plain")
    torch.testing.assert_close(dist, pdist, rtol=RTOL, atol=row["atol"])
    agree = float((slots == pslots).all(1).float().mean())
    if agree < 0.99:
        raise AssertionError(f"sift1m delta scan: kernel and plain top-{k} ids "
                             f"agree for only {agree:.4f} of queries")
    if not bool(live[slots.long()].all()):
        raise AssertionError("sift1m delta scan: a dead row was returned")
    full = ops.l2_distance(q, x)
    masked = ops.l2_distance(q, x, live)

    def unfused():
        # the yardstick of the fused mask: the distances, a separate mask
        # pass, the sort
        dd = torch.where(live[None, :], ops.l2_distance(q, x), INF)
        vals, idx = torch.sort(dd, dim=-1, stable=True)
        return vals[:, :k], idx[:, :k]

    want_d, want_s = unfused()
    if not (torch.equal(want_d, dist)
            and torch.equal(want_s.to(torch.int32), slots)):
        raise AssertionError("sift1m delta scan: the masked kernel's top-k "
                             "differs from the separate mask pass's")
    emit("sift1m", delta_bytes=x.numel() * 4, ids_agree_share=agree,
         sort_ms=s.time_ms(lambda: torch.sort(masked, dim=-1, stable=True), 3),
         mask_pass_ms=s.time_ms(
             lambda: torch.where(live[None, :], full, INF), 3),
         scan_ms=s.time_ms(lambda: ops.delta_scan(q, x, live, k), 3),
         unfused_scan_ms=s.time_ms(unfused, 3),
         plain_scan_ms=s.time_ms(
             lambda: ops.delta_scan(q, x, live, k, impl="plain"), 3),
         **row)


def _streamed_hop(s: Smoke, recs, ids, q, lut, *, cap: int, rp: int) -> None:
    """One hop of the streamed tier at SIFT1M size: the records go to a
    pages.bin on the host's disk, a quarter of the pages (a seeded random
    choice) stay on the card, and the hop's misses are read through a
    ``PageFetcher`` over the memmap, copied to the card through a pinned
    buffer and scored by ``page_scan_recs`` while the resident lanes go
    through ``page_scan`` -- the steps of ``core.search.score_page_batch``,
    timed one by one. The first hop reads after the file's pages were
    dropped from the OS cache (``posix_fadvise``; the file system may keep
    some), the second finds them in the fetcher's LRU stage or the OS
    cache. The merged scores must equal the fully resident scan exactly."""
    import numpy as np

    torch = s.torch
    from repro_torch.core.config import MemoryBudget
    from repro_torch.core.stream import PageFetcher
    from repro_torch.kernels import ops

    dev = recs.device
    pages, rows, lanes = recs.shape
    nq, b = ids.shape
    kw = dict(capacity=cap, dim=q.shape[1], rp=rp)
    want = ops.page_scan(recs, ids, q, lut, **kw)
    SCRATCH.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=SCRATCH))
    try:
        path = tmp / "pages.bin"
        t0 = time.perf_counter()
        recs.cpu().numpy().tofile(path)
        with open(path, "rb+") as f:
            os.fsync(f.fileno())
            os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)
        write_s = time.perf_counter() - t0
        n_res = MemoryBudget(fraction=BUDGET).resolve_pages(pages, rows * lanes * 4)
        rng = np.random.default_rng(s.seed)
        resident_ids = np.sort(rng.permutation(pages)[:n_res])
        rmap = torch.full((pages,), -1, dtype=torch.int32, device=dev)
        rmap[torch.as_tensor(resident_ids, device=dev)] = torch.arange(
            n_res, dtype=torch.int32, device=dev)
        recs_res = recs[torch.as_tensor(resident_ids, device=dev)]
        fetcher = PageFetcher(np.memmap(path, dtype=np.float32, mode="r",
                                        shape=(pages, rows, lanes)))
        buf = torch.empty((nq * b, rows, lanes), dtype=torch.float32,
                          pin_memory=True)
        for label in ("cold", "warm"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slot = rmap[ids.long()]
            resident = slot >= 0
            miss_ids = ids[~resident].cpu().numpy()
            t1 = time.perf_counter()
            fetcher(miss_ids, out=buf.numpy())
            t2 = time.perf_counter()
            fetched = buf[: miss_ids.size].to(dev, non_blocking=True)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            staged = torch.zeros((nq, b, rows, lanes), device=dev)
            staged[~resident] = fetched
            ex_r, est_r = ops.page_scan(recs_res, torch.where(resident, slot, 0),
                                        q, lut, **kw)
            ex_s, est_s = ops.page_scan_recs(staged, q, lut, **kw)
            lane = resident[:, :, None]
            got = (torch.where(lane, ex_r, ex_s), torch.where(lane, est_r, est_s))
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError("streamed hop: scores differ from the "
                                     "fully resident scan")
            fs = fetcher.fetch_stats()
            emit("sift1m", name="streamed_hop", read=label, q=nq, b=b,
                 pages=pages, resident_pages=n_res,
                 write_and_drop_s=write_s if label == "cold" else None,
                 misses=int(miss_ids.size), pages_fetched=fs["pages_fetched"],
                 fetch_hits=fs["fetch_hits"],
                 miss_bytes=int(miss_ids.size) * rows * lanes * 4,
                 lookup_ms=(t1 - t0) * 1e3, host_fetch_ms=(t2 - t1) * 1e3,
                 h2d_ms=(t3 - t2) * 1e3, scan_ms=(t4 - t3) * 1e3,
                 host_fetch_gb_s=miss_ids.size * rows * lanes * 4 / (t2 - t1) / 1e9,
                 h2d_gb_s=miss_ids.size * rows * lanes * 4 / (t3 - t2) / 1e9)
            fetcher.reset_stats()
        del fetcher
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _profile_search(index, q, sample: int | None = None,
                    params=None) -> dict:
    """One more search under ``torch.profiler``: the device's busy time
    (kernels and copies on the card) against the wall clock, and the device
    work by name. The profiler slows the host, so its wall time is longer
    than an unprofiled search's; both shares are reported. With ``sample``
    (the LSH sample size S), ``routing_sorts`` counts the ``aten::sort``
    calls over (Q, S) rows: the routing's sort, which the fused
    ``hamming_topk`` replaced. ``params``: the search's (default: the
    index's)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=sample is not None) as prof:
        t0 = time.perf_counter()
        res = index.search(q, k=10, params=params)
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
    routing_sorts = None
    if sample is not None:
        routing_sorts = sum(
            1 for e in prof.events()
            if e.name == "aten::sort" and e.input_shapes
            and e.input_shapes[0] and e.input_shapes[0][-1] == sample)
    return dict(
        profiled_wall_ms=wall * 1e3,
        device_busy_ms=busy if by_name else None,
        device_launches=sum(n for _, n in by_name.values()),
        top=[dict(name=name[:90], device_ms=ms, count=n)
             for name, (ms, n) in top],
        hops=hops,
        routing_sorts=routing_sorts,
    )


def make_data(n: int, dim: int, n_queries: int, seed: int):
    """Vectors, queries and their metadata, all from ``seed``: one tag field
    of 10 values and one uniform numeric field (``tests/test_filter.py``'s
    schema, with ten tags instead of three)."""
    import numpy as np

    from repro_torch.data.pipeline import clustered_vectors, query_vectors

    x = clustered_vectors(n, dim, num_clusters=64, seed=seed)
    q = query_vectors(x, n_queries, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    meta = {"topic": [f"t{i}" for i in rng.integers(0, 10, n)],
            "score": rng.uniform(0.0, 1.0, n).tolist()}
    return x, q, meta


def run_e2e(cfg, n: int, n_queries: int, *, device: str, seed: int,
            label: str = "e2e"):
    """Build (with the seeded metadata schema) -> search -> recall through
    the port's entry points; then the same search through the plain
    versions, which must agree. Returns the emitted numbers and a dict of
    what later phases reuse: the index, the data and the result."""
    import dataclasses

    import numpy as np

    from repro_torch.core import MetadataSchema, PageANNIndex, recall_at_k
    from repro_torch.core.vamana import brute_force_knn
    from repro_torch.kernels import ops

    x, q, meta = make_data(n, cfg.dim, n_queries, seed)
    t0 = time.perf_counter()
    index = PageANNIndex.build(
        x, cfg, schema=MetadataSchema(tags=("topic",), numerics=("score",)),
        metadata=meta, device=device)
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

    profile = (_profile_search(index, q, sample=cfg.lsh_sample)
               if device == "cuda" else None)
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
                          for k, v in launches.items() if v},
    )
    emit(label, **out)
    if not (np.isfinite(res.dists[:, 0]).all() and res.ids.shape == (n_queries, 10)):
        raise AssertionError(f"{label}: malformed results")
    if agree < 0.99:
        raise AssertionError(f"{label}: kernel and plain paths agree on ids "
                             f"for only {agree:.4f} of queries")
    if device == "cuda" and launches["hamming"] != 1:
        raise AssertionError(f"{label}: {launches['hamming']} hamming launches "
                             "in one search, not 1")
    if profile is not None and profile["routing_sorts"]:
        raise AssertionError(f"{label}: the routing still sorts (Q, S) "
                             "distances")
    return out, dict(index=index, x=x, q=q, meta=meta, result=res, wall=wall,
                     truth=truth)


def _median_wall(fn, device: str, runs: int = 3) -> float:
    import numpy as np

    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        if device == "cuda":
            import torch

            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def run_stream(ctx: dict, *, device: str, label: str = "stream") -> dict:
    """Save the e2e index, reload it under the memory budget and search the
    same queries: every field must equal the resident search's exactly.
    Adds the streamed index to ``ctx`` for the filter phase."""
    import numpy as np

    from repro_torch.core import PageANNIndex
    from repro_torch.kernels import ops

    index, q, want = ctx["index"], ctx["q"], ctx["result"]
    SCRATCH.mkdir(parents=True, exist_ok=True)
    directory = tempfile.mkdtemp(dir=SCRATCH)
    try:
        index.save(directory)
        streamed = PageANNIndex.load(directory, device=device,
                                     memory_budget=BUDGET)
        streamed.search(q, k=10)          # warm-up: pinned buffer, OS cache
        streamed.fetcher.reset_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = streamed.search(q, k=10)    # the streamed path, counted
        if device == "cuda":
            import torch

            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        fetch = streamed.fetch_stats()
        for field in got._fields:
            if not np.array_equal(getattr(got, field), getattr(want, field)):
                raise AssertionError(f"{label}: streamed {field} differ from "
                                     "the resident search's")
        recs_kernel = ("page_scan_recs" if index.cfg.memory_mode.value != "mem_all"
                       else "page_scan_recs_members")
        if device == "cuda" and launches[recs_kernel] <= 0:
            raise AssertionError(f"{label}: {recs_kernel} never launched")
        stream_wall = _median_wall(lambda: streamed.search(q, k=10), device)
        resident_wall = _median_wall(lambda: index.search(q, k=10), device)
        hops = max(1, int(got.hops.max()))
        out = dict(
            mode=index.cfg.memory_mode.value, budget=BUDGET,
            resident_pages=streamed.stats.resident_pages,
            total_pages=streamed.stats.pages,
            resident_bytes=streamed.stats.resident_bytes,
            pages_fetched=fetch["pages_fetched"], fetch_hits=fetch["fetch_hits"],
            fetch_wall_ms=fetch["fetch_wall_s"] * 1e3,
            fetch_calls=len(fetch["wall_window"]),
            equal_to_resident=True, launches=launches,
            counted_wall_ms=wall * 1e3,
            qps=len(q) / stream_wall, resident_qps=len(q) / resident_wall,
            host_ms_per_hop=stream_wall * 1e3 / hops,
            resident_host_ms_per_hop=resident_wall * 1e3 / hops,
        )
        emit(label, **out)
        ctx["streamed"] = streamed
        return out
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def _filtered_truth(index, x, q, expr):
    """(the (N,) mask of vectors passing ``expr``, the post-filter
    brute-force top-10 ids of ``q``, -1 padded)."""
    import numpy as np

    from repro_torch.core import filter as filter_mod
    from repro_torch.core.vamana import brute_force_knn

    cf, _ = index.compiled_filter(expr)
    passing = filter_mod.filter_mask_np(cf, index.meta_host.tags,
                                        index.meta_host.nums)
    pids = np.flatnonzero(passing)
    truth = np.full((len(q), 10), -1, np.int64)
    take = min(10, len(pids))
    truth[:, :take] = pids[brute_force_knn(x[pids], q, take)]
    return passing, truth


def run_filter(ctx: dict, *, device: str, exprs: dict,
               label: str = "filter") -> dict:
    """Filtered search, resident and streamed, through the kernels and the
    plain versions, held to a post-filter brute force over the same
    metadata. Returns the launches of the resident and the streamed runs."""
    import numpy as np

    from repro_torch.core import FilterParams, recall_at_k
    from repro_torch.kernels import ops

    index, streamed, x, q = ctx["index"], ctx["streamed"], ctx["x"], ctx["q"]
    beam0 = index.default_params.beam_width
    cap = FilterParams().max_filter_oversample
    for expr in exprs.values():
        index.search(q[:8], k=10, filter=expr)        # warm-up per beam width
    runs = {}
    ops.reset_launch_counts()
    for name, expr in exprs.items():                  # resident, counted
        t0 = time.perf_counter()
        res = index.search(q, k=10, filter=expr)
        runs[name] = dict(res=res, wall=time.perf_counter() - t0)
    launches = ops.launch_counts()
    ops.reset_launch_counts()
    for name, expr in exprs.items():                  # streamed, counted
        runs[name]["streamed"] = streamed.search(q, k=10, filter=expr)
    stream_launches = ops.launch_counts()
    for name, expr in exprs.items():
        r = runs[name]
        res, got = r["res"], r["streamed"]
        plain = index.search(q, k=10, filter=expr, impl="plain")
        sel = index.compiled_filter(expr)[1]
        passing, truth = _filtered_truth(index, x, q, expr)
        recall = recall_at_k(res.ids, truth)
        agree = float((res.ids == plain.ids).all(1).mean())
        ok = np.where(res.ids >= 0, passing[np.maximum(res.ids, 0)], True)
        out = dict(
            mode=index.cfg.memory_mode.value, filter=name, selectivity=sel,
            beam=beam0 * index._filter_oversample(sel, cap),
            recall_at_10=recall, plain_recall_at_10=recall_at_k(plain.ids, truth),
            ids_agree_share=agree, all_pass=bool(ok.all()),
            mean_ios=float(res.ios.mean()), mean_hops=float(res.hops.mean()),
            qps=len(q) / r["wall"],
            streamed_qps=len(q) / _median_wall(
                lambda: streamed.search(q, k=10, filter=expr), device, runs=1),
        )
        emit(label, **out)
        for field in res._fields:
            if not np.array_equal(getattr(got, field), getattr(res, field)):
                raise AssertionError(f"{label} {name}: streamed {field} differ "
                                     "from the resident search's")
        if not ok.all():
            raise AssertionError(f"{label} {name}: a returned id fails the filter")
        if agree < 0.99:
            raise AssertionError(f"{label} {name}: kernel and plain paths agree "
                                 f"on ids for only {agree:.4f} of queries")
        if recall < MIN_RECALL:
            raise AssertionError(f"{label} {name}: recall@10 {recall:.4f} < "
                                 f"{MIN_RECALL}")
    emit(label, mode=index.cfg.memory_mode.value, launches=launches,
         stream_launches=stream_launches)
    return dict(launches=launches, stream_launches=stream_launches)


def _search_equal(got, want, what: str) -> None:
    import numpy as np

    for field in got._fields:
        if not np.array_equal(getattr(got, field), getattr(want, field)):
            raise AssertionError(f"{what}: {field} differ")


def _walls_in_turns(fa, fb, device: str) -> tuple[float, float]:
    """Median wall seconds of ``fa()`` and of ``fb()``, run in turns (a, b,
    b, a, a, b) so that both see the same host."""
    import numpy as np

    walls = ([], [])
    for i in (0, 1, 1, 0, 0, 1):
        walls[i].append(_median_wall((fa, fb)[i], device, runs=1))
    return float(np.median(walls[0])), float(np.median(walls[1]))


def run_adaptive(ctx: dict, *, device: str, label: str = "adaptive") -> dict:
    """Adaptive search over the e2e index (``AdaptiveParams``): early
    termination, entry selection and both, through the kernels and the plain
    versions, resident and under the memory budget; one filtered search at
    selectivity 0.1 with patience 2; in HYBRID, ``autotune`` to a recall
    target on a reloaded copy, saved and reloaded. ``AdaptiveParams()`` must
    equal the plain search exactly. Returns each setting's launches."""
    import numpy as np

    from repro_torch.core import AdaptiveParams, Num, PageANNIndex, recall_at_k
    from repro_torch.kernels import ops

    index, streamed, x, q = ctx["index"], ctx["streamed"], ctx["x"], ctx["q"]
    want, truth = ctx["result"], ctx["truth"]
    mode = index.cfg.memory_mode.value
    base = index.default_params.replace(k=10)
    _search_equal(index.search(q, params=base.replace(adaptive=AdaptiveParams())),
                  want, f"{label}: AdaptiveParams() against adaptive=None")
    plain_recall = recall_at_k(want.ids, truth)

    def sync():
        if device == "cuda":
            import torch

            torch.cuda.synchronize()

    results, launches = {}, {}
    for name, kw in ADAPTIVE.items():
        p = base.replace(adaptive=AdaptiveParams(**kw))
        index.search(q, params=p)                     # warm-up
        sync()
        ops.reset_launch_counts()
        res = index.search(q, params=p)               # this setting, counted
        sync()
        launches[name] = {k: v for k, v in ops.launch_counts().items() if v}
        results[name] = res
        plain = index.search(q, params=p, impl="plain")
        wall, base_wall = _walls_in_turns(
            lambda: index.search(q, params=p),
            lambda: index.search(q, params=base), device)
        prof = (_profile_search(index, q, params=p) if device == "cuda"
                else None)
        if prof is not None and prof["device_busy_ms"] is not None:
            prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] / (wall * 1e3)
        ops.reset_launch_counts()
        _search_equal(streamed.search(q, params=p), res,
                      f"{label} {name}: streamed against resident")
        launches[f"{name} (streamed)"] = {
            k: v for k, v in ops.launch_counts().items() if v}
        # early termination only adds a reason to stop: against the same
        # start (the same entry selection, patience off) a lane hops less
        same_start = {k: v for k, v in kw.items() if k != "patience"}
        bound_name = (None if "patience" not in kw
                      else ADAPTIVE_NAME[tuple(sorted(same_start.items()))]
                      if same_start else "plain")
        bound = results.get(bound_name, want)
        recall = recall_at_k(res.ids, truth)
        agree = float((res.ids == plain.ids).all(1).mean())
        emit(label, mode=mode, setting=name, adaptive=kw,
             bounded_by=bound_name,
             recall_at_10=recall, plain_recall_at_10=plain_recall,
             mean_hops=float(res.hops.mean()), plain_mean_hops=float(want.hops.mean()),
             loop_iterations=int(res.hops.max()),
             plain_loop_iterations=int(want.hops.max()),
             mean_ios=float(res.ios.mean()), plain_mean_ios=float(want.ios.mean()),
             qps=len(q) / wall, plain_qps=len(q) / base_wall,
             ids_agree_share=agree, streamed_equal=True,
             launches_per_search=launches[name],
             streamed_launches_per_search=launches[f"{name} (streamed)"],
             profile=prof)
        if bound_name is not None and ((res.hops > bound.hops).any()
                                       or (res.ios > bound.ios).any()):
            raise AssertionError(f"{label} {name}: more hops or ios than the "
                                 "same search without early termination")
        if agree < 0.99:
            raise AssertionError(f"{label} {name}: kernel and plain paths agree "
                                 f"on ids for only {agree:.4f} of queries")
        if recall < plain_recall - 0.02 or (mode == "hybrid" and recall < MIN_RECALL):
            raise AssertionError(f"{label} {name}: recall@10 {recall:.4f} "
                                 f"(plain {plain_recall:.4f})")

    # one filtered selectivity with early termination
    expr = Num("score").le(float(np.quantile(np.asarray(ctx["meta"]["score"]), 0.1)))
    p = base.replace(adaptive=AdaptiveParams(patience=2))
    index.search(q, params=p, filter=expr)            # warm-up
    sync()
    ops.reset_launch_counts()
    res = index.search(q, params=p, filter=expr)      # counted
    sync()
    launches["filter_patience2"] = {k: v for k, v in ops.launch_counts().items() if v}
    off = index.search(q, params=base, filter=expr)
    plain = index.search(q, params=p, filter=expr, impl="plain")
    ops.reset_launch_counts()
    _search_equal(streamed.search(q, params=p, filter=expr), res,
                  f"{label} filtered: streamed against resident")
    launches["filter_patience2 (streamed)"] = {
        k: v for k, v in ops.launch_counts().items() if v}
    passing, ftruth = _filtered_truth(index, x, q, expr)
    recall = recall_at_k(res.ids, ftruth)
    agree = float((res.ids == plain.ids).all(1).mean())
    ok = np.where(res.ids >= 0, passing[np.maximum(res.ids, 0)], True)
    wall, base_wall = _walls_in_turns(
        lambda: index.search(q, params=p, filter=expr),
        lambda: index.search(q, params=base, filter=expr), device)
    emit(label, mode=mode, setting="filter_patience2", selectivity=0.1,
         recall_at_10=recall, plain_recall_at_10=recall_at_k(off.ids, ftruth),
         mean_hops=float(res.hops.mean()), plain_mean_hops=float(off.hops.mean()),
         loop_iterations=int(res.hops.max()),
         plain_loop_iterations=int(off.hops.max()),
         qps=len(q) / wall, plain_qps=len(q) / base_wall,
         ids_agree_share=agree, launches_per_search=launches["filter_patience2"],
         streamed_launches_per_search=launches["filter_patience2 (streamed)"])
    if (res.hops > off.hops).any() or (res.ios > off.ios).any():
        raise AssertionError(f"{label} filtered: more hops or ios than without "
                             "early termination")
    if not ok.all():
        raise AssertionError(f"{label} filtered: a returned id fails the filter")
    # no recall floor here: a lane whose top-k holds no passing member yet
    # has an infinite frontier, which never improves, so early termination
    # stops it after ``patience`` such hops (the reference's rule)
    if agree < 0.99:
        raise AssertionError(f"{label} filtered: kernel and plain paths agree "
                             f"on ids for only {agree:.4f} of queries")

    if mode == "hybrid":
        SCRATCH.mkdir(parents=True, exist_ok=True)
        directory = tempfile.mkdtemp(dir=SCRATCH)
        try:
            # a reloaded copy: the e2e index keeps its default params
            index.save(os.path.join(directory, "base"))
            copy = PageANNIndex.load(os.path.join(directory, "base"), device=device)
            t0 = time.perf_counter()
            win = copy.autotune(q, recall_target=AUTOTUNE_RECALL, truth=truth)
            tune_s = time.perf_counter() - t0
            copy.save(os.path.join(directory, "tuned"))
            back = PageANNIndex.load(os.path.join(directory, "tuned"), device=device)
            got = recall_at_k(back.search(q, k=10).ids, truth)
            emit(label, mode=mode, setting="autotune", target=AUTOTUNE_RECALL,
                 seconds=tune_s, winner=win["params"].to_json(),
                 recall_at_10=win["recall"], qps=win["qps"],
                 mean_hops=win["mean_hops"], p99_us=win["p99_us"],
                 reloaded_recall_at_10=got,
                 points=[dict(params=m["params"].to_json(), recall=m["recall"],
                              qps=m["qps"], mean_hops=m["mean_hops"])
                         for m in copy.tuned])
            if back.default_params != win["params"]:
                raise AssertionError(f"{label}: the reloaded default params are "
                                     "not the autotuned winner")
            if back.params_for_target(recall_target=AUTOTUNE_RECALL) != win["params"]:
                raise AssertionError(f"{label}: params_for_target is not the winner")
            if win["recall"] < AUTOTUNE_RECALL or got != win["recall"]:
                raise AssertionError(f"{label}: autotune recall {win['recall']}, "
                                     f"reloaded {got}, target {AUTOTUNE_RECALL}")
        finally:
            shutil.rmtree(directory, ignore_errors=True)
    return dict(launches=launches)


def run_profile(ctx: dict, *, device: str, label: str = "profile") -> None:
    """``index.profile`` against ``index.search`` with the same params
    (plain and patience 2): the same results exactly, a trail whose per-hop
    deltas sum to the totals, saved as JSON and rendered by the report."""
    import numpy as np

    from repro_torch.core import AdaptiveParams
    from repro_torch.obs.report import profile_to_dict, render_profile

    index, q = ctx["index"], ctx["q"]
    base = index.default_params.replace(k=10)
    for name, adaptive in (("plain", None), ("patience2", AdaptiveParams(patience=2))):
        p = base.replace(adaptive=adaptive)
        want = index.search(q, params=p)
        got, trail = index.profile(q, params=p)
        _search_equal(got, want, f"{label} {name}: profile against search")
        if not (np.array_equal(trail.active.sum(1), got.hops)
                and np.array_equal(trail.ios.sum(1), got.ios)
                and np.array_equal(trail.cache_hits.sum(1), got.cache_hits)
                and (trail.pages[~trail.active] == -1).all()):
            raise AssertionError(f"{label} {name}: the trail does not add up")
        if adaptive is None and trail.stall.any():
            raise AssertionError(f"{label} {name}: stall without patience")
        SCRATCH.mkdir(parents=True, exist_ok=True)
        fd, path = tempfile.mkstemp(suffix=".json", dir=SCRATCH)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(profile_to_dict(got, trail), f)
            with open(path) as f:
                text = render_profile(json.load(f), queries=2)
        finally:
            os.unlink(path)
        if "query 1: hops=" not in text:
            raise AssertionError(f"{label} {name}: the profile did not render")
        profiled, unprofiled = _walls_in_turns(
            lambda: index.profile(q, params=p),
            lambda: index.search(q, params=p), device)
        # lanes that early termination stopped: the stall counter reached
        # patience on their last hop
        last = trail.stall[np.arange(len(q)), np.maximum(got.hops - 1, 0)]
        emit(label, mode=index.cfg.memory_mode.value, setting=name,
             profiled_ms=profiled * 1e3, search_ms=unprofiled * 1e3,
             mean_hops=float(got.hops.mean()), equal_to_search=True,
             stopped_by_patience=(int((last >= adaptive.patience).sum())
                                  if adaptive is not None else 0),
             rendered_lines=text.count("\n"))


def fresh_vectors(n_base: int, n_new: int, dim: int, seed: int):
    """``n_new`` vectors from the seeded clustered distribution of
    ``make_data`` (the same 64 centres: the generator draws them first)."""
    from repro_torch.data.pipeline import clustered_vectors

    return clustered_vectors(n_base + n_new, dim, num_clusters=64,
                             seed=seed)[n_base:]


def _mutable_writes(m, x, meta, *, seed: int):
    """The mutable phase's writes: N_INSERTS fresh vectors (every tenth with
    the tag value "t10", which the base never saw), N_UPSERTS base ids moved
    to new vectors, N_DELETES other base ids deleted. Returns the live set
    as (external ids, vectors, metadata columns), the deleted and upserted
    ids and the upserted vectors."""
    import numpy as np

    n, dim = x.shape
    rng = np.random.default_rng(seed + 3)
    new = fresh_vectors(n, N_INSERTS, dim, seed)
    new_meta = {"topic": [f"t{i}" for i in rng.integers(0, 10, N_INSERTS)],
                "score": rng.uniform(0.0, 1.0, N_INSERTS).tolist()}
    new_meta["topic"][::10] = ["t10"] * len(new_meta["topic"][::10])
    pick = rng.permutation(n)
    upserted, deleted = pick[:N_UPSERTS], pick[N_UPSERTS:N_UPSERTS + N_DELETES]
    moved = (x[upserted] + 0.3 * rng.standard_normal(
        (N_UPSERTS, dim))).astype(np.float32)
    moved_meta = {"topic": ["t10"] * N_UPSERTS,
                  "score": rng.uniform(0.0, 1.0, N_UPSERTS).tolist()}
    new_ids = np.arange(n, n + N_INSERTS)
    m.insert(new, ids=new_ids, metadata=new_meta)
    m.insert(moved, ids=upserted, metadata=moved_meta)
    if m.delete(deleted) != N_DELETES:
        raise AssertionError("mutable: delete did not remove every id")

    keep = np.ones(n, bool)
    keep[upserted] = keep[deleted] = False
    live_ids = np.concatenate([np.flatnonzero(keep), new_ids, upserted])
    live_x = np.concatenate([x[keep], new, moved])
    live_meta = {f: [meta[f][i] for i in np.flatnonzero(keep)] + new_meta[f]
                 + moved_meta[f] for f in meta}
    return (live_ids, live_x, live_meta), deleted, upserted, moved


def run_mutable(ctx: dict, *, device: str, seed: int,
                label: str = "mutable") -> dict:
    """The e2e index wrapped in a ``MutableIndex``: writes, then the unified
    search (base search + delta scan through ``l2_distance`` + merge) of the
    same queries, through the kernels and the plain versions, unfiltered and
    at selectivity 0.1, held to a brute force over the live set; then a
    dirty save and load, resident and under the budget, equal to the saved
    state exactly. Returns the counted search's launches."""
    import numpy as np

    from repro_torch.core import MutableIndex, Num, recall_at_k
    from repro_torch.core import filter as filter_mod
    from repro_torch.core.delta import scan_delta
    from repro_torch.core.vamana import brute_force_knn
    from repro_torch.kernels import ops

    index, x, q, meta = ctx["index"], ctx["x"], ctx["q"], ctx["meta"]
    m = MutableIndex(index, auto_compact=False)
    t0 = time.perf_counter()
    (live_ids, live_x, live_meta), deleted, upserted, moved = _mutable_writes(
        m, x, meta, seed=seed)
    write_s = time.perf_counter() - t0
    if m.delta_fraction >= m.delta_params.compact_fraction:
        raise AssertionError(f"{label}: delta fraction {m.delta_fraction} "
                             "is past the compaction trigger")

    def sync():
        if device == "cuda":
            import torch

            torch.cuda.synchronize()

    score_q = float(np.quantile(np.asarray(meta["score"]), 0.1))
    exprs = {None: None, "score<=q0.1": Num("score").le(score_q)}
    for expr in exprs.values():                  # warm-up: the delta upload
        m.search(q, k=10, filter=expr)
        m.search(q, k=10, filter=expr, impl="plain")
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = m.search(q, k=10)                      # the mutable path, counted
    sync()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()

    walls = {"mutable": [wall], "mutable_plain": [], "base": [], "base_k": [],
             "delta_scan": []}
    view = m._state.delta
    base_k = 10 + m._oversample(m.stats.tombstones)

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        walls[key].append(time.perf_counter() - t0)
        return out

    plain = timed("mutable_plain", lambda: m.search(q, k=10, impl="plain"))
    for _ in range(2):                            # in turns
        timed("base", lambda: index.search(q, k=10))
        timed("mutable", lambda: m.search(q, k=10))
        # the mutable search's own parts: the base search at the
        # tombstone-oversampled k, and the delta scan
        timed("base_k", lambda: index.search(q, k=base_k))
        timed("delta_scan", lambda: scan_delta(view, q, 10))
        timed("mutable_plain", lambda: m.search(q, k=10, impl="plain"))
    med = {key: float(np.median(v)) for key, v in walls.items()}
    profile = _profile_search(m, q) if device == "cuda" else None
    if profile is not None and profile["device_busy_ms"] is not None:
        profile["device_idle_share"] = 1.0 - profile["device_busy_ms"] / (
            med["mutable"] * 1e3)

    rows = []
    for name, expr in exprs.items():
        got = res if expr is None else m.search(q, k=10, filter=expr)
        ref = plain if expr is None else m.search(q, k=10, filter=expr,
                                                  impl="plain")
        if expr is None:
            pool = np.arange(live_ids.size)
        else:
            cf = filter_mod.compile_filter(expr, m.schema, m.vocab)
            enc = filter_mod.encode_metadata(m.schema, m.vocab, live_meta,
                                             live_ids.size)
            pool = np.flatnonzero(filter_mod.filter_mask_np(cf, enc.tags,
                                                            enc.nums))
        truth = live_ids[pool[brute_force_knn(live_x[pool], q, 10)]]
        recall = recall_at_k(got.ids, truth)
        agree = float((got.ids == ref.ids).all(1).mean())
        rows.append(dict(filter=name, recall_at_10=recall,
                         plain_recall_at_10=recall_at_k(ref.ids, truth),
                         ids_agree_share=agree,
                         mean_ios=float(got.ios.mean()),
                         mean_hops=float(got.hops.mean())))
        if np.isin(got.ids, deleted).any():
            raise AssertionError(f"{label} {name}: a deleted id was returned")
        if recall < MIN_RECALL:
            raise AssertionError(f"{label} {name}: recall@10 {recall:.4f} < "
                                 f"{MIN_RECALL}")
        if agree < 0.99:
            raise AssertionError(f"{label} {name}: kernel and plain paths agree "
                                 f"on ids for only {agree:.4f} of queries")
    up = m.search(moved, k=1)
    if not np.array_equal(up.ids[:, 0], upserted):
        raise AssertionError(f"{label}: an upserted id does not return its "
                             "new vector")
    if device == "cuda" and launches["l2_distance"] <= 0:
        raise AssertionError(f"{label}: l2_distance never launched")

    SCRATCH.mkdir(parents=True, exist_ok=True)
    directory = tempfile.mkdtemp(dir=SCRATCH)
    try:
        t0 = time.perf_counter()
        m.save(directory)
        save_s = time.perf_counter() - t0
        loaded = {"resident": MutableIndex.load(directory, device=device),
                  "budget": MutableIndex.load(directory, device=device,
                                              memory_budget=BUDGET)}
        for expr in exprs.values():
            want = m.search(q, k=10, filter=expr)
            for how, lm in loaded.items():
                got = lm.search(q, k=10, filter=expr)
                for field in got._fields:
                    if not np.array_equal(getattr(got, field),
                                          getattr(want, field)):
                        raise AssertionError(
                            f"{label}: {how} load's {field} differ from the "
                            "saved state's")
    finally:
        shutil.rmtree(directory, ignore_errors=True)

    st = m.stats
    out = dict(
        n_base=int(st.base_rows), inserts=N_INSERTS, upserts=N_UPSERTS,
        deletes=N_DELETES, delta_live=st.delta_live, delta_rows=view.count,
        delta_padded=int(view.vecs.shape[0]), tombstones=st.tombstones,
        delta_fraction=st.delta_fraction,
        base_k=base_k, write_s=write_s, searches=rows, launches=launches,
        qps=len(q) / med["mutable"], plain_qps=len(q) / med["mutable_plain"],
        base_qps=len(q) / med["base"],
        search_ms=med["mutable"] * 1e3, base_search_ms=med["base"] * 1e3,
        base_k_search_ms=med["base_k"] * 1e3,
        delta_scan_ms=med["delta_scan"] * 1e3,
        delta_scan_share=med["delta_scan"] / med["mutable"],
        search_ms_runs=[w * 1e3 for w in walls["mutable"]],
        profile=profile,
        save_s=save_s, saved_equals_loaded=True,
    )
    emit(label, **out)
    return out


def run_compaction(cfg, *, device: str, seed: int,
                   label: str = "compaction") -> dict:
    """Compaction on a small mutable index: a base of N_COMPACT_BASE
    vectors, 5% of them deleted, then inserts past ``compact_fraction`` (0.21
    of the live base, then 0.32) so the insert itself compacts. The rebuilt
    index is held to a fresh build over the merged set on the same device:
    every array the search reads (codebooks, codes, page records and
    neighbours, LSH planes, samples and codes) equal with ``torch.equal``,
    and the search's ids (translated to external ids), distances, I/Os,
    hops and cache hits equal exactly; its recall@10 against the merged
    set's brute force within 0.005 of the fresh build's. Raises naming
    every field that differs."""
    import numpy as np
    import torch

    from repro_torch.core import MutableIndex, PageANNIndex, recall_at_k
    from repro_torch.core.vamana import brute_force_knn

    n = N_COMPACT_BASE
    n_del, n_first, n_new = n // 20, n // 5, 3 * n // 10
    x, q, _ = make_data(n, cfg.dim, 200, seed + 5)
    new = fresh_vectors(n, n_new, cfg.dim, seed + 5)
    t0 = time.perf_counter()
    m = MutableIndex(PageANNIndex.build(x, cfg, device=device))
    base_build_s = time.perf_counter() - t0
    m.delete(np.arange(n_del))
    m.insert(new[:n_first])                   # 0.21 of the base: below
    gen_before = m.generation
    fraction_before = m.delta_fraction
    if gen_before != 0:
        raise AssertionError(f"{label}: compacted below the trigger")
    t0 = time.perf_counter()
    m.insert(new[n_first:])                   # 0.32: past it, compacts
    compact_s = time.perf_counter() - t0
    if m.generation != gen_before + 1 or m.stats.delta_live != 0:
        raise AssertionError(f"{label}: the insert did not compact")
    merged = np.concatenate([x[n_del:], new])
    ids = np.arange(n_del, n + n_new)
    truth = ids[brute_force_knn(merged, q, 10)]
    got = m.search(q, k=10)
    t0 = time.perf_counter()
    fresh = PageANNIndex.build(merged, cfg, device=device)
    fresh_build_s = time.perf_counter() - t0
    want = fresh.search(q, k=10)
    want_ids = np.where(want.ids >= 0, ids[np.maximum(want.ids, 0)], -1)
    recall, fresh_recall = recall_at_k(got.ids, truth), recall_at_k(want_ids, truth)
    differ = [f"data.{f}" for f in fresh.data._fields
              if not torch.equal(getattr(m.base.data, f),
                                 getattr(fresh.data, f))]
    differ += [f"search.{f}" for f in got._fields
               if not np.array_equal(getattr(got, f),
                                     want_ids if f == "ids" else getattr(want, f))]
    out = dict(n_base=n, deletes=n_del, inserts=n_new,
               generation_before=gen_before,
               generation=m.generation, delta_fraction_before=fraction_before,
               compact_s=compact_s, base_build_s=base_build_s,
               fresh_build_s=fresh_build_s, recall_at_10=recall,
               fresh_recall_at_10=fresh_recall,
               ids_equal_fresh_share=float((got.ids == want_ids).all(1).mean()),
               fields_compared=len(fresh.data._fields) + len(got._fields),
               fields_differing=differ)
    emit(label, **out)
    if differ:
        raise AssertionError(f"{label}: the compacted index differs from a "
                             f"fresh build of the merged set in {differ}")
    if abs(recall - fresh_recall) > 0.005:
        raise AssertionError(f"{label}: recall {recall:.4f} after compaction, "
                             f"{fresh_recall:.4f} for a fresh build")
    return out


# the baselines' operating points: the default SearchParams, and a beam
# of 128, where DiskANN's recall@10 meets PageANN HYBRID's at its default
# (0.9651 against 0.9604 on an H100 over this data); the paper compares the
# systems at comparable recall. At the default beam DiskANN's 16-byte PQ
# estimates leave recall@10 at 0.7687 here, so the reference test's floor
# of 0.85 is held at the second point
BASELINE_POINTS = {"default": {}, "beam128": {"beam_width": 128}}
BASELINE_MIN_RECALL = 0.85
BASELINE_RECALL_POINT = "beam128"


def _baseline_point(index, q, truth, p, *, device: str) -> tuple[dict, object]:
    """One baseline search at params ``p``: counted through the kernels,
    then the plain versions; ids equal for >= 99% of queries, ios and hops
    equal exactly. Returns (numbers, the kernels' result)."""
    import numpy as np

    from repro_torch.core import recall_at_k
    from repro_torch.kernels import ops

    index.search(q, params=p)                     # warm-up
    index.search(q, params=p, impl="plain")
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = index.search(q, params=p)               # the baseline path, counted
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    plain = index.search(q, params=p, impl="plain")
    wall = _median_wall(lambda: index.search(q, params=p), device)
    row = dict(
        beam=p.beam_width, recall_at_10=recall_at_k(res.ids, truth),
        plain_recall_at_10=recall_at_k(plain.ids, truth),
        mean_ios=float(res.ios.mean()), mean_hops=float(res.hops.mean()),
        max_hops=int(res.hops.max()), qps=len(q) / wall,
        ids_agree_share=float((res.ids == plain.ids).all(1).mean()),
        ios_equal=bool(np.array_equal(res.ios, plain.ios)),
        hops_equal=bool(np.array_equal(res.hops, plain.hops)),
        dists_max_abs_diff=float(np.abs(res.dists - plain.dists)[
            np.isfinite(res.dists)].max()),
        launches=launches,
    )
    if device == "cuda":
        prof = _profile_search(index, q, params=p)
        if prof["device_busy_ms"] is not None:
            prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] / (
                wall * 1e3)
        row["profile"] = prof
    if not (np.isfinite(res.dists[:, 0]).all()
            and res.ids.shape == (len(q), p.k)):
        raise AssertionError("malformed results")
    if row["ids_agree_share"] < 0.99:
        raise AssertionError(f"kernel and plain ids agree for only "
                             f"{row['ids_agree_share']:.4f} of queries")
    if not (row["ios_equal"] and row["hops_equal"]):
        raise AssertionError("kernel and plain ios or hops differ")
    if device == "cuda" and not (launches.get("pq_adc", 0) > 0
                                 and launches.get("page_gather_l2", 0) > 0):
        raise AssertionError(f"pq_adc and page_gather_l2 not both launched: "
                             f"{launches}")
    return row, res


def run_baselines(ctx: dict, pageann: dict, cfg, *, device: str,
                  smoke: Smoke | None = None, label: str = "baselines") -> dict:
    """The paper's baselines over the e2e data: ``DiskANNIndex.build`` (a
    Vamana graph and PQ codebooks of its own, id-order pages), then
    ``StarlingIndex.from_data`` on the same graph and codebooks with
    ``group_pages``' layout. Both search the e2e queries at each of
    BASELINE_POINTS through the kernels (``pq_adc`` for the entry and
    neighbour estimates, ``page_gather_l2`` for the exact rerank, launches
    counted from 0 before each search) and through the plain versions
    (``_baseline_point``); one graph gives both the same ids, Starling
    reads fewer pages, recall@10 >= BASELINE_MIN_RECALL at
    BASELINE_RECALL_POINT; each saved and reloaded through ``load_index``
    equal exactly. ``pageann``: the e2e HYBRID run's numbers, printed beside
    the baselines'. Returns the numbers and, under ``"index"``, the DiskANN
    index (the serve phase serves it)."""
    import numpy as np

    from repro_torch.core import (DiskANNIndex, SearchParams, StarlingIndex,
                                  load_index)

    x, q, truth = ctx["x"], ctx["q"], ctx["truth"]
    t0 = time.perf_counter()
    disk = DiskANNIndex.build(x, cfg, device=device)
    build_s = time.perf_counter() - t0
    nbrs = disk.data.nbrs.cpu().numpy()
    t0 = time.perf_counter()
    star = StarlingIndex.from_data(
        x, nbrs, disk.data.codebooks.cpu().numpy(),
        page_of=StarlingIndex._layout(x, nbrs, cfg), device=device)
    layout_s = time.perf_counter() - t0

    out = dict(n=len(x), dim=x.shape[1], queries=len(q), build_s=build_s,
               starling_layout_s=layout_s, pq_subspaces=cfg.pq_subspaces,
               pageann_hybrid=dict(
                   recall_at_10=pageann["recall_at_10"],
                   mean_ios=pageann["mean_ios"],
                   mean_hops=pageann["mean_hops"], qps=pageann["qps"]))
    SCRATCH.mkdir(parents=True, exist_ok=True)
    directory = tempfile.mkdtemp(dir=SCRATCH)
    try:
        for name, index in (("diskann", disk), ("starling", star)):
            out[name] = dict(pages=index.stats.pages)
            for point, kw in BASELINE_POINTS.items():
                p = SearchParams(**kw)
                try:
                    row, res = _baseline_point(index, q, truth, p,
                                               device=device)
                except AssertionError as e:
                    raise AssertionError(f"{label}: {name} {point}: {e}")
                out[name][point] = row
                if point == "default":
                    sub = os.path.join(directory, name)
                    index.save(sub)
                    _search_equal(load_index(sub, device=device).search(q),
                                  res, f"{label}: {name} reloaded")
                    out[name]["reload_equal"] = True
                out[name][point]["_ids"] = res.ids
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    for point in BASELINE_POINTS:
        dk, st = out["diskann"][point], out["starling"][point]
        if not np.array_equal(dk.pop("_ids"), st.pop("_ids")):
            raise AssertionError(f"{label}: {point}: one graph, two traversals")
        if not st["mean_ios"] < dk["mean_ios"]:
            raise AssertionError(f"{label}: {point}: Starling reads no fewer "
                                 "pages than DiskANN")
    for name in ("diskann", "starling"):
        got = out[name][BASELINE_RECALL_POINT]["recall_at_10"]
        if got < BASELINE_MIN_RECALL:
            raise AssertionError(f"{label}: {name} recall@10 {got:.4f} < "
                                 f"{BASELINE_MIN_RECALL} at "
                                 f"{BASELINE_RECALL_POINT}")
    if smoke is not None:
        # the kernels at the baseline path's shapes: the rerank's (Q, b)
        # node ids over the vectors as (N, 1, d) pages, and the neighbour
        # estimates' (Q, b R) code rows of the DiskANN table
        import torch

        rng = np.random.default_rng(smoke.seed + 19)
        b, r = SearchParams().io_batch, disk.data.nbrs.shape[1]
        ids = torch.as_tensor(rng.integers(0, len(x), (len(q), b)).astype(
            np.int32)).to(device)
        qt = torch.as_tensor(q).to(device)
        smoke.rows["page_gather_l2"] = _page_gather_case(
            smoke, disk.data.x.view(len(x), 1, -1), ids, qt)
        nids = torch.as_tensor(rng.integers(0, len(x), (len(q), b * r))).to(device)
        from repro_torch.core import pq as pq_mod

        lut = pq_mod.pq_lut(qt, disk.data.codebooks).contiguous()
        for row in (smoke.rows["page_gather_l2"],
                    _pq_adc_gather_case(smoke, disk.data.codes, nids, lut, 50)):
            emit("kernels", path=label, **row)
    emit(label, **out)
    out["index"] = disk
    return out


SERVE_BATCH = 64         # the engine's batch in the serve phase
SERVE_REQUESTS = 1000    # requests submitted by SERVE_THREADS threads
SERVE_THREADS = 4
SERVE_INSERTS, SERVE_DELETES = 200, 100
SERVE_HTTP = 20
# the timed pass: the README's serving timeout, and requests enough that
# every collection's group leaves a ragged tail only the timer can send
SERVE_TIMEOUT_MS = 2.0
SERVE_TIMED_REQUESTS = 300


def _serve_requests(svc, names, q, n_req: int, *, flush: bool,
                    label: str) -> tuple[dict, float]:
    """SERVE_THREADS submitters, request i to collection ``names[i % 3]``
    with query ``i % len(q)``; a full group dispatches in the thread that
    filled it. With ``flush``, one flush sends the ragged tails once every
    request is in; without it only the engine's timer can. Returns
    ({request: RequestResult}, wall seconds)."""
    import threading

    futs: dict = {}
    errors: list = []

    def submitter(t):
        try:
            for i in range(t, n_req, SERVE_THREADS):
                futs[i] = svc.submit(names[i % 3], q[i % len(q)])
        except Exception as e:             # reported below, not lost
            errors.append(repr(e))

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if flush:
        svc.flush()
    rows = {i: f.result(timeout=300) for i, f in futs.items()}
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads) or len(rows) != n_req:
        raise AssertionError(f"{label}: {len(rows)} of {n_req} requests "
                             f"completed; errors {errors[:3]}")
    return rows, wall


def _rows_equal(rows: dict, want: dict, names, n_q: int, label: str) -> float:
    """Each request's result against its collection's direct search of the
    same query: ids, ios, hops and cache hits exactly, dists within RTOL /
    ATOL. Returns the largest dists difference."""
    import numpy as np

    max_diff = 0.0
    for i, rr in rows.items():
        w, j = want[names[i % 3]], i % n_q
        for field in ("ids", "ios", "hops", "cache_hits"):
            if not np.array_equal(getattr(rr.result, field),
                                  getattr(w, field)[j]):
                raise AssertionError(f"{label}: request {i} ({names[i % 3]}) "
                                     f"{field} differ from the direct search")
        if not np.allclose(rr.result.dists, w.dists[j], rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{label}: request {i} dists differ")
        max_diff = max(max_diff, float(np.abs(rr.result.dists
                                              - w.dists[j]).max()))
    return max_diff


def _dispatch_overlap(spans) -> tuple[float, int]:
    """Mean length (ms) of the ``device_dispatch`` spans and the most of
    them that ran at once."""
    disp = [sp for sp in spans if sp.name == "device_dispatch"]
    events = sorted([(sp.ts, 1) for sp in disp]
                    + [(sp.ts + sp.dur, -1) for sp in disp])
    live = most = 0
    for _, step in events:
        live += step
        most = max(most, live)
    return 1e3 * sum(sp.dur for sp in disp) / max(len(disp), 1), most


def run_serve(ctx: dict, disk, *, device: str, seed: int,
              label: str = "serve") -> dict:
    """The serving layer over three collections: the HYBRID e2e index
    (saved, then attached from disk), the DiskANN index, and a
    ``MutableIndex`` over the HYBRID index, behind one ``VectorService``
    (``BatchingEngine`` at batch 64, no timeout). SERVE_THREADS threads
    submit SERVE_REQUESTS requests, routed round-robin, then one flush
    sends the ragged tails: each result must equal the collection's direct
    search of that query (ids, ios, hops exactly, dists
    within RTOL / ATOL). Then: a second same-geometry collection adds no
    compile-cache miss; SERVE_INSERTS inserts and SERVE_DELETES deletes
    through the engine, after which no deleted id comes back and the live
    inserts find themselves; ``save_database`` / ``load_database`` give
    equal results; ``HttpFrontend`` on 127.0.0.1 answers SERVE_HTTP
    ``/search`` requests as the direct search does and one ``/metrics``
    scrape reconciles with ``metrics()``; a traced pass has every engine
    phase. A timed pass sends SERVE_TIMED_REQUESTS more through a second
    service over the same indexes with a SERVE_TIMEOUT_MS timeout and no
    flush (the tails go out on the timer), held to the direct search too.
    Prints the engine's QPS and p50 / p99 request latency, in both passes,
    beside the QPS of the same requests searched directly, in one call a
    collection and in the engine's batches; for the timed pass also its
    batches, their mean occupancy, the mean dispatch and the most
    dispatches that ran at once."""
    import urllib.request

    import numpy as np

    from repro_torch.core import MutableIndex
    from repro_torch.obs import (Tracer, parse_prometheus_text, sample_value,
                                 serve_registry)
    from repro_torch.serve import HttpFrontend, VectorService

    index, x, q = ctx["index"], ctx["x"], ctx["q"]
    names = ("hybrid", "diskann", "mutable")
    SCRATCH.mkdir(parents=True, exist_ok=True)
    directory = tempfile.mkdtemp(dir=SCRATCH)
    tracer = Tracer(enabled=False, capacity=200_000)
    # no timeout: a group dispatches when full or on a flush. Each search is
    # host-bound (a 64-query dispatch costs about what a 1,000-query one
    # does), so the timed pass below, whose timer sends part-filled groups,
    # is measured on its own
    svc = VectorService(device=device, batch_size=SERVE_BATCH,
                        timeout_ms=None, tracer=tracer)
    try:
        art = os.path.join(directory, "hybrid")
        index.save(art)
        svc.attach("hybrid", art, k=10)
        svc.create_collection("diskann", disk, k=10)
        svc.create_collection("mutable", MutableIndex(index, auto_compact=False),
                              k=10)
        want = {n: svc.index_of(n).search(q, k=10) for n in names}
        # the same requests as direct searches: one call a collection, and
        # in the engine's batches of SERVE_BATCH
        routed = {n: q[[i % len(q) for i in range(c, SERVE_REQUESTS, 3)]]
                  for c, n in enumerate(names)}
        direct_wall = sum(_median_wall(
            lambda n=n: svc.index_of(n).search(routed[n], k=10), device)
            for n in names)
        batched_wall = sum(_median_wall(
            lambda n=n: [svc.index_of(n).search(routed[n][i:i + SERVE_BATCH],
                                                k=10)
                         for i in range(0, len(routed[n]), SERVE_BATCH)],
            device) for n in names)

        rows, wall = _serve_requests(svc, names, q, SERVE_REQUESTS,
                                     flush=True, label=label)
        n_req = SERVE_REQUESTS
        m_run = svc.metrics()
        max_diff = _rows_equal(rows, want, names, len(q), label)
        if m_run.compile_misses != 3 or m_run.compiled_executables != 3:
            raise AssertionError(f"{label}: {m_run.compile_misses} compile "
                                 "misses for three collections")

        # a second collection of the HYBRID geometry compiles nothing new
        svc.attach("hybrid2", art, k=10)
        got2 = svc.search("hybrid2", q[:SERVE_BATCH])
        m_geo = svc.metrics()
        if m_geo.compile_misses != m_run.compile_misses \
                or m_geo.compile_hits <= m_run.compile_hits:
            raise AssertionError(f"{label}: a same-geometry collection added "
                                 "a compile miss")
        if not np.array_equal(np.stack([r.result.ids for r in got2]),
                              want["hybrid"].ids[:SERVE_BATCH]):
            raise AssertionError(f"{label}: hybrid2 differs from hybrid")

        # the timer's dispatch path: a second service over the same indexes
        # with the README's timeout and no flush, so each collection's
        # ragged tail goes out on the timer alone
        timed_tracer = Tracer(enabled=True, capacity=200_000)
        with VectorService(device=device, batch_size=SERVE_BATCH,
                           timeout_ms=SERVE_TIMEOUT_MS,
                           tracer=timed_tracer) as svc_t:
            for n in names:
                svc_t.create_collection(n, svc.index_of(n), k=10)
            rows_t, wall_t = _serve_requests(
                svc_t, names, q, SERVE_TIMED_REQUESTS, flush=False,
                label=f"{label} (timed)")
            m_timed = svc_t.metrics()
        max_diff = max(max_diff, _rows_equal(rows_t, want, names, len(q),
                                             f"{label} (timed)"))
        timed_dispatch_ms, timed_overlap = _dispatch_overlap(
            timed_tracer.spans())

        # writes through the engine
        rng = np.random.default_rng(seed + 23)
        new = (x[rng.integers(0, len(x), SERVE_INSERTS)]
               + 0.05 * rng.standard_normal((SERVE_INSERTS, x.shape[1]))
               ).astype(np.float32)
        t0 = time.perf_counter()
        new_ids = svc.insert("mutable", new)
        dead = np.concatenate([new_ids[:SERVE_DELETES // 2],
                               rng.choice(len(x), SERVE_DELETES // 2,
                                          replace=False)])
        removed = svc.delete("mutable", dead)
        write_s = time.perf_counter() - t0
        if removed != SERVE_DELETES:
            raise AssertionError(f"{label}: {removed} of {SERVE_DELETES} "
                                 "deletes were live")
        probe = np.concatenate([q, new])
        after = np.stack([r.result.ids
                          for r in svc.search("mutable", probe)])
        if np.isin(after, dead).any():
            raise AssertionError(f"{label}: a deleted id came back")
        live_new = new_ids[SERVE_DELETES // 2:]
        found = float((after[len(q) + SERVE_DELETES // 2:, 0] == live_new).mean())
        if found < 0.99:
            raise AssertionError(f"{label}: only {found:.3f} of the live "
                                 "inserts find themselves first")

        # the whole database through save_database / load_database
        db = os.path.join(directory, "db")
        t0 = time.perf_counter()
        svc.save(db)
        with VectorService.load(db, device=device,
                                batch_size=SERVE_BATCH) as svc2:
            reload_s = time.perf_counter() - t0
            if svc2.list_collections() != svc.list_collections():
                raise AssertionError(f"{label}: collections differ on reload")
            for n in svc.list_collections():
                _search_equal(svc2.index_of(n).search(probe, k=10),
                             svc.index_of(n).search(probe, k=10),
                             f"{label}: database {n}")

        # the HTTP frontend on an ephemeral port
        with HttpFrontend(svc, host="127.0.0.1", port=0,
                          registry=serve_registry(svc)) as fe:
            for i in range(SERVE_HTTP):
                name = names[i % 3]
                body = json.dumps({"collection": name,
                                   "query": q[i].tolist()}).encode()
                req = urllib.request.Request(
                    fe.url + "/search", body,
                    {"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    doc = json.loads(r.read())
                direct = svc.index_of(name).search(q[i:i + 1], k=10).ids[0]
                if doc["results"]["ids"] != direct.tolist():
                    raise AssertionError(f"{label}: HTTP search {i} differs")
            with urllib.request.urlopen(fe.url + "/metrics", timeout=60) as r:
                parsed = parse_prometheus_text(r.read().decode())
            m_http = svc.metrics()
            for series, field in (("requests_total", "requests"),
                                  ("batches_total", "batches"),
                                  ("compile_misses_total", "compile_misses"),
                                  ("inserts_total", "inserts"),
                                  ("deletes_total", "deletes")):
                if sample_value(parsed, f"pageann_{series}") != getattr(
                        m_http, field):
                    raise AssertionError(f"{label}: /metrics {series} does not "
                                         "reconcile with metrics()")
            http_ok = sample_value(parsed, "pageann_http_requests_total",
                                   route="/search", code="200")
            if http_ok != SERVE_HTTP:
                raise AssertionError(f"{label}: {http_ok} HTTP 200s counted")

        # a traced pass: a new k is a new signature, so it compiles
        tracer.enabled = True
        svc.search("hybrid", q[:SERVE_BATCH], k=5)
        tracer.enabled = False
        phases = {"submit", "queue_wait", "batch_assemble", "compile",
                  "device_dispatch", "demux", "request"}
        traced = {sp.name for sp in tracer.spans()}
        if not phases <= traced:
            raise AssertionError(f"{label}: trace lacks {phases - traced}")
    finally:
        svc.close()
        shutil.rmtree(directory, ignore_errors=True)
    out = dict(
        collections=list(names), batch=SERVE_BATCH, requests=n_req,
        threads=SERVE_THREADS, wall_s=wall, qps_wall=n_req / wall,
        engine_qps=m_run.qps, latency_ms_p50=m_run.latency_ms_p50,
        latency_ms_p99=m_run.latency_ms_p99,
        latency_ms_mean=m_run.latency_ms_mean, batches=m_run.batches,
        mean_batch_occupancy=m_run.mean_batch_occupancy,
        padded_fraction=m_run.padded_fraction, mean_ios=m_run.mean_ios,
        mean_hops=m_run.mean_hops, compile_misses=m_run.compile_misses,
        compile_hits_after_second_geometry=m_geo.compile_hits,
        direct_qps=n_req / direct_wall,
        direct_batched_qps=n_req / batched_wall,
        timed=dict(
            timeout_ms=SERVE_TIMEOUT_MS, requests=SERVE_TIMED_REQUESTS,
            wall_s=wall_t, qps_wall=SERVE_TIMED_REQUESTS / wall_t,
            engine_qps=m_timed.qps, latency_ms_p50=m_timed.latency_ms_p50,
            latency_ms_p99=m_timed.latency_ms_p99, batches=m_timed.batches,
            mean_batch_occupancy=m_timed.mean_batch_occupancy,
            mean_dispatch_ms=timed_dispatch_ms,
            most_dispatches_at_once=timed_overlap),
        dists_max_abs_diff=max_diff, inserts=SERVE_INSERTS,
        deletes=SERVE_DELETES, write_s=write_s, inserts_found_first=found,
        database_reload_s=reload_s, http_requests=SERVE_HTTP,
        trace_phases=sorted(traced & phases), trace_spans=len(tracer),
    )
    emit(label, **out)
    return out


N_SHARDS = 2             # the sharded phase's shards (paper §7)
# the store's search points, in whole-collection SearchParams (the store
# scales them per shard with shard_params_for): the defaults (beam 64 ->
# 16 a shard) and beam 128 (-> 32), where the recall floor is held. At the
# defaults the 10,000 x 128 store reaches recall@10 0.8228 on the card
# against the unsharded index's 0.9604, and the JAX package's search over
# the same store gives the same ids (tools/sharded_recall_ref.py): the
# per-shard beam is the cause, not the port
SHARDED_POINTS = {"default": {}, "beam128": {"beam_width": 128}}
SHARDED_RECALL_POINT = "beam128"
SHARDED_MIN_RECALL = 0.85
SHARDED_REQUESTS = 300   # served by SERVE_THREADS threads over 3 collections
SHARDED_INSERTS, SHARDED_DELETES = 200, 100   # the mutable index under a mesh


def _sharded_point(store, index, q, truth, p, *, device: str,
                   label: str) -> tuple[dict, object]:
    """The host fan-out at ``p``: warmed up, then counted from 0 through the
    kernels, then through the plain versions (ids equal for >= 99% of
    queries, ios and hops exactly); recall@10, each shard's loop iterations
    and the QPS beside the unsharded ``index``'s default search, in turns.
    Returns (numbers, the counted result)."""
    import numpy as np

    from repro_torch.core import recall_at_k
    from repro_torch.dist import shard_params_for
    from repro_torch.kernels import ops

    def search(**kw):
        return store.search(q, k=10, params=p, **kw)

    search()                                  # warm-up
    search(impl="plain")
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = search()                            # counted
    launches = ops.launch_counts()
    plain = search(impl="plain")
    agree = float((res.ids == plain.ids).all(1).mean())
    if agree < 0.99:
        raise AssertionError(f"{label}: kernel and plain paths agree on ids "
                             f"for only {agree:.4f} of queries")
    for field in ("ios", "hops"):
        if not np.array_equal(getattr(res, field), getattr(plain, field)):
            raise AssertionError(f"{label}: kernel and plain {field} differ")
    if not (np.isfinite(res.dists[:, 0]).all() and res.ids.shape == (len(q), 10)
            and res.ids.max() < sum(len(part) for part in store.parts)):
        raise AssertionError(f"{label}: malformed results")
    sp = shard_params_for(store.resolve_params(10, p), store.num_shards)
    sharded_wall, unsharded_wall = _walls_in_turns(
        search, lambda: index.search(q, k=10), device)
    return dict(
        shard_params=dict(beam_width=sp.beam_width, io_batch=sp.io_batch,
                          max_hops=sp.max_hops),
        recall_at_10=recall_at_k(res.ids, truth),
        plain_recall_at_10=recall_at_k(plain.ids, truth),
        ids_agree_share=agree,
        dists_max_abs_diff=float(np.abs(res.dists - plain.dists)[
            np.isfinite(res.dists)].max()),
        qps=len(q) / sharded_wall, unsharded_qps=len(q) / unsharded_wall,
        mean_ios=float(res.ios.mean()), mean_hops=float(res.hops.mean()),
        loop_iterations=[int(s.search(q, k=10, params=sp).hops.max())
                         for s in store.shards],
        launches=launches,
    ), res


def run_sharded(ctx: dict, pageann: dict, cfg, *, device: str, seed: int,
                label: str = "sharded") -> dict:
    """Data sharding over the e2e data: ``ShardedPageStore.build`` with
    N_SHARDS shards (one full build each), then

    * the host fan-out at each of SHARDED_POINTS through the kernels
      (launches counted from 0) and the plain versions: ids equal for >= 99%
      of queries, ios and hops exactly (``_sharded_point``); recall@10 >=
      SHARDED_MIN_RECALL at SHARDED_RECALL_POINT, each point's printed
      beside the unsharded HYBRID index's (``pageann``) with the gap, QPS
      beside its QPS in turns;
    * the mesh fan-out on an (N_SHARDS, 1) mesh naming the card N_SHARDS
      times: the host fan-out's ids, ios and dists exactly, hops and cache
      hits 0 (the reference's contract); with 2+ cards, again over
      distinct cards;
    * the query split (``shard_search``) on the unsharded HYBRID index, on
      the (1, 1) host mesh and a (1, 2) mesh: ``index.search`` exactly;
    * save, ``load_index``, and a load at BUDGET per shard: the search
      exactly (the budgeted store's mesh path refuses);
    * a ``VectorService`` over the store, its reload attached with the
      mesh, and the HYBRID index with the host mesh: SHARDED_REQUESTS from
      SERVE_THREADS threads, each equal to its direct search; the compile
      cache's counters;
    * ``MutableIndex.search(mesh=)`` with writes pending = without the
      mesh.
    Everything after the first item runs at the default point. Returns the
    numbers; ``launches`` are the counted default-point host fan-out's."""
    import numpy as np

    from repro_torch.core import MutableIndex, SearchParams, load_index
    from repro_torch.dist import ShardedPageStore
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.serve import VectorService

    index, x, q, truth = ctx["index"], ctx["x"], ctx["q"], ctx["truth"]
    t0 = time.perf_counter()
    store = ShardedPageStore.build(x, cfg, N_SHARDS, device=device)
    build_s = time.perf_counter() - t0

    points = {}
    for point, kw in SHARDED_POINTS.items():
        points[point], counted = _sharded_point(
            store, index, q, truth, SearchParams(**kw), device=device,
            label=f"{label}: {point}")
        points[point]["recall_gap"] = (pageann["recall_at_10"]
                                       - points[point]["recall_at_10"])
        if point == "default":
            res = counted

    def search(**kw):
        return store.search(q, k=10, **kw)

    # the mesh fan-out: one shard per position of the data axis
    card = make_host_mesh(device).flat[0]
    mesh = make_mesh((N_SHARDS, 1), ("data", "model"), devices=[card] * N_SHARDS)
    ops.reset_launch_counts()
    mres = search(mesh=mesh)
    mesh_launches = ops.launch_counts()

    def mesh_equal(got, what):
        for field in ("ids", "ios", "dists"):
            if not np.array_equal(getattr(got, field), getattr(res, field)):
                raise AssertionError(f"{label}: {what} {field} differ from "
                                     "the host fan-out")
        if got.hops.any() or got.cache_hits.any():
            raise AssertionError(f"{label}: {what} reports hops or cache "
                                 "hits (the reference's are 0)")

    mesh_equal(mres, "mesh path")
    host_wall, mesh_wall = _walls_in_turns(search, lambda: search(mesh=mesh),
                                           device)
    n_cards = 0
    if device == "cuda":
        import torch

        n_cards = torch.cuda.device_count()
    if n_cards >= N_SHARDS:
        spread = make_mesh((N_SHARDS, 1), ("data", "model"))
        mesh_equal(search(mesh=spread), "mesh over distinct cards")
        multi = f"{spread.distinct_devices} distinct cards: equal"
    else:
        multi = (f"skipped: {n_cards} CUDA device(s), a mesh over distinct "
                 f"cards needs {N_SHARDS}")

    # the query split over the unsharded index's replicas
    want = index.search(q, k=10)
    split = make_mesh((1, 2), ("data", "model"), devices=[card] * 2)
    for m in (make_host_mesh(device), split):
        _search_equal(index.search(q, k=10, mesh=m), want,
                      f"{label}: shard_search on a {m.dims} mesh")

    SCRATCH.mkdir(parents=True, exist_ok=True)
    directory = tempfile.mkdtemp(dir=SCRATCH)
    try:
        art = os.path.join(directory, "store")
        store.save(art)
        reloaded = load_index(art, device=device)
        _search_equal(reloaded.search(q, k=10), res, f"{label}: reloaded")
        budgeted = load_index(art, device=device, memory_budget=BUDGET)
        _search_equal(budgeted.search(q, k=10), res,
                      f"{label}: loaded at budget {BUDGET}")
        fetched = budgeted.fetch_stats()["pages_fetched"]
        if not fetched:
            raise AssertionError(f"{label}: the budgeted store fetched nothing")
        try:
            budgeted.search(q, k=10, mesh=mesh)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{label}: a budgeted store searched a mesh")
        del budgeted

        names = ("sharded", "sharded_mesh", "hybrid_mesh")
        with VectorService(device=device, batch_size=SERVE_BATCH) as svc:
            svc.create_collection("sharded", store, k=10)
            svc.attach("sharded_mesh", art, k=10, mesh=mesh)
            svc.create_collection("hybrid_mesh", index, k=10,
                                  mesh=make_host_mesh(device))
            rows, serve_wall = _serve_requests(svc, names, q, SHARDED_REQUESTS,
                                               flush=True, label=label)
            served = svc.metrics()
            stats = svc.stats()["sharded"]
        serve_diff = _rows_equal(rows, {"sharded": res, "sharded_mesh": mres,
                                        "hybrid_mesh": want},
                                 names, len(q), label)
        if served.compile_misses != 3 or served.compiled_executables != 3:
            raise AssertionError(f"{label}: {served.compile_misses} compile "
                                 f"misses, {served.compiled_executables} "
                                 "executables for 3 collections")
        if stats != store.stats:
            raise AssertionError(f"{label}: service stats {stats} are not the "
                                 "store's")
    finally:
        shutil.rmtree(directory, ignore_errors=True)

    m = MutableIndex(index, auto_compact=False)
    m.insert(fresh_vectors(len(x), SHARDED_INSERTS, x.shape[1], seed + 5),
             ids=np.arange(len(x), len(x) + SHARDED_INSERTS))
    m.delete(np.arange(SHARDED_DELETES))
    _search_equal(m.search(q, k=10, mesh=make_host_mesh(device)),
                  m.search(q, k=10), f"{label}: mutable search with a mesh")

    default = points["default"]
    profile = _profile_search(store, q) if device == "cuda" else None
    if profile is not None and profile["device_busy_ms"] is not None:
        profile["device_idle_share"] = 1.0 - profile["device_busy_ms"] * (
            default["qps"] / len(q) / 1e3)
    out = dict(
        n=len(x), dim=x.shape[1], queries=len(q), shards=N_SHARDS,
        shard_sizes=[len(p) for p in store.parts], build_s=build_s,
        stats=store.stats, points=points,
        unsharded=dict(recall_at_10=pageann["recall_at_10"],
                       mean_ios=pageann["mean_ios"],
                       mean_hops=pageann["mean_hops"]),
        launches=default["launches"], mesh_launches=mesh_launches,
        mesh_qps=len(q) / mesh_wall, host_qps_beside_mesh=len(q) / host_wall,
        mesh_distinct_devices=mesh.distinct_devices,
        multi_card=multi, budget_pages_fetched=fetched,
        serve=dict(requests=SHARDED_REQUESTS, qps=SHARDED_REQUESTS / serve_wall,
                   p50_ms=served.latency_ms_p50, p99_ms=served.latency_ms_p99,
                   batches=served.batches,
                   compile_misses=served.compile_misses,
                   compile_hits=served.compile_hits,
                   compiled_executables=served.compiled_executables,
                   dists_max_abs_diff=serve_diff),
        profile=profile,
    )
    emit(label, **out)
    recall = points[SHARDED_RECALL_POINT]["recall_at_10"]
    if recall < SHARDED_MIN_RECALL:
        raise AssertionError(f"{label}: recall@10 {recall:.4f} < "
                             f"{SHARDED_MIN_RECALL} at {SHARDED_RECALL_POINT}")
    for point, row in points.items():
        if device == "cuda" and row["launches"]["hamming"] != N_SHARDS:
            raise AssertionError(f"{label}: {point}: {row['launches']['hamming']}"
                                 f" hamming launches for {N_SHARDS} shards")
    return out


# ------------------------------------------------------------------ lm_serve
LM_ARCH = "granite-3-2b"     # the reference driver's default arch, full width
# the phase's corpus: half of examples/serve_rag.py's 2,000 documents (cut
# so that the lm_families phase fits the smoke's time; the builds are 99%
# host-side prune); the database holds the same documents as two
# collections of 500
N_LM_DOCS = 1000
LM_BATCH, LM_PROMPT, LM_GEN = 8, 32, 16   # the timed generate
# the 2-layer full-width cut's logits (|logit| up to ~5), card against CPU:
# cuBLAS and the CPU's BLAS sum in other orders, and where k or v straddles
# a bf16 rounding boundary the KV cache element lands one bf16 step (2^-8
# relative) apart. On the H100 0.5% of the cache's k elements did, and the
# logits differed by up to 0.0033; with a float32 cache (a diagnostic only,
# tools/lm_cut_card_vs_cpu.py) by 4.9e-6
LM_LOGIT_TOL = 1e-2
LM_PREFILL_TOL = 2e-2        # tests/test_models.py's prefill = decode bound


def _lm_index_cfg(dim: int):
    """``examples/serve_rag.py``'s PageANNConfig at the model's width, one
    build round as in the e2e phase."""
    from repro_torch.core import MemoryMode, PageANNConfig

    return PageANNConfig(dim=dim, graph_degree=16, build_beam=32,
                         pq_subspaces=8, lsh_sample=512, lsh_entries=8,
                         beam_width=48, build_rounds=1,
                         memory_mode=MemoryMode.HYBRID)


def _token_means(model, n: int, vocab: int, seed: int, length: int = 16):
    """``n`` mean embeddings of ``length`` random tokens each (float32,
    host), as ``examples/serve_rag.py`` makes its documents and the driver
    its queries."""
    import numpy as np
    import torch

    tokens = np.random.default_rng(seed).integers(0, vocab, (n, length))
    with torch.no_grad():
        emb = model.embed[torch.as_tensor(tokens, device=model.device)]
        return emb.mean(dim=1).to(torch.float32).cpu().numpy()


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def _positions3(arch, B: int, t0: int, T: int, device):
    """M-RoPE positions (3, B, T) for ``T`` tokens from position ``t0``, as
    a VLM lays out a 4-wide patch grid: the temporal stream counts tokens,
    the height and width streams walk the grid. None without M-RoPE."""
    if not arch.mrope:
        return None
    import torch

    t = torch.arange(t0, t0 + T, device=device, dtype=torch.int32)
    return torch.stack([t, t // 4, t % 4])[:, None, :].expand(3, B, T)


def _lm_decode(model, arch, prompts, steps: int):
    """Teacher-forced decode of ``prompts`` then ``steps`` greedy tokens
    (M-RoPE positions passed where the config has them); returns every
    step's logits (B, V_pad) on the host and the tokens."""
    import torch

    from repro_torch.models import transformer as tf

    B, T = prompts.shape
    cache = tf.init_cache(arch, B, T + steps, device=model.device)
    logits, out, toks = [], [], None
    for t in range(T + steps):
        tok = prompts[:, t] if t < T else toks
        lg, cache = tf.decode_step(model, cache, tok, t, arch,
                                   _positions3(arch, B, t, 1, model.device))
        logits.append(lg.cpu())
        toks = torch.argmax(lg[:, :arch.vocab_size], -1).to(torch.int32)
        if t >= T - 1:
            out.append(toks.cpu())
    return logits, torch.stack(out, 1)


def _generate(model, arch, prompts, n_gen: int):
    """The driver's ``generate`` (``repro_torch.launch.serve``); for an
    M-RoPE config the same loop with its positions passed to every step."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    if not arch.mrope:
        return serve.generate(model, arch, prompts, n_gen)
    B, T = prompts.shape
    cache = tf.init_cache(arch, B, T + n_gen, device=model.device)
    for t in range(T):
        logits, cache = tf.decode_step(
            model, cache, prompts[:, t], t, arch,
            _positions3(arch, B, t, 1, model.device))
    out = [torch.argmax(logits[:, :arch.vocab_size], -1).to(torch.int32)]
    for t in range(T, T + n_gen - 1):
        logits, cache = tf.decode_step(
            model, cache, out[-1], t, arch,
            _positions3(arch, B, t, 1, model.device))
        out.append(torch.argmax(logits[:, :arch.vocab_size], -1)
                   .to(torch.int32))
    return torch.stack(out, dim=1)


def _profile_step(fn, wall_ms: float) -> dict:
    """``fn()`` once under the profiler: the device's busy ms, its kernel
    launches, its idle share against ``wall_ms`` and the eight kernels that
    took the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name: dict = {}
    for e in kern:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(
        device_busy_ms=busy if kern else None,
        device_launches=len(kern),
        device_idle_share=(1.0 - busy / wall_ms) if kern else None,
        top=[dict(name=n[:90], device_ms=ms, count=c)
             for n, (ms, c) in top])


def _step_bytes(model) -> int:
    """The bytes a decode step must read: every parameter but the input
    embedding table (a step reads B of its rows), which is also the output
    head where the embeddings are tied. For an MoE that is every expert:
    the reference's dispatch computes all of them."""
    from repro_torch.models import transformer as tf

    skip = model.embed if (model.embed is not None
                           and model.unembed is not None) else None
    return tf.param_bytes(model) - (
        skip.numel() * skip.element_size() if skip is not None else 0)


def _lm_model_phase(model, arch, *, device, seed: int,
                    prefill_check: bool = True, label: str = "lm_serve"
                    ) -> dict:
    """The LM on the card: (i) ``generate`` timed (prefill token by token,
    then greedy steps), a decode step profiled for its launches and the
    device's idle share, against the weights-read bound; (iii) with
    ``prefill_check``, the last prefill step's logits against
    ``forward_train``'s at the reference test's 2e-2."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tf

    gen = torch.Generator(device=device).manual_seed(seed + 1)
    prompts = torch.randint(0, arch.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=device).to(torch.int32)

    def timed(n_gen):
        _sync(device)
        t0 = time.perf_counter()
        out = _generate(model, arch, prompts, n_gen)
        _sync(device)
        return out, time.perf_counter() - t0

    _generate(model, arch, prompts, 2)            # warm-up: cuBLAS, allocator
    walls16, walls1 = [], []
    for _ in range(2):                            # in turns
        out, w = timed(LM_GEN)
        walls16.append(w)
        walls1.append(timed(1)[1])
    t16, t1 = float(np.median(walls16)), float(np.median(walls1))
    if tuple(out.shape) != (LM_BATCH, LM_GEN) or not (
            (out >= 0) & (out < arch.vocab_size)).all():
        raise AssertionError(f"{label}: {arch.name}: generate gave "
                             f"{tuple(out.shape)} tokens or tokens outside "
                             "the vocabulary")
    decode_ms = (t16 - t1) * 1e3 / (LM_GEN - 1)

    profile = None
    if str(device).startswith("cuda"):
        cache = tf.init_cache(arch, LM_BATCH, LM_PROMPT + 1, device=device)
        for t in range(LM_PROMPT):
            tf.decode_step(model, cache, prompts[:, t], t, arch,
                           _positions3(arch, LM_BATCH, t, 1, device))
        tok = prompts[:, -1]
        p3 = _positions3(arch, LM_BATCH, LM_PROMPT, 1, device)
        profile = _profile_step(
            lambda: tf.decode_step(model, cache, tok, LM_PROMPT, arch, p3),
            decode_ms)

    prefill_diff = None
    if prefill_check:
        # (iii) prefill = token-by-token decode at full width
        logits, _ = _lm_decode(model, arch, prompts, 0)
        batch = {"tokens": prompts}
        if arch.mrope:
            batch["positions3"] = _positions3(arch, LM_BATCH, 0, LM_PROMPT,
                                              device)
        with torch.no_grad():
            full, _ = tf.forward_train(model, batch, arch)
        full_last = full[:, -1, :arch.vocab_size].float().cpu()
        dec_last = logits[-1][:, :arch.vocab_size].float()
        prefill_diff = float((full_last - dec_last).abs().max())
        torch.testing.assert_close(full_last, dec_last, rtol=LM_PREFILL_TOL,
                                   atol=LM_PREFILL_TOL)

    step_bytes = _step_bytes(model)
    return dict(
        batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN,
        generate_s_runs=walls16, prefill_s_runs=walls1,
        prefill_ms=t1 * 1e3, decode_ms_per_step=decode_ms,
        decode_tokens_per_s=LM_BATCH / (decode_ms / 1e3),
        generate_tokens_per_s=LM_BATCH * LM_GEN / t16,
        step_weight_bytes=step_bytes,
        step_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
        prefill_vs_decode_max_abs_diff=prefill_diff,
        profile=profile,
    )


def _driver(argv, *, device, label: str, phase: str = "lm_serve"
            ) -> tuple[str, dict, float]:
    """``repro_torch.launch.serve.main(argv)`` with its output captured and
    echoed as one phase line; returns (output, launches, seconds). A
    ``SystemExit`` (a failed self-retrieval or self-check) fails the phase."""
    import contextlib
    import io

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    buf = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            serve.main(argv, device=device)
    except SystemExit as e:
        raise AssertionError(f"{phase} {label}: the driver exited: {e}")
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    emit(phase, stage="driver", run=label, argv=argv, seconds=seconds,
         launches={k: v for k, v in launches.items() if v},
         output=buf.getvalue().splitlines())
    return buf.getvalue(), launches, seconds


def _retrieved(text: str) -> str:
    """The ids block a driver printed for an ``--index-dir`` run."""
    return text.split("retrieved ids per prompt:\n")[1].split("\ngenerated ")[0]


def _lm_searches(index, directory, docs, q, extra, *, device,
                 label: str = "lm_serve") -> dict:
    """The LM-width retrieval through the kernels and the plain versions:
    resident, streamed at BUDGET and (unless ``extra`` is None) a
    MutableIndex with ``extra`` inserted; ids equal for >= 99% of queries,
    ios and hops exactly, streamed = resident exactly; recall@10 against
    brute force printed (no floor). Returns each search's launches."""
    import numpy as np

    from repro_torch.core import MutableIndex, PageANNIndex, recall_at_k
    from repro_torch.core.vamana import brute_force_knn
    from repro_torch.kernels import ops

    streamed = PageANNIndex.load(directory, device=device,
                                 memory_budget=BUDGET)
    truth = brute_force_knn(docs, q, 10)
    searches = [("resident", index, truth), ("streamed", streamed, truth)]
    if extra is not None:
        mutable = MutableIndex(index, auto_compact=False)
        mutable.insert(extra)
        truth_mut = brute_force_knn(np.concatenate([docs, extra]), q, 10)
        searches.append(("mutable", mutable, truth_mut))
    dim = index.cfg.dim
    out, resident = {}, None
    for name, idx, want in searches:
        idx.search(q, k=10)                       # warm-up
        ops.reset_launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        got = idx.search(q, k=10)                 # counted
        _sync(device)
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        plain = idx.search(q, k=10, impl="plain")
        agree = float((got.ids == plain.ids).all(1).mean())
        row = dict(
            queries=len(q), wall_ms=wall * 1e3, qps=len(q) / wall,
            recall_at_10=recall_at_k(got.ids, want),
            plain_recall_at_10=recall_at_k(plain.ids, want),
            ids_agree_share=agree,
            mean_ios=float(np.mean(got.ios)), mean_hops=float(np.mean(got.hops)),
            launches={k: v for k, v in launches.items() if v})
        out[name] = row
        if agree < 0.99:
            raise AssertionError(f"{label} {name}: kernel and plain ids agree "
                                 f"on only {agree:.4f} of queries at d = {dim}")
        if name != "mutable" and not (np.array_equal(got.ios, plain.ios)
                                      and np.array_equal(got.hops, plain.hops)):
            raise AssertionError(f"{label} {name}: kernel and plain ios or "
                                 f"hops differ at d = {dim}")
        if name == "resident":
            resident = got
        if name == "streamed":
            for field in got._fields:
                if not np.array_equal(getattr(got, field),
                                      getattr(resident, field)):
                    raise AssertionError(f"{label}: streamed {field} differ "
                                         "from the resident search's")
    if str(device).startswith("cuda"):
        need = {"resident": ("page_scan", "pq_adc", "hamming"),
                "streamed": ("page_scan_recs",), "mutable": ("l2_distance",)}
        for name in out:
            never = [k for k in need[name] if not out[name]["launches"].get(k)]
            if never:
                raise AssertionError(f"{label} {name}: {never} never "
                                     f"launched at d = {dim}")
    return out


def _lm_kernel_cases(s, index, q, extra) -> dict:
    """Rows 1-5 of the kernel table at the retrieval's LM-width shapes, on
    the index's own records, codes and LSH sample: each against its plain
    version, timed beside its bound (``l2_distance``, the delta scan, only
    when ``extra`` rows were inserted)."""
    import numpy as np

    torch = s.torch
    from repro_torch.core.delta import _pow2

    data, cfg = index.data, index.cfg
    dev = data.page_recs.device
    rng = np.random.default_rng(s.seed + 7)
    nq, b = len(q), cfg.io_batch
    cap = cfg.resolve_capacity()
    m_disk, rp = cfg.pq_subspaces, data.nbr_ids.shape[1]
    pages = data.page_recs.shape[0]
    ids = torch.as_tensor(rng.integers(0, pages, (nq, b)).astype(np.int32)).to(dev)
    qt = torch.as_tensor(q).to(dev)
    lut = torch.as_tensor(rng.random((nq, m_disk, 256)).astype(np.float32)).to(dev)
    kw = dict(cap=cap, dim=cfg.dim, rp=rp, m=m_disk, adc=True, reps=20)
    rows = {"page_scan": _page_scan_case(s, data.page_recs, ids, qt, lut, **kw),
            "page_scan_recs": _page_scan_case(s, data.page_recs, ids, qt, lut,
                                              staged=True, **kw)}
    m_mem = data.mem_codes.shape[1]
    nids = torch.as_tensor(rng.integers(
        0, data.mem_codes.shape[0], (nq, b * rp))).to(dev)
    lut_mem = torch.as_tensor(rng.random((nq, m_mem, 256)).astype(np.float32)).to(dev)
    rows["pq_adc"] = _pq_adc_gather_case(s, data.mem_codes, nids, lut_mem, 20)
    qcodes = torch.as_tensor(rng.integers(
        -2**31, 2**31, (nq, data.lsh_codes.shape[1])).astype(np.int32)).to(dev)
    rows["hamming"] = _hamming_topk_case(s, data.lsh_codes, qcodes,
                                         cfg.lsh_entries)
    if extra is None:
        return rows
    # the delta scan's call: the inserted rows padded to a power of two
    c_pad = _pow2(len(extra))
    x = np.zeros((c_pad, cfg.dim), np.float32)
    x[:len(extra)] = extra
    keep = torch.zeros(c_pad, dtype=torch.bool, device=dev)
    keep[:len(extra)] = True
    rows["l2_distance"] = _l2_case(s, qt, torch.as_tensor(x).to(dev), 10,
                                   keep=keep)
    return rows


# the lm_serve search each d = 2048 kernel row's launches come from
LM_PATHS = {"page_scan": "resident", "pq_adc": "resident",
            "hamming": "resident", "page_scan_recs": "streamed",
            "l2_distance": "mutable"}


def _lm_row(lm: dict, name: str) -> dict | None:
    """A kernel's numbers at d = 2048 for the kernels line: its device ms
    against its bound at the lm_serve retrieval's shapes and its launches in
    that phase's counted 1,000-query search (None for a kernel off that
    path)."""
    if name not in LM_PATHS:
        return None
    r = lm["kernels"][name]
    search = LM_PATHS[name]
    return dict(
        search=search, launches=lm["search"][search]["launches"].get(name, 0),
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        max_abs_err=r["max_abs_err"])


def run_lm_serve(s: Smoke, *, device: str, seed: int, smoke_arch: bool = False,
                 n_docs: int = N_LM_DOCS, n_queries: int = N_QUERIES) -> dict:
    """The dense decoder at granite-3-2b's full CONFIG (``smoke_arch`` takes
    SMOKE, for a CPU rehearsal) and the port's serving driver over indexes of
    its mean token embeddings (d = 2048: HYBRID capacity 1, 16 member rows a
    record). In order: the model's init; the LM on the card (``generate``
    timed, a decode step profiled, prefill = decode, a 2-layer cut held to
    the CPU); the corpus, index and two-collection database; the driver,
    ``repro_torch.launch.serve.main``, over ``--index-dir``, ``--mutable``,
    ``--memory-budget 0.25`` (its ids equal the resident run's) and
    ``--db-dir --route :wiki,:notes --semantic-cache 0.98 --metrics-port 0
    --obs-selfcheck --trace-out --http-port 0`` (every replayed prompt a
    cache hit); then 1,000 queries through the kernels and the plain
    versions, resident, streamed and mutable (1,000 inserted rows), and
    kernel rows 1-5 at these shapes against their plain versions. Returns
    the phase's numbers, with the kernel rows under ``kernels`` and each
    driver run's launches under ``driver_launches``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import PageANNIndex, save_database
    from repro_torch.models import transformer as tf

    arch = get_arch(LM_ARCH, smoke=smoke_arch)
    size = ["--smoke"] if smoke_arch else []
    out: dict = {"arch": arch.name}
    _sync(device)
    t0 = time.perf_counter()
    model = tf.init_params(arch, torch.Generator(device=device).manual_seed(seed),
                           device=device)
    _sync(device)
    out["model"] = dict(
        params=sum(p.numel() for p in model.parameters()),
        param_bytes=tf.param_bytes(model), init_s=time.perf_counter() - t0,
        layers=arch.num_layers, d_model=arch.d_model, d_ff=arch.d_ff,
        heads=arch.num_heads, kv_heads=arch.num_kv_heads,
        padded_vocab=arch.padded_vocab)
    emit("lm_serve", stage="model", **out["model"])
    docs = _token_means(model, n_docs, arch.vocab_size, seed + 10)
    q = _token_means(model, n_queries, arch.vocab_size, seed + 11)
    extra = _token_means(model, n_queries, arch.vocab_size, seed + 12)
    out["lm"] = _lm_model_phase(model, arch, device=device, seed=seed)
    emit("lm_serve", stage="lm", **out["lm"])
    del model
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    out["cut"] = _family_cut(LM_ARCH, device=device, seed=seed,
                             smoke=smoke_arch)
    emit("lm_serve", stage="cut", **out["cut"])

    cfg = _lm_index_cfg(arch.d_model)
    SCRATCH.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(dir=SCRATCH))
    try:
        t0 = time.perf_counter()
        index = PageANNIndex.build(docs, cfg, device=device)
        build_s = time.perf_counter() - t0
        index.save(str(root / "idx.pageann"))
        half = n_docs // 2
        t0 = time.perf_counter()
        colls = {"wiki": PageANNIndex.build(docs[:half], cfg, device=device),
                 "notes": PageANNIndex.build(docs[half:], cfg, device=device)}
        db_build_s = time.perf_counter() - t0
        save_database(colls, str(root / "db"))
        del colls
        out["index"] = dict(
            docs=n_docs, dim=cfg.dim, capacity=cfg.resolve_capacity(),
            record_rows=int(index.data.page_recs.shape[1]),
            pages=int(index.data.page_recs.shape[0]), build_s=build_s,
            stats=dataclasses.asdict(index.stats),
            db_collections={"wiki": half, "notes": n_docs - half},
            db_build_s=db_build_s)
        emit("lm_serve", stage="index", **out["index"])

        idx_dir = str(root / "idx.pageann")
        runs = {
            "index": ["--index-dir", idx_dir],
            "mutable": ["--index-dir", idx_dir, "--mutable"],
            "budget": ["--index-dir", idx_dir, "--memory-budget",
                       str(BUDGET)],
            "db": ["--db-dir", str(root / "db"), "--route", ":wiki,:notes",
                   "--semantic-cache", "0.98", "--metrics-port", "0",
                   "--obs-selfcheck", "--trace-out", str(root / "trace.json"),
                   "--http-port", "0"],
        }
        texts, out["driver_launches"], out["driver_s"] = {}, {}, {}
        for label, argv in runs.items():
            texts[label], launches, sec = _driver(size + argv, device=device,
                                                  label=label)
            out["driver_launches"][label] = {k: v for k, v in launches.items()
                                             if v}
            out["driver_s"][label] = sec
        if _retrieved(texts["budget"]) != _retrieved(texts["index"]):
            raise AssertionError("lm_serve: the driver's ids under a 0.25 "
                                 "budget differ from the resident run's")
        if "self-retrieval" not in texts["mutable"]:
            raise AssertionError("lm_serve: the mutable run printed no "
                                 "self-retrieval")
        batch = 4                                  # the driver's default
        if f"replay served {batch}/{batch} from cache" not in texts["db"]:
            raise AssertionError("lm_serve: the replayed prompts were not all "
                                 "semantic-cache hits")
        if "obs selfcheck ok" not in texts["db"]:
            raise AssertionError("lm_serve: no obs self-check line")
        trace = json.loads((root / "trace.json").read_text())
        if not trace.get("traceEvents"):
            raise AssertionError("lm_serve: the trace holds no events")
        if str(device).startswith("cuda"):
            need = {"index": ("page_scan", "pq_adc", "hamming"),
                    "mutable": ("l2_distance",), "budget": ("page_scan_recs",)}
            for label, kernels in need.items():
                never = [k for k in kernels
                         if not out["driver_launches"][label].get(k)]
                if never:
                    raise AssertionError(f"lm_serve driver {label}: {never} "
                                         "never launched")

        out["search"] = _lm_searches(index, idx_dir, docs, q, extra,
                                     device=device)
        emit("lm_serve", stage="search", **out["search"])
        if str(device).startswith("cuda"):
            out["kernels"] = _lm_kernel_cases(s, index, q, extra)
            for row in out["kernels"].values():
                emit("lm_serve", stage="kernel", **row)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# --------------------------------------------------------------- lm_families
# the other families at their CONFIG's full width (d_model, heads, d_ff,
# experts, ssm_state, rnn_width, window, vocab); depth cut only where 80 GB
# forces it: qwen2-vl-72b's 80 layers are 291 GB in f32 (8 layers: 38.1
# GB), one arctic-480b layer 56.3 GB in f32 and one kimi-k2 layer 38.8 GB
# in bf16 (all its experts: the reference's dispatch computes every one)
FAMILY_DEPTH = {"mamba2-370m": None, "recurrentgemma-9b": None,
                "hubert-xlarge": None, "qwen2-vl-72b": 8,
                "arctic-480b": 1, "kimi-k2-1t-a32b": 1}
FAMILY_PREFILL = ("mamba2-370m", "recurrentgemma-9b")
ENC_BATCH, ENC_FRAMES = 8, 256        # hubert-xlarge's frame batch
# the card-against-CPU cut of each family: 2 layers (the hybrid: one
# (rec, rec, attn) block) at full width. Two arctic layers are 107 GB in
# f32, more than the card or the host holds, so the MoE cut keeps 8 of its
# 128 experts (top-2, dense residual; 10.3 GB)
FAMILY_CUTS = ("mamba2-370m", "recurrentgemma-9b", "hubert-xlarge",
               "qwen2-vl-72b", "arctic-480b")
CUT_EXPERTS = 8
# recurrentgemma-9b retrieves through the driver at its d_model, 4,096
D4096_ARCH = "recurrentgemma-9b"
N_D4096_DOCS = 1000
D4096_TOKENS = 32                     # tokens a document's mean embeds
D4096_PATHS = {"page_scan": "resident", "pq_adc": "resident",
               "hamming": "resident", "page_scan_recs": "streamed"}


def _family_arch(name: str, smoke: bool = False):
    """``name``'s full CONFIG with its depth cut (FAMILY_DEPTH), and the
    cuts as {field: [kept, full]}; ``smoke`` takes SMOKE, uncut."""
    import dataclasses

    from repro_torch.configs.registry import get_arch

    full = get_arch(name, smoke=smoke)
    depth = FAMILY_DEPTH[name]
    if depth is None or smoke:
        return full, {}
    return (dataclasses.replace(full, num_layers=depth),
            {"num_layers": [depth, full.num_layers]})


def _family_model(name: str, *, device, seed: int, smoke: bool = False
                  ) -> dict:
    """One family at full width on the card: init, then (decoders) the LM
    phase (``generate`` timed, a step profiled against its weights-read
    bound, prefill = decode for the SSM and the hybrid) or (the encoder)
    ``forward_train`` on a frame batch, timed."""
    import numpy as np
    import torch

    from repro_torch.models import frontend as fe
    from repro_torch.models import transformer as tf

    arch, reduced = _family_arch(name, smoke)
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _sync(device)
    t0 = time.perf_counter()
    model = tf.init_params(arch, torch.Generator(device=device)
                           .manual_seed(seed), device=device)
    _sync(device)
    out = dict(arch=name, family=arch.family, reduced=reduced,
               layers=arch.num_layers, d_model=arch.d_model,
               heads=arch.num_heads, kv_heads=arch.num_kv_heads,
               d_ff=arch.d_ff, experts=arch.num_experts,
               experts_per_token=arch.experts_per_token,
               ssm_state=arch.ssm_state, rnn_width=arch.rnn_width,
               window=arch.window, padded_vocab=arch.padded_vocab,
               param_dtype=arch.param_dtype,
               activation_dtype=arch.activation_dtype,
               param_count=arch.param_count(),
               params=sum(p.numel() for p in model.parameters()),
               param_bytes=tf.param_bytes(model),
               init_s=time.perf_counter() - t0,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9
               if str(device).startswith("cuda") else None)
    if arch.is_decoder:
        out["lm"] = _lm_model_phase(model, arch, device=device, seed=seed,
                                    prefill_check=name in FAMILY_PREFILL,
                                    label="lm_families")
    else:
        batch = fe.make_train_batch(arch, ENC_BATCH, ENC_FRAMES,
                                    torch.Generator(device=device)
                                    .manual_seed(seed + 1))
        walls = []
        for _ in range(3):
            _sync(device)
            t0 = time.perf_counter()
            logits, _ = tf.forward_train(model, batch, arch)
            _sync(device)
            walls.append(time.perf_counter() - t0)
        lg = logits[..., :arch.vocab_size]
        if tuple(logits.shape) != (ENC_BATCH, ENC_FRAMES, arch.padded_vocab) \
                or not torch.isfinite(lg).all():
            raise AssertionError(f"lm_families: {name}: forward gave "
                                 f"{tuple(logits.shape)} or non-finite "
                                 "logits")
        fwd_ms = float(np.median(walls[1:])) * 1e3
        profile = None
        if str(device).startswith("cuda"):
            profile = _profile_step(
                lambda: tf.forward_train(model, batch, arch), fwd_ms)
        # the bound: 2 flops a parameter a frame (the products) plus the
        # attention's 4 B T^2 d a layer; the weights, frames and logits once
        tokens = ENC_BATCH * ENC_FRAMES
        flops = 2 * out["params"] * tokens + \
            4 * ENC_BATCH * ENC_FRAMES ** 2 * arch.d_model * arch.num_layers
        moved = tf.param_bytes(model) + batch["embeds"].numel() * 2 \
            + logits.numel() * 4
        out["encoder"] = dict(batch=ENC_BATCH, frames=ENC_FRAMES,
                              forward_s_runs=walls, forward_ms=fwd_ms,
                              frames_per_s=tokens / (fwd_ms / 1e3),
                              weight_bytes=tf.param_bytes(model),
                              **_bound(moved, flops), profile=profile)
    del model
    return out


def _family_cut(name: str, *, device, seed: int, smoke: bool = False
                ) -> dict:
    """(ii) ``name``'s full width cut to 2 layers (the hybrid to one block,
    the MoE to CUT_EXPERTS experts), the same weights (a CPU generator) on
    the card and on the CPU: every decode step's logits (the encoder's
    forward logits) within LM_LOGIT_TOL, the greedy tokens (the encoder's
    argmax) equal. The lm_serve phase cuts granite-3-2b the same way."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tf

    full = get_arch(name, smoke=smoke)
    if full.family == "hybrid":
        cut = dataclasses.replace(full, num_layers=len(full.block_pattern),
                                  tail_pattern=())
    else:
        cut = dataclasses.replace(full, num_layers=2)
    reduced = {"num_layers": [cut.num_layers, full.num_layers]}
    if full.family == "moe":
        cut = dataclasses.replace(cut, num_experts=CUT_EXPERTS)
        reduced["num_experts"] = [CUT_EXPERTS, full.num_experts]
    cpu = tf.init_params(cut, torch.Generator().manual_seed(seed),
                         device="cpu")
    card = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(seed + 3)
    diff = 0.0
    if cut.is_decoder:
        prompts = torch.as_tensor(rng.integers(0, cut.vocab_size, (2, 8)),
                                  dtype=torch.int32)
        got, got_tok = _lm_decode(card, cut, prompts.to(device), 8)
        want, want_tok = _lm_decode(cpu, cut, prompts, 8)
        steps = len(got)
    else:
        embeds = torch.as_tensor(rng.standard_normal(
            (2, 64, tf.FRONTEND_DIM)), dtype=torch.float32)
        got = [tf.forward_train(card, {"embeds": embeds.to(device)},
                                cut)[0].cpu()]
        want = [tf.forward_train(cpu, {"embeds": embeds}, cut)[0]]
        got_tok = got[0][..., :cut.vocab_size].argmax(-1)
        want_tok = want[0][..., :cut.vocab_size].argmax(-1)
        steps = 0
    for g, w in zip(got, want):
        g = g[..., :cut.vocab_size].float()
        w = w[..., :cut.vocab_size].float()
        torch.testing.assert_close(g, w, rtol=LM_LOGIT_TOL, atol=LM_LOGIT_TOL)
        diff = max(diff, float((g - w).abs().max()))
    if not torch.equal(got_tok, want_tok):
        raise AssertionError(f"{name}: the card's greedy tokens differ from "
                             "the CPU's on the 2-layer cut")
    return dict(arch=name, family=cut.family, reduced=reduced,
                param_bytes=tf.param_bytes(cpu), steps=steps,
                logits_max_abs_diff=diff, tol=LM_LOGIT_TOL, tokens_equal=True)


def _d4096_retrieval(s: Smoke, *, device, seed: int, smoke_arch: bool,
                     n_docs: int, n_queries: int) -> dict:
    """recurrentgemma-9b's driver retrieving at its d_model: documents and
    queries are the mean embeddings of random D4096_TOKENS-token sequences
    under the driver's own table (``serve._model_and_prompts``), in a
    HYBRID index (capacity 1); ``serve.main`` over ``--index-dir`` and again
    with ``--memory-budget 0.25`` (ids equal), then the queries through the
    kernels and the plain versions, resident and streamed, and the on-path
    kernels against their plain versions at these shapes."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import PageANNIndex
    from repro_torch.launch import serve

    arch = get_arch(D4096_ARCH, smoke=smoke_arch)
    size = ["--smoke"] if smoke_arch else []
    model, _ = serve._model_and_prompts(arch, 1, 1, device)
    docs = _token_means(model, n_docs, arch.vocab_size, seed + 20,
                        D4096_TOKENS)
    q = _token_means(model, n_queries, arch.vocab_size, seed + 21,
                     D4096_TOKENS)
    del model
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    cfg = _lm_index_cfg(arch.d_model)
    out: dict = {}
    SCRATCH.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(dir=SCRATCH))
    try:
        t0 = time.perf_counter()
        index = PageANNIndex.build(docs, cfg, device=device)
        build_s = time.perf_counter() - t0
        idx_dir = str(root / "idx.pageann")
        index.save(idx_dir)
        out["index"] = dict(
            docs=n_docs, dim=cfg.dim, capacity=cfg.resolve_capacity(),
            record_rows=int(index.data.page_recs.shape[1]),
            pages=int(index.data.page_recs.shape[0]), build_s=build_s,
            stats=dataclasses.asdict(index.stats))
        emit("lm_families", stage="d4096_index", **out["index"])
        runs = {"index": ["--arch", D4096_ARCH, "--index-dir", idx_dir],
                "budget": ["--arch", D4096_ARCH, "--index-dir", idx_dir,
                           "--memory-budget", str(BUDGET)]}
        texts, out["driver_launches"], out["driver_s"] = {}, {}, {}
        for label, argv in runs.items():
            texts[label], launches, sec = _driver(
                size + argv, device=device, label=label, phase="lm_families")
            out["driver_launches"][label] = {k: v for k, v in launches.items()
                                             if v}
            out["driver_s"][label] = sec
        if _retrieved(texts["budget"]) != _retrieved(texts["index"]):
            raise AssertionError("lm_families: the driver's ids under a 0.25 "
                                 "budget differ from the resident run's at "
                                 f"d = {cfg.dim}")
        if str(device).startswith("cuda"):
            need = {"index": ("page_scan", "pq_adc", "hamming"),
                    "budget": ("page_scan_recs",)}
            for label, kernels in need.items():
                never = [k for k in kernels
                         if not out["driver_launches"][label].get(k)]
                if never:
                    raise AssertionError(f"lm_families driver {label}: "
                                         f"{never} never launched")
        out["search"] = _lm_searches(index, idx_dir, docs, q, None,
                                     device=device, label="lm_families")
        emit("lm_families", stage="d4096_search", **out["search"])
        if str(device).startswith("cuda"):
            out["kernels"] = _lm_kernel_cases(s, index, q, None)
            for row in out["kernels"].values():
                emit("lm_families", stage="d4096_kernel", **row)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _d4096_row(fam: dict, name: str) -> dict | None:
    """A kernel's numbers at d = 4096 for the kernels line (None for a
    kernel off this path): device ms, plain ms and bound at the retrieval's
    shapes, launches in that phase's counted 1,000-query search."""
    if name not in D4096_PATHS:
        return None
    r = fam["d4096"]["kernels"][name]
    search = D4096_PATHS[name]
    return dict(
        search=search,
        launches=fam["d4096"]["search"][search]["launches"].get(name, 0),
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r["library_ms"],
        max_abs_err=r["max_abs_err"])


def run_lm_families(s: Smoke, *, device: str, seed: int,
                    smoke_arch: bool = False, n_docs: int = N_D4096_DOCS,
                    n_queries: int = N_QUERIES) -> dict:
    """The MoE, SSM, hybrid, audio and VLM families on the card, one model
    at a time (each freed before the next): at full width (FAMILY_DEPTH's
    cuts) ``generate`` timed and a step profiled, or the encoder's forward;
    each family's cut held card against CPU; then recurrentgemma-9b's
    retrieval at d = 4096 through the driver and the kernels.
    ``smoke_arch`` takes the SMOKE configs, for a CPU rehearsal."""
    out: dict = {"models": {}, "cuts": {}}
    for name in FAMILY_DEPTH:
        row = _family_model(name, device=device, seed=seed, smoke=smoke_arch)
        out["models"][name] = row
        emit("lm_families", stage="model", **row)
    for name in FAMILY_CUTS:
        out["cuts"][name] = _family_cut(name, device=device, seed=seed,
                                        smoke=smoke_arch)
        emit("lm_families", stage="cut", **out["cuts"][name])
    out["d4096"] = _d4096_retrieval(s, device=device, seed=seed,
                                    smoke_arch=smoke_arch, n_docs=n_docs,
                                    n_queries=n_queries)
    return out


def filter_exprs(scores, *, full: bool) -> dict:
    """The predicates of the filter phase: numeric bounds at each
    selectivity (quantiles of the score column) and a tag-and-numeric
    conjunction; ``full=False`` keeps one bound and the conjunction."""
    import numpy as np

    from repro_torch.core import Num, Tag

    scores = np.asarray(scores)
    sels = SELECTIVITIES if full else (0.1,)
    exprs = {f"score<=q{sel}": Num("score").le(float(np.quantile(scores, sel)))
             for sel in sels}
    exprs["topic=t3&score<=0.5"] = (Tag("topic") == "t3") & Num("score").le(0.5)
    return exprs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # 10,000: the Vamana build's host-side prune takes 14-19 ms a vector on
    # the card's host, so 20,000 would not fit in 5 minutes
    ap.add_argument("--n", type=int, default=10_000,
                    help="vectors in the HYBRID end-to-end build and the "
                         "baselines' build")
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
    lm = run_lm_serve(smoke, device="cuda", seed=args.seed)
    torch.cuda.empty_cache()
    fam = run_lm_families(smoke, device="cuda", seed=args.seed)
    torch.cuda.empty_cache()

    # each path's launches, counted from 0 just before its run: the e2e
    # searches (page_scan, pq_adc, hamming; members-only in MEM_ALL), the
    # streamed searches (page_scan_recs*), the filtered ones (*_masked);
    # each adaptive setting's search is counted on its own as well
    launches, adaptive_launches, baseline_launches = {}, {}, {}
    sharded_launches = {}
    for cfg, label in ((cfg_h, "e2e"), (cfg_m, "e2e_memall")):
        hybrid = cfg is cfg_h
        run, ctx = run_e2e(cfg, args.n if hybrid else N_MEMALL,
                           N_QUERIES, device="cuda", seed=args.seed,
                           label=label)
        if hybrid and run["recall_at_10"] < MIN_RECALL:
            raise AssertionError(
                f"HYBRID recall@10 {run['recall_at_10']} < {MIN_RECALL}")
        names = (("page_scan", "pq_adc", "hamming") if hybrid
                 else ("page_scan_members",))
        for name in names:
            launches[name] = run["launches"][name]
        stream = run_stream(ctx, device="cuda",
                            label="stream" if hybrid else "stream_memall")
        name = "page_scan_recs" if hybrid else "page_scan_recs_members"
        launches[name] = stream["launches"][name]
        filt = run_filter(ctx, device="cuda",
                          exprs=filter_exprs(ctx["meta"]["score"], full=hybrid),
                          label="filter" if hybrid else "filter_memall")
        name = "page_scan_masked" if hybrid else "page_scan_members_masked"
        launches[name] = filt["launches"][name]
        name = "page_scan_recs_masked" if hybrid else "page_scan_recs_members_masked"
        launches[name] = filt["stream_launches"][name]
        adapt = run_adaptive(ctx, device="cuda",
                             label="adaptive" if hybrid else "adaptive_memall")
        for setting, counts in adapt["launches"].items():
            for name, n in counts.items():
                adaptive_launches.setdefault(name, {})[
                    f"{cfg.memory_mode.value}:{setting}"] = n
        run_profile(ctx, device="cuda",
                    label="profile" if hybrid else "profile_memall")
        if hybrid:
            mut = run_mutable(ctx, device="cuda", seed=args.seed)
            launches["l2_distance"] = mut["launches"]["l2_distance"]
            bl = run_baselines(ctx, run, cfg_h, device="cuda", smoke=smoke)
            baseline_launches = bl["diskann"]["default"]["launches"]
            launches["page_gather_l2"] = baseline_launches["page_gather_l2"]
            run_serve(ctx, bl.pop("index"), device="cuda", seed=args.seed)
            del bl
            sharded_launches = run_sharded(ctx, run, cfg_h, device="cuda",
                                           seed=args.seed)["launches"]
        del ctx
        torch.cuda.empty_cache()
    run_compaction(cfg_h, device="cuda", seed=args.seed)
    # the distance-only hamming has no caller but its entry point: its path
    # is the one counted call of the kernels phase
    launches["hamming_distances"] = smoke.rows["hamming_distances"]["launches"]
    never = [name for name in KERNELS if launches.get(name, 0) <= 0]
    if never:
        raise AssertionError(f"never launched on their paths: {never}")

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = smoke.rows[name]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], launches_path=PATHS[name],
            launches_adaptive=adaptive_launches.get(name, {}),
            launches_baselines=baseline_launches.get(name, 0),
            launches_sharded=sharded_launches.get(name, 0),
            launches_lm_serve=sum(run.get(name, 0) for run in
                                  lm["driver_launches"].values()),
            lm_serve_d2048=_lm_row(lm, name),
            launches_lm_families=sum(run.get(name, 0) for run in
                                     fam["d4096"]["driver_launches"].values()),
            lm_families_d4096=_d4096_row(fam, name),
            max_abs_err=smoke.err[name],
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
