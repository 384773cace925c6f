"""The paper's own workload at production scale: ``repro.launch.dryrun_pageann``
in PyTorch.

The reference lowers and compiles the sharded PageANN search of a
SIFT100M-like index (100M x 128 float32, 4 KB pages) for its production
meshes and reads one hop-batch body's cost. The port has no compiler to
prove the program against, so its proof is one device's program run at
its production shape: shard (0, 0) of SIFT100M over ``data = 16``
(6,250,000 vectors: 1,041,667 HYBRID pages of 24 record rows, a
``page_recs`` of 3.2e9 float32, 12.8 GB) with ``QUERY_BATCH / model = 64``
queries, through ``core.search.batch_search`` and the real kernels on the
card.

The shard's pages are the pages of a small index (``base``) tiled to the
shard's page count, each tile's neighbour ids, member ids and LSH sample
ids shifted into its own id range (random floats would be read as ids);
the LSH samples are tiled last tile first, so the search's entry points lie
in the shard's highest pages and its reads pass 2^31 floats. The record
keeps the reference's keys: ``raw_loop_body_terms`` are one hop's analytic
kernel counts (``launch.roofline``), the totals scale them by the
reference's stated ``MEAN_HOPS`` (beside the run's own hop count),
``hop_ms`` comes from CUDA events, ``peak_gib_per_device`` from
``max_memory_allocated`` and the merge's collective bytes (an all-gather of
each data shard's top-k ids, distances and I/O counts) from the shapes.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_pageann --mesh single
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.core import MemoryMode, PageANNConfig, SearchParams
from repro_torch.core import search as search_mod
from repro_torch.kernels import ops
from repro_torch.kernels.record_layout import PAGE_LANES, record_rows
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import HBM_BYTES

# SIFT100M geometry (paper Table 2) under the Sec 4.2 page equation
N_VECTORS = 100_000_000
DIM = 128
QUERY_BATCH = 1024
MEAN_HOPS = 18.0        # the reference's stated assumption (its CPU proxy)
DATA, MODEL = 16, 16    # the single-pod mesh: shards x query groups
K = 10


def production_config(mode: str = "hybrid", io_batch: int = 5) -> PageANNConfig:
    return PageANNConfig(
        dim=DIM, graph_degree=32, page_degree=48, pq_subspaces=16,
        lsh_sample=262_144, lsh_bits=64, lsh_entries=32,
        beam_width=128, io_batch=io_batch, max_hops=64,
        memory_mode=MemoryMode(mode),
    )


def shard_geometry(cfg: PageANNConfig, n_vectors: int = N_VECTORS,
                   num_shards: int = DATA) -> dict:
    """One shard's capacity, pages, record rows and record bytes."""
    cap = cfg.resolve_capacity()
    pages = -(-(n_vectors // num_shards) // cap)
    m_rec = 0 if cfg.memory_mode == MemoryMode.MEM_ALL else cfg.pq_subspaces
    rows = record_rows(cap, DIM, m_rec)
    return {"capacity": cap, "pages": pages, "record_rows": rows,
            "page_recs_floats": pages * rows * PAGE_LANES,
            "page_recs_bytes": pages * rows * PAGE_LANES * 4}


def _tile(t: torch.Tensor, n: int, shift=None) -> torch.Tensor:
    """``t`` repeated along dim 0 to ``n`` rows; ``shift(tile)`` added to
    tile ``tile``'s rows when given (ids; PAD, negative, kept)."""
    idx = torch.arange(n, device=t.device) % t.shape[0]
    out = t[idx]
    if shift is not None:
        tile = torch.arange(n, device=t.device) // t.shape[0]
        off = shift(tile).to(out.dtype)
        off = off.reshape(-1, *([1] * (out.ndim - 1)))
        out = torch.where(out >= 0, out + off, out)
    return out


def tiled_shard(base: search_mod.SearchData, base_cap: int, pages: int,
                lsh_sample: int) -> search_mod.SearchData:
    """``base``'s pages tiled to ``pages`` (see the module docstring)."""
    p0 = base.member_count.shape[0]
    if base.page_recs.shape[0] != p0:
        raise ValueError("the base index must be fully resident")
    n0 = p0 * base_cap                      # the base's padded vector ids
    n_pad = pages * base_cap
    full_tiles = pages // p0
    if full_tiles < 1:
        raise ValueError(f"{pages} pages hold no full tile of {p0}")
    s0 = base.lsh_ids.shape[0]
    dev = base.page_recs.device
    # LSH sample block j points into tile full_tiles - 1 - j
    lsh_tile = (full_tiles - 1 - torch.arange(lsh_sample, device=dev) // s0)
    lsh_tile = lsh_tile.clamp(min=0)
    lsh_ids = base.lsh_ids[torch.arange(lsh_sample, device=dev) % s0]
    return search_mod.SearchData(
        page_recs=_tile(base.page_recs, pages),
        member_count=_tile(base.member_count, pages),
        nbr_ids=_tile(base.nbr_ids, pages, lambda t: t * n0),
        nbr_count=_tile(base.nbr_count, pages),
        resident_map=torch.arange(pages, dtype=torch.int32, device=dev),
        mem_codes=_tile(base.mem_codes, n_pad),
        mem_mask=_tile(base.mem_mask, n_pad),
        mem_codebooks=base.mem_codebooks,
        disk_codebooks=base.disk_codebooks,
        cached_pages=base.cached_pages[:0],
        lsh_planes=base.lsh_planes,
        lsh_ids=(lsh_ids.long() + lsh_tile * n0).to(base.lsh_ids.dtype),
        lsh_codes=_tile(base.lsh_codes, lsh_sample),
        lsh_pq=_tile(base.lsh_pq, lsh_sample),
    )


def hop_counts(cfg: PageANNConfig, nq: int, *, cap: int, rows: int) -> dict:
    """One hop's analytic kernel counts for ``nq`` queries (every lane
    active, every page distinct): the page scan over b pages and the
    in-memory re-score of their b x Rp neighbours (HYBRID, MEM_ALL)."""
    b, rp = cfg.io_batch, cfg.page_degree
    m = cfg.pq_subspaces
    adc = cfg.memory_mode != MemoryMode.MEM_ALL
    scan = rf.page_scan_counts(nq, b, records=nq * b, cap=cap, dim=DIM,
                               rp=rp, m=m if adc else 0, k=cfg.pq_ksub,
                               adc=adc)
    terms = {"page_scan": scan}
    if cfg.memory_mode != MemoryMode.DISK_ONLY:
        terms["pq_adc"] = rf.pq_adc_gather_counts(
            nq, b * rp, 2 * m, cfg.pq_ksub, rows=nq * b * rp, id_bytes=8)
    byts = sum(v[0] for v in terms.values())
    ops_ = sum(v[1] for v in terms.values())
    return {"kernels": {k: {"bytes": v[0], "operations": v[1]}
                        for k, v in terms.items()},
            "hlo_bytes": float(byts), "hlo_flops": float(ops_)}


def merge_collective_bytes(nq: int, k: int = K, data: int = DATA) -> int:
    """The cross-shard merge: an all-gather over ``data`` of each shard's
    (nq, k) ids and distances and (nq,) I/O counts (output bytes)."""
    return data * nq * (k * 4 + k * 4 + 4)


def run(base: search_mod.SearchData, base_cap: int, queries: torch.Tensor,
        *, mode: str = "hybrid", io_batch: int = 5,
        n_vectors: int = N_VECTORS, sample: int | None = None,
        data: search_mod.SearchData | None = None) -> dict:
    """Search the tiled shard with ``QUERY_BATCH / MODEL`` of ``queries``
    through the kernels (timed) and the plain versions, on the device of
    ``base``. ``n_vectors`` scales the index (the CPU tests use a small
    one); ``sample`` limits the plain search to that many queries;
    ``data`` is the shard ``tiled_shard`` made already, if the caller
    keeps it."""
    cfg = production_config(mode, io_batch)
    geo = shard_geometry(cfg, n_vectors)
    cap, pages = geo["capacity"], geo["pages"]
    if cap != base_cap:
        raise ValueError(f"base capacity {base_cap} != the shard's {cap}")
    dev = base.page_recs.device
    cuda = dev.type == "cuda"
    nq = QUERY_BATCH // MODEL
    q = queries[:nq].to(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if data is None:
        data = tiled_shard(base, base_cap, pages, cfg.lsh_sample)
    build_s = time.perf_counter() - t0
    params = SearchParams.from_config(cfg, k=K)
    kw = dict(capacity=cap, mode=cfg.memory_mode.value)

    search_mod.batch_search(q, data, params, **kw)          # warm-up
    ops.reset_launch_counts()
    if cuda:
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t1 = time.perf_counter()
    res = search_mod.batch_search(q, data, params, **kw)
    if cuda:
        end.record()
        torch.cuda.synchronize(dev)
        search_ms = start.elapsed_time(end)
    else:
        search_ms = (time.perf_counter() - t1) * 1e3
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    ns = nq if sample is None else min(sample, nq)
    plain = search_mod.batch_search(q[:ns], data, params, impl="plain", **kw)
    hops = int(res.hops.max())
    agree = float((res.ids[:ns] == plain.ids).all(1).float().mean())
    body = hop_counts(cfg, nq, cap=cap, rows=geo["record_rows"])
    coll = float(merge_collective_bytes(nq))
    scaled = {"hlo_flops": body["hlo_flops"] * MEAN_HOPS,
              "hlo_bytes": body["hlo_bytes"] * MEAN_HOPS,
              "collective_bytes": coll}           # the merge happens once
    run_scaled = {"hlo_flops": body["hlo_flops"] * float(res.hops.float().mean()),
                  "hlo_bytes": body["hlo_bytes"] * float(res.hops.float().mean()),
                  "collective_bytes": coll}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    rec = {
        "arch": "pageann-sift100m", "shape": f"serve_q{QUERY_BATCH}",
        "mesh": "pod16x16", "mode": mode, "io_batch": io_batch,
        "status": "ok", "devices": DATA * MODEL,
        "device_run": f"shard (0, 0): {nq} queries",
        "pages_per_shard": pages, "page_capacity": cap,
        "record_rows": geo["record_rows"],
        "page_recs_bytes": geo["page_recs_bytes"],
        "trace_s": round(build_s, 2),
        "mean_hops_assumed": MEAN_HOPS,
        "mean_hops_run": float(res.hops.float().mean()),
        "max_hops_run": hops,
        "hop_ms": search_ms / max(hops, 1), "search_ms": search_ms,
        "launches": launches,
        "launches_per_hop": {k: v / max(hops, 1) for k, v in launches.items()},
        "plain_sample": ns, "ids_agree_share": agree,
        "mean_ios": float(res.ios.float().mean()),
        "raw_loop_body_terms": {**body, **rf.terms_from_counters(
            {**body, "collective_bytes": 0.0})},
        **rf.terms_from_counters(scaled),
        "run_hops_terms": rf.terms_from_counters(run_scaled),
        "collective_breakdown": {"all-gather": coll},
    }
    if peak is not None:
        rec["peak_gib_per_device"] = round(peak / 2**30, 3)
        rec["fits_hbm"] = bool(peak <= HBM_BYTES)
    finite = torch.isfinite(res.dists[:, 0]).all()
    if not (bool(finite) and tuple(res.ids.shape) == (nq, K)):
        raise AssertionError("pageann dry run: malformed results")
    return rec


def build_base(n: int = 3000, *, device="cuda", seed: int = 0):
    """A small HYBRID index at the production config's page geometry (its
    build knobs cut for time) and queries near its vectors: (SearchData,
    capacity, queries)."""
    import numpy as np

    from repro_torch.core import PageANNIndex

    cfg = production_config()
    small = PageANNConfig(
        dim=DIM, graph_degree=cfg.graph_degree, page_degree=cfg.page_degree,
        pq_subspaces=cfg.pq_subspaces, lsh_bits=cfg.lsh_bits,
        lsh_sample=min(1024, n), build_rounds=1, memory_mode=cfg.memory_mode)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    idx = PageANNIndex.build(x, small, device=device)
    q = torch.from_numpy(
        x[rng.integers(0, n, QUERY_BATCH)]
        + 0.1 * rng.standard_normal((QUERY_BATCH, DIM)).astype(np.float32))
    return idx.data, idx.store.capacity, q


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single"])
    ap.add_argument("--mode", default="hybrid",
                    choices=[m.value for m in MemoryMode])
    ap.add_argument("--io-batch", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    base, cap, q = build_base(device=args.device)
    rec = run(base, cap, q, mode=args.mode, io_batch=args.io_batch)
    suffix = "" if (args.mode == "hybrid" and args.io_batch == 5) \
        else f"_{args.mode}_b{args.io_batch}"
    with open(os.path.join(args.out, f"pageann_serve_single{suffix}.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
