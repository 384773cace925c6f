#!/usr/bin/env python3
"""The sharded store at the chip smoke's size, the port's search held
against the JAX package's on the same shards.

    # on the card: build a 2-shard ShardedPageStore as chip_smoke.py's
    # sharded phase does (10,000 x 128 clustered vectors from seed 0, the
    # default PageANNConfig in HYBRID), search the 1,000 queries at the
    # default SearchParams and at beam 128, save the store, the queries and
    # the port's results
    PYTHONPATH=src python3 tools/sharded_recall_ref.py dump OUT

    # on the CPU, where the JAX package runs: its ShardedPageStore.load and
    # host fan-out over the store the port saved; prints each package's
    # recall@10 and how many queries differ in ids, ios or hops
    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/sharded_recall_ref.py check OUT

``dump`` imports only the port (``repro_torch``) and ``check`` only the
reference (``repro``); the two meet in the saved artifact. ``check`` exits
1 when the reference's recall differs from the port's at either point.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

N, DIM, N_QUERIES, SEED = 10_000, 128, 1_000, 0   # chip_smoke.py's main path
SHARDS = 2
POINTS = {"default": {}, "beam128": {"beam_width": 128}}
CHUNK = 250            # queries a reference search, to bound its CPU memory


def _recall(ids: np.ndarray, truth: np.ndarray) -> float:
    """recall@10: the share of each query's true 10 found among its 10."""
    return float(np.mean([len(np.intersect1d(a[:10], b[:10])) / 10.0
                          for a, b in zip(ids, truth)]))


def _truth(x: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Exact 10 nearest by squared L2, in float64 (independent of either
    package)."""
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    d = (q64 ** 2).sum(1)[:, None] - 2.0 * q64 @ x64.T + (x64 ** 2).sum(1)[None]
    return np.argsort(d, axis=1, kind="stable")[:, :10]


def dump(out: str, *, device: str = "cuda") -> int:
    import torch

    from repro_torch.core import MemoryMode, PageANNConfig, SearchParams
    from repro_torch.data.pipeline import clustered_vectors, query_vectors
    from repro_torch.dist import ShardedPageStore

    torch.backends.cuda.matmul.allow_tf32 = False
    x = clustered_vectors(N, DIM, num_clusters=64, seed=SEED)
    q = query_vectors(x, N_QUERIES, seed=SEED + 1)
    cfg = PageANNConfig(dim=DIM, build_rounds=1, memory_mode=MemoryMode.HYBRID)
    t0 = time.perf_counter()
    store = ShardedPageStore.build(x, cfg, SHARDS, device=device)
    build_s = time.perf_counter() - t0
    truth = _truth(x, q)
    os.makedirs(out, exist_ok=True)
    np.save(os.path.join(out, "queries.npy"), q)
    np.save(os.path.join(out, "vectors.npy"), x)
    store.save(os.path.join(out, "store"))
    summary = dict(n=N, dim=DIM, queries=N_QUERIES, seed=SEED, shards=SHARDS,
                   build_s=build_s,
                   device=(torch.cuda.get_device_name(0)
                           if device == "cuda" else device))
    for point, kw in POINTS.items():
        res = store.search(q, k=10, params=SearchParams(**kw))
        np.savez(os.path.join(out, f"{point}.npz"), ids=res.ids,
                 dists=res.dists, ios=res.ios, hops=res.hops)
        summary[point] = dict(recall_at_10=_recall(res.ids, truth),
                              mean_ios=float(res.ios.mean()),
                              mean_hops=float(res.hops.mean()))
    print(json.dumps(summary), flush=True)
    return 0


def check(out: str) -> int:
    from repro.core.config import SearchParams
    from repro.dist import ShardedPageStore

    q = np.load(os.path.join(out, "queries.npy"))
    truth = _truth(np.load(os.path.join(out, "vectors.npy")), q)
    store = ShardedPageStore.load(os.path.join(out, "store"))
    ok = True
    for point, kw in POINTS.items():
        p = SearchParams(**kw)
        parts = [store.search(q[i:i + CHUNK], k=10, params=p)
                 for i in range(0, len(q), CHUNK)]
        ref = {f: np.concatenate([np.asarray(getattr(r, f)) for r in parts])
               for f in ("ids", "dists", "ios", "hops")}
        with np.load(os.path.join(out, f"{point}.npz")) as z:
            port = {f: z[f] for f in ref}
        row = dict(
            point=point,
            reference_recall_at_10=_recall(ref["ids"], truth),
            port_recall_at_10=_recall(port["ids"], truth),
            reference_mean_ios=float(ref["ios"].mean()),
            port_mean_ios=float(port["ios"].mean()),
            reference_mean_hops=float(ref["hops"].mean()),
            port_mean_hops=float(port["hops"].mean()),
            queries_ids_differ=int((ref["ids"] != port["ids"]).any(1).sum()),
            queries_ios_differ=int((ref["ios"] != port["ios"]).sum()),
            queries_hops_differ=int((ref["hops"] != port["hops"]).sum()),
            dists_max_abs_diff=float(np.abs(ref["dists"] - port["dists"])[
                np.isfinite(ref["dists"])].max()),
        )
        ok &= row["reference_recall_at_10"] == row["port_recall_at_10"]
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("dump", "check"))
    ap.add_argument("out", help="directory of the saved store and results")
    ap.add_argument("--device", default="cuda",
                    help="where dump builds and searches (default: the card)")
    args = ap.parse_args(argv)
    if args.mode == "dump":
        return dump(args.out, device=args.device)
    return check(args.out)


if __name__ == "__main__":
    sys.exit(main())
