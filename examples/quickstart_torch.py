"""Quickstart through the port: ``examples/quickstart.py`` on PyTorch, the
index lifecycle of build, search, save, load and re-search.

Build-time knobs (page geometry, PQ, memory mode) live in
``PageANNConfig``; runtime knobs (beam L, io batch b, LSH top-T, k) are a
per-call ``SearchParams``, so sweeping them reuses the one built index. The
saved artifact is the paper's disk layout (a raw page-aligned ``pages.bin``
plus numpy sidecars and a JSON manifest, the reference's format), and
loading it back gives search results equal bit for bit; the run ends with
``SystemExit`` otherwise. Runs on the card by default:

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import shutil
import sys
import tempfile

import numpy as np

from repro_torch.core import (
    MemoryMode,
    PageANNConfig,
    PageANNIndex,
    SearchParams,
    recall_at_k,
)
from repro_torch.core.vamana import brute_force_knn
from repro_torch.data.pipeline import clustered_vectors, query_vectors
from repro_torch.device import resolve_device


def main(argv=None, *, device: str = "cuda", n: int = 5000) -> dict:
    """The lifecycle over ``n`` clustered vectors at d = 32 (5,000 as in the
    reference). Returns the first search's recall@10, whether the
    reloaded index's search was identical, and the index and its vectors
    (``index``, ``vectors``) for a caller that searches it further."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=device)
    device = resolve_device(ap.parse_args(argv or []).device)

    x = clustered_vectors(n, 32, num_clusters=64, seed=0)
    queries = query_vectors(x, 32, seed=1)
    truth = brute_force_knn(x, queries, 10)

    cfg = PageANNConfig(
        dim=32,
        graph_degree=24,          # Vamana degree R
        pq_subspaces=8,           # on-page compressed neighbor codes
        memory_mode=MemoryMode.HYBRID,
    )
    print("building page-node index …")
    index = PageANNIndex.build(x, cfg, device=device)
    s = index.stats
    print(f"  pages={s.pages} capacity={s.capacity} "
          f"mean_page_degree={s.mean_page_degree:.1f}")
    print(f"  logical page bytes={s.logical_page_bytes} "
          f"(padded DMA tile={s.padded_tile_bytes})")
    print(f"  in-memory footprint={s.memory_bytes / 1e6:.2f} MB "
          f"({100 * s.memory_bytes / x.nbytes:.1f}% of dataset)")

    res = index.search(queries, k=10)
    recall = recall_at_k(res.ids, truth)
    print(f"recall@10 = {recall:.3f}")
    print(f"mean page reads/query = {res.ios.mean():.1f} "
          f"(hops={res.hops.mean():.1f}, cache hits={res.cache_hits.mean():.1f})")

    # runtime knobs are per-call: sweep the beam over the SAME built index
    for beam, entries in ((16, 4), (64, 12), (128, 16)):
        params = SearchParams(k=10, beam_width=beam, lsh_entries=entries)
        r = index.search(queries, params=params)
        print(f"  beam={beam:3d} -> recall={recall_at_k(r.ids, truth):.3f} "
              f"ios={r.ios.mean():.1f}")

    # persist the index (the paper's on-SSD artifact) and reload it
    scratch = tempfile.mkdtemp(prefix="quickstart_index_")
    art = scratch + "/idx.pageann"
    try:
        index.save(art)
        loaded = PageANNIndex.load(art, device=device)
        res2 = loaded.search(queries, k=10)
        identical = all(
            np.array_equal(np.asarray(getattr(res, f)),
                           np.asarray(getattr(res2, f)))
            for f in res._fields
        )
        print(f"saved -> {art}; reloaded search bit-identical: {identical}")
        if not identical:
            raise SystemExit("save/load round trip diverged")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return {"recall_at_10": recall, "identical": identical, "index": index,
            "vectors": x}


if __name__ == "__main__":
    main(sys.argv[1:])
