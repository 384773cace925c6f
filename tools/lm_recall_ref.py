"""Recall of the JAX package's and the port's HYBRID index at the LM's
width, on the CPU: 1,000 documents and 100 queries, each the mean of 16
random rows of a Gaussian embedding table (d = 2048, entries of variance
1/d, as the models' ``init_params`` draws them), ``examples/serve_rag.py``'s
PageANNConfig with one build round, as the smoke's lm_serve phase has it.
Each package builds its own index (their PQ and LSH draws differ), so the
ids are not compared; the recalls and the data's contrast are.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/lm_recall_ref.py   # ~1 min

Prints one JSON line: recall@10 of each package, the build seconds, and
the median over queries of the nearest document's squared distance over
the median document's (near 1: little neighbourhood structure).
"""
from __future__ import annotations

import json
import time

import numpy as np

from repro.core import MemoryMode as JMode
from repro.core import PageANNConfig as JConfig
from repro.core import PageANNIndex as JIndex
from repro.core.vamana import brute_force_knn
from repro_torch.core import MemoryMode, PageANNConfig, PageANNIndex, recall_at_k

D, N, NQ, VOCAB = 2048, 1000, 100, 8000


def main() -> None:
    rng = np.random.default_rng(0)
    emb = (rng.standard_normal((VOCAB, D)) * D ** -0.5).astype(np.float32)
    docs = emb[rng.integers(0, VOCAB, (N, 16))].mean(1).astype(np.float32)
    q = emb[rng.integers(0, VOCAB, (NQ, 16))].mean(1).astype(np.float32)
    kw = dict(dim=D, graph_degree=16, build_beam=32, pq_subspaces=8,
              lsh_sample=512, lsh_entries=8, beam_width=48, build_rounds=1)
    truth = brute_force_knn(docs, q, 10)
    t0 = time.perf_counter()
    ref = JIndex.build(docs, JConfig(memory_mode=JMode.HYBRID, **kw))
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    port = PageANNIndex.build(docs, PageANNConfig(
        memory_mode=MemoryMode.HYBRID, **kw), device="cpu")
    port_s = time.perf_counter() - t0
    d2 = ((q[:, None, :] - docs[None]) ** 2).sum(-1)
    print(json.dumps({
        "dim": D, "docs": N, "queries": NQ,
        "recall_at_10_reference": recall_at_k(
            np.asarray(ref.search(q, k=10).ids), truth),
        "recall_at_10_port": recall_at_k(port.search(q, k=10).ids, truth),
        "build_s_reference": ref_s, "build_s_port": port_s,
        "nearest_over_median_sq_dist": float(np.median(
            d2.min(1) / np.median(d2, 1))),
    }))


if __name__ == "__main__":
    main()
