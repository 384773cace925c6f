"""Retrieval-augmented serving through the port: ``examples/serve_rag.py``
on PyTorch, with the same steps, names and printed lines.

A language model embeds each request (the mean of its tokens' ``embed``
rows), a :class:`repro_torch.serve.VectorService` retrieves the nearest
passages' ids, and the retrieved context tokens are prepended before greedy
decoding: the kNN-augmented serving loop the paper's index accelerates.

One shared document collection serves several agents, each seeing only its
own tag-namespaced slice: every document carries an ``agent`` tag
("support", "research" or "shared"), and each agent's retrievals run with
``filter=Tag("agent").isin(<name>, "shared")``. The predicate is enforced
inside the page scan (the masked kernel variants on the card), so there is
one index, one page file and N isolated views. A
:class:`repro_torch.serve.SemanticCache` sits in front of the service:
re-asked questions within a cosine threshold of an answered one are served
from the cache without touching the index, scoped per (collection, k,
params, filter), so one agent's cached answers never reach another's view.

The model is granite-3-2b (SMOKE width by default; ``main(smoke=False)``
runs the full CONFIG), a random init from a ``torch.Generator`` seeded 0,
so its weights are not the reference's ``jax.random`` bits. Runs on the
card by default:

  PYTHONPATH=src python examples/serve_rag_torch.py [--device cpu]
"""
import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core import MemoryMode, MetadataSchema, PageANNConfig, Tag
from repro_torch.device import resolve_device
from repro_torch.launch.serve import embed_prompts, generate
from repro_torch.models import transformer as tf
from repro_torch.serve import SemanticCache, VectorService

AGENTS = ("support", "research")
N_DOCS = 2000
DOC_LEN, REQUESTS, REQUEST_LEN, GEN = 16, 4, 8, 8


def embed(model, tokens) -> np.ndarray:
    """Mean of the tokens' ``embed`` rows as the retrieval embedding, float32
    on the host. The reference also runs ``forward_train`` over the tokens
    and discards the logits; the port computes only what is returned."""
    return embed_prompts(model, torch.as_tensor(tokens, device=model.device))


def corpus(vocab_size: int, rows: int = N_DOCS):
    """The documents' tokens (rows, 16), their owners and the requests'
    tokens (4, 8), drawn from ``np.random.default_rng(0)`` in the
    reference's order."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab_size, (rows, DOC_LEN), np.int32)
    owners = rng.choice(AGENTS + ("shared",), size=rows).tolist()
    requests = rng.integers(0, vocab_size, (REQUESTS, REQUEST_LEN), np.int32)
    return tokens, owners, requests


def index_config(dim: int) -> PageANNConfig:
    return PageANNConfig(
        dim=dim, graph_degree=16, build_beam=32,
        pq_subspaces=8, lsh_sample=512, lsh_entries=8,
        beam_width=48, memory_mode=MemoryMode.HYBRID,
    )


def agent_views() -> dict:
    return {a: Tag("agent").isin(a, "shared") for a in AGENTS}


def retrieve_and_decode(model, arch, tokens, owners, *, device, requests,
                        cfg: PageANNConfig | None = None,
                        index_dir: str | None = None) -> dict:
    """Embed the documents, serve them as one filtered collection, route the
    requests to alternating agents' views, replay them through the semantic
    cache, then decode each request with its top document prepended.

    The collection is built from the documents with ``cfg`` (default
    ``index_config`` at the model's width), or attached from ``index_dir``
    (an artifact of the same documents saved with their ``agent`` tags).
    A retrieved document outside its agent's view ends the run with an
    ``AssertionError``. Returns what was embedded, retrieved and generated,
    the service's metrics and the collection's index."""
    doc_emb = embed(model, tokens)
    rows = len(doc_emb)
    views = agent_views()
    out: dict = {"doc_emb": doc_emb, "views": views}
    with VectorService(
        batch_size=4, semantic_cache=SemanticCache(threshold=0.98),
        device=device,
    ) as svc:
        t0 = time.perf_counter()
        if index_dir is None:
            print(f"building shared PageANN collection ({rows} docs, "
                  f"agents: {', '.join(AGENTS)} + shared) …")
            svc.create_collection(
                "docs", cfg or index_config(doc_emb.shape[1]), doc_emb, k=3,
                schema=MetadataSchema(tags=("agent",)),
                metadata={"agent": owners},
            )
        else:
            print(f"attaching shared PageANN collection ({rows} docs, "
                  f"agents: {', '.join(AGENTS)} + shared) …")
            svc.attach("docs", index_dir, k=3)
        out["build_s"] = time.perf_counter() - t0

        q_emb = embed(model, requests)
        # requests alternate between the two agents; each dispatch group is
        # keyed by its filter, so the two views never share a batch, and
        # never see each other's documents
        route = [AGENTS[i % len(AGENTS)] for i in range(len(q_emb))]
        futures = [
            svc.submit("docs", q, filter=views[agent])
            for agent, q in zip(route, q_emb)
        ]
        svc.flush()
        rows_out = [f.result() for f in futures]
        ids = np.stack([np.asarray(r.result.ids) for r in rows_out])
        for i, (agent, got) in enumerate(zip(route, ids)):
            seen = {owners[d] for d in got if d >= 0}
            print(f"request {i} [{agent}] -> ids {got} "
                  f"(owners: {sorted(seen)})")
            assert seen <= {agent, "shared"}, "view isolation violated"

        # the same questions again: answered from the semantic cache, no
        # index dispatch, but only within the SAME agent's view
        replay = [
            svc.submit("docs", q, filter=views[agent])
            for agent, q in zip(route, q_emb)
        ]
        svc.flush()
        n_cached = sum(f.result().cached for f in replay)
        m = svc.metrics()
        print(f"replayed {len(replay)} requests: {n_cached} served from "
              f"the semantic cache ({m.semantic_hits} hits / "
              f"{m.semantic_misses} misses)")
        print(f"service: {m.requests} requests in {m.batches} batch(es), "
              f"p50 latency {m.latency_ms_p50:.1f} ms, compile cache "
              f"{m.compile_hits} hits / {m.compile_misses} misses")
        out.update(q_emb=q_emb, route=route, ids=ids, cached=n_cached,
                   metrics=m, index=svc.index_of("docs"),
                   batches=[(r.batch_index, r.batch_size) for r in rows_out])

    # prepend each request's top document (from ITS view) and decode
    top = np.where(ids[:, 0] >= 0, ids[:, 0], 0)
    prompts = torch.as_tensor(
        np.concatenate([tokens[top], requests], axis=1), device=model.device)
    t0 = time.perf_counter()
    generated = generate(model, arch, prompts, GEN).cpu().numpy()
    out["decode_s"] = time.perf_counter() - t0
    print(f"generated continuation tokens:\n{generated}")
    out["generated"] = generated
    return out


def run(*, device: str = "cuda", smoke: bool = True,
        n_docs: int = N_DOCS) -> dict:
    """The whole example: granite-3-2b (SMOKE unless ``smoke=False``) from a
    ``torch.Generator`` seeded 0, its corpus of ``n_docs`` documents, and
    :func:`retrieve_and_decode` over them."""
    device = resolve_device(device)
    arch = get_arch("granite-3-2b", smoke=smoke)
    model = tf.init_params(
        arch, torch.Generator(device=device).manual_seed(0), device=device)
    tokens, owners, requests = corpus(arch.vocab_size, n_docs)
    return retrieve_and_decode(model, arch, tokens, owners, device=device,
                               requests=requests)


def main(argv=None, *, device: str = "cuda", smoke: bool = True) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv or [])
    return run(device=args.device, smoke=smoke)


if __name__ == "__main__":
    main(sys.argv[1:])
