"""The port's example entry points (``examples/*_torch.py``) against the
reference's (``examples/serve_rag.py``, ``examples/quickstart.py``) on the
CPU.

``serve_rag``: 200 documents at granite-3-2b's SMOKE width (d = 64). The
reference's steps run here as ``examples/serve_rag.py`` runs them: its
``init_train_state(arch, PRNGKey(0)).params``, its ``embed``, its
``VectorService`` building the collection with the ``agent`` tag, the four
routed requests, the replay and its ``generate``. The collection is saved
and attached to the port's service, and the reference's parameters reach
the port through ``params_from_jax``. Held: document and request
embeddings within rtol = atol = 1e-5 (the mean is summed in another
order); each request's ids, the cache hits and the generated tokens equal.

``quickstart``: ``main(n=1000, device="cpu")`` reloads its index bit for
bit, and its recall@10 lies within 0.02 of the reference's index built with
the same config on the same data (the builds draw PQ and Vamana seeds from
other generators, so their graphs differ).
"""
import contextlib
import dataclasses
import functools
import importlib.util
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import MemoryMode as JMode
from repro.core import MetadataSchema as JSchema
from repro.core import PageANNConfig as JConfig
from repro.core import PageANNIndex as JIndex
from repro.core import Tag as JTag
from repro.core import recall_at_k as jrecall
from repro.core.vamana import brute_force_knn
from repro.data.pipeline import clustered_vectors, query_vectors
from repro.launch.serve import generate as jgenerate
from repro.serve import SemanticCache as JCache
from repro.serve import VectorService as JService
from repro.train.step import init_train_state
from repro_torch.configs.registry import get_arch
from repro_torch.models.transformer import params_from_jax

# six test workers share the host's cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_DOCS = 200
AGENTS = ("support", "research")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


serve_rag_torch = _example("serve_rag_torch")
quickstart_torch = _example("quickstart_torch")


@functools.cache
def ref_serve_rag():
    """The reference example's module (``embed`` is its own)."""
    return _example("serve_rag")


def _ref_corpus(vocab: int, rows: int):
    """``examples/serve_rag.py``'s draws, in its order, at ``rows``."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, (rows, 16), np.int32)
    owners = rng.choice(AGENTS + ("shared",), size=rows).tolist()
    requests = rng.integers(0, vocab, (4, 8), np.int32)
    return tokens, owners, requests


def _ref_cfg(dim: int) -> JConfig:
    return JConfig(dim=dim, graph_degree=16, build_beam=32, pq_subspaces=8,
                   lsh_sample=512, lsh_entries=8, beam_width=48,
                   memory_mode=JMode.HYBRID)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference example's loop over N_DOCS documents; its collection
    saved for the port."""
    arch = jget_arch("granite-3-2b", smoke=True)
    params = init_train_state(arch, jax.random.PRNGKey(0)).params
    embed = ref_serve_rag().embed
    tokens, owners, requests = _ref_corpus(arch.vocab_size, N_DOCS)
    doc_emb = np.asarray(embed(params, arch, jnp.asarray(tokens)), np.float32)
    views = {a: JTag("agent").isin(a, "shared") for a in AGENTS}
    directory = str(tmp_path_factory.mktemp("rag") / "docs.pageann")
    with JService(batch_size=4, semantic_cache=JCache(threshold=0.98)) as svc:
        svc.create_collection("docs", _ref_cfg(doc_emb.shape[1]), doc_emb,
                              k=3, schema=JSchema(tags=("agent",)),
                              metadata={"agent": owners})
        q_emb = np.asarray(embed(params, arch, jnp.asarray(requests)),
                           np.float32)
        route = [AGENTS[i % 2] for i in range(len(q_emb))]
        futures = [svc.submit("docs", q, filter=views[a])
                   for a, q in zip(route, q_emb)]
        svc.flush()
        ids = np.stack([np.asarray(f.result().result.ids) for f in futures])
        replay = [svc.submit("docs", q, filter=views[a])
                  for a, q in zip(route, q_emb)]
        svc.flush()
        cached = sum(f.result().cached for f in replay)
        svc.index_of("docs").save(directory)
    top = np.where(ids[:, 0] >= 0, ids[:, 0], 0)
    prompts = jnp.concatenate([jnp.asarray(tokens[top]),
                               jnp.asarray(requests)], axis=1)
    generated = np.asarray(jgenerate(params, arch, prompts, gen=8))
    return dict(params=jax.tree.map(np.asarray, params), tokens=tokens,
                owners=owners, requests=requests, doc_emb=doc_emb,
                q_emb=q_emb, route=route, ids=ids, cached=cached,
                generated=generated, directory=directory)


@pytest.fixture(scope="module")
def port(reference):
    """The port's ``retrieve_and_decode`` on the reference's parameters
    and saved collection, its printed lines captured."""
    arch = get_arch("granite-3-2b", smoke=True)
    model = params_from_jax(reference["params"], arch, device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve_rag_torch.retrieve_and_decode(
            model, arch, reference["tokens"], reference["owners"],
            device="cpu", requests=reference["requests"],
            index_dir=reference["directory"])
    out["text"] = buf.getvalue()
    return out


def test_corpus_draws_the_reference_examples_documents():
    vocab = get_arch("granite-3-2b", smoke=True).vocab_size
    for rows in (N_DOCS, serve_rag_torch.N_DOCS):
        want = _ref_corpus(vocab, rows)
        got = serve_rag_torch.corpus(vocab, rows)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])


def test_index_config_is_the_reference_examples():
    want = dataclasses.asdict(_ref_cfg(64))
    got = dataclasses.asdict(serve_rag_torch.index_config(64))
    want["memory_mode"] = want["memory_mode"].value
    got["memory_mode"] = got["memory_mode"].value
    assert got == want


def test_embeddings_match_the_reference(reference, port):
    """rtol = atol = 1e-5."""
    np.testing.assert_allclose(port["doc_emb"], reference["doc_emb"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port["q_emb"], reference["q_emb"],
                               rtol=1e-5, atol=1e-5)


def test_requests_retrieve_the_reference_ids_within_their_views(reference,
                                                                 port):
    assert port["route"] == reference["route"]
    np.testing.assert_array_equal(port["ids"], reference["ids"])
    owners = reference["owners"]
    for agent, ids in zip(port["route"], port["ids"]):
        assert {owners[d] for d in ids if d >= 0} <= {agent, "shared"}
    for i, agent in enumerate(port["route"]):
        assert f"request {i} [{agent}] -> ids " in port["text"]


def test_two_views_never_share_a_batch(port):
    """The filter is part of the dispatch group's key: the four requests
    alternate views, so they go out as two batches of two."""
    batches = port["batches"]
    assert [size for _, size in batches] == [2, 2, 2, 2]
    assert batches[0][0] == batches[2][0] != batches[1][0] == batches[3][0]
    assert port["metrics"].batches == 2


def test_replay_is_all_cache_hits(reference, port):
    assert reference["cached"] == 4
    assert port["cached"] == 4
    m = port["metrics"]
    assert (m.semantic_hits, m.semantic_misses) == (4, 4)
    assert "replayed 4 requests: 4 served from the semantic cache" \
        in port["text"]


def test_generated_tokens_equal_the_reference(reference, port):
    assert port["generated"].shape == (4, 8)
    np.testing.assert_array_equal(port["generated"], reference["generated"])


def test_serve_rag_runs_end_to_end_with_its_own_build():
    """``run`` builds the port's own collection and prints the reference's
    lines in the reference's order."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve_rag_torch.run(device="cpu", n_docs=300)
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("building shared PageANN collection (300 docs, "
                               "agents: support, research + shared)")
    assert [ln.split(" -> ")[0] for ln in lines[1:5]] == [
        "request 0 [support]", "request 1 [research]",
        "request 2 [support]", "request 3 [research]"]
    assert lines[5].startswith("replayed 4 requests: 4 served from the "
                               "semantic cache (4 hits / 4 misses)")
    assert lines[6].startswith("service: 4 requests in 2 batch(es)")
    assert lines[7] == "generated continuation tokens:"
    assert out["generated"].shape == (4, 8)


@pytest.mark.parametrize("example", ["serve_rag_torch", "quickstart_torch"])
def test_examples_run_on_the_card_by_default(example, monkeypatch):
    """With no card, the default device raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"serve_rag_torch": serve_rag_torch.main,
            "quickstart_torch": quickstart_torch.main}[example]
    with pytest.raises(RuntimeError, match="CUDA"):
        main()


def test_quickstart_reloads_bit_for_bit_at_the_reference_recall():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = quickstart_torch.main(n=1000, device="cpu")
    text = buf.getvalue()
    assert "reloaded search bit-identical: True" in text
    assert out["identical"]
    for beam in (16, 64, 128):
        assert f"  beam={beam:3d} -> recall=" in text
    x = clustered_vectors(1000, 32, num_clusters=64, seed=0)
    q = query_vectors(x, 32, seed=1)
    truth = brute_force_knn(x, q, 10)
    ji = JIndex.build(x, JConfig(dim=32, graph_degree=24, pq_subspaces=8,
                                 memory_mode=JMode.HYBRID))
    want = jrecall(ji.search(q, k=10).ids, truth)
    assert abs(out["recall_at_10"] - want) <= 0.02, (out["recall_at_10"], want)
