"""The port's serving driver (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``) on the CPU.

Both drivers run at granite-3-2b's SMOKE width (d = 64) over the same
JAX-built artifacts: a HYBRID PageANN index of mean token embeddings with
``examples/serve_rag.py``'s config, an autotuned copy of it, and a
two-collection database (``wiki``, ``notes``). The port cannot reproduce
``jax.random``'s bits, so its one helper for the model and prompts
(``serve._model_and_prompts``) is monkeypatched to the reference's
``init_params(SMOKE, PRNGKey(0))`` (carried across by ``params_from_jax``)
and ``randint(PRNGKey(1))`` prompts. Everything the drivers print before
the generation line (retrieved ids, self-retrieval, cache hits, compile
counters, obs self-check) must be equal, line for line, and the generated
tokens equal. A reference run costs seconds at this size, mostly in its
eager ``generate``, so the reference generates once (``ref_tokens``) and its
retrieval runs use a stub; the port always generates. Flag misuse raises
the reference's ``SystemExit`` message.
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import MemoryMode as JMode
from repro.core import PageANNConfig as JConfig
from repro.core import PageANNIndex as JIndex
from repro.core.persist import save_database as jsave_database
from repro.core.vamana import brute_force_knn
from repro.launch import serve as jserve
from repro.models import transformer as jtf
from repro_torch.launch import serve
from repro_torch.models import transformer as tf

# six test workers share the host's cores
torch.set_num_threads(1)

ARCH = "granite-3-2b"
B, T, GEN = 2, 8, 4
RUN = ["--smoke", "--batch", str(B), "--prompt-len", str(T), "--gen", str(GEN)]
N_DOCS, N_COLL = 600, 300    # the index's documents; each collection's


@functools.cache
def ref_params():
    cfg = jget_arch(ARCH, smoke=True)
    return jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(0)))


@functools.cache
def ref_prompts():
    cfg = jget_arch(ARCH, smoke=True)
    return np.array(jax.random.randint(
        jax.random.PRNGKey(1), (B, T), 0, cfg.vocab_size))


def _docs(n: int, seed: int) -> np.ndarray:
    """Documents as ``examples/serve_rag.py`` makes them: the mean of 16
    random tokens' embedding rows."""
    embed = ref_params()["embed"]
    vocab = jget_arch(ARCH, smoke=True).vocab_size
    tokens = np.random.default_rng(seed).integers(0, vocab, (n, 16))
    return embed[tokens].mean(axis=1).astype(np.float32)


def _cfg() -> JConfig:
    # examples/serve_rag.py's PageANNConfig at the SMOKE width
    return JConfig(dim=64, graph_degree=16, build_beam=32, pq_subspaces=8,
                   lsh_sample=512, lsh_entries=8, beam_width=48,
                   memory_mode=JMode.HYBRID)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{"index", "tuned", "db", "dim32"}: saved directories, JAX-built."""
    root = tmp_path_factory.mktemp("serve_driver")
    x = _docs(N_DOCS, seed=0)
    index = JIndex.build(x, _cfg())
    index.save(str(root / "idx.pageann"))
    q = _docs(64, seed=5)
    truth = brute_force_knn(x, q, 10)
    index.autotune(q, recall_target=0.9, truth=truth, beam_grid=(16, 32, 48))
    index.save(str(root / "tuned.pageann"))
    colls = {name: JIndex.build(_docs(N_COLL, seed=s), _cfg())
             for name, s in (("wiki", 1), ("notes", 2))}
    jsave_database(colls, str(root / "db"))
    small = JConfig(dim=32, graph_degree=8, build_beam=16, pq_subspaces=4,
                    lsh_sample=64, lsh_entries=4, beam_width=16)
    JIndex.build(np.random.default_rng(3).standard_normal(
        (120, 32)).astype(np.float32), small).save(str(root / "d32.pageann"))
    return {"index": str(root / "idx.pageann"),
            "tuned": str(root / "tuned.pageann"), "db": str(root / "db"),
            "dim32": str(root / "d32.pageann")}


@pytest.fixture
def ported(monkeypatch):
    """The port's driver with the reference's params and prompts."""
    def model_and_prompts(arch, batch, prompt_len, device):
        assert (batch, prompt_len) == (B, T)
        model = tf.params_from_jax(ref_params(), arch, device)
        return model, torch.from_numpy(ref_prompts()).to(device)

    monkeypatch.setattr(serve, "_model_and_prompts", model_and_prompts)


_REF_GENERATE = jserve.generate


@functools.cache
def ref_tokens() -> np.ndarray:
    """The reference driver's ``generate`` on its own params and prompts
    (``init_train_state(SMOKE, PRNGKey(0)).params`` is ``init_params``'s)."""
    cfg = jget_arch(ARCH, smoke=True)
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    return np.asarray(_REF_GENERATE(params, cfg, ref_prompts(), GEN))


def _ref_main(monkeypatch, argv):
    """The reference driver with its generation stubbed out: its tokens do
    not depend on the retrieval flags (``ref_tokens`` holds them)."""
    monkeypatch.setattr(
        jserve, "generate",
        lambda params, arch, prompts, gen: np.zeros((B, gen), np.int32))
    return jserve.main(argv)


def _retrieval_lines(text: str) -> list[str]:
    """What a driver printed before its generation line, less the lines
    that name an ephemeral port."""
    lines = text.split("\ngenerated ")[0].splitlines()
    return [ln for ln in lines
            if not ln.startswith(("metrics sidecar:", "frontend:"))]


def test_generate_equals_reference():
    cfg = jget_arch(ARCH, smoke=True)
    model = tf.params_from_jax(ref_params(), cfg, "cpu")
    got = serve.generate(model, cfg, torch.from_numpy(ref_prompts()), GEN)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), ref_tokens())


def test_driver_without_index_equals_reference(ported, capsys):
    out = serve.main(RUN, device="cpu")
    printed = capsys.readouterr().out
    np.testing.assert_array_equal(out.numpy(), ref_tokens())
    assert printed.startswith("generated (2, 4) in ")


MODES = {
    "index": lambda a: ["--index-dir", a["index"]],
    "mutable": lambda a: ["--index-dir", a["index"], "--mutable"],
    "budget": lambda a: ["--index-dir", a["index"], "--memory-budget", "0.25"],
    "db-route-cache": lambda a: ["--db-dir", a["db"], "--route",
                                 ":wiki,:notes", "--semantic-cache", "0.98"],
    "recall-target": lambda a: ["--index-dir", a["tuned"],
                                "--recall-target", "0.9"],
    "db-recall-target": lambda a: ["--db-dir", a["db"],
                                   "--recall-target", "0.9"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_driver_retrieval_equals_reference(mode, artifacts, ported,
                                           monkeypatch, capsys):
    argv = RUN + MODES[mode](artifacts)
    _ref_main(monkeypatch, argv)
    want = _retrieval_lines(capsys.readouterr().out)
    out = serve.main(argv, device="cpu")
    got = _retrieval_lines(capsys.readouterr().out)
    assert got == want
    assert len(got) >= 2
    np.testing.assert_array_equal(out.numpy(), ref_tokens())
    if mode == "mutable":
        assert any(ln.startswith("mutable: inserted 2 docs") for ln in got)
    if mode == "db-route-cache":
        assert f"replay served {B}/{B} from cache" in "\n".join(got)


def test_obs_selfcheck_trace_and_http(artifacts, ported, capsys, tmp_path):
    """--metrics-port 0 --obs-selfcheck, --trace-out and --http-port 0 run
    over the database (and the sidecar over the index's engine)."""
    trace = tmp_path / "trace.json"
    serve.main(RUN + ["--db-dir", artifacts["db"], "--route", ":wiki,:notes",
                      "--semantic-cache", "0.98", "--metrics-port", "0",
                      "--obs-selfcheck", "--trace-out", str(trace),
                      "--http-port", "0"], device="cpu")
    printed = capsys.readouterr().out
    assert "obs selfcheck ok:" in printed
    assert "frontend: http://127.0.0.1:" in printed
    assert "metrics sidecar: http://127.0.0.1:" in printed
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    serve.main(RUN + ["--index-dir", artifacts["index"], "--metrics-port",
                      "0", "--obs-selfcheck"], device="cpu")
    assert "obs selfcheck ok:" in capsys.readouterr().out


MISUSE = {
    "selfcheck-no-port": lambda a: ["--obs-selfcheck"],
    "http-no-db": lambda a: ["--http-port", "0"],
    "forever-no-http": lambda a: ["--serve-forever"],
    "metrics-no-path": lambda a: ["--metrics-port", "0"],
    "trace-no-path": lambda a: ["--trace-out", "t.json"],
    "db-and-index": lambda a: ["--db-dir", a["db"], "--index-dir", a["index"]],
    "cache-no-db": lambda a: ["--semantic-cache", "0.9"],
    "encoder-only": lambda a: ["--arch", "hubert-xlarge"],
    "unknown-route": lambda a: ["--db-dir", a["db"], "--route", ":wiki,:web"],
    "bad-rate-limit": lambda a: ["--db-dir", a["db"], "--http-port", "0",
                                 "--rate-limit", "wiki"],
    "no-tuned-point": lambda a: ["--index-dir", a["index"],
                                 "--recall-target", "0.9"],
    "dim-mismatch": lambda a: ["--index-dir", a["dim32"]],
    "db-dim-mismatch": lambda a: ["--db-dir", a["db"]],
}


@pytest.mark.parametrize("case", list(MISUSE))
def test_flag_misuse_matches_reference(case, artifacts, ported, monkeypatch,
                                       tmp_path):
    argv = RUN + MISUSE[case](artifacts)
    if case == "db-dim-mismatch":
        # a database whose only collection has another width
        jsave_database({"code": JIndex.load(artifacts["dim32"])},
                       str(tmp_path / "db32"))
        argv = RUN + ["--db-dir", str(tmp_path / "db32")]
    with pytest.raises(SystemExit) as want:
        _ref_main(monkeypatch, argv)
    with pytest.raises(SystemExit) as got:
        serve.main(argv, device="cpu")
    assert str(got.value) == str(want.value)
    assert str(got.value)


def test_non_dense_arch_names_a13b():
    with pytest.raises(NotImplementedError, match="A13b"):
        serve.main(["--smoke", "--arch", "mamba2-370m", "--batch", "1",
                    "--prompt-len", "2", "--gen", "1"], device="cpu")
