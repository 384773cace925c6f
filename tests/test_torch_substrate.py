"""The port's training substrate against the reference's on the CPU:
optimizers (``repro_torch.optim``), int8 error feedback
(``repro_torch.train.compress``), checkpoints
(``repro_torch.checkpoint.checkpointing``), fault tolerance
(``repro_torch.ft.failures``) and the token pipeline
(``repro_torch.data.pipeline.TokenPipeline``).

``tests/test_substrate.py``'s cases run over the port. Beside them: each
optimizer fed the same parameters and gradients as the reference's gives
parameters and state allclose at rtol = atol = 1e-6 (the frameworks reduce
in other orders; the global norm, the means and ``pow`` round
differently); the port's per-layer Adafactor equals the reference's
stacked update, including an MoE expert stack (updated whole, not scanned
over its experts), a stacked per-layer vector (one factored matrix) and a
hybrid tail leaf (scanned over its leading dimension); int8 compression
equals the reference's bit for bit; the pipeline's batches equal the
reference's bit for bit for every arch and host split.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")  # property sweeps skip cleanly without it
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs.registry import get_arch as jget_arch  # noqa: E402
from repro.data.pipeline import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.optim import Adafactor as JAdafactor  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.train import compress as jcompress  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import checkpointing as ckpt  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline, clustered_vectors  # noqa: E402
from repro_torch.ft.failures import (  # noqa: E402
    PreemptionGuard,
    RestartManager,
    StragglerMonitor,
    elastic_remesh,
)
from repro_torch.optim import Adafactor, AdamW, global_norm, make_optimizer  # noqa: E402
from repro_torch.train import compress  # noqa: E402

# six test workers share the host's cores
torch.set_num_threads(1)

OPT_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


# ------------------------------------------------------------- optimizers ---
@pytest.mark.parametrize("opt", [AdamW(lr=0.1), Adafactor(lr=0.5)])
def test_optimizer_decreases_quadratic(opt):
    params = {"w": torch.tensor(np.random.default_rng(0).standard_normal((8, 4)),
                                dtype=torch.float32)}
    state = opt.init(params)
    l0 = float(torch.sum(params["w"] ** 2))
    for _ in range(30):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.update(grads, state, params)
    assert float(torch.sum(params["w"] ** 2)) < 0.5 * l0


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros((16, 8)), "b": torch.zeros((8,))}
    st_ = Adafactor().init(params)
    assert st_.vr["w"].shape == (16,)
    assert st_.vc["w"].shape == (8,)
    assert st_.vr["b"].shape == (8,)     # rank-1: unfactored


def test_adafactor_scanned_update_matches_unscanned():
    """Stacked (L, r, c) leaves update layer by layer: results identical."""
    rng = np.random.default_rng(0)
    opt = Adafactor(lr=0.1)
    w = torch.tensor(rng.standard_normal((3, 8, 4)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((3, 8, 4)), dtype=torch.float32)
    stacked = {"w": w.clone()}
    opt.update({"w": g}, opt.init(stacked), stacked)
    for i in range(3):
        one = {"w": w[i].clone()}
        opt.update({"w": g[i]}, opt.init(one), one)
        np.testing.assert_allclose(stacked["w"][i].numpy(), one["w"].numpy(),
                                   rtol=2e-4, atol=1e-5)


def test_global_norm():
    t = {"a": torch.ones((2, 2)), "b": torch.ones((5,))}
    assert abs(float(global_norm(t)) - 3.0) < 1e-6
    stacked = {"a": T.Stack([torch.ones((2,)), torch.ones((2,))]),
               "b": torch.ones((5,))}
    assert abs(float(global_norm(stacked)) - 3.0) < 1e-6


def test_make_optimizer_matches_the_reference_defaults():
    assert make_optimizer("adamw") == AdamW(lr=3e-4)
    assert make_optimizer("adafactor", 0.01) == Adafactor(lr=0.01)
    with pytest.raises(ValueError):
        make_optimizer("sgd")


def _ref_update(opt, params, grads, steps: int):
    """The reference's ``opt.update`` ``steps`` times on numpy trees."""
    p = jax.tree.map(jnp.asarray, params)
    s = opt.init(p)
    g = jax.tree.map(jnp.asarray, grads)
    norms = []
    for _ in range(steps):
        p, s, n = opt.update(g, s, p)
        norms.append(float(n))
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s), norms


def _tree_close(got, want, **tol):
    flat_g, flat_w = T.flatten(got), T.flatten(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, a), (_, b) in zip(flat_g, flat_w):
        a = a.stacked() if isinstance(a, T.Stack) else a
        np.testing.assert_allclose(
            np.asarray(a, np.float32), np.asarray(b, np.float32),
            err_msg=T.name(path), **(tol or OPT_TOL))


def _mixed_tree(rng, layers: int):
    """A tree of the shapes an LM's has: per-layer matrices, an MoE expert
    stack (E, d, ff), per-layer vectors, rank-3 attention weights, and
    unstacked leaves (an embedding, a hybrid tail's (d, H, hd) ``wq``)."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    stacked = {"mlp": {"w_up": a(layers, 8, 12)},
               "moe": {"we_gate": a(layers, 3, 8, 6)},
               "attn": {"wq": a(layers, 8, 2, 4)},
               "scale": a(layers, 8)}
    return {"embed": a(16, 8), "final": {"scale": a(8)},
            "layers": stacked,
            "tail": {"tail0_attn": {"attn": {"wq": a(8, 2, 4)}}}}


def _as_port(tree: dict) -> dict:
    """The tree as the port holds it: ``layers`` leaves as a Stack of
    per-layer tensors, the rest as tensors."""
    out = T.map(lambda x: _t(x), {k: v for k, v in tree.items()
                                  if k != "layers"})
    out["layers"] = T.map(lambda x: T.Stack(_t(s) for s in x), tree["layers"])
    return out


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_equals_the_reference_on_a_stacked_tree(name, layers):
    """The port's per-layer leaves (a Stack) against the reference's
    stacked ones, the same gradients, three steps: params, state and the
    grad norm at 1e-6."""
    rng = np.random.default_rng(layers)
    params, grads = _mixed_tree(rng, layers), _mixed_tree(rng, layers)
    jopt = {"adamw": JAdamW(lr=0.05), "adafactor": JAdafactor(lr=0.05)}[name]
    opt = {"adamw": AdamW(lr=0.05), "adafactor": Adafactor(lr=0.05)}[name]
    want_p, want_s, want_n = _ref_update(jopt, params, grads, 3)
    p, g = _as_port(params), _as_port(grads)
    s = opt.init(p)
    norms = []
    for _ in range(3):
        p, s, n = opt.update(g, s, p)
        norms.append(float(n))
    _tree_close(p, want_p)
    assert int(s.step) == int(want_s.step) == 3
    for field in s._fields[1:]:
        _tree_close(getattr(s, field), getattr(want_s, field))
    np.testing.assert_allclose(norms, want_n, rtol=1e-6)


def test_adafactor_state_has_the_reference_shapes():
    rng = np.random.default_rng(0)
    params = _mixed_tree(rng, 3)
    want = JAdafactor().init(jax.tree.map(jnp.asarray, params))
    got = Adafactor().init(_as_port(params))
    for field in ("vr", "vc"):
        for (path, a), (_, b) in zip(T.flatten(getattr(got, field)),
                                     T.flatten(getattr(want, field))):
            assert tuple(a.shape) == tuple(b.shape), T.name(path)
    assert got.vr["layers"]["moe"]["we_gate"].shape == (3, 3, 8)


def test_adamw_updates_bf16_params_as_the_reference():
    rng = np.random.default_rng(4)
    import ml_dtypes

    params = {"w": rng.standard_normal((6, 5)).astype(ml_dtypes.bfloat16)}
    grads = {"w": rng.standard_normal((6, 5)).astype(ml_dtypes.bfloat16)}
    want_p, _, _ = _ref_update(JAdamW(lr=0.01), params, grads, 2)
    from repro_torch.models.transformer import to_numpy, to_tensor

    p = {"w": to_tensor(params["w"])}
    opt = AdamW(lr=0.01)
    s = opt.init(p)
    for _ in range(2):
        p, s, _ = opt.update({"w": to_tensor(grads["w"])}, s, p)
    assert p["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(p["w"]).astype(np.float32),
                                  want_p["w"].astype(np.float32))


# ------------------------------------------------------ grad compression ----
@settings(max_examples=10, deadline=None)
@given(scale=st.floats(1e-3, 1e3))
def test_int8_compression_error_bounded(scale):
    rng = np.random.default_rng(int(scale * 7) % 100)
    g = torch.tensor(scale * rng.standard_normal((64,)), dtype=torch.float32)
    q, s = compress.compress(g)
    back = compress.decompress(q, s)
    assert float((back - g).abs().max()) <= float(s) * 0.5 + 1e-9


def test_error_feedback_accumulates_truth():
    """Sum of EF-compressed grads converges to the true sum."""
    rng = np.random.default_rng(0)
    grads = [{"w": torch.tensor(rng.standard_normal((32,)) * 0.01,
                                dtype=torch.float32)} for _ in range(50)]
    ef = compress.init_ef(grads[0])
    applied = torch.zeros((32,))
    for g in grads:
        codes, scales, ef = compress.ef_compress_tree(g, ef)
        applied = applied + compress.ef_decompress_tree(codes, scales)["w"]
    true = sum(g["w"] for g in grads)
    assert float((applied + ef.residual["w"] - true).abs().max()) < 1e-4


def test_int8_error_feedback_equals_the_reference():
    """Codes, scales and residuals bit for bit over 5 steps, a stacked leaf
    (one scale over its layers, as the reference's) included; ties round
    half to even in both."""
    rng = np.random.default_rng(2)
    steps = [{"w": rng.standard_normal((3, 16)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32)}
             for _ in range(5)]
    steps[0]["b"][:3] = [0.5, 1.5, -2.5]     # exact halves after scaling
    jef = jcompress.init_ef(steps[0])
    ef = compress.init_ef({"w": T.Stack(_t(steps[0]["w"][i]) for i in range(3)),
                           "b": _t(steps[0]["b"])})
    for g in steps:
        jc, js, jef = jcompress.ef_compress_tree(g, jef)
        port_g = {"w": T.Stack(_t(g["w"][i]) for i in range(3)), "b": _t(g["b"])}
        c, s, ef = compress.ef_compress_tree(port_g, ef)
        for k in ("w", "b"):
            np.testing.assert_array_equal(c[k].numpy(), np.asarray(jc[k]))
            assert float(s[k]) == float(js[k])
            np.testing.assert_array_equal(ef.residual[k].numpy(),
                                          np.asarray(jef.residual[k]))
        back = compress.ef_decompress_tree(c, s)
        np.testing.assert_array_equal(
            back["w"].numpy(),
            np.asarray(jcompress.ef_decompress_tree(jc, js)["w"]))
    halves = torch.tensor([0.5, 1.5, 2.5, -0.5])
    assert torch.round(halves).tolist() == [0.0, 2.0, 2.0, -0.0]


# ----------------------------------------------------------- checkpoints ----
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3),
            "n": {"b": torch.ones((4,), dtype=torch.bfloat16)}}
    ckpt.save(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    target = T.map(torch.zeros_like, tree)
    out = ckpt.restore(str(tmp_path), 7, target)
    assert out is target
    for a, b in zip(T.leaves(tree), T.leaves(out)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_atomic_commit(tmp_path):
    d = ckpt.save(str(tmp_path), 1, {"a": torch.zeros((2,))})
    assert not d.endswith(".tmp")
    assert not os.path.exists(d + ".tmp")


def test_async_checkpointer(tmp_path):
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    for s in (1, 2):
        w.submit(s, {"a": torch.full((3,), float(s))})
    w.close()
    assert ckpt.latest_step(str(tmp_path)) == 2
    out = ckpt.restore(str(tmp_path), 2, {"a": torch.zeros((3,))})
    assert torch.equal(out["a"], torch.full((3,), 2.0))


def test_async_snapshot_survives_in_place_updates(tmp_path):
    """``submit`` copies: a CPU tensor updated in place right after (as the
    optimizer does) leaves the checkpoint as it was submitted."""
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    a = torch.arange(4, dtype=torch.float32)
    stack = T.Stack([torch.ones(2), torch.zeros(2)])
    w.submit(1, {"a": a, "s": stack})
    a.add_(100.0)
    stack[0].mul_(7.0)
    w.close()
    out = ckpt.restore(str(tmp_path), 1, {"a": torch.empty(4),
                                          "s": T.Stack([torch.empty(2),
                                                              torch.empty(2)])})
    assert torch.equal(out["a"], torch.arange(4, dtype=torch.float32))
    assert torch.equal(out["s"][0], torch.ones(2))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros((2,))})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros((3,))})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), 1, {"b": torch.zeros((2,))})


def test_stacked_leaf_is_written_in_the_reference_shape(tmp_path):
    stack = T.Stack([torch.full((2, 3), float(i)) for i in range(4)])
    ckpt.save(str(tmp_path), 3, {"layers": {"w": stack}})
    arr = np.load(tmp_path / "step_3" / "layers::w.npy")
    assert arr.shape == (4, 2, 3)
    np.testing.assert_array_equal(arr[:, 0, 0], [0, 1, 2, 3])


# --------------------------------------------------------- fault tolerance --
def test_straggler_monitor_flags_slow_steps():
    m = StragglerMonitor(threshold=2.0, rebalance_after=2)
    for s in range(10):
        m.observe(s, 1.0)
    assert not m.slow_steps
    assert m.observe(10, 5.0)
    assert not m.should_rebalance()
    m.observe(11, 5.0)
    assert m.should_rebalance()
    assert [s for s, _ in m.slow_steps] == [10, 11]


def test_restart_manager_recovers():
    calls = {"n": 0}

    def step(s):
        calls["n"] += 1
        if s == 3 and calls["n"] < 6:
            raise RuntimeError("chip failure")

    rm = RestartManager(max_restarts=3)
    assert rm.run(6, step, lambda: 2) == 6
    assert rm.restarts >= 1


def test_restart_manager_gives_up():
    rm = RestartManager(max_restarts=1)

    def step(s):
        raise RuntimeError("hard failure")

    with pytest.raises(RuntimeError):
        rm.run(3, step, lambda: 0)


def test_preemption_guard_flag():
    g = PreemptionGuard()
    assert not g.preempted
    g.request()
    assert g.preempted


def test_elastic_remesh_shapes():
    assert elastic_remesh(256) == (16, 16)
    assert elastic_remesh(240) == (15, 16)   # one host of 16 chips lost
    assert elastic_remesh(512, multi_pod=True) == (2, 16, 16)
    assert elastic_remesh(8) == (1, 8)


def test_straggler_monitor_equals_the_reference_on_a_trace():
    from repro.ft.failures import StragglerMonitor as JMonitor

    rng = np.random.default_rng(0)
    trace = np.abs(rng.standard_normal(60)) + 0.5
    trace[[20, 21, 22, 40]] *= 8
    m, jm = StragglerMonitor(), JMonitor()
    for s, d in enumerate(trace):
        assert m.observe(s, float(d)) == jm.observe(s, float(d))
        assert m.should_rebalance() == jm.should_rebalance()
    assert m.slow_steps == jm.slow_steps


# ------------------------------------------------------------------ data ----
def test_token_pipeline_determinism_and_host_sharding():
    arch = get_arch("granite-3-2b", smoke=True)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=8)
    p0 = TokenPipeline(arch, shape, num_hosts=2, host_id=0)
    p0b = TokenPipeline(arch, shape, num_hosts=2, host_id=0)
    p1 = TokenPipeline(arch, shape, num_hosts=2, host_id=1)
    b0, b0b, b1 = p0.batch(3), p0b.batch(3), p1.batch(3)
    np.testing.assert_array_equal(b0["tokens"], b0b["tokens"])
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    assert b0["tokens"].shape == (4, 16)
    # next-token labels
    np.testing.assert_array_equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])
    with pytest.raises(ValueError):
        TokenPipeline(arch, shape, num_hosts=3)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_token_pipeline_equals_the_reference(arch_id):
    """Every arch (tokens, frame embeddings, M-RoPE positions), two seeds,
    three steps and each host of 1, 2 and 4: bit for bit."""
    from repro.configs.base import SHAPES as JSHAPES

    arch, jarch = get_arch(arch_id, smoke=True), jget_arch(arch_id, smoke=True)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=12, global_batch=8)
    jshape = dataclasses.replace(JSHAPES["train_4k"], seq_len=12, global_batch=8)
    for seed in (0, 5):
        for hosts in (1, 2, 4):
            for host in range(hosts):
                got = TokenPipeline(arch, shape, seed, hosts, host)
                want = JTokenPipeline(jarch, jshape, seed, hosts, host)
                for step in (0, 1, 17):
                    a, b = got.batch(step), want.batch(step)
                    assert sorted(a) == sorted(b)
                    for k in a:
                        assert a[k].dtype == b[k].dtype, k
                        np.testing.assert_array_equal(a[k], b[k])


def test_clustered_vectors_shape_and_structure():
    x = clustered_vectors(256, 16, num_clusters=4, seed=0)
    assert x.shape == (256, 16)
    rng = np.random.default_rng(0)
    rand = rng.standard_normal((256, 16)).astype(np.float32)

    def spread(a):
        return np.var(a, axis=0).sum()

    assert spread(x) < spread(rand) * 3
