"""Checkpoints across the two packages and the port's training driver
(``repro_torch.launch.train``) against the reference's on the CPU.

A checkpoint written by either package restores in the other: the
reference saves granite's SMOKE ``TrainState`` after one step and the
port's next step from the restored state gives the reference's next step
(loss, nll and grad norm within 1e-5 relative; parameters within rtol
1e-4, atol 1e-5: after step 2 AdamW's update is m/sqrt(v) of two
gradients, and an entry where both are within rounding of 0 moves by a
different fraction of lr); the port saves and
``repro.checkpoint.checkpointing.restore`` reads every leaf back bit for
bit, bfloat16 included (kimi-k2). The drivers run
``examples/train_lm_torch.py``'s drill shortened to 80 steps and a restart
to 120 (the printed lines drift apart in their 4th decimal after ~150
steps, as float32 training does across frameworks); the port's initial
state is the reference's ``init_train_state(SMOKE, PRNGKey(0))``, carried
across by ``train_state_from_jax`` through the driver's one init helper
(``train._init_state``). Every printed line but its timing must be equal.
"""
import contextlib
import io
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as jckpt
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.registry import get_arch as jget_arch
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.ft import failures as jfailures
from repro.launch import train as jtrain
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import tree as T
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.ft import failures
from repro_torch.launch import train
from repro_torch.train.step import (
    init_train_state,
    make_train_step,
    train_state_from_jax,
    train_state_to_numpy,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
from train_lm_torch import drill_args  # noqa: E402

# six test workers share the host's cores
torch.set_num_threads(1)

SHAPE = dict(seq_len=32, global_batch=4)


def _jshape(num_mb=1):
    return JShapeConfig("t", SHAPE["seq_len"], SHAPE["global_batch"], "train",
                        num_microbatches=num_mb)


def _shape(num_mb=1):
    return ShapeConfig("t", SHAPE["seq_len"], SHAPE["global_batch"], "train",
                       num_microbatches=num_mb)


def _ref_state(arch_id, lr=None):
    return jinit_train_state(jget_arch(arch_id, smoke=True),
                             jax.random.PRNGKey(0), lr)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_port_restores_a_reference_checkpoint_and_steps_as_it_does(tmp_path):
    jcfg, cfg = jget_arch("granite-3-2b", smoke=True), get_arch(
        "granite-3-2b", smoke=True)
    jstep = jax.jit(jmake_train_step(jcfg, _jshape(2)))
    pipe = JTokenPipeline(jcfg, _jshape(2))
    batch = lambda i: {k: jnp.asarray(v) for k, v in pipe.batch(i).items()}
    state, _ = jstep(_ref_state("granite-3-2b"), batch(0))
    jckpt.save(str(tmp_path), 1, state)
    want_state, want = jstep(state, batch(1))

    target = init_train_state(cfg, torch.Generator().manual_seed(5),
                              device="cpu")
    assert ckpt.latest_step(str(tmp_path)) == 1
    restored = ckpt.restore(str(tmp_path), 1, target)
    assert restored is target
    got_np, saved_np = train_state_to_numpy(restored), _np(state)
    for (path, a), (_, b) in zip(T.flatten(got_np), T.flatten(saved_np),
                                 strict=True):
        np.testing.assert_array_equal(a, b, err_msg=T.name(path))
    new_state, got = make_train_step(cfg, _shape(2))(
        restored, TokenPipeline(cfg, _shape(2)).batch(1))
    for k in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    assert int(new_state.step) == int(want_state.step) == 2
    got_p = train_state_to_numpy(new_state).params
    for (path, a), (_, b) in zip(T.flatten(got_p),
                                 T.flatten(_np(want_state.params))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=T.name(path))


@pytest.mark.parametrize("arch_id", ["granite-3-2b", "kimi-k2-1t-a32b",
                                     "recurrentgemma-9b"])
def test_reference_restores_a_port_checkpoint_bit_for_bit(arch_id, tmp_path):
    """After one step on the CPU (the hybrid: its stacked blocks and
    unstacked tail; kimi-k2: bfloat16 parameters)."""
    cfg = get_arch(arch_id, smoke=True)
    state = init_train_state(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    state, _ = make_train_step(cfg, _shape())(
        state, TokenPipeline(cfg, _shape()).batch(0))
    ckpt.save(str(tmp_path), 1, state)
    assert jckpt.latest_step(str(tmp_path)) == 1
    got = _np(jckpt.restore(str(tmp_path), 1, _ref_state(arch_id)))
    want = train_state_to_numpy(state)
    flat_g, flat_w = T.flatten(got), T.flatten(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, a), (_, b) in zip(flat_g, flat_w):
        assert a.dtype == b.dtype, T.name(path)
        np.testing.assert_array_equal(a, b, err_msg=T.name(path))
    if cfg.param_dtype == "bfloat16":
        assert got.params["embed"].dtype.name == "bfloat16"


def test_checkpoint_names_equal_the_reference(tmp_path):
    """The same manifest, name for name, shape for shape and dtype for
    dtype, for the same TrainState written by each package."""
    jstate = _ref_state("recurrentgemma-9b")
    jckpt.save(str(tmp_path / "ref"), 0, jstate)
    state = train_state_from_jax(_np(jstate),
                                 get_arch("recurrentgemma-9b", smoke=True),
                                 "cpu")
    ckpt.save(str(tmp_path / "port"), 0, state)
    import json

    def manifest(d):
        with open(tmp_path / d / "step_0" / "MANIFEST.json") as f:
            return json.load(f)

    assert manifest("port") == manifest("ref")


def test_async_snapshot_survives_an_in_place_step(tmp_path):
    cfg = get_arch("granite-3-2b", smoke=True)
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    before = train_state_to_numpy(state)
    writer = ckpt.AsyncCheckpointer(str(tmp_path))
    writer.submit(0, state)
    step = make_train_step(cfg, _shape())
    batch = TokenPipeline(cfg, _shape()).batch(0)
    for _ in range(2):
        state, _ = step(state, batch)         # updates the tensors in place
    writer.close()
    after = train_state_to_numpy(state)
    assert not np.array_equal(after.params["embed"], before.params["embed"])
    target = init_train_state(cfg, torch.Generator().manual_seed(3),
                              device="cpu")
    got = train_state_to_numpy(ckpt.restore(str(tmp_path), 0, target))
    for (path, a), (_, b) in zip(T.flatten(got), T.flatten(before)):
        np.testing.assert_array_equal(a, b, err_msg=T.name(path))


# ------------------------------------------------------------ the drivers ---
def _ref_init(arch, lr, device):
    jarch = jget_arch(arch.name.removesuffix("-smoke"), smoke=True)
    return train_state_from_jax(_np(jinit_train_state(
        jarch, jax.random.PRNGKey(0), lr)), arch, device)


def _lines(text: str, ckpt_dir: str) -> list[str]:
    """The printed lines, timings dropped and the directory named."""
    out = []
    for line in text.splitlines():
        line = re.sub(r" \(\d+\.\d+s\)", "", line).replace(" [SLOW]", "")
        out.append(line.replace(ckpt_dir, "CKPT"))
    return out


def _run(main, argvs, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for argv in argvs:
            main(argv, **kw)
    return buf.getvalue()


def test_drill_prints_the_reference_drivers_lines(tmp_path, monkeypatch):
    """The drill shortened to 80 steps (checkpoints at 40 and 80) and a
    restart to 120: the loss lines, the restore line and the restart's
    resume step equal the reference driver's."""
    monkeypatch.setattr(train, "_init_state", _ref_init)
    dirs = {name: str(tmp_path / name) for name in ("ref", "port")}
    ref = _run(jtrain.main, [drill_args(dirs["ref"], n) for n in (80, 120)])
    port = _run(train.main, [drill_args(dirs["port"], n) for n in (80, 120)],
                device="cpu")
    want, got = _lines(ref, dirs["ref"]), _lines(port, dirs["port"])
    assert got == want
    assert "restored step 80 from CKPT" in got
    assert sum(line.startswith("step ") for line in got) == 8
    assert ckpt.latest_step(dirs["port"]) == 120
    assert sorted(p.name for p in Path(dirs["port"]).iterdir()) == sorted(
        p.name for p in Path(dirs["ref"]).iterdir())


def test_drill_runs_on_the_ports_own_init(tmp_path):
    """The example's drill at its own length (120 steps, restart to 200)
    on the port's seeded init: it resumes at 120 and the loss falls."""
    sys.modules.pop("train_lm_torch", None)
    import train_lm_torch

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        first, second = train_lm_torch.drill(str(tmp_path), device="cpu")
    text = buf.getvalue()
    assert "restored step 120 from" in text
    assert int(first.step) == 120 and int(second.step) == 200
    losses = [float(m) for m in re.findall(r"loss=(\d+\.\d+)", text)]
    assert losses[-1] < losses[0]


class _PreemptAt:
    """A PreemptionGuard that reports a preemption from its ``n``-th
    check on."""

    def __init__(self, n):
        self.n = n
        self.checks = 0

    @property
    def preempted(self):
        self.checks += 1
        return self.checks >= self.n


def test_preemption_checkpoints_the_step_it_stopped_at(tmp_path, monkeypatch):
    """Preempted after step 4 of 20: the port's latest checkpoint is step
    5, so a restart resumes there. The reference then also writes the
    preempted state as step 20 (ROADMAP C7), and its restart would resume
    at 20."""
    argv = ["--arch", "granite-3-2b", "--smoke", "--steps", "20",
            "--seq-len", "16", "--batch", "4", "--ckpt-every", "50"]
    monkeypatch.setattr(train, "PreemptionGuard", lambda: _PreemptAt(5))
    monkeypatch.setattr(jtrain, "PreemptionGuard", lambda: _PreemptAt(5))
    port = _run(train.main, [argv + ["--ckpt-dir", str(tmp_path / "port")]],
                device="cpu")
    _run(jtrain.main, [argv + ["--ckpt-dir", str(tmp_path / "ref")]])
    assert "preemption: checkpointing at step 5 and exiting" in port
    assert ckpt.latest_step(str(tmp_path / "port")) == 5
    assert jckpt.latest_step(str(tmp_path / "ref")) == 20   # C7


def test_production_build_returns_production_mesh_and_rules():
    """Without ``--smoke`` ``build`` takes ``SHAPES[--shape]``, the
    production mesh over the default process group (here the dry run's
    fake world of 256, or 512 with ``--multi-pod``) and ``Rules``; a world
    of another size is refused by name."""
    import argparse

    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.models.sharding import Rules

    def args(**kw):
        return argparse.Namespace(**{**dict(
            arch="granite-3-2b", shape="train_4k", smoke=False,
            multi_pod=False, seq_len=128, batch=8, microbatches=2), **kw})

    with fake_world(256):
        arch, shape, mesh, rules = train.build(args(), "cpu")
        assert arch == get_arch("granite-3-2b") and shape == SHAPES["train_4k"]
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (16, 16)
        assert isinstance(rules, Rules) and rules.dp == ("data",)
        assert rules.device_mesh is mesh
        with pytest.raises(RuntimeError, match="512 ranks"):
            train.build(args(multi_pod=True), "cpu")
    with fake_world(512):
        _, _, mesh, rules = train.build(args(multi_pod=True,
                                             shape="prefill_32k"), "cpu")
        assert tuple(mesh.shape) == (2, 16, 16)
        assert rules.dp == ("pod", "data")


def test_driver_flags_match_the_reference():
    """The same flags, defaults and choices as the reference's parser."""
    import argparse

    def flags(main):
        seen = {}
        real = argparse.ArgumentParser.parse_args

        def capture(self, argv=None, namespace=None):
            seen.update({a.dest: (a.default, tuple(a.choices or ()))
                         for a in self._actions})
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = capture
        try:
            with pytest.raises(SystemExit):
                main([])
        finally:
            argparse.ArgumentParser.parse_args = real
        return seen

    assert flags(lambda a: train.main(a, device="cpu")) == flags(jtrain.main)


def test_fault_tolerance_module_is_the_references():
    for name in ("PreemptionGuard", "StragglerMonitor", "RestartManager",
                 "elastic_remesh"):
        assert getattr(failures, name).__doc__ == getattr(
            jfailures, name).__doc__
