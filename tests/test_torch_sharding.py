"""The port's sharding rules (``repro_torch.models.sharding``,
``repro_torch.launch.shardings``) against the reference's on the CPU, and
its sharded train step on four gloo ranks.

Specs, name for name: the reference's side is built with
``jax.eval_shape(init_train_state)`` over ``AbstractMesh``es (no devices),
the port's with a full-width model under ``FakeTensorMode`` (no storage)
over a port ``Mesh`` that names the CPU 256 (512) times. Every arch in the
registry at full width on ``pod16x16`` and ``pod2x16x16``, with
``fsdp_over_pod`` and ``replicate_kv`` as the dry run sets them: the
parameters', the optimizer state's (AdamW and Adafactor; ROADMAP C9 is
one named case), the batches' and the caches' specs, and the
applicability matrix.

The sharded step: ``tests/torch_sharding_worker.py`` runs four gloo ranks
on a (2, 2) CPU DeviceMesh from the reference's SMOKE init. granite-3-2b
(2 microbatches) and arctic-480b (MoE) take one ``make_train_step(rules=)``
step, and one with ``zero1=True`` (at one microbatch: ZeRO-1 accumulates
in bf16, and two accumulations that round a partial sum at different
points differ by a bf16 step, which AdamW's first step turns into a whole
``lr``). Loss and grad norm equal the ``rules=None`` step within 1e-5
relative and the reference's loss within 1e-5 relative, the parameters
after the step within 1e-5. arctic runs at a capacity factor under which
no token is dropped: with rules the MoE dispatches per dp shard at the
reference's per-shard capacity, which drops other tokens than one shard
would. A checkpoint written at ``rules=None`` restores under
``shardings=`` bit for bit, and the sharded state's checkpoint restores at
``rules=None`` bit for bit.
"""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import shape_applicable as jshape_applicable
from repro.configs.registry import get_arch as jget_arch
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch.shardings import batch_specs as jbatch_specs
from repro.launch.shardings import cache_spec_tree as jcache_spec_tree
from repro.launch.shardings import state_specs as jstate_specs
from repro.models import transformer as jtf
from repro.models.sharding import Rules as JRules
from repro.models.sharding import fix_spec as jfix_spec
from repro.train.step import init_train_state as jinit_train_state
from repro_torch import tree as T
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shardings import (
    batch_specs,
    cache_spec_tree,
    state_specs,
)
from repro_torch.models.sharding import P, Rules, fix_spec, spec_leaves
from repro_torch.models.transformer import init_cache
from repro_torch.train.step import (
    init_train_state,
    make_train_step,
    train_state_from_jax,
    train_state_to_numpy,
)
from torch_sharding_worker import as_state

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    n = int(np.prod(shape))
    return AbstractMesh(shape, axes), make_mesh(shape, axes,
                                                devices=["cpu"] * n)


def _rule_kw(arch_id):
    """``fsdp_over_pod`` and ``replicate_kv`` as ``dryrun._rules`` sets them."""
    a = get_arch(arch_id)
    return dict(fsdp_over_pod=a.param_count() >= 400e9,
                replicate_kv=a.replicate_kv)


def _ref_flat(tree) -> dict:
    """A reference spec tree as {checkpoint-style name: tuple}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for path, spec in flat:
        parts = []
        for p in path:
            k = getattr(p, "key", None)
            if k is None:
                k = getattr(p, "idx", None)
            if k is None:
                k = getattr(p, "name", None)
            parts.append(str(k))
        out["::".join(parts)] = tuple(spec)
    return out


def _port_flat(specs) -> dict:
    return {T.name(path): tuple(s) for path, s in spec_leaves(specs)}


@functools.lru_cache(maxsize=None)
def _state_specs(arch_id, mesh_name, optimizer=None):
    """(reference, port) flat state specs of the full-width arch."""
    am, pm = _meshes(mesh_name)
    kw = _rule_kw(arch_id)
    ja = jget_arch(arch_id)
    pa = get_arch(arch_id)
    if optimizer:
        ja = dataclasses.replace(ja, optimizer=optimizer)
        pa = dataclasses.replace(pa, optimizer=optimizer)
    st = jax.eval_shape(lambda: jinit_train_state(ja, jax.random.PRNGKey(0)))
    ref = _ref_flat(jstate_specs(st, JRules(am, **kw)))
    with FakeTensorMode():
        pst = init_train_state(pa, torch.Generator(), device="cpu")
        port = _port_flat(state_specs(pst, Rules(pm, **kw)))
    return ref, port


# ------------------------------------------------------------------ specs
FIX_CASES = [
    ((49155, 2048), ("model", "data")),        # vocab 49,155 on 16
    ((49408, 2048), ("model", "data")),
    ((2048, 8, 128), ("data", "model", None)),  # 8 KV heads on 16
    ((2048, 40, 128), ("data", "model", None)),
    ((40, 3, 2048), (None, "data", "model")),
    ((7, 13), ("data", "model")),
    ((4096, 64), (("pod", "data"), "model")),
    ((24, 4096), ("model", ("pod", "data"))),
    ((128,), ("model",)),
]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("reassign", [True, False])
@pytest.mark.parametrize("shape,spec", FIX_CASES)
def test_fix_spec_matches_reference(shape, spec, reassign, mesh_name):
    am, pm = _meshes(mesh_name)
    if any(a == "pod" or (isinstance(a, tuple) and "pod" in a)
           for a in spec) and mesh_name == "pod16x16":
        spec = tuple(("data" if a == ("pod", "data") else a) for a in spec)
    want = jfix_spec(jax.sharding.PartitionSpec(*spec), shape, am,
                     reassign=reassign)
    got = fix_spec(P(*spec), shape, pm, reassign=reassign)
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_state_specs_match_reference(arch_id, mesh_name):
    """Parameters and optimizer moments, name for name, at full width."""
    ref, port = _state_specs(arch_id, mesh_name)
    assert set(port) == set(ref)
    bad = {k: (ref[k], port[k]) for k in ref if port[k] != ref[k]}
    assert not bad


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_state_specs_both_optimizers(optimizer):
    ref, port = _state_specs("granite-3-2b", "pod16x16", optimizer)
    assert port == ref
    assert any(k.startswith("opt_state::" + ("m" if optimizer == "adamw"
                                             else "vr")) for k in port)


def test_c9_adafactor_moment_takes_first_shape_match():
    """ROADMAP C9, reproduced: qwen1.5-110b's ``final.scale`` row moment
    (8192,) takes ``embed``'s column-moment layout P('data'), not its own
    parameter's P(None)."""
    ref, port = _state_specs("qwen1.5-110b", "pod16x16")
    name = "opt_state::vr::final::scale"
    assert ref[name] == ("data",) == port[name]
    assert port["params::final::scale"] == (None,)


def _cells():
    for aid in ARCH_IDS:
        for sid in SHAPES:
            yield aid, sid


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch_id, mesh_name):
    """Every applicable shape: train/prefill batches, decode caches."""
    am, pm = _meshes(mesh_name)
    kw = _rule_kw(arch_id)
    jr, pr = JRules(am, **kw), Rules(pm, **kw)
    ja, pa = jget_arch(arch_id), get_arch(arch_id)
    checked = 0
    for sid, shape in SHAPES.items():
        ok, _ = shape_applicable(pa, shape)
        if not ok:
            continue
        jshape = JSHAPES[sid]
        want = {k: tuple(v) for k, v in jbatch_specs(ja, jshape, jr).items()}
        got = {k: tuple(v) for k, v in batch_specs(pa, shape, pr).items()}
        assert got == want, sid
        if shape.kind == "decode":
            cache = jax.eval_shape(lambda: jtf.init_cache(
                ja, jshape.global_batch, jshape.seq_len))
            want = _ref_flat(jcache_spec_tree(cache, ja, jr))
            got = _port_flat(cache_spec_tree(init_cache(
                pa, shape.global_batch, shape.seq_len, device="meta"), pa, pr))
            assert got == want, sid
        checked += 1
    assert checked


def test_applicability_matrix_matches_reference():
    for aid, sid in _cells():
        assert shape_applicable(get_arch(aid), SHAPES[sid]) == \
            jshape_applicable(jget_arch(aid), JSHAPES[sid])


VARIANTS = ["baseline", "zero1", "bf16", "attn_pairs", "chunks1024x2048",
            "zero1+bf16", "remat-dots", "repkv", "padheads64",
            "zero1+bf16+attn_pairs+chunks256x512"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_kwargs_match_reference(variant):
    jax.devices()      # the reference module sets XLA_FLAGS on import
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.hillclimb import variant_kwargs as jvariant_kwargs
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    from repro_torch.launch.hillclimb import variant_kwargs

    assert variant_kwargs(variant) == jvariant_kwargs(variant)


def test_unknown_param_name_raises():
    from repro_torch.models.sharding import param_specs

    _, pm = _meshes("pod16x16")
    with pytest.raises(KeyError, match="no sharding rule"):
        param_specs({"bogus": torch.zeros(4)}, Rules(pm))


def test_placements_map_spec_entries():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.sharding import placements

    class M:       # a DeviceMesh's names are all placements read
        mesh_dim_names = ("pod", "data", "model")

    assert placements(P(("pod", "data"), None, "model"), M()) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements(P(None, "data"), M()) == \
        (Replicate(), Shard(1), Replicate())


# -------------------------------------------------- the sharded train step
CASES = [
    # (name, arch, overrides, microbatches, zero1)
    ("granite", "granite-3-2b", {}, 2, False),
    ("granite-zero1", "granite-3-2b", {}, 1, True),
    ("arctic", "arctic-480b", {"moe_capacity_factor": 8.0}, 2, False),
    ("arctic-zero1", "arctic-480b", {"moe_capacity_factor": 8.0}, 1, True),
]
BATCH, SEQ = 8, 16


def _jax_case(arch, overrides):
    jcfg = dataclasses.replace(jget_arch(arch, smoke=True), **overrides)
    state = jinit_train_state(jcfg, jax.random.PRNGKey(0))
    batch = JTokenPipeline(jcfg, JShapeConfig("t", SEQ, BATCH, "train"),
                           seed=0).batch(0)
    return jcfg, state, batch


def _plain(tree):
    """The reference's TrainState as the worker's plain dicts."""
    np_state = jax.tree.map(np.asarray, tree)
    opt = np_state.opt_state
    return {"params": np_state.params,
            "opt_state": {f: getattr(opt, f) for f in opt._fields},
            "step": np_state.step}


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """The worker's results and the cases' reference losses and
    ``rules=None`` steps."""
    work = str(tmp_path_factory.mktemp("sharded"))
    cases, expect = [], []
    for name, arch, overrides, num_mb, zero1 in CASES:
        jcfg, jstate, jbatch = _jax_case(arch, overrides)
        # the step's loss: the mean of its contiguous microbatches' losses
        jloss = np.mean([float(jtf.loss_fn(jstate.params, {
            k: v[j * BATCH // num_mb:(j + 1) * BATCH // num_mb]
            for k, v in jbatch.items()}, jcfg)[0]) for j in range(num_mb)])
        cfg = dataclasses.replace(get_arch(arch, smoke=True), **overrides)
        plain = _plain(jstate)
        batch = {k: np.asarray(v) for k, v in jbatch.items()}
        cases.append(dict(arch=arch, overrides=overrides, num_mb=num_mb,
                          zero1=zero1, state=plain, batch=batch))
        state = train_state_from_jax(as_state(plain), cfg, "cpu")
        if not expect:     # the rules=None checkpoint the worker restores
            ckpt.save(os.path.join(work, "ckpt_in"), 0, state)
        shape = ShapeConfig("t", SEQ, BATCH, "train", num_microbatches=num_mb)
        state, m = make_train_step(cfg, shape, zero1=zero1)(state, batch)
        expect.append(dict(name=name, cfg=cfg, ref_loss=float(jloss),
                           metrics={k: float(v) for k, v in m.items()},
                           state=train_state_to_numpy(state)))
    with open(os.path.join(work, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "torch_sharding_worker.py"),
         work], capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(os.path.join(work, "results.pkl"), "rb") as f:
        results = pickle.load(f)
    return work, cases, expect, results


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_sharded_step_equals_unsharded_and_reference(sharded_run, i):
    _, _, expect, results = sharded_run
    want, got = expect[i], results[i]
    for k in ("loss", "grad_norm", "nll", "aux"):
        assert _rel(got["metrics"][k], want["metrics"][k]) <= 1e-5 or \
            abs(got["metrics"][k] - want["metrics"][k]) <= 1e-7, k
    assert _rel(got["metrics"]["loss"], want["ref_loss"]) <= 1e-5
    pairs = list(zip(jax.tree.leaves(got["state"].params),
                     jax.tree.leaves(want["state"].params), strict=True))
    assert max(float(np.abs(a - b).max()) for a, b in pairs) <= 1e-5
    for a, b in zip(jax.tree.leaves(got["state"].opt_state),
                    jax.tree.leaves(want["state"].opt_state), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_sharded_decode_equals_unsharded(sharded_run):
    """``decode_step`` on the sharded model, its cache laid out by
    ``cache_spec_tree`` (the sequence over 'model'), equals the plain
    decode step by step within 1e-5."""
    from repro_torch.models.transformer import decode_step, init_cache

    _, cases, _, results = sharded_run
    got = results[-1]
    cfg = dataclasses.replace(get_arch(cases[0]["arch"], smoke=True),
                              **cases[0]["overrides"])
    model = train_state_from_jax(as_state(cases[0]["state"]), cfg,
                                 "cpu").params
    tokens = got["decode_tokens"]
    cache = init_cache(cfg, tokens.shape[0], tokens.shape[1], device="cpu")
    with torch.no_grad():
        for pos in range(tokens.shape[1]):
            want, cache = decode_step(model, cache,
                                      torch.as_tensor(tokens[:, pos]), pos,
                                      cfg)
            np.testing.assert_allclose(got["decode_logits"][pos],
                                       want.numpy(), rtol=1e-5, atol=1e-5)


def test_unsharded_checkpoint_restores_sharded_bit_for_bit(sharded_run):
    _, cases, _, results = sharded_run
    cfg = dataclasses.replace(get_arch(cases[0]["arch"], smoke=True),
                              **cases[0]["overrides"])
    want = train_state_to_numpy(train_state_from_jax(
        as_state(cases[0]["state"]), cfg, "cpu"))
    got = results[0]["restored"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_sharded_checkpoint_restores_unsharded_bit_for_bit(sharded_run):
    work, cases, _, results = sharded_run
    cfg = dataclasses.replace(get_arch(cases[0]["arch"], smoke=True),
                              **cases[0]["overrides"])
    target = train_state_from_jax(as_state(cases[0]["state"]), cfg, "cpu")
    ckpt.restore(os.path.join(work, "ckpt_out"), 1, target)
    got = train_state_to_numpy(target)
    want = results[0]["state"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        assert np.array_equal(a, b)
