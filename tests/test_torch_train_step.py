"""The port's train step (``repro_torch.train.step``) against the
reference's (``repro.train.step``) on the CPU.

``tests/test_train_step.py``'s cases run over the port, on its own seeded
init. Then, for every family's SMOKE config (granite, mamba2,
recurrentgemma, arctic, kimi-k2, qwen2-vl, hubert), from the reference's
``init_train_state(SMOKE, PRNGKey(0))`` carried across by
``train_state_from_jax`` and the reference's ``TokenPipeline`` batch:

* one step's ``loss``/``nll``/``aux`` and its ``grad_norm`` within 1e-5
  relative (kimi-k2's bfloat16 parameters: 1e-2);
* every gradient leaf, by the reference's name, within rtol 1e-4 and atol
  1e-5 x the largest |g| of any leaf (bfloat16: 2e-2 for both);
* the optimizer, AdamW and Adafactor, fed the reference's own gradients:
  parameters and state allclose at rtol = atol = 1e-6 (bfloat16 parameters
  within one bfloat16 step, 2^-8 relative: an update that lands within a
  float32 rounding of a bfloat16 boundary rounds either way).

A whole step's parameters are not compared: at step 1 AdamW moves each
parameter by about lr x sign(g), and a gradient entry within rounding of 0
can take the other sign in the other framework, which moves that
parameter by 2 lr. So the gradients are compared first, and then the
optimizer on identical gradients.

With ``activation_dtype="bfloat16"`` (granite's SMOKE config, AdamW) one
whole ``make_train_step`` step is held to the reference's at a bf16
tolerance (its test states it).

Within the port: ``remat`` ``none``/``full``/``dots`` give the same loss and
gradients bit for bit, and two microbatches give the unbatched step's
parameters within the reference test's bounds (atol 5e-4, rtol 5e-3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.registry import get_arch as jget_arch
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import transformer as jtf
from repro.optim import global_norm as jglobal_norm
from repro.optim import make_optimizer as jmake_optimizer
from repro.train.step import init_train_state as jinit_train_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import tree as T
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import transformer as tf
from repro_torch.optim import make_optimizer
from repro_torch.train.step import (
    effective_microbatches,
    init_train_state,
    loss_and_grads,
    make_train_step,
    train_state_from_jax,
    train_state_to_numpy,
)

# six test workers share the host's cores
torch.set_num_threads(1)

FAMILIES = ["granite-3-2b", "mamba2-370m", "recurrentgemma-9b", "arctic-480b",
            "kimi-k2-1t-a32b", "qwen2-vl-72b", "hubert-xlarge"]
B, SEQ = 4, 32
# mamba2 against the reference: at 32 tokens a chunk's decay overflows the
# reference's masked exp and its gradients are NaN (ROADMAP C8; held
# separately below), so the two packages' gradients are compared at 4 (at 6 already
# 514 of its gradient entries are NaN)
SEQ_REF = {"mamba2-370m": 4}


def _setup(arch_id="granite-3-2b", num_mb=1, batch=B, seq=SEQ):
    cfg = get_arch(arch_id, smoke=True)
    shape = ShapeConfig("t", seq, batch, "train", num_microbatches=num_mb)
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    return cfg, shape, state, TokenPipeline(cfg, shape).batch(0)


def _snapshot(model):
    return [p.detach().clone() for p in model.parameters()]


# ------------------------------------ tests/test_train_step.py's cases ----
def test_train_step_updates_params_and_metrics():
    cfg, shape, state, batch = _setup()
    before = _snapshot(state.params)
    new_state, metrics = make_train_step(cfg, shape)(state, batch)
    assert int(new_state.step) == 1
    assert int(new_state.opt_state.step) == 1
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    deltas = [float((a - b).abs().max())
              for a, b in zip(before, new_state.params.parameters())]
    assert max(deltas) > 0
    assert new_state.params is state.params      # updated in place


def test_loss_decreases_over_steps():
    cfg, shape, state, batch = _setup()
    step_fn = make_train_step(cfg, shape, lr=3e-3)
    losses = []
    for _ in range(8):
        state, m = step_fn(state, batch)  # same batch: must overfit
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_microbatched_grads_match_unbatched():
    cfg, shape1, s1, batch = _setup(num_mb=1)
    _, shape4, s4, _ = _setup(num_mb=4)
    n1, m1 = make_train_step(cfg, shape1)(s1, batch)
    n4, m4 = make_train_step(cfg, shape4)(s4, batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    for a, b in zip(n1.params.parameters(), n4.params.parameters()):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(),
                                   atol=5e-4, rtol=5e-3)


def test_moe_arch_train_step_runs():
    cfg, shape, state, batch = _setup("kimi-k2-1t-a32b", num_mb=2)
    state, metrics = make_train_step(cfg, shape)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["aux"]) > 0   # router aux loss present


def test_serving_models_build_no_graph():
    cfg = get_arch("granite-3-2b", smoke=True)
    model = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    logits, _ = tf.forward_train(model, {"tokens": tokens}, cfg)
    assert not logits.requires_grad
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    logits, _ = tf.forward_train(state.params, {"tokens": tokens}, cfg)
    assert logits.requires_grad


def test_effective_microbatches_match_reference():
    """The microbatches halved until each divides over the dp degree,
    as the reference's, on both production meshes and small ones."""
    from jax.sharding import AbstractMesh

    from repro.configs.base import SHAPES as JSHAPES
    from repro.models.sharding import Rules as JRules
    from repro.train.step import effective_microbatches as jeffective
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import Rules

    meshes = [((16, 16), ("data", "model")),
              ((2, 16, 16), ("pod", "data", "model")),
              ((4, 2), ("data", "model")), ((1, 1), ("data", "model"))]
    shapes = [(SHAPES[k], JSHAPES[k]) for k in SHAPES] + [
        (ShapeConfig("s", 32, b, "train", num_microbatches=m),
         JShapeConfig("s", 32, b, "train", num_microbatches=m))
        for b, m in ((8, 4), (96, 16), (6, 2))]
    for dims, axes in meshes:
        rules = Rules(make_mesh(dims, axes,
                                devices=["cpu"] * int(np.prod(dims))))
        jrules = JRules(AbstractMesh(dims, axes))
        for shape, jshape in shapes:
            assert effective_microbatches(shape, rules) == \
                jeffective(jshape, jrules), (dims, shape)
    _, shape, _, _ = _setup()
    assert effective_microbatches(shape, None) == 1


def test_accumulation_dtype_follows_the_reference():
    """bf16 accumulation when the parameters are bf16 or ``zero1`` is set:
    two microbatches accumulated in bf16 differ from float32's."""
    cfg, shape, _, batch = _setup(num_mb=2)
    outs = {}
    for zero1 in (False, True):
        s = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        n, m = make_train_step(cfg, shape, zero1=zero1)(s, batch)
        outs[zero1] = float(m["grad_norm"])
    assert outs[False] != outs[True]
    assert abs(outs[False] - outs[True]) < 1e-2 * outs[False]


# -------------------------------------------- parity with the reference ----
def _reference(arch_id: str, seq: int | None = None):
    """The reference on its own init (AdamW state) and batch: the numpy
    TrainState, the batch, (loss, nll, aux), the grads and their global
    norm."""
    return _reference_at(arch_id, seq or SEQ_REF.get(arch_id, SEQ))


@functools.cache
def _reference_at(arch_id: str, seq: int):
    jcfg = jget_arch(arch_id, smoke=True)
    state = jinit_train_state(jcfg, jax.random.PRNGKey(0))
    batch = JTokenPipeline(jcfg, JShapeConfig("t", seq, B, "train")).batch(0)

    def loss(params, b):
        return jtf.loss_fn(params, b, jcfg)

    (l, (nll, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        state.params, {k: jnp.asarray(v) for k, v in batch.items()})
    to_np = functools.partial(jax.tree.map, np.asarray)
    return dict(state=to_np(state), batch=batch,
                metrics=(float(l), float(nll), float(aux)),
                grads=to_np(grads), grad_norm=float(jglobal_norm(grads)))


@functools.cache
def _ref_update(arch_id: str, optimizer: str):
    """(params, opt_state) after the reference's ``optimizer`` took one
    step from its init on ``_reference``'s grads, numpy."""
    ref = _reference(arch_id)
    opt = jmake_optimizer(optimizer)
    params = jax.tree.map(jnp.asarray, ref["state"].params)
    new_p, new_s, _ = jax.jit(opt.update)(
        jax.tree.map(jnp.asarray, ref["grads"]), opt.init(params), params)
    return jax.tree.map(np.asarray, new_p), jax.tree.map(np.asarray, new_s)


def _port(arch_id: str, seq: int | None = None):
    ref = _reference(arch_id, seq)
    cfg = get_arch(arch_id, smoke=True)
    return cfg, ref, train_state_from_jax(ref["state"], cfg, "cpu")


def _bf16(cfg) -> bool:
    return cfg.param_dtype == "bfloat16"


def _grads_from_jax(tree, model):
    """The reference's gradient tree as the port's: stacked leaves as a
    Stack of per-layer tensors."""
    out = {}
    for (path, leaf), (_, g) in zip(T.flatten(model.param_tree()),
                                    T.flatten(tree)):
        t = (T.Stack(tf.to_tensor(g[i]) for i in range(len(leaf)))
             if isinstance(leaf, T.Stack) else tf.to_tensor(g))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_step_metrics_and_grads_equal_the_reference(arch_id):
    cfg, ref, state = _port(arch_id)
    rel = 1e-2 if _bf16(cfg) else 1e-5
    loss, nll, aux, grads = loss_and_grads(state.params, ref["batch"], cfg)
    for got, want in zip((loss, nll, aux), ref["metrics"]):
        np.testing.assert_allclose(float(got), want, rtol=rel, atol=rel)
    flat_g = [(p, g.stacked() if isinstance(g, T.Stack) else g)
              for p, g in T.flatten(grads)]
    flat_w = T.flatten(ref["grads"])
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    gmax = max(float(np.abs(np.asarray(w, np.float32)).max())
               for _, w in flat_w)
    rtol, atol = (2e-2, 2e-2 * gmax) if _bf16(cfg) else (1e-4, 1e-5 * gmax)
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol, err_msg=T.name(path))
    # the whole step's metrics
    _, _, state = _port(arch_id)
    _, metrics = make_train_step(cfg)(state, ref["batch"])
    np.testing.assert_allclose(float(metrics["grad_norm"]), ref["grad_norm"],
                               rtol=rel)
    np.testing.assert_allclose(float(metrics["loss"]), ref["metrics"][0],
                               rtol=rel, atol=rel)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch_id", FAMILIES)
def test_optimizer_on_the_reference_grads_equals_the_reference(arch_id,
                                                               optimizer):
    cfg, ref, state = _port(arch_id)
    want_params, want_opt = _ref_update(arch_id, optimizer)
    opt = make_optimizer(optimizer)
    grads = _grads_from_jax(ref["grads"], state.params)
    tree = state.params.param_tree()
    _, new_opt, gnorm = opt.update(grads, opt.init(tree), tree)
    np.testing.assert_allclose(float(gnorm), ref["grad_norm"], rtol=1e-6)
    got = train_state_to_numpy(state._replace(opt_state=new_opt))
    p_tol = dict(rtol=2.0 ** -8, atol=2.0 ** -8) if _bf16(cfg) \
        else dict(rtol=1e-6, atol=1e-6)
    for (path, a), (_, b) in zip(T.flatten(got.params),
                                 T.flatten(want_params)):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), **p_tol,
                                   err_msg=T.name(path))
    assert int(got.opt_state.step) == int(want_opt.step) == 1
    for (path, a), (_, b) in zip(T.flatten(tuple(got.opt_state)[1:]),
                                 T.flatten(tuple(want_opt)[1:]), strict=True):
        assert a.shape == b.shape, T.name(path)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                   err_msg=T.name(path))


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_remat_changes_no_value(arch_id):
    """none / full / dots: loss and every gradient equal bit for bit (the
    hybrid with two blocks, so that one remat'd block feeds another)."""
    extra = {}
    if arch_id == "recurrentgemma-9b":
        extra = dict(num_layers=8)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(get_arch(arch_id, smoke=True), remat=remat,
                                  **extra)
        state = init_train_state(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        batch = TokenPipeline(cfg, ShapeConfig("t", SEQ, B, "train")).batch(1)
        loss, _, _, grads = loss_and_grads(state.params, batch, cfg)
        out[remat] = (loss, T.layer_leaves(grads))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1], strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_two_microbatches_equal_one(arch_id):
    """From the reference's state: the step on two microbatches gives the
    unbatched step's parameters within the reference test's bounds. An MoE
    routes each microbatch with its own capacity (the reference's
    microbatches do too), so for arctic and kimi the losses agree to 1e-2
    and the parameters are not compared."""
    cfg, ref, s1 = _port(arch_id)
    _, _, s2 = _port(arch_id)
    n1, m1 = make_train_step(cfg, ShapeConfig("t", SEQ, B, "train"))(
        s1, ref["batch"])
    n2, m2 = make_train_step(
        cfg, ShapeConfig("t", SEQ, B, "train", num_microbatches=2))(
        s2, ref["batch"])
    if cfg.family == "moe":
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   rtol=1e-2)
        return
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    for a, b in zip(n1.params.parameters(), n2.params.parameters()):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(),
                                   atol=5e-4, rtol=5e-3)


def test_microbatches_split_positions3_on_its_batch_axis():
    """qwen2-vl's M-RoPE positions (3, B, T): each microbatch takes its
    rows of the batch axis, as the reference's split does."""
    from repro_torch.train.step import _split

    p3 = torch.arange(3 * 4 * 2).reshape(3, 4, 2)
    tokens = torch.arange(8).reshape(4, 2)
    mbs = _split({"positions3": p3, "tokens": tokens,
                  "scalar": torch.tensor(1.0)}, 2)
    assert torch.equal(mbs[1]["positions3"], p3[:, 2:])
    assert torch.equal(mbs[1]["tokens"], tokens[2:])
    assert float(mbs[0]["scalar"]) == 1.0
    with pytest.raises(ValueError):
        _split({"tokens": tokens}, 3)


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """ROADMAP C8: at 32 tokens (one chunk of the SMOKE config's 32) the
    reference's masked exp overflows and NaN reaches its gradients; the
    port masks before the exp: the same loss, finite gradients that train."""
    cfg, ref, state = _port("mamba2-370m", SEQ)
    assert any(np.isnan(np.asarray(g)).any() for g in T.leaves(ref["grads"]))
    loss, _, _, grads = loss_and_grads(state.params, ref["batch"], cfg)
    np.testing.assert_allclose(float(loss), ref["metrics"][0], rtol=1e-5)
    assert all(torch.isfinite(g).all() for g in T.layer_leaves(grads))
    step = make_train_step(cfg, lr=3e-3)
    losses = [float(step(state, ref["batch"])[1]["loss"]) for _ in range(4)]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("arch_id", ["granite-3-2b", "kimi-k2-1t-a32b"])
def test_train_state_round_trips_bit_for_bit(arch_id):
    ref = _reference(arch_id)
    cfg = get_arch(arch_id, smoke=True)
    back = train_state_to_numpy(train_state_from_jax(ref["state"], cfg, "cpu"))
    flat_a, flat_b = T.flatten(back), T.flatten(ref["state"])
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, T.name(path)
        np.testing.assert_array_equal(a, b, err_msg=T.name(path))


def _product_calls(remat: str) -> tuple[dict, dict]:
    """The aten ``mm`` and ``bmm`` calls of granite's SMOKE forward and of
    its backward pass (recomputed forward products included) under
    ``remat``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    cfg = dataclasses.replace(get_arch("granite-3-2b", smoke=True),
                              remat=remat)
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = TokenPipeline(cfg, ShapeConfig("t", 16, 2, "train")).batch(0)
    fwd, bwd = Count(), Count()
    with fwd:
        loss, _ = tf.loss_fn(state.params, batch, cfg)
    with bwd:
        loss.backward()
    return fwd.n, bwd.n


def test_dots_keeps_the_weight_products_and_recomputes_the_rest():
    """``dots`` recomputes no weight product (``aten.mm``: every q/k/v/o
    projection and MLP product) and every batched attention product
    (``aten.bmm``); ``full`` recomputes the weight products too (up to
    the last one whose output a gradient needs: the recompute stops
    there)."""
    fwd, none = _product_calls("none")
    _, dots = _product_calls("dots")
    _, full = _product_calls("full")
    # q, k, v, o and the three MLP products of each of the 2 layers, and
    # the head
    assert fwd["mm"] == 7 * 2 + 1 and fwd["bmm"] > 0
    assert dots["mm"] == none["mm"]
    assert dots["bmm"] == none["bmm"] + fwd["bmm"]
    assert full["mm"] > none["mm"]
    assert full["bmm"] == dots["bmm"]


# ------------------------------------------------- bf16 activations ----
# granite's SMOKE step with activation_dtype="bfloat16", port against
# reference (test_bf16_activation_step_equals_the_reference states how
# these were measured); BF16_LOSS_VS_F32_REL is also chip_smoke.py's
# BF16_LOSS_REL, the bound its full-width bf16 step is held to
BF16_LOSS_REL, BF16_GNORM_REL = 2.0 ** -11, 2.0 ** -8
BF16_LOSS_VS_F32_REL = 2.0 ** -9
BF16_FAR_SHARE = 2.0 ** -7


@functools.cache
def _reference_bf16_step(seed: int):
    """The reference's granite SMOKE state from ``PRNGKey(seed)``, its
    batch from ``seed``, and its jitted step with bf16 activations: the
    state before and after and the metrics, numpy."""
    jcfg = dataclasses.replace(jget_arch("granite-3-2b", smoke=True),
                               activation_dtype="bfloat16")
    jshape = JShapeConfig("t", SEQ, B, "train")
    state = jinit_train_state(jcfg, jax.random.PRNGKey(seed))
    batch = JTokenPipeline(jcfg, jshape, seed=seed).batch(0)
    to_np = functools.partial(jax.tree.map, np.asarray)
    before = to_np(state)
    new, m = jax.jit(jmake_train_step(jcfg, jshape))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(state=before, batch=batch, new=to_np(new),
                loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))


def _bf16_products(fn):
    """``fn()`` under a dispatch mode that counts the matrix products (aten
    ``mm``, ``bmm``, ``addmm``, ``baddbmm``) and those with a bfloat16
    operand: (fn's result, (bfloat16 products, products))."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    products = {aten.mm.default, aten.bmm.default, aten.addmm.default,
                aten.baddbmm.default}
    seen = [0, 0]

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in products:
                seen[1] += 1
                seen[0] += any(isinstance(a, torch.Tensor)
                               and a.dtype == torch.bfloat16 for a in args)
            return func(*args, **(kwargs or {}))

    with _Count():
        out = fn()
    return out, tuple(seen)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_activation_step_equals_the_reference(seed):
    """One AdamW step of granite's SMOKE config with bf16 activations
    (float32 parameters and optimizer) from the reference's state, against
    the reference's step. Measured over seeds 0-2: the loss 4.6e-5 to
    6.9e-5 relative apart, held at 2^-11; the grad norm 3.1e-4 to 9.5e-4,
    held at 2^-8; the port's bf16 loss against its own float32 loss on
    the same parameters 1.3e-5 to 2.3e-4, held at 2^-9. AdamW's first step
    moves a parameter by lr x g / (|g| + eps), within (-lr, lr): where a
    gradient entry within bf16 rounding of 0 takes the other sign, the two
    updates lie up to 2 lr apart, as measured (6.0e-4 at lr 3e-4). So every
    parameter is held within 2 lr (plus 2^-8 of it and 1e-6) and at most
    2^-7 of them more than lr / 2 apart (0.22-0.25% measured). The bf16
    path must be in effect: its loss differs from the float32 loss, and
    its forward's matrix products take bf16 operands where the float32
    forward's take none."""
    ref = _reference_bf16_step(seed)
    cfg = get_arch("granite-3-2b", smoke=True)
    bf16 = dataclasses.replace(cfg, activation_dtype="bfloat16")
    assert bf16.optimizer == "adamw"
    state = train_state_from_jax(ref["state"], bf16, "cpu")
    batch = {k: tf.to_tensor(v, "cpu") for k, v in ref["batch"].items()}
    with torch.no_grad():
        loss32, (n32, _) = _bf16_products(
            lambda: float(tf.loss_fn(state.params, batch, cfg)[0]))
        loss16, (n16, n) = _bf16_products(
            lambda: float(tf.loss_fn(state.params, batch, bf16)[0]))
    assert n32 == 0 and 0 < n16 <= n, (n32, n16, n)
    assert loss16 != loss32
    np.testing.assert_allclose(loss16, loss32, rtol=BF16_LOSS_VS_F32_REL)
    new, metrics = make_train_step(bf16, ShapeConfig("t", SEQ, B, "train"))(
        state, ref["batch"])
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"],
                               rtol=BF16_LOSS_REL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), ref["grad_norm"],
                               rtol=BF16_GNORM_REL)
    got = train_state_to_numpy(new)
    assert int(got.step) == int(ref["new"].step) == 1
    lr = make_optimizer("adamw").lr
    far = total = 0
    for (path, a), (_, b) in zip(T.flatten(got.params),
                                 T.flatten(ref["new"].params), strict=True):
        diff = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
        assert diff.max() <= 2 * lr * (1 + 2.0 ** -8) + 1e-6, T.name(path)
        far += int((diff > lr / 2).sum())
        total += diff.size
    assert far <= BF16_FAR_SHARE * total, far / total
