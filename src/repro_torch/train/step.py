"""train_step / serve_step builders: ``repro.train.step`` in PyTorch.

``make_train_step`` returns a (state, batch) -> (state, metrics) function
with the reference's microbatching: the batch is split contiguously
(``positions3`` on its own batch axis), each microbatch's gradients are
accumulated in ``accum_dtype`` in microbatch order (into the first
microbatch's buffers: the bits are those of the reference's zero-filled
accumulator), then multiplied by ``1/num_mb``. A parameter's gradient is
folded into its accumulator as soon as the backward pass has produced it
(a post-accumulate hook), so one microbatch's gradients never sit beside
the accumulated ones. The optimizer then updates the state in place
(``repro_torch.optim``): the state passed in is the state returned, as the
reference's driver donates it.

With ``rules`` (``models.sharding.Rules``) the step runs on DTensors, as
the reference runs under GSPMD: ``shard_train_state`` lays the parameters
and the optimizer moments out by ``launch.shardings.state_specs`` (in
place: the model's parameters become DTensor parameters), each
microbatch is cut from the global batch and laid out over the dp axes
(``_shard_batch``), and each gradient comes back, reduce-scattered, in its
parameter's layout. ``zero1`` gathers a copy of the parameters without the
FSDP axis once per step, outside the microbatch loop, accumulates the
gradients in that layout and reduce-scatters them once. PyTorch runs
eagerly, so the builders return plain closures where the reference returns
functions for ``jax.jit``. ``make_serve_step`` returns the decode-one-token
function, ``make_prefill`` the prompt forward that returns logits.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer as tf
from repro_torch.models.sharding import Rules, layer_spec, spec_leaves, to_layout
from repro_torch.optim import AdafactorState, AdamWState, make_optimizer


class TrainState(NamedTuple):
    params: tf.Transformer
    opt_state: object
    step: torch.Tensor


def _trainable(model: tf.Transformer) -> tf.Transformer:
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     lr: float | None = None, *,
                     device: str | torch.device = "cuda") -> TrainState:
    """A model drawn from ``generator`` (as ``init_params``), its parameters
    trainable, the config's optimizer state and step 0, on ``device``."""
    model = _trainable(tf.init_params(cfg, generator, device=device))
    opt = make_optimizer(cfg.optimizer, lr)
    return TrainState(params=model, opt_state=opt.init(model.param_tree()),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def _shard_batch(batch: dict, rules: Rules | None) -> dict:
    if rules is None:
        return batch
    out = {}
    for k, v in batch.items():
        if k == "positions3":
            out[k] = rules.shard(v, None, "dp", None)
        elif v.ndim >= 2:
            out[k] = rules.shard(v, "dp", *([None] * (v.ndim - 1)))
        else:
            out[k] = v
    return out


def effective_microbatches(shape: ShapeConfig, rules: Rules | None) -> int:
    """Per-microbatch batch must stay divisible by the dp degree, or part
    of the mesh idles: the microbatches are halved until it does."""
    num_mb = shape.num_microbatches
    if rules is None:
        return num_mb
    dp_size = math.prod(rules.sizes[a] for a in rules.dp)
    while num_mb > 1 and (shape.global_batch // num_mb) % dp_size != 0:
        num_mb //= 2
    return num_mb


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _replace_param(model, name: str, new: torch.nn.Parameter) -> None:
    owner_name, _, leaf = name.rpartition(".")
    owner = model.get_submodule(owner_name) if owner_name else model
    if isinstance(owner, torch.nn.ParameterDict):
        owner[leaf] = new
    else:
        setattr(owner, leaf, new)


def _lay_out_params(model, placements_of, fn=None) -> dict:
    """Replace each parameter ``p`` of ``model`` by a parameter holding
    ``to_layout(p, *placements_of[id(p)])`` (or ``fn(p)``); returns name ->
    the parameter it replaced."""
    old = {}
    for name, p in list(model.named_parameters()):
        if fn is not None:
            t = fn(p.detach())
        else:
            t = to_layout(p.detach(), *placements_of[id(p)])
        new = torch.nn.Parameter(t, requires_grad=p.requires_grad)
        _replace_param(model, name, new)
        old[name] = p
    return old


def _param_placements(model, specs, rules: Rules) -> dict:
    """id(per-layer parameter) -> (device mesh, placements) of ``specs``."""
    out = {}
    mesh = rules.device_mesh
    flat = spec_leaves(specs)
    for (path, leaf), (spath, spec) in zip(T.flatten(model.param_tree()),
                                           flat, strict=True):
        assert path == spath, (path, spath)
        stacked = isinstance(leaf, T.Stack)
        pl = rules.placements(layer_spec(spec, stacked))
        for t in (leaf if stacked else (leaf,)):
            out[id(t)] = (mesh, pl)
    return out


def shard_model(model, rules: Rules):
    """``model``'s parameters replaced in place by DTensor parameters laid
    out by ``param_specs``; returns the model."""
    from repro_torch.models.sharding import param_specs

    if not _is_dtensor(model.final["scale"]):
        _lay_out_params(model, _param_placements(
            model, param_specs(model, rules), rules))
    return model


def shard_train_state(state: TrainState, rules: Rules) -> TrainState:
    """``state`` laid out by ``launch.shardings.state_specs``: the model's
    parameters are replaced in place by DTensor parameters, the optimizer
    moments become DTensors (the step counters stay plain). A state that
    is laid out already comes back as it is."""
    from repro_torch.launch.shardings import state_specs

    model = state.params
    if _is_dtensor(model.final["scale"]):
        return state
    specs = state_specs(state, rules)
    _lay_out_params(model, _param_placements(model, specs.params, rules))
    opt = state.opt_state
    mesh = rules.device_mesh
    fields = []
    for f in opt._fields:
        tree = getattr(opt, f)
        if f == "step":
            fields.append(tree)
            continue
        it = iter(spec_leaves(getattr(specs.opt_state, f)))
        fields.append(T.map(lambda t: to_layout(
            t, mesh, rules.placements(next(it)[1])), tree))
    return TrainState(model, type(opt)(*fields), state.step)


def _split(batch: dict, num_mb: int) -> list[dict]:
    """The batch as ``num_mb`` contiguous microbatches (views);
    ``positions3`` (3, B, T) is split along its batch axis, a scalar goes
    to every microbatch."""
    out = [{} for _ in range(num_mb)]
    for k, v in batch.items():
        axis = 1 if k == "positions3" else 0
        if v.ndim == 0:
            parts = [v] * num_mb
        else:
            if v.shape[axis] % num_mb:
                raise ValueError(f"batch {k!r} of {v.shape[axis]} does not "
                                 f"split into {num_mb} microbatches")
            parts = torch.chunk(v, num_mb, dim=axis)
        for mb, part in zip(out, parts):
            mb[k] = part
    return out


def loss_and_grads(model: tf.Transformer, batch: dict, cfg: ArchConfig,
                   num_mb: int = 1, accum_dtype=None, rules=None):
    """(loss, nll, aux, grads) of ``batch`` over ``num_mb`` microbatches,
    as the reference's train step computes them before its optimizer:
    ``grads`` in the tree of ``model.param_tree()``; with one microbatch in
    the parameters' dtype, else accumulated in ``accum_dtype`` (default
    float32) and returned as float32 times ``1/num_mb``.

    With ``rules`` the parameters are DTensors: each microbatch is laid
    out over dp (``_shard_batch``) and each gradient is redistributed to
    its parameter's layout before it is accumulated."""
    dev = model.device
    batch = {k: tf.to_tensor(v, dev) for k, v in batch.items()}
    mbs = _split(batch, num_mb) if num_mb > 1 else [batch]
    mbs = [_shard_batch(mb, rules) for mb in mbs]
    accum_dtype = accum_dtype or torch.float32
    params = list(model.parameters())
    acc: dict = {}

    def fold(p):
        g, p.grad = p.grad, None
        if rules is not None:
            g = to_layout(g, p.device_mesh, p.placements)
        if num_mb > 1:
            g = g.to(accum_dtype)
        prev = acc.get(id(p))
        if prev is None:
            acc[id(p)] = g
        else:
            prev.add_(g)

    for p in params:
        p.grad = None
    hooks = [p.register_post_accumulate_grad_hook(fold) for p in params]
    try:
        sums = None
        for mb in mbs:
            loss, (nll, aux) = tf.loss_fn(model, mb, cfg, rules=rules)
            loss.backward()
            terms = (loss.detach(), nll.detach(), aux.detach())
            sums = terms if sums is None else tuple(
                a + b for a, b in zip(sums, terms))
    finally:
        for h in hooks:
            h.remove()

    def grad(p):
        g = acc.get(id(p))
        if g is None:   # a parameter the loss does not read
            return torch.zeros_like(p, dtype=torch.float32 if num_mb > 1
                                    else p.dtype)
        if num_mb == 1:
            return g
        inv = 1.0 / num_mb
        return g.mul_(inv) if g.dtype == torch.float32 \
            else g.to(torch.float32) * inv

    grads = T.map(lambda leaf: T.Stack(grad(p) for p in leaf)
                  if isinstance(leaf, T.Stack) else grad(leaf),
                  model.param_tree())
    if num_mb > 1:
        inv = 1.0 / num_mb
        sums = tuple(s * inv for s in sums)
    loss, nll, aux = sums
    return loss, nll, aux, grads


def make_train_step(
    cfg: ArchConfig,
    shape: ShapeConfig | None = None,
    rules=None,
    *,
    accum_dtype=None,
    lr: float | None = None,
    zero1: bool = False,
):
    """The reference's train step. ``accum_dtype`` defaults to bfloat16
    where the parameters are bfloat16 or ``zero1`` is set (ZeRO-1 then
    keeps a bf16 accumulation copy), float32 otherwise.

    ``zero1`` (with ``rules``): hoist the FSDP parameter all-gather out of
    the microbatch loop. FSDP re-gathers every weight in every
    microbatch's forward and backward; ZeRO-1 gathers once, computes all
    microbatches against the gathered copy (accumulating gradients in the
    gathered layout) and reduce-scatters once into the fsdp-sharded
    optimizer layout. With ``rules`` the metrics are plain tensors (each
    reduced over every shard)."""
    opt = make_optimizer(cfg.optimizer, lr)
    num_mb = effective_microbatches(shape, rules) if shape else 1
    if accum_dtype is None:
        accum_dtype = (torch.bfloat16
                       if (cfg.param_dtype == "bfloat16" or zero1)
                       else torch.float32)

    if zero1 and rules is not None:
        nofsdp_rules = Rules(rules.device_mesh)
        nofsdp_rules.fsdp = ()
    else:
        nofsdp_rules = None

    def train_step(state: TrainState, batch: dict):
        if rules is not None:
            state = shard_train_state(state, rules)
        model = state.params
        with _sharded(rules):
            if nofsdp_rules is None:
                loss, nll, aux, grads = loss_and_grads(
                    model, batch, cfg, num_mb, accum_dtype, rules)
            else:
                loss, nll, aux, grads = _zero1_grads(
                    model, batch, cfg, num_mb, accum_dtype, rules,
                    nofsdp_rules)
            _, new_opt, gnorm = opt.update(grads, state.opt_state,
                                           model.param_tree())
        metrics = {"loss": loss, "nll": nll, "aux": aux, "grad_norm": gnorm}
        if rules is not None:
            metrics = {k: v.full_tensor() if _is_dtensor(v) else v
                       for k, v in metrics.items()}
        return TrainState(model, new_opt, state.step + 1), metrics

    return train_step


def unshard_train_state(state: TrainState) -> TrainState:
    """The inverse of ``shard_train_state``: every DTensor of ``state``
    replaced by its full value (gathered on every rank), the model's
    parameters in place."""
    def whole(t):
        return t.full_tensor() if _is_dtensor(t) else t

    model = state.params
    _lay_out_params(model, None, whole)
    opt = state.opt_state
    return TrainState(model, type(opt)(*(T.map(whole, tree) for tree in opt)),
                      state.step)


def _sharded(rules):
    """Plain tensors met beside DTensors count as replicated (step
    counters, masks, RoPE tables) while a sharded step runs."""
    if rules is None:
        return contextlib.nullcontext()
    from repro_torch.models.sharding import implicit_replication

    return implicit_replication()


def _zero1_grads(model, batch, cfg, num_mb, accum_dtype, rules,
                 nofsdp_rules):
    """``loss_and_grads`` against a copy of the parameters gathered once
    into ``nofsdp_rules``' layout; the accumulated gradients are
    reduce-scattered once, into the parameters' own layout."""
    from repro_torch.models.sharding import param_specs

    gathered = _param_placements(model, param_specs(model, nofsdp_rules),
                                 nofsdp_rules)
    own = [(p.device_mesh, p.placements)
           for p in T.layer_leaves(model.param_tree())]
    old = _lay_out_params(model, gathered)
    try:
        loss, nll, aux, grads = loss_and_grads(
            model, batch, cfg, num_mb, accum_dtype, rules)
    finally:
        for name, p in old.items():
            _replace_param(model, name, p)
    it = iter(to_layout(g, *pl)
              for g, pl in zip(T.layer_leaves(grads), own, strict=True))
    grads = T.map(lambda leaf: T.Stack(next(it) for _ in leaf)
                  if isinstance(leaf, T.Stack) else next(it), grads)
    return loss, nll, aux, grads


# ---------------------------------------------- the reference's TrainState
def _opt_state_type(fields: tuple):
    for cls in (AdamWState, AdafactorState):
        if tuple(fields) == cls._fields:
            return cls
    raise ValueError(f"unknown optimizer state fields {fields}")


def train_state_from_jax(state, cfg: ArchConfig,
                         device: str | torch.device = "cuda") -> TrainState:
    """The port's TrainState from the reference's given as numpy arrays
    (``jax.tree.map(np.asarray, state)``): the parameters through
    ``params_from_jax`` (trainable), the optimizer state (``m``/``v`` or
    ``vr``/``vc``, in the reference's stacked shapes) and both step
    counters copied bit for bit."""
    model = _trainable(tf.params_from_jax(state.params, cfg, device))
    dev = model.device
    opt = state.opt_state
    cls = _opt_state_type(opt._fields)
    opt_state = cls(*(T.map(lambda a: tf.to_tensor(a, dev), getattr(opt, f))
                      for f in cls._fields))
    return TrainState(model, opt_state, tf.to_tensor(state.step, dev))


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The inverse of ``train_state_from_jax``: the reference's trees of
    numpy arrays (parameters stacked as ``params_to_numpy`` stacks them),
    each a copy, so the next in-place step leaves it as it was."""
    def copy(a):
        return np.array(tf.to_numpy(a) if isinstance(a, torch.Tensor) else a,
                        copy=True)

    opt = state.opt_state
    return TrainState(T.map(copy, tf.params_to_numpy(state.params)),
                      type(opt)(*T.map(copy, tuple(opt))), copy(state.step))


# ----------------------------------------------------------------- serving
def make_serve_step(cfg: ArchConfig):
    """decode one token: (model, cache, token, pos[, positions3])."""

    def serve_step(model, cache, token, pos, positions3=None):
        return tf.decode_step(model, cache, token, pos, cfg, positions3)

    return serve_step


def make_prefill(cfg: ArchConfig):
    def prefill_step(model, batch):
        logits, aux = tf.forward_train(model, batch, cfg)
        return logits

    return prefill_step
