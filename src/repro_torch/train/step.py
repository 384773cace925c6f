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

The port runs on one device: ``rules`` other than None are refused
(sharding rules come with ROADMAP A13d); ``rules=None`` is what the
reference computes with a one-device ``Rules``. PyTorch runs eagerly, so
the builders return plain closures where the reference returns functions
for ``jax.jit``. ``make_serve_step`` returns the decode-one-token function,
``make_prefill`` the prompt forward that returns logits.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer as tf
from repro_torch.models.context import refuse_rules
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


def effective_microbatches(shape: ShapeConfig, rules=None) -> int:
    """The shape's microbatches: the reference halves them until each
    divides over the dp degree, which is 1 without rules."""
    refuse_rules(rules)
    return shape.num_microbatches


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
                   num_mb: int = 1, accum_dtype=None):
    """(loss, nll, aux, grads) of ``batch`` over ``num_mb`` microbatches,
    as the reference's train step computes them before its optimizer:
    ``grads`` in the tree of ``model.param_tree()``; with one microbatch in
    the parameters' dtype, else accumulated in ``accum_dtype`` (default
    float32) and returned as float32 times ``1/num_mb``."""
    dev = model.device
    batch = {k: tf.to_tensor(v, dev) for k, v in batch.items()}
    mbs = _split(batch, num_mb) if num_mb > 1 else [batch]
    accum_dtype = accum_dtype or torch.float32
    params = list(model.parameters())
    acc: dict = {}

    def fold(p):
        g, p.grad = p.grad, None
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
            loss, (nll, aux) = tf.loss_fn(model, mb, cfg)
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
    """The reference's train step on one device. ``accum_dtype`` defaults
    to bfloat16 where the parameters are bfloat16 or ``zero1`` is set (the
    reference's ZeRO-1 then keeps a bf16 accumulation copy), float32
    otherwise."""
    refuse_rules(rules)
    opt = make_optimizer(cfg.optimizer, lr)
    num_mb = effective_microbatches(shape, rules) if shape else 1
    if accum_dtype is None:
        accum_dtype = (torch.bfloat16
                       if (cfg.param_dtype == "bfloat16" or zero1)
                       else torch.float32)

    def train_step(state: TrainState, batch: dict):
        model = state.params
        loss, nll, aux, grads = loss_and_grads(model, batch, cfg, num_mb,
                                               accum_dtype)
        _, new_opt, gnorm = opt.update(grads, state.opt_state,
                                       model.param_tree())
        metrics = {"loss": loss, "nll": nll, "aux": aux, "grad_norm": gnorm}
        return TrainState(model, new_opt, state.step + 1), metrics

    return train_step


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
