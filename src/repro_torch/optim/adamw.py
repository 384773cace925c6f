"""AdamW as plain functions on tensors: ``repro.optim.adamw`` in PyTorch.

The arithmetic is the reference's line for line: a global-norm clip, then
``m``, ``v`` and the bias-corrected step with the weight decay added to the
update (not ``torch.optim.AdamW``'s decoupled form, which rounds
differently). The port updates in place, leaf by leaf: each parameter and
its ``m`` and ``v`` are overwritten (the reference returns new trees, and
its driver donates the old state, ``donate_argnums=(0,)``). At
granite-3-2b's full width a second copy of params, ``m`` and ``v`` would
add 31.6 GB to about 56 GB, more than the card holds. ``m`` and ``v`` are
held in the reference's stacked shapes; a :class:`~repro_torch.tree.Stack`
parameter is updated layer by layer through views of them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import tree as T


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def _zeros_f32(p) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=T.layer_leaves(params)[0].device)


def layer_items(params, *trees):
    """(parameter, its leaf in each of ``trees``) one layer at a time: a
    :class:`~repro_torch.tree.Stack` parameter's ``i``-th tensor with the
    ``i``-th slice (a view) of the others' stacked leaves."""
    for p, *others in T.zip_leaves(params, *trees):
        if isinstance(p, T.Stack):
            for i in range(len(p)):
                yield (p[i], *(leaf[i] for leaf in others))
        else:
            yield (p, *others)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, a Stack layer by layer
    (the reference sums over stacked leaves: equal to rounding)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in T.layer_leaves(tree)))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        return AdamWState(step=_step0(params), m=T.map(_zeros_f32, params),
                          v=T.map(_zeros_f32, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """Returns (params, state, grad norm); ``params`` and the state's
        ``m`` and ``v`` are updated in place."""
        gnorm = global_norm(grads)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        t = step.to(torch.float32)
        b1c = 1 - self.b1 ** t
        b2c = 1 - self.b2 ** t
        for p, g, m, v in layer_items(params, grads, state.m, state.v):
            g = g.to(torch.float32) * scale
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            mh, vh = m / b1c, v / b2c
            delta = mh / (torch.sqrt(vh) + self.eps) \
                + self.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - self.lr * delta).to(p.dtype))
        return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
