"""Adafactor (Shazeer & Stern 2018) with factored second moments and no
first moment: ``repro.optim.adafactor`` in PyTorch, updated in place as
``AdamW`` is (``repro_torch.optim.adamw``).

The per-leaf rule follows the reference's tree. The reference scans a leaf
of rank >= 3 whose leading dimension is > 1 slice by slice, and that
leading dimension is the layer stack. So a
:class:`~repro_torch.tree.Stack` parameter of rank >= 3 stacked over more
than one layer is updated layer by layer, each layer's tensor as one slice
(an MoE expert stack (E, d, ff) is not scanned again over its experts,
which would change the RMS clip). A stacked leaf of rank 2 (a per-layer
vector such as a norm scale) is one factored matrix in the reference:
it is stacked, updated whole and written back. A leaf that the reference
does not stack (embeddings, the hybrid's ``tail`` layers) keeps the
reference's rule on its own shape, scan included. ``vr`` and ``vc`` are
held in the reference's stacked shapes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import tree as T
from repro_torch.optim.adamw import AdamW, _step0, global_norm

F32 = torch.float32


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: dict   # row second moments (or full v for rank<2 leaves)
    vc: dict   # col second moments (zeros for rank<2 leaves)


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: float = 1e-3
    decay: float = 0.8       # beta2_t = 1 - step^-decay
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0

    def init(self, params) -> AdafactorState:
        def vr(p):
            shape = p.shape[:-1] if p.ndim >= 2 else p.shape
            return torch.zeros(shape, dtype=F32, device=p.device)

        def vc(p):
            shape = (*p.shape[:-2], p.shape[-1]) if p.ndim >= 2 else ()
            return torch.zeros(shape, dtype=F32, device=p.device)

        return AdafactorState(step=_step0(params), vr=T.map(vr, params),
                              vc=T.map(vc, params))

    def _upd(self, p, g, vr, vc, beta2) -> None:
        """The reference's ``upd`` on one slice, written into ``p``, ``vr``
        and ``vc``."""
        g = g.to(F32)
        g2 = g * g + self.eps1
        if p.ndim >= 2:
            vr2 = beta2 * vr + (1 - beta2) * g2.mean(-1)
            vc2 = beta2 * vc + (1 - beta2) * g2.mean(-2)
            denom = vr2.mean(-1, keepdim=True)[..., None]
            vhat = (vr2[..., None] * vc2[..., None, :]) / torch.clamp(
                denom, min=self.eps1)
            u = g * torch.rsqrt(torch.clamp(vhat, min=self.eps1))
        else:
            vr2 = beta2 * vr + (1 - beta2) * g2
            vc2 = vc
            u = g * torch.rsqrt(torch.clamp(vr2, min=self.eps1))
        # update clipping (RMS-based)
        rms_u = torch.sqrt(torch.mean(u * u) + self.eps1)
        u = u / torch.clamp(rms_u / self.clip_threshold, min=1.0)
        scale = torch.clamp(
            torch.sqrt(torch.mean(torch.square(p.to(F32)))), min=self.eps2)
        new_p = p.to(F32) - (self.lr * scale) * u
        p.copy_(new_p.to(p.dtype))
        vr.copy_(vr2)
        vc.copy_(vc2)

    def _upd_leaf(self, p, g, vr, vc, beta2) -> None:
        if isinstance(p, T.Stack):
            if p.ndim >= 3 and len(p) > 1:
                for i in range(len(p)):   # the reference's scan over layers
                    self._upd(p[i], g[i], vr[i], vc[i], beta2)
                return
            whole = p.stacked()
            self._upd(whole, T.Stack(g).stacked(), vr, vc, beta2)
            if len(p) > 1:
                for i, t in enumerate(p):
                    t.copy_(whole[i])
            return
        if p.ndim >= 3 and p.shape[0] > 1:
            for i in range(p.shape[0]):   # the reference's scan over dim 0
                self._upd(p[i], g[i], vr[i], vc[i], beta2)
            return
        self._upd(p, g, vr, vc, beta2)

    @torch.no_grad()
    def update(self, grads, state: AdafactorState, params):
        """Returns (params, state, grad norm); ``params`` and the state's
        ``vr`` and ``vc`` are updated in place."""
        step = state.step + 1
        t = step.to(F32)
        beta2 = 1.0 - t ** (-self.decay)
        for p, g, vr, vc in T.zip_leaves(params, grads, state.vr, state.vc):
            self._upd_leaf(p, g, vr, vc, beta2)
        return (params, AdafactorState(step, state.vr, state.vc),
                global_norm(grads))


def make_optimizer(name: str, lr: float | None = None):
    if name == "adamw":
        return AdamW(lr=lr or 3e-4)
    if name == "adafactor":
        return Adafactor(lr=lr or 1e-3)
    raise ValueError(name)
