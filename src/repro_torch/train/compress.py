"""Gradient compression for cross-pod reduction: ``repro.train.compress``
in PyTorch.

Two pieces:
  * bf16 microbatch accumulation (in ``train.step``) halves the
    accumulate-buffer bytes and the cross-replica reduce payload.
  * int8 error-feedback compressor: per-tensor symmetric quantization with
    a residual carried to the next step, so compression error is fed back
    rather than lost (1-bit/8-bit SGD style).

"Per tensor" is per leaf of the reference's tree: a
:class:`~repro_torch.tree.Stack` of per-layer gradients is one stacked
tensor with one scale, as in the reference. ``torch.round`` rounds half to
even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tree as T


class EFState(NamedTuple):
    residual: dict  # the grads' structure, stacked leaves stacked, f32


def _tensor(g) -> torch.Tensor:
    return g.stacked() if isinstance(g, T.Stack) else g


def init_ef(grads_like) -> EFState:
    return EFState(residual=T.map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 codes, scale). Symmetric per-tensor quantization."""
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_tree(grads, ef: EFState):
    """Apply error feedback, compress every leaf. Returns (codes, scales,
    new EFState): codes are what crosses the pod links."""
    out = []
    for g, r in T.zip_leaves(grads, ef.residual):
        corrected = _tensor(g).to(torch.float32) + r
        q, s = compress(corrected)
        out.append((q, s, corrected - decompress(q, s)))
    codes, scales, residual = (T.unflatten(grads, [o[i] for o in out])
                               for i in range(3))
    return codes, scales, EFState(residual=residual)


def ef_decompress_tree(codes, scales):
    return T.unflatten(codes, [decompress(q, s)
                               for q, s in T.zip_leaves(codes, scales)])
