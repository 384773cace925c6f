"""The plain reference: exact nearest neighbours by brute force.

Plain PyTorch over the benchmark's own collection and queries, in blocks of
queries on whatever device the tensors are on. It imports nothing of the
program and takes nothing the program made.

* ``exact_distances``: the squared L2 distance of given ids to their query,
  summed directly in float64 (the judge of every returned distance).
* ``exact_topk``: the true top-k: candidates from the expanded form ``|q|^2 - 2 q.x + |x|^2`` in float32 with TF32 off, then
  re-ranked by ``exact_distances``.
* ``control_topk``: the same brute force computed one precision below the
  configuration's float32 (TF32 matrix products): the control a sound
  comparison must reject.
"""
from __future__ import annotations

import contextlib

import torch

BLOCK = 4096        # queries a block
EXTRA = 16          # candidates beyond k that the exact re-rank looks at


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 matrix products on (or off) on the card for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa, to nearest with
    ties away from zero, as the card converts a product's operands."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def exact_distances(x: torch.Tensor, q: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """(Q, k) float64 squared L2 of ``x[ids]`` to each row of ``q``; NaN
    where an id is negative or out of range."""
    n = x.shape[0]
    ok = (ids >= 0) & (ids < n)
    out = torch.empty(ids.shape, dtype=torch.float64, device=q.device)
    for s in range(0, q.shape[0], BLOCK):
        blk = slice(s, s + BLOCK)
        vec = x[ids[blk].clamp(0, n - 1)].double()          # (B, k, d)
        diff = vec - q[blk, None, :].double()
        out[blk] = (diff * diff).sum(-1)
    return torch.where(ok, out, torch.nan)


def _expanded(x: torch.Tensor, q: torch.Tensor, x_sq: torch.Tensor,
              emulate_tf32: bool) -> torch.Tensor:
    if emulate_tf32:
        prod = round_tf32(q) @ round_tf32(x).T
    else:
        prod = q @ x.T
    return (q * q).sum(1, keepdim=True) - 2.0 * prod + x_sq[None, :]


def _blocks(x, q, k, *, use_tf32):
    """Yield (block slice, top-(k) ids, their expanded distances) of the
    brute force over each block of queries."""
    x_sq = (x * x).sum(1)
    emulate = use_tf32 and not x.is_cuda
    with tf32(use_tf32 and x.is_cuda):
        for s in range(0, q.shape[0], BLOCK):
            blk = slice(s, s + BLOCK)
            d = _expanded(x, q[blk], x_sq, emulate)
            vals, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
            yield blk, idx, vals


def exact_topk(x: torch.Tensor, q: torch.Tensor, k: int) -> torch.Tensor:
    """(Q, k) int64 ids of each query's k nearest vectors, nearest first."""
    width = min(k + EXTRA, x.shape[0])
    out = torch.empty((q.shape[0], k), dtype=torch.int64, device=q.device)
    for blk, idx, vals in _blocks(x, q, width, use_tf32=False):
        d = exact_distances(x, q[blk], idx)
        order = torch.sort(d, dim=1, stable=True).indices[:, :k]
        out[blk] = idx.gather(1, order)
    return out


def control_topk(x: torch.Tensor, q: torch.Tensor, k: int):
    """The reference put in the program's place one precision down: the
    top-k by the expanded form with TF32 products (emulated off the card),
    and those TF32 distances, as a search would return them."""
    ids = torch.empty((q.shape[0], k), dtype=torch.int64, device=q.device)
    dists = torch.empty((q.shape[0], k), dtype=torch.float32,
                        device=q.device)
    for blk, idx, vals in _blocks(x, q, k, use_tf32=True):
        ids[blk], dists[blk] = idx, vals
    return ids, dists
