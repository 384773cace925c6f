"""CUDA wrapper: batched squared L2 distance, the delta tier's scan.

Replaces ``src/repro/kernels/l2dist.py`` (``l2_distance``). The kernel is
``csrc/l2_distance.cu``: bound by operations on the H100 at the delta
scan's shapes (2 Q N d flops against Q N output floats). A tiled float32
product on the CUDA cores (64 x 64 output tile a block, 4 x 4 accumulators a
thread) with both norms and the ``(|q|^2 - 2 q.x) + |x|^2`` epilogue in the
same kernel; no TF32, so the port keeps the reference's precision.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_QUERY_TILES = 65535   # the grid's y extent: Q <= 65535 * 64


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"l2_distance: {msg}")


def l2_distance(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q: (Q, d), x: (N, d), both contiguous on one CUDA device -> (Q, N)
    f32 squared distances. Inputs of another float type (bf16, f16) are
    cast to f32 first."""
    _require(q.is_cuda and x.device == q.device,
             "q and x must be on one CUDA device")
    _require(q.dim() == 2 and x.dim() == 2 and q.shape[1] == x.shape[1],
             f"need (Q, d) and (N, d), got {tuple(q.shape)} and {tuple(x.shape)}")
    _require(q.is_floating_point() and x.is_floating_point(),
             "q and x must be floating point")
    q = q.to(torch.float32).contiguous()
    x = x.to(torch.float32).contiguous()
    nq, d = q.shape
    nx = x.shape[0]
    _require(-(-nq // 64) <= MAX_QUERY_TILES, f"too many queries: {nq}")
    out = torch.empty((nq, nx), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _build.library().pageann_l2_distance(
            q.data_ptr(), x.data_ptr(), out.data_ptr(), nq, nx, d,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "l2_distance")
    return out
