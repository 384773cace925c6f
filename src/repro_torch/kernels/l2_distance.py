"""CUDA wrapper: batched squared L2 distance, the delta tier's scan.

Replaces ``src/repro/kernels/l2dist.py`` (``l2_distance``). The kernel is
``csrc/l2_distance.cu``: bound by operations on the H100 at the delta
scan's shapes (2 Q N d flops against Q N output floats). A register-blocked
float32 product on the CUDA cores (a 128 x 64 output tile a block of 256
threads, 8 x 4 accumulators a thread, slabs of q and x staged by 16-byte
``cp.async`` three deep) with both norms and the ``(|q|^2 - 2 q.x) + |x|^2``
epilogue in the same kernel, which also writes ``+inf`` where the optional
``keep`` mask is false; no TF32, so the port keeps the reference's
precision. Products and norms are summed in chunks of 128 of d, the chunks
added in order, so the rounding stays within the expanded form's tolerance
at d = 2048 (one chain over all of d did not).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

TILE = 128                # query rows a block (and 64 vector rows)
MAX_QUERY_TILES = 65535   # the grid's y extent: Q <= 65535 * TILE


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"l2_distance: {msg}")


def l2_distance(q: torch.Tensor, x: torch.Tensor,
                keep: torch.Tensor | None = None) -> torch.Tensor:
    """q: (Q, d), x: (N, d), keep: (N,) bool or None, all on one CUDA
    device -> (Q, N) f32 squared distances, ``+inf`` in the columns where
    ``keep`` is false. Inputs of another float type (bf16, f16) are cast to
    f32 first."""
    _require(q.is_cuda and x.device == q.device,
             "q and x must be on one CUDA device")
    _require(q.dim() == 2 and x.dim() == 2 and q.shape[1] == x.shape[1],
             f"need (Q, d) and (N, d), got {tuple(q.shape)} and {tuple(x.shape)}")
    _require(q.is_floating_point() and x.is_floating_point(),
             "q and x must be floating point")
    if keep is not None:
        _require(keep.device == q.device and keep.dtype == torch.bool
                 and keep.shape == (x.shape[0],),
                 f"keep must be a ({x.shape[0]},) bool tensor on q's device")
        keep = keep.contiguous()
    q = q.to(torch.float32).contiguous()
    x = x.to(torch.float32).contiguous()
    nq, d = q.shape
    nx = x.shape[0]
    _require(-(-nq // TILE) <= MAX_QUERY_TILES, f"too many queries: {nq}")
    out = torch.empty((nq, nx), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _build.library().pageann_l2_distance(
            q.data_ptr(), x.data_ptr(),
            keep.data_ptr() if keep is not None else None, out.data_ptr(),
            nq, nx, d, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "l2_distance")
    return out


def blocks_per_sm() -> int:
    """Blocks of the 16-byte-copy kernel one SM holds at once, as the CUDA
    runtime computes it."""
    blocks = ctypes.c_int(0)
    rc = _build.library().pageann_l2_distance_blocks_per_sm(
        ctypes.addressof(blocks))
    if rc != 0:
        raise RuntimeError(f"l2_distance occupancy query failed: cudaError {rc}")
    return blocks.value
