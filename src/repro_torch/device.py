"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    The default is the GPU. Asking for CUDA on a host without one raises
    rather than falling back to the CPU: a CPU run must be requested
    explicitly (``device="cpu"``), as the tests do. Float32 matrix products
    and convolutions are pinned to full FP32 here (no TF32), so distances
    computed on the card keep the reference's precision.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
