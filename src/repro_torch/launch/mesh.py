"""Device meshes for the port's sharded searches.

Port of ``repro.launch.mesh`` and of ``repro.core.compat.make_mesh``. A
:class:`Mesh` is an n-d grid of ``torch.device``s with named axes, driven
by one host process: ``core.distributed.make_sharded_search`` puts one data
shard on each position of the ``data`` axis and splits the query batch over
``model``; ``core.search.shard_search`` replicates the index and splits the
batch over every position.

A mesh may name one device more than once, so one card can rehearse an
S-shard mesh; ``distinct_devices`` says how many cards it really spans.
Meshes are frozen and compare by value (the serving engine keys its
compile-cache geometry by them).

``make_production_mesh`` is the training/serving mesh of the LM zoo: a
``torch.distributed.DeviceMesh`` of ``(16, 16)`` ``("data", "model")``, or
``(2, 16, 16)`` with ``"pod"`` in front, over the default process group (a
real ``torchrun`` world, or the dry run's fake one). The hardware
constants below are the roofline's, for an H100 SXM.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device


def _canonical(device) -> torch.device:
    """``device`` with a CUDA index always set, so "cuda" and "cuda:0"
    name one device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An n-d grid of devices with one name per axis.

    ``flat`` holds the devices in row-major order over ``dims``."""

    flat: tuple
    dims: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.dims) != len(self.axis_names):
            raise ValueError(
                f"{len(self.dims)} axis sizes but {len(self.axis_names)} names")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if math.prod(self.dims) != len(self.flat) or not self.flat:
            raise ValueError(
                f"a {self.dims} mesh needs {math.prod(self.dims)} devices, "
                f"got {len(self.flat)}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.flat)

    @property
    def devices(self) -> np.ndarray:
        """The devices as an object array of shape ``dims``."""
        grid = np.empty(len(self.flat), dtype=object)
        grid[:] = self.flat
        return grid.reshape(self.dims)

    @property
    def distinct_devices(self) -> int:
        """How many different devices the mesh names."""
        return len(set(self.flat))


def make_mesh(axis_shapes, axis_names, devices=None) -> Mesh:
    """A mesh of ``axis_shapes`` named ``axis_names``.

    ``devices`` (anything ``torch.device`` accepts, one per position,
    row-major, repeats allowed) defaults to the visible CUDA devices in
    order; too few of them raise, and there is no fallback to the CPU."""
    dims = tuple(int(n) for n in axis_shapes)
    need = math.prod(dims)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            raise RuntimeError(
                f"a {dims} mesh needs {need} CUDA devices, {have} visible; "
                "pass devices= to name them (repeats allowed)")
        devices = [torch.device("cuda", i) for i in range(need)]
    return Mesh(flat=tuple(_canonical(d) for d in devices), dims=dims,
                axis_names=tuple(axis_names))


def make_host_mesh(device: str | torch.device = "cuda") -> Mesh:
    """The (1, 1) ``("data", "model")`` mesh on one device: the same code
    path as a real mesh, on the card by default."""
    return make_mesh((1, 1), ("data", "model"), devices=[resolve_device(device)])


def make_production_mesh(*, multi_pod: bool = False):
    """The production ``DeviceMesh`` over the default process group, whose
    world size must be 256 (512 with ``multi_pod``): one rank per GPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"the production mesh needs a process group of {need} ranks "
            "(torchrun, or the dry run's fake group); none is initialized")
    if dist.get_world_size() != need:
        raise RuntimeError(
            f"the {shape} production mesh needs {need} ranks, the process "
            f"group has {dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


# H100 SXM data-sheet constants used by the roofline (per GPU).
PEAK_FLOPS_BF16 = 989e12      # dense bf16 tensor-core peak
HBM_BW = 3.35e12              # bytes/s of HBM3
HBM_BYTES = 80 * 10**9        # 80 GB of HBM3
# One collective rate, as the reference keeps one: the 16-wide model axis
# spans two 8-GPU NVLink nodes, so its collectives run at one NDR
# 400 Gb/s InfiniBand link per GPU (50e9 bytes/s), not at NVLink's rate.
ICI_BW = 50e9
