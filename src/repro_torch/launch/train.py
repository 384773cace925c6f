"""Training driver, ported to PyTorch from ``repro.launch.train``.

Wires every substrate piece together: the host mesh, the token pipeline,
the microbatched train step, async checkpointing, restore from the latest
checkpoint, the preemption guard and straggler monitoring, and prints the
reference's log lines. ``--smoke`` runs the reduced config with
``Rules(make_host_mesh(device))``: a world of size 1 (NCCL on the card,
gloo on the CPU) and the ``(1, 1)`` DeviceMesh over it, so the state is
laid out as DTensors and the step runs the sharded code path
(``examples/train_lm_torch.py`` drives it that way). Without ``--smoke`` it
takes ``SHAPES[--shape]``, ``make_production_mesh(multi_pod=...)`` over the
default process group and ``Rules``: run it under ``torchrun`` with 256
ranks (512 with ``--multi-pod``), one GPU each; the driver opens the NCCL
group from torchrun's environment when none is open. A restart restores
the latest checkpoint with ``shardings=``.

The initial weights come from a ``torch.Generator`` seeded 0
(``_init_state``), so they are not the reference's ``jax.random`` bits;
``main`` takes ``device=`` (default ``"cuda"``; the tests pass
``device="cpu"``). The train step updates the state in place, as the
reference's ``donate_argnums=(0,)`` lets it. After a preemption the
reference also writes the preempted state as the last step's checkpoint,
so a restart would skip the remaining steps (ROADMAP C7); the port writes
only the preempted step's.

Usage (on the card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --smoke --steps 50 --ckpt-dir /tmp/ckpt --ckpt-every 20
  # production, 32 nodes of 8 GPUs:
  torchrun --nnodes 32 --nproc-per-node 8 --rdzv-backend c10d \
      --rdzv-endpoint HOST:29500 -m repro_torch.launch.train \
      --arch granite-3-2b --shape train_4k --ckpt-dir CKPT
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.ft.failures import PreemptionGuard, StragglerMonitor
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.shardings import state_specs, to_shardings
from repro_torch.models.sharding import Rules, param_shardings, release_world
from repro_torch.models.transformer import to_tensor
from repro_torch.train.step import (
    TrainState,
    init_train_state,
    make_train_step,
    shard_train_state,
    unshard_train_state,
)


def _open_world() -> None:
    """The NCCL group of a ``torchrun`` world, if none is open yet."""
    import os

    import torch.distributed as dist

    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")


def build(args, device):
    """(arch, shape, mesh, rules) for ``args``."""
    arch = get_arch(args.arch, smoke=args.smoke)
    if args.smoke:
        shape = ShapeConfig(
            "smoke", args.seq_len, args.batch, "train",
            num_microbatches=args.microbatches,
        )
        mesh = make_host_mesh(device)
    else:
        shape = SHAPES[args.shape]
        _open_world()
        mesh = make_production_mesh(multi_pod=args.multi_pod)
    return arch, shape, mesh, Rules(mesh)


def _device_of(mesh):
    """The device this process computes on."""
    if hasattr(mesh, "flat"):
        return mesh.flat[0]
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _init_state(arch, lr, device):
    return init_train_state(arch, torch.Generator().manual_seed(0), lr,
                            device=device)


def main(argv=None, *, device: str | torch.device = "cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    arch, shape, mesh, rules = build(args, device)
    dev = _device_of(mesh)
    guard = PreemptionGuard()
    monitor = StragglerMonitor()

    state = shard_train_state(_init_state(arch, args.lr, dev), rules)
    step_fn = make_train_step(arch, shape, rules, lr=args.lr)
    start = 0
    writer = None
    if args.ckpt_dir:
        writer = ckpt.AsyncCheckpointer(args.ckpt_dir)
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            shardings = TrainState(
                params=param_shardings(state.params, rules),
                opt_state=to_shardings(state_specs(state, rules).opt_state,
                                       rules.device_mesh),
                step=None,
            )
            state = ckpt.restore(args.ckpt_dir, latest, state, shardings)
            start = latest
            print(f"restored step {latest} from {args.ckpt_dir}")

    pipe = TokenPipeline(arch, shape, seed=0)
    t_last = time.perf_counter()
    preempted = False
    for step in range(start, args.steps):
        monitor.start_step(step)
        batch = {k: to_tensor(v, dev) for k, v in pipe.batch(step).items()}
        state, metrics = step_fn(state, batch)
        slow = monitor.end_step()
        if monitor.should_rebalance():
            print(f"step {step}: straggler threshold hit — a production "
                  "deployment would elastic_remesh() here")
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            print(
                f"step {step} loss={float(metrics['loss']):.4f} "
                f"nll={float(metrics['nll']):.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"({dt:.2f}s)" + (" [SLOW]" if slow else "")
            )
        if writer and (step + 1) % args.ckpt_every == 0:
            writer.submit(step + 1, state)
        if guard.preempted:
            print(f"preemption: checkpointing at step {step + 1} and exiting")
            if writer:
                writer.submit(step + 1, state)
            preempted = True
            break
    if writer:
        if not preempted:
            writer.submit(args.steps, state)
        writer.close()
    if args.smoke:   # the world-1 group goes; the state comes back whole
        state = unshard_train_state(state)
        release_world()
    return state


if __name__ == "__main__":
    main()
