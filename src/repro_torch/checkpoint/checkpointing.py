"""Checkpointing: ``repro.checkpoint.checkpointing`` in PyTorch, with the
same layout on disk, so a checkpoint written by either package restores in
the other:

  <dir>/step_<N>.tmp/   leaf files while writing
  <dir>/step_<N>/       renamed atomically on commit
    MANIFEST.json       {step, leaf names, files, shapes, dtypes}
    <leaf>.npy          one file per leaf of the tree

A leaf's name is the reference's ``tree_flatten_with_path`` name
(``params::layers::attn::wq``, ``opt_state::m::embed``,
``opt_state::step``, ``step``; ``repro_torch.tree``), and a layer-stacked
leaf (a :class:`~repro_torch.tree.Stack`, which a model's ``param_tree``
gives) is written in the reference's stacked shape. bfloat16 is written as
its uint16 bits and marked ``bfloat16`` in the manifest, as the reference
writes it; reading it back takes the same view in torch, with no
``ml_dtypes``.

``restore`` copies into the target tree's own tensors and returns that
tree: the reference returns new arrays, but at full width a second copy of
a training state does not fit beside the first.

A sharded state (DTensor leaves, ``train.step.shard_train_state``) is saved
as full arrays: every rank gathers each leaf (a collective, so every rank
calls ``save``) and rank 0 writes. ``restore(..., shardings=)`` re-shards
elastically, as the reference's: ``shardings`` is a tree of the target's
structure whose leaves are DTensor placements (or None; a Stack's are each
layer's, as ``models.sharding.param_shardings`` gives them), and each rank
copies its local slice of the saved full array into the target's DTensor
shard, so a checkpoint written on one mesh restores onto another. A
DTensor target restores into its own layout without it.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch

from repro_torch import tree as T


def _full(t):
    """A DTensor's full value (gathered on every rank); a tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _host(leaf) -> torch.Tensor:
    """A host copy of ``leaf`` (a Stack stacked, tensors copied even when
    they are on the CPU already, so later in-place updates miss it)."""
    if isinstance(leaf, T.Stack):
        out = torch.empty(leaf.shape, dtype=leaf.dtype, device="cpu")
        for i, t in enumerate(leaf):
            out[i].copy_(_full(t.detach()))
        return out
    return _full(torch.as_tensor(leaf).detach()).to("cpu", copy=True)


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0, or no group."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array numpy can write, the logical dtype's name)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _host_leaves(tree):
    for path, leaf in T.flatten(tree):
        yield T.name(path), _host(leaf)


def _write(ckpt_dir: str, step: int, named) -> str:
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for name, arr in named:
        arr, logical = _to_numpy(arr)
        fname = name.replace("/", "_") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": list(arr.shape),
             "dtype": logical})
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def save(ckpt_dir: str, step: int, tree) -> str:
    """Synchronous atomic save, one leaf on the host at a time. Returns the
    committed directory (rank 0 writes; every rank gathers)."""
    if not _writer():
        for _ in _host_leaves(tree):
            pass
        return os.path.join(ckpt_dir, f"step_{step}")
    return _write(ckpt_dir, step, _host_leaves(tree))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def _load(final: str, entry: dict) -> torch.Tensor:
    arr = np.load(os.path.join(final, entry["file"]))
    if entry["dtype"] == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _copy_in(dst, src: torch.Tensor, sharding=None) -> None:
    """``src`` (the full array) into ``dst``: into a DTensor its local
    slice under the placements ``sharding`` (default its own), into a
    tensor the whole."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import local_chunk

    if isinstance(dst, DTensor):
        pl = tuple(sharding) if sharding is not None else dst.placements
        if pl != tuple(dst.placements):
            raise ValueError(f"target laid out as {dst.placements}, "
                             f"shardings ask for {pl}")
        dst.to_local().copy_(local_chunk(src, dst.device_mesh, pl))
    elif sharding is not None and not all(p.is_replicate()
                                          for p in sharding):
        raise ValueError("shardings given for a target that is not laid "
                         "out (train.step.shard_train_state)")
    else:
        dst.copy_(src)


def _sharding_leaves(shardings, target_tree) -> list:
    """The placements (or None) of each leaf of ``target_tree``, in
    flatten order."""
    if shardings is None:
        return [None] * len(T.flatten(target_tree))
    out = []

    def walk(tree, sh):
        if tree is None:
            return
        if isinstance(tree, T.Stack) or isinstance(tree, torch.Tensor):
            out.append(sh)
        elif hasattr(tree, "param_tree"):
            walk(tree.param_tree(), sh)
        elif isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], None if sh is None else sh[k])
        elif hasattr(tree, "_fields"):
            for f in tree._fields:
                walk(getattr(tree, f), None if sh is None else getattr(sh, f))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, None if sh is None else sh[i])
        else:
            out.append(sh)

    walk(target_tree, shardings)
    return out


@torch.no_grad()
def restore(ckpt_dir: str, step: int, target_tree, shardings=None):
    """Restore step ``step`` into the tensors of ``target_tree`` (each cast
    to its target's dtype) and return the tree. ``shardings`` (the
    target's structure, placements leaves or None)
    re-shards elastically onto the target's mesh. A missing leaf raises
    ``KeyError``, a shape that differs ``ValueError``."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(final, "MANIFEST.json")) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e for e in manifest["leaves"]}
    flat = T.flatten(target_tree)
    for (path, leaf), sh in zip(flat, _sharding_leaves(shardings,
                                                       target_tree)):
        name = T.name(path)
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf '{name}'")
        src = _load(final, by_name[name])
        want = tuple(leaf.shape)
        if tuple(src.shape) != want:
            raise ValueError(f"{name}: ckpt {tuple(src.shape)} vs target {want}")
        if isinstance(leaf, T.Stack):
            for i, t in enumerate(leaf):
                _copy_in(t, src[i].to(t.dtype), sh)
        else:
            _copy_in(leaf, src.to(leaf.dtype), sh)
    return target_tree


class AsyncCheckpointer:
    """Background writer: ``submit`` copies the tree to host memory at once
    (so training can update its tensors in place) and a daemon thread
    serializes."""

    def __init__(self, ckpt_dir: str, max_queue: int = 2):
        self.ckpt_dir = ckpt_dir
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._err: Exception | None = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, named = item
            try:
                _write(self.ckpt_dir, step, named)
            except Exception as e:  # surfaced on next submit/close
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, step: int, tree):
        if self._err:
            raise self._err
        named = list(_host_leaves(tree))
        if _writer():
            self._q.put((step, named))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._t.join()
