"""The system under test: the port's ``PageANNIndex``, built once per
checkout and loaded by every run.

The only module of the benchmark that imports the program. It builds the
cell's index with ``PageANNIndex.build`` over the benchmark's collection,
saves it under ``portbench/.cache/<config>/<key>/``, and loads it with
``PageANNIndex.load`` (under the configuration's ``memory_budget``): the
key covers the configuration's file, the harness's code that makes the
collection and builds from it (``data.py``, this file), and every source
file of the program (``src/repro_torch/**/*.py`` and the CUDA sources), so
a change to any of them builds anew on the next run and the first run of a
checkout pays for it, as it pays for the kernels' compile.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import (
    MemoryMode,
    PageANNConfig,
    PageANNIndex,
)

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = ROOT / "src" / "repro_torch"
HARNESS = Path(__file__).resolve().parent
BUILD_CODE = ("data.py", "system.py")   # make the collection, build from it


def cache_key(config_bytes: bytes) -> str:
    """A hash of the configuration's file, of the harness's code that makes
    and builds the collection, and of every Python and CUDA source of the
    program."""
    h = hashlib.sha256(config_bytes)
    for name in BUILD_CODE:
        h.update(name.encode())
        h.update((HARNESS / name).read_bytes())
    for p in sorted(p for p in PROGRAM.rglob("*")
                    if p.is_file() and p.suffix in (".py", ".cu", ".cuh")):
        h.update(str(p.relative_to(PROGRAM)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:20]


def pageann_config(cfg: dict) -> PageANNConfig:
    fields = dict(cfg["pageann"])
    fields["memory_mode"] = MemoryMode(fields["memory_mode"])
    return PageANNConfig(dim=int(cfg["dim"]), **fields)


def build_index(x: torch.Tensor, cfg: dict, directory: Path, *,
                device) -> float:
    """Build the configuration's index over ``x`` and save it; the
    seconds the build took."""
    t0 = time.perf_counter()
    index = PageANNIndex.build(x.cpu().numpy(), pageann_config(cfg),
                               device=device)
    seconds = time.perf_counter() - t0
    index.save(str(directory))
    return seconds


def cached_index_dir(cache: Path, name: str, config_bytes: bytes,
                     make) -> tuple[Path, float | None]:
    """The saved index of configuration ``name``: built by ``make(dir)``
    (which returns the build's seconds) when no artifact with this key
    exists. Returns the directory and the build seconds (None: loaded).

    Each build writes into a directory of its own and is then renamed onto
    the key's: of two runs that build at once, the first to finish puts
    its artifact in place and the other's is discarded."""
    final = cache / name / cache_key(config_bytes)
    if (final / "manifest.json").exists():
        return final, None
    final.parent.mkdir(parents=True, exist_ok=True)
    partial = Path(tempfile.mkdtemp(prefix=final.name + ".partial-",
                                    dir=final.parent))
    try:
        seconds = make(partial)
        os.replace(partial, final)
    except OSError:
        if not (final / "manifest.json").exists():
            raise
    finally:
        shutil.rmtree(partial, ignore_errors=True)
    return final, seconds


class System:
    """One loaded index and the search call the window drives."""

    def __init__(self, directory: Path, cfg: dict, *, device):
        self.index = PageANNIndex.load(
            str(directory), device=device,
            memory_budget=cfg.get("memory_budget"))
        self.pages = int(self.index.stats.pages)
        self.capacity = int(self.index.store.capacity)

    def search(self, queries: np.ndarray, k: int):
        """One batch through ``PageANNIndex.search``: host arrays in, host
        arrays out (ids, dists, ios, hops, cache hits)."""
        return self.index.search(queries, k=k)

    def close(self) -> None:
        self.index = None
