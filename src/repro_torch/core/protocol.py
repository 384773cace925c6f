"""The index lifecycle contract: build -> save -> load -> search.

Copy of ``repro.core.protocol``. :class:`repro_torch.core.index.PageANNIndex`
speaks :class:`VectorIndex`:

  * ``search(queries, k=None, params=None, *, mesh=None) -> SearchResult``:
    runtime knobs arrive per call as a
    :class:`repro_torch.core.config.SearchParams` (``k`` overrides
    ``params.k`` when given); results carry ORIGINAL vector ids and the
    paper's I/O accounting. ``mesh`` (a ``repro_torch.launch.mesh.Mesh``)
    spreads one search over devices: the PageANN index splits the query
    batch over it, the sharded store (``repro_torch.dist``) puts a shard
    on each position of its ``data`` axis, the mutable index passes it to
    its base. (The reference's protocol leaves the keyword out; the
    baselines have no mesh path and do not take it.)
  * ``save(directory)``: persist the index artifact to disk.
  * ``load(directory)`` (classmethod): reload it; searches on the loaded
    index equal the saved one's bit for bit. Implementations with a page
    tier also accept ``load(directory, memory_budget=...)``: the hottest
    pages that fit stay on the device and the rest stream from the
    ``pages.bin`` memmap per hop, with the same results.
  * ``stats``: build and footprint statistics (``BuildStats``).
  * ``dim``: the vector width ``search`` accepts.

:class:`MutableVectorIndex` adds writes (``insert`` / ``delete`` /
``compact``), implemented by :class:`repro_torch.core.delta.MutableIndex`
(an in-memory delta tier and tombstones over a frozen base, folded back
into the disk artifact on compaction). ``repro_torch.core.persist.
load_index`` reopens a saved directory as whichever implementation wrote it.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.config import SearchParams
from repro_torch.core.search import SearchResult


@runtime_checkable
class VectorIndex(Protocol):
    @property
    def dim(self) -> int: ...

    @property
    def default_params(self) -> SearchParams: ...

    @property
    def stats(self): ...

    def search(
        self,
        queries: np.ndarray,
        k: int | None = None,
        params: SearchParams | None = None,
        *,
        mesh=None,
    ) -> SearchResult: ...

    def save(self, directory: str) -> None: ...

    @classmethod
    def load(cls, directory: str) -> "VectorIndex": ...


@runtime_checkable
class MutableVectorIndex(VectorIndex, Protocol):
    """A ``VectorIndex`` that accepts writes between searches.

    ``insert`` returns the external ids assigned to the new vectors (caller
    ids echoed back, or freshly allocated when omitted); ``delete`` returns
    how many ids were live; ``compact`` folds pending writes into a fresh
    base artifact and returns whether anything was folded. Writes must
    interleave safely with concurrent ``search`` calls.
    """

    def insert(
        self, vectors: np.ndarray, ids: np.ndarray | None = None
    ) -> np.ndarray: ...

    def delete(self, ids: np.ndarray) -> int: ...

    def compact(self) -> bool: ...
