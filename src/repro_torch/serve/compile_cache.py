"""Shared compile-cache registry: one warm executable per search *geometry*.

Port of ``repro.serve.compile_cache``. The port compiles nothing yet: its
search is eager PyTorch over prebuilt CUDA kernels, so this cache is the
reference's accounting and no more. For the same dispatch sequence it
counts the same hits, misses and unique signatures as the reference, and a
later change keys whatever it does cache per signature (CUDA graphs of the
hop body) with the same keys.

The reference's jitted search hot path (``core.search.batch_search``)
compiles one executable per (static knobs, array shapes) signature. When
one process serves many collections, what determines that signature is
not the collection — it is the collection's **geometry**: vector dim, page
capacity, memory mode, and the shapes of the device arrays the search
touches. Two collections built with the same config over same-sized
corpora share every one of those, so their dispatch groups would hit the
*same* compiled executable; a third collection with a different page count
or dim compiles its own.

This module makes that sharing observable and accountable at the serving
layer.  A :class:`CompileCache` maps

    geometry ⊕ (batch_size, resolved SearchParams)   →   seen-before?

where ``geometry`` is derived from the index artifact by
:func:`geometry_of`.  The batching engine consults the cache on every
group dispatch: the first dispatch of a key is a **miss** (the reference
traces and compiles underneath), every later dispatch — from *any*
collection with the same geometry — is a **hit**. Hit/miss/unique-executable
counters ride :class:`repro_torch.serve.engine.EngineMetrics`, so
"attaching collection B compiled 0 new executables" is a measurable claim.

Geometry extraction is conservative: an index whose compiled shapes this
module cannot prove stable (e.g. a mutable index, whose delta-scan shapes
grow with the fill level) gets a per-object key, so the cache never
reports sharing that a compiled-executable cache would not deliver.
"""
from __future__ import annotations

import itertools
import threading
import weakref
from typing import Any, NamedTuple


class CompileCacheStats(NamedTuple):
    hits: int      # dispatches whose executable was already warm
    misses: int    # dispatches that compiled a new executable
    unique: int    # distinct executables this cache has seen compiled


# --- per-object identity tokens for unshareable geometries -----------------
# id() alone is not a safe cache-key component: a process-scoped cache
# outlives services, and CPython recycles addresses after GC — a brand-new
# backend allocated where a dead one lived would register as already warm.
# Tokens are monotonic and retired (never reused) when the object dies.
_token_lock = threading.Lock()
_tokens: dict[int, int] = {}             # id(obj) -> token, while obj lives
_token_refs: dict[int, weakref.ref] = {}
_token_counter = itertools.count()


def unshared_token(obj: Any) -> int:
    """A stable token for ``obj``, distinct from every other object's —
    including past objects that happened to share its address."""
    with _token_lock:
        oid = id(obj)
        tok = _tokens.get(oid)
        if tok is None:
            tok = next(_token_counter)

            def _cleanup(_ref, oid=oid):
                with _token_lock:
                    _tokens.pop(oid, None)
                    _token_refs.pop(oid, None)

            try:
                _token_refs[oid] = weakref.ref(obj, _cleanup)
            except TypeError:
                # not weakref-able: the entry is pinned for the process
                # lifetime, which keeps the token stable (never recycled)
                pass
            _tokens[oid] = tok
        return tok


def geometry_of(index: Any) -> tuple:
    """Everything about ``index`` that shapes its compiled search
    executable, as a hashable key.

    For a :class:`repro_torch.core.index.PageANNIndex` this is the artifact
    geometry — (dim, capacity, memory mode) plus the shape/dtype signature
    of every tensor of its :class:`repro_torch.core.search.SearchData` —
    the reference's traced part of ``batch_search``'s jit signature, so
    equal keys mean a shareable executable. Anything else (baselines,
    mutable indexes whose delta shapes drift between calls) is keyed by
    object identity: correct, never falsely shared.
    """
    data = getattr(index, "data", None)
    cfg = getattr(index, "cfg", None)
    store = getattr(index, "store", None)
    if data is not None and cfg is not None and store is not None:
        sig = tuple(
            (tuple(t.shape), str(t.dtype)) for t in data if t is not None
        )
        key = (
            "pageann",
            cfg.dim,
            store.capacity,
            cfg.memory_mode.value,
            sig,
        )
        fetcher = getattr(index, "fetcher", None)
        if fetcher is not None:
            # a streamed index's search closes over its host fetcher (the
            # reference's executable is cached per fetcher), so two streamed
            # indexes never share one: the residency identity joins the key
            key = key + (("stream", unshared_token(fetcher)),)
        return key
    return ("unshared", unshared_token(index))


class CompileCache:
    """Thread-safe registry of compiled-search signatures with counters.

    ``note(key)`` records one dispatch under ``key`` and returns whether
    the executable was already warm.  One cache is typically shared by
    every collection behind one engine/service, which is what lets a
    second same-geometry collection register as all-hits.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._seen: dict[tuple, int] = {}
        self._hits = 0
        self._misses = 0

    def note(self, key: tuple) -> bool:
        """Record a dispatch of ``key``; True if it was already compiled."""
        with self._lock:
            warm = key in self._seen
            self._seen[key] = self._seen.get(key, 0) + 1
            if warm:
                self._hits += 1
            else:
                self._misses += 1
            return warm

    def contains(self, key: tuple) -> bool:
        with self._lock:
            return key in self._seen

    def stats(self) -> CompileCacheStats:
        with self._lock:
            return CompileCacheStats(
                hits=self._hits, misses=self._misses, unique=len(self._seen)
            )

    def clear(self) -> None:
        with self._lock:
            self._seen.clear()
            self._hits = 0
            self._misses = 0
