"""Database-level serving API: many named collections, one process.

Port of ``repro.serve.service``. Every index it builds, attaches or loads
lives on the service's ``device`` (the card by default; ``device="cpu"``
must be asked for). A collection created or attached with ``mesh=``
routes its dispatches through its index's mesh search.

The paper frames PageANN as the engine of a vector database; this module
is the database surface. A :class:`VectorService` owns

  * a **collection registry** — named :class:`repro_torch.core.protocol.
    VectorIndex` artifacts (built in-process, or attached from disk), each
    registered on
  * one shared :class:`repro_torch.serve.engine.BatchingEngine` core — a single
    batching/timer/demux loop whose pending groups are keyed by
    ``(collection, k-bin, params)``, so every collection gets fixed-shape
    dispatches without its own process, its own metrics machinery, or its
    own timer thread, and
  * one shared :class:`repro_torch.serve.compile_cache.CompileCache` — compiled
    search executables are keyed by *geometry* (dim, page capacity, memory
    mode, array shapes, batch, resolved params), not by collection, so
    attaching a second collection with the geometry of an already-warm one
    compiles **zero** new executables (observable in ``metrics()``), and
  * optionally a :class:`repro_torch.serve.semantic_cache.SemanticCache` in
    front of ``submit``: a query embedding within a cosine threshold of a
    recently answered one (same collection/k/params/filter scope) returns
    the cached result as an already-completed future — no queueing, no
    dispatch. Writes to a collection invalidate its cached entries, so a
    hit is never stale; hit/miss/eviction/invalidation counters ride
    ``metrics()``.

Lifecycle::

    with VectorService(batch_size=64, timeout_ms=2.0) as svc:
        svc.create_collection("wiki", index)          # built VectorIndex
        svc.create_collection("notes", cfg, vectors)  # build from a config
        svc.attach("prod", "artifacts/prod_idx")      # load from disk
        fut = svc.submit("wiki", query, k=10)         # routed dispatch
        svc.insert("notes", fresh_vectors)            # writes, if mutable
        svc.save("db_dir")                            # whole database

    svc = VectorService.load("db_dir")                # round-trips

On disk a database is ``db.json`` (collection name -> subdirectory,
versioned like index manifests) over ordinary per-collection artifacts —
see ``repro_torch.core.persist.save_database``.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.core import persist
from repro_torch.core.config import PageANNConfig, SearchParams
from repro_torch.device import resolve_device
from repro_torch.serve.compile_cache import CompileCache
from repro_torch.serve.engine import BatchingEngine, EngineMetrics, RequestResult
from repro_torch.serve.semantic_cache import SemanticCache


class CollectionHandle:
    """A bound view of one named collection: the service's routing surface
    with the name pre-applied. Handles stay cheap and stateless — dropping
    the collection invalidates the handle (later calls raise KeyError)."""

    __slots__ = ("_service", "name")

    def __init__(self, service: "VectorService", name: str):
        self._service = service
        self.name = name

    @property
    def index(self):
        """The underlying ``VectorIndex`` (e.g. for ``stats`` / ``save``)."""
        return self._service.index_of(self.name)

    def submit(self, query, *, k=None, params=None, filter=None,
               deadline_ms=None):
        return self._service.submit(
            self.name, query, k=k, params=params, filter=filter,
            deadline_ms=deadline_ms,
        )

    def search(self, queries, *, k=None, params=None, filter=None):
        return self._service.search(
            self.name, queries, k=k, params=params, filter=filter
        )

    def insert(self, vectors, ids=None, *, metadata=None):
        return self._service.insert(
            self.name, vectors, ids, metadata=metadata
        )

    def delete(self, ids):
        return self._service.delete(self.name, ids)

    def compact(self):
        return self._service.compact(self.name)

    def __repr__(self) -> str:
        return f"CollectionHandle({self.name!r})"


class VectorService:
    """One serving process, many named vector collections (see module
    docstring). All engine knobs (``batch_size``, ``timeout_ms``,
    ``k_bins``, …) are shared across collections — they shape the batching
    core, not any one index. ``device`` is where collections built, attached
    or loaded by the service live."""

    def __init__(
        self,
        *,
        device: str | torch.device = "cuda",
        batch_size: int = 64,
        timeout_ms: float | None = None,
        k_bins: tuple[int, ...] | None = None,
        compile_cache: CompileCache | None = None,
        semantic_cache: SemanticCache | None = None,
        tracer=None,
        **engine_kwargs: Any,
    ):
        self.device = resolve_device(device)
        self._compile_cache = compile_cache or CompileCache()
        # the tracer (duck-typed, see repro_torch.obs.trace.Tracer) is threaded
        # down into the engine (request/dispatch spans), the semantic
        # cache (lookup spans), and — via add_collection — any streamed
        # collection's PageFetcher (host-fetch spans)
        self._tracer = tracer
        self._engine = BatchingEngine(
            batch_size=batch_size,
            timeout_ms=timeout_ms,
            k_bins=k_bins,
            compile_cache=self._compile_cache,
            tracer=tracer,
            **engine_kwargs,
        )
        self._semantic_cache = semantic_cache
        if semantic_cache is not None and tracer is not None:
            semantic_cache.tracer = tracer
        self._lock = threading.Lock()
        self._indexes: dict[str, Any] = {}
        # per-collection write generation: bumped by insert/delete/compact/
        # drop so in-flight cache misses never store a stale result
        self._write_gen: dict[str, int] = {}
        self._closed = False

    # ------------------------------------------------------- context manager
    def __enter__(self) -> "VectorService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:
        """Flush and shut down the shared engine. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._engine.close()

    # ------------------------------------------------- collection lifecycle
    def create_collection(
        self,
        name: str,
        index_or_cfg,
        vectors: np.ndarray | None = None,
        *,
        k: int | None = None,
        params: SearchParams | None = None,
        mesh=None,
        priority: float = 1.0,
        **build_kwargs: Any,
    ) -> CollectionHandle:
        """Register a new collection under ``name``.

        ``index_or_cfg`` is either an already built/loaded ``VectorIndex``,
        or a :class:`PageANNConfig` — then ``vectors`` supplies the corpus
        and the index is built here, on the service's device
        (``build_kwargs`` forwarded to ``PageANNIndex.build``).
        ``k``/``params`` set the collection's serving defaults; ``mesh``
        routes its dispatches through ``shard_search`` (a sharded store:
        its data-axis fan-out); ``priority`` weights this collection's
        dispatch order on the shared core (see
        ``BatchingEngine.add_collection``).
        """
        persist.check_collection_name(name)
        if isinstance(index_or_cfg, PageANNConfig):
            if vectors is None:
                raise ValueError(
                    "create_collection from a PageANNConfig needs vectors"
                )
            from repro_torch.core.index import PageANNIndex

            build_kwargs.setdefault("device", self.device)
            index = PageANNIndex.build(
                np.asarray(vectors, np.float32), index_or_cfg, **build_kwargs
            )
        else:
            if vectors is not None:
                raise ValueError(
                    "vectors only apply when building from a PageANNConfig"
                )
            index = index_or_cfg
            if not (hasattr(index, "search") and hasattr(index, "dim")):
                raise TypeError(
                    f"{type(index).__name__} does not implement the "
                    "VectorIndex protocol (need search + dim)"
                )
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            if name in self._indexes:
                raise ValueError(f"collection {name!r} already exists")
            self._indexes[name] = index
        try:
            self._engine.add_collection(
                name, index=index, default_k=k, default_params=params,
                mesh=mesh, priority=priority,
            )
        except Exception:
            with self._lock:
                self._indexes.pop(name, None)
            raise
        return CollectionHandle(self, name)

    def attach(
        self,
        name: str,
        directory: str,
        *,
        k: int | None = None,
        params: SearchParams | None = None,
        mesh=None,
        memory_budget=None,
        recall_target: float | None = None,
        priority: float = 1.0,
    ) -> CollectionHandle:
        """Load a persisted index artifact (any manifest kind, written by
        either package) from ``directory`` onto the service's device and
        register it as collection ``name``.

        ``memory_budget`` (``MemoryBudget`` | bytes | fraction | spec
        string | None) caps the collection's device-resident page region —
        pages beyond it stream from the artifact's memmap per hop with
        bit-identical results (see ``PageANNIndex.load``).

        ``recall_target`` resolves the collection's serving defaults from
        the artifact's autotuned operating points (the manifest ``tuned``
        section written by ``PageANNIndex.autotune``): the highest-QPS
        stored point whose measured recall meets the target. Strict — an
        artifact with no qualifying point (or no tuned section at all)
        raises ``LookupError`` rather than silently serving hand-picked
        params. Mutually exclusive with an explicit ``params``."""
        persist.check_collection_name(name)
        index = persist.load_index(directory, device=self.device,
                                   memory_budget=memory_budget)
        if recall_target is not None:
            if params is not None:
                raise ValueError(
                    "pass either params= or recall_target=, not both"
                )
            params = index.params_for_target(recall_target=recall_target)
        return self.create_collection(
            name, index, k=k, params=params, mesh=mesh, priority=priority,
        )

    def drop(self, name: str) -> None:
        """Unregister ``name``: its pending requests are dispatched first,
        then later routing to it raises ``KeyError``. The index object (and
        anything it has persisted on disk) is left untouched."""
        with self._lock:
            if name not in self._indexes:
                raise KeyError(f"no collection {name!r}")
        self._engine.remove_collection(name)
        with self._lock:
            self._indexes.pop(name, None)
        # a later collection reusing the name must not inherit cached
        # results computed against the dropped index
        self._invalidate(name)

    def list_collections(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._indexes))

    def collection(self, name: str) -> CollectionHandle:
        """A bound handle for ``name`` (KeyError if it does not exist)."""
        self.index_of(name)  # existence check
        return CollectionHandle(self, name)

    def index_of(self, name: str):
        with self._lock:
            try:
                return self._indexes[name]
            except KeyError:
                raise KeyError(
                    f"no collection {name!r}; have {sorted(self._indexes)}"
                ) from None

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._indexes

    def __len__(self) -> int:
        with self._lock:
            return len(self._indexes)

    def __iter__(self) -> Iterator[str]:
        return iter(self.list_collections())

    # -------------------------------------------------------------- routing
    def submit(
        self,
        collection: str,
        query: np.ndarray,
        *,
        k: int | None = None,
        params: SearchParams | None = None,
        filter=None,
        deadline_ms: float | None = None,
    ):
        """Enqueue one query for ``collection``; returns a
        Future[RequestResult]. Requests sharing a (collection, k-bin,
        params, filter) group share one fixed-shape dispatch on the common
        core. ``deadline_ms`` bounds queue time (see
        ``BatchingEngine.submit``); a semantic-cache hit resolves
        immediately and never expires.

        With a :class:`SemanticCache` installed, a query embedding within
        the cache's cosine threshold of an already-answered one (under the
        SAME (collection, k, params, filter) scope) resolves immediately
        from the cache — the returned future is already completed and its
        ``RequestResult.cached`` is True. Misses fall through to the
        engine and populate the cache on completion, unless the collection
        was written to while the request was in flight (the result would
        already be stale)."""
        cache = self._semantic_cache
        if cache is None:
            return self._engine.submit(query, k=k, params=params,
                                       collection=collection, filter=filter,
                                       deadline_ms=deadline_ms)
        scope = (collection, k, params, filter)
        q = np.asarray(query, np.float32).reshape(-1)
        hit = cache.get(scope, q)
        if hit is not None:
            fut: Future = Future()
            fut.set_result(
                RequestResult(
                    result=hit, latency_ms=0.0, batch_size=0,
                    batch_index=-1, cached=True,
                )
            )
            return fut
        with self._lock:
            gen = self._write_gen.get(collection, 0)
        fut = self._engine.submit(query, k=k, params=params,
                                  collection=collection, filter=filter,
                                  deadline_ms=deadline_ms)

        def _store(done, _q=q, _scope=scope, _gen=gen):
            if done.cancelled() or done.exception() is not None:
                return
            with self._lock:
                stale = self._write_gen.get(collection, 0) != _gen
            if not stale:
                cache.put(_scope, _q, done.result().result)

        fut.add_done_callback(_store)
        return fut

    def search(
        self,
        collection: str,
        queries: np.ndarray,
        *,
        k: int | None = None,
        params: SearchParams | None = None,
        filter=None,
    ) -> list[RequestResult]:
        """Synchronous convenience: submit a (Q, d) batch, flush, gather.
        Routed through :meth:`submit` so the semantic cache applies."""
        futs = [
            self.submit(collection, q, k=k, params=params, filter=filter)
            for q in np.asarray(queries)
        ]
        self._engine.flush(collection=collection)
        return [f.result() for f in futs]

    def flush(self, collection: str | None = None) -> None:
        self._engine.flush(collection=collection)

    # --------------------------------------------------------------- writes
    def _invalidate(self, collection: str) -> None:
        """A write landed on ``collection``: bump its generation (in-flight
        misses stop populating the cache) and drop its cached entries."""
        with self._lock:
            self._write_gen[collection] = (
                self._write_gen.get(collection, 0) + 1
            )
        if self._semantic_cache is not None:
            self._semantic_cache.invalidate(
                lambda scope: scope[0] == collection
            )

    def insert(
        self, collection: str, vectors, ids=None, *, metadata=None
    ) -> np.ndarray:
        out = self._engine.insert(
            vectors, ids, collection=collection, metadata=metadata
        )
        self._invalidate(collection)
        return out

    def delete(self, collection: str, ids) -> int:
        removed = self._engine.delete(ids, collection=collection)
        self._invalidate(collection)
        return removed

    def compact(self, collection: str) -> bool:
        # compaction does not change the live set, but it swaps the base
        # artifact the cached results were computed against — invalidate
        # rather than reason about bit-identity across a rebuild
        did = self._engine.compact(collection=collection)
        if did:
            self._invalidate(collection)
        return did

    # -------------------------------------------------------------- metrics
    def metrics(self) -> EngineMetrics:
        """Aggregate serving metrics of the shared core, including the
        compile-cache hit/miss/unique-executable counters and — when a
        semantic cache is installed — its hit/miss/eviction/invalidation
        counters."""
        m = self._engine.metrics()
        if self._semantic_cache is not None:
            cs = self._semantic_cache.stats()
            m = m._replace(
                semantic_hits=cs.hits,
                semantic_misses=cs.misses,
                semantic_evictions=cs.evictions,
                semantic_invalidations=cs.invalidations,
            )
        return m

    def metrics_windows(self) -> dict:
        """The engine's trailing metric windows (latency/hops/ios/fetch
        wall) in one atomic snapshot — the exposition layer's histogram
        feed (see ``BatchingEngine.metrics_windows``)."""
        return self._engine.metrics_windows()

    def stats(self) -> dict:
        """Per-collection index stats keyed by collection name, as plain
        dicts (dataclass stats flattened recursively — a mutable index
        nests its base's ``BuildStats`` under ``"base"``). Includes the
        residency split (``resident_pages``/``resident_bytes`` vs
        ``pages``/``disk_bytes``) for streamed collections — the
        ``/stats`` endpoint's payload."""
        with self._lock:
            snapshot = dict(self._indexes)
        out: dict[str, dict] = {}
        for name, idx in snapshot.items():
            st = getattr(idx, "stats", None)
            if dataclasses.is_dataclass(st) and not isinstance(st, type):
                st = dataclasses.asdict(st)
            elif hasattr(st, "_asdict"):
                st = st._asdict()
            out[name] = st if isinstance(st, dict) else {}
        return out

    # ------------------------------------------------------------ lifecycle
    def save(self, directory: str) -> None:
        """Persist every collection under ``directory`` as one database
        (``db.json`` + per-collection artifacts); round-trips through
        :meth:`load`."""
        with self._lock:
            snapshot = dict(self._indexes)
        persist.save_database(snapshot, directory)

    @classmethod
    def load(
        cls,
        directory: str,
        *,
        memory_budget=None,
        recall_target: float | None = None,
        **service_kwargs: Any,
    ) -> "VectorService":
        """Reopen a saved database as a ready-to-serve service: every
        collection in ``db.json`` is loaded (whatever index kind it
        persisted as, by either package) onto the service's ``device``
        (a ``service_kwargs`` key) and registered on a fresh shared core.
        ``memory_budget`` caps each collection's device-resident page
        region independently (see :meth:`attach`).

        ``recall_target`` resolves each collection's serving defaults from
        its autotuned operating points where possible. Lenient per
        collection — a database mixes index kinds and tuning states, so a
        collection with no qualifying tuned point keeps its own defaults
        instead of failing the whole load (use :meth:`attach` for the
        strict single-artifact behavior)."""
        svc = cls(**service_kwargs)
        try:
            loaded = persist.load_database(
                directory, device=svc.device, memory_budget=memory_budget
            )
            for name, index in loaded.items():
                params = None
                if recall_target is not None:
                    try:
                        params = index.params_for_target(
                            recall_target=recall_target
                        )
                    except (LookupError, AttributeError):
                        params = None
                svc.create_collection(name, index, params=params)
        except Exception:
            svc.close()
            raise
        return svc
