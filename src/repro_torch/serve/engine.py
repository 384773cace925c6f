"""Request-batching serving core, collection-agnostic.

Port of ``repro.serve.engine``. The search behind a collection runs on its
index's device (the card by default); the engine itself is host-side
Python, and results come back as numpy arrays, as in the reference. A
collection registered with ``mesh=`` dispatches through its index's mesh
search (``shard_search`` for a PageANN index, the data-axis fan-out for a
sharded store).

The reference's jitted search is fixed-shape: one compiled executable per
(batch, k, SearchParams, index geometry) signature. A serving workload,
though, is a stream of single queries arriving at arbitrary times with
per-request knobs, possibly aimed at different *collections* (per-tenant
corpora, per-modality embeddings) served by one process. This engine bridges the
two — the paper's "query threads" as a batching frontend:

  * one or more named **collections** register a search backend each
    (``add_collection``); ``submit`` enqueues one query (optionally with
    its own ``k``/``SearchParams``/``collection``) and returns a future;
  * requests are grouped by ``(collection, k-bin, params, filter)``: each
    distinct group fills its own fixed-shape batch, so per-request knobs
    never force a recompile of an already-warm executable — and requests
    carrying different filter predicates (static args of the compiled
    program) never share a dispatch. Per-request ``k`` is
    rounded UP to the engine's ``k_bins`` grid (results trimmed back to
    the requested k), so the number of compiled shapes — and the padding a
    small k pays — stays bounded no matter how many distinct k values
    clients send;
  * the **compiled executable is keyed by geometry**, not by collection:
    a shared :class:`repro_torch.serve.compile_cache.CompileCache` tracks
    (geometry, batch, resolved params) signatures, so two collections
    with identical geometry dispatch through one warm executable — the
    second collection compiles nothing (hit/miss counters ride
    ``metrics()``);
  * a group dispatches when ``batch_size`` of its requests are pending,
    when ``timeout_ms`` elapses after the first pending request, or on an
    explicit ``flush`` — whichever comes first. The search runs in the
    thread that triggered the dispatch, so one submit() in every
    ``batch_size`` pays the search latency inline — amortized, not hidden.
    Timer dispatches run one at a time: a group that comes due while one
    runs goes out when it returns (see ``_flush_due``);
  * ragged batches are zero-padded to the fixed ``batch_size`` shape (one
    executable per group, no recompiles) and the pad rows' results dropped;
  * results are demultiplexed back to futures in submission order, with
    per-request latency and aggregate QPS / mean-I/O counters.

The engine lock covers only queue and counter bookkeeping — the search
itself runs outside it, so other threads keep enqueuing (and the next
batch keeps filling) while a batch computes.

A collection backend is any ``fn(queries (B, d), k, params) ->
SearchResult``-like NamedTuple (or tuple, list or dict) of arrays or
tensors with a leading batch axis. ``from_index``
remains the one-collection convenience: it wraps anything speaking the
:class:`repro_torch.core.protocol.VectorIndex` protocol under the collection
name ``"default"``, so pre-multi-collection call sites keep working
unchanged. The database-level surface (create/attach/drop/save/load of
whole collections) lives one layer up in
:class:`repro_torch.serve.service.VectorService`.

The engine is a context manager; ``close()`` flushes pending groups and
is idempotent.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.config import SearchParams
from repro_torch.serve.compile_cache import (
    CompileCache,
    geometry_of,
    unshared_token,
)

DEFAULT_COLLECTION = "default"


def _tree_map(fn, tree):
    """``fn`` over the leaves of a result: NamedTuples, tuples, lists and
    dicts are walked, None is kept, anything else is a leaf."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {key: _tree_map(fn, t) for key, t in tree.items()}
    return fn(tree)


def _host(a):
    """A result leaf as a numpy array (a device tensor is copied back)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class RequestResult(NamedTuple):
    """One request's slice of the batch result, plus serving metadata."""

    result: Any          # per-request result (leaves: leading axis removed)
    latency_ms: float    # submit -> demux wall time
    batch_size: int      # how many real requests shared the dispatch
    batch_index: int     # which dispatch served it (0-based)
    cached: bool = False  # served from the semantic cache, no dispatch


class EngineMetrics(NamedTuple):
    """One lock-consistent snapshot of the engine's serving counters.

    ``metrics()`` captures EVERY source — engine counters and windows,
    compile-cache hit/miss totals, and each streamed collection's live
    fetch counters — under one acquisition of the engine lock, at one
    snapshot instant. Monotonicity contract: the cumulative counters
    (``requests``, ``batches``, ``inserts``, ``deletes``,
    ``compactions``, ``early_exits``, ``compile_*``, ``pages_fetched``,
    ``fetch_hits``, ``fetch_wall_s``, ``semantic_*``) never decrease
    across successive snapshots of one engine, and no counter can run
    ahead of the ``requests`` it belongs to within a snapshot — safe to
    export as Prometheus counters and ``rate()`` over. The remaining
    fields (qps, latency/hops/ios aggregates, occupancy) are gauges
    derived from bounded trailing windows and move both ways.
    """

    requests: int
    batches: int
    # completed requests / wall-clock between the first submit and the most
    # recent demux. 0.0 until at least one dispatch has completed AND a
    # nonzero wall has elapsed — a single instantaneous batch (or a mocked
    # clock) has no measurable wall, and reporting inf for it poisoned
    # downstream aggregation.
    qps: float
    latency_ms_mean: float     # over the trailing latency window
    latency_ms_p50: float
    latency_ms_p99: float
    mean_ios: float            # mean disk page reads per request
    mean_batch_occupancy: float  # real requests per dispatched batch
    padded_fraction: float     # pad rows / dispatched rows
    inserts: int = 0           # vectors written through engine.insert
    deletes: int = 0           # ids removed through engine.delete
    compactions: int = 0       # compact() calls that folded the delta
    collections: int = 0       # registered collections
    compile_hits: int = 0      # dispatches served by an already-warm executable
    compile_misses: int = 0    # dispatches that compiled a new executable
    compiled_executables: int = 0  # distinct (geometry, batch, params) signatures
    # streaming page tier (summed over collections with a MemoryBudget):
    pages_fetched: int = 0     # page records read off the host memmap
    fetch_hits: int = 0        # page requests served by the staging cache
    fetch_wall_s: float = 0.0  # wall seconds inside the host fetch callback
    # traversal cost per request (trailing window over SearchResult
    # counters) — where adaptive early termination shows up in serving
    mean_hops: float = 0.0     # mean while_loop hops per request
    p99_hops: float = 0.0
    p99_ios: float = 0.0
    # requests whose search exited before the resolved params' max_hops
    # (early termination, beam exhaustion, or convergence)
    early_exits: int = 0
    # requests whose deadline_ms passed while still queued: completed
    # exceptionally with TimeoutError, never dispatched (admission
    # control's load-shedding signal)
    sheds: int = 0
    # semantic query cache (populated by VectorService when one is
    # installed; the bare engine reports zeros)
    semantic_hits: int = 0          # submits served from the cache
    semantic_misses: int = 0        # submits that fell through to a dispatch
    semantic_evictions: int = 0     # entries dropped by LRU or TTL
    semantic_invalidations: int = 0  # entries dropped by writes


class _Pending(NamedTuple):
    future: Future
    query: np.ndarray
    k: int               # the k the caller asked for (<= the group's k bin)
    t_submit: float
    rid: int             # engine-wide request id (trace span track key)
    # absolute engine-clock time after which this request is shed instead
    # of dispatched (None = wait forever). Expiry applies only while
    # QUEUED: once taken into a batch the request completes normally.
    deadline: float | None = None


class _Collection(NamedTuple):
    """One named backend behind the shared batching core."""

    name: str
    search_fn: Callable[[np.ndarray, int, SearchParams | None], Any]
    dim: int
    default_k: int
    default_params: SearchParams | None
    geometry: tuple      # compile-cache geometry key (see compile_cache)
    resolve_fn: Callable | None   # (k, params) -> resolved SearchParams
    insert_fn: Callable | None
    delete_fn: Callable | None
    compact_fn: Callable | None
    # () -> {pages_fetched, fetch_hits, fetch_wall_s}; None when the
    # backend has no streaming page tier
    fetch_stats_fn: Callable | None = None
    # whether search_fn takes a 4th positional arg (a FilterExpr): True
    # for index-backed collections whose search exposes filter=; raw
    # three-arg closures reject filtered submits up front
    accepts_filter: bool = False
    # QoS dispatch weight: when several groups are due, the one with the
    # highest priority * queue-age dispatches first (weighted aging —
    # high-priority collections win contended slots, low-priority ones
    # age their way in instead of starving)
    priority: float = 1.0


class BatchingEngine:
    def __init__(
        self,
        search_fn: Callable[[np.ndarray, int, SearchParams | None], Any]
        | None = None,
        *,
        dim: int | None = None,
        batch_size: int = 64,
        timeout_ms: float | None = None,
        default_k: int | None = None,
        default_params: SearchParams | None = None,
        k_bins: tuple[int, ...] | None = None,
        latency_window: int = 8192,
        dtype=np.float32,
        clock: Callable[[], float] = time.perf_counter,
        insert_fn: Callable[[np.ndarray, Any], np.ndarray] | None = None,
        delete_fn: Callable[[Any], int] | None = None,
        compact_fn: Callable[[], bool] | None = None,
        compile_cache: CompileCache | None = None,
        tracer=None,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if k_bins is not None and (not k_bins or min(k_bins) < 1):
            raise ValueError("k_bins must be a non-empty tuple of positive ints")
        self._batch_size = batch_size
        self._timeout_ms = timeout_ms
        self._k_bins = tuple(sorted(k_bins)) if k_bins else None
        self._dtype = dtype
        self._clock = clock
        self._lock = threading.RLock()
        self._collections: dict[str, _Collection] = {}
        # (collection, k_bin, params, filter) -> pending requests of that group
        self._pending: dict[tuple, list[_Pending]] = {}
        self._timer: threading.Timer | None = None
        self._timer_gen = 0     # invalidates stale timers (see _flush_due)
        self._timer_running = False   # a timer thread is dispatching
        self._closed = False
        self._compile_cache = compile_cache or CompileCache()
        # request tracing (duck-typed — anything with .enabled/.add; see
        # repro_torch.obs.trace.Tracer). Spans are stamped with the ENGINE's
        # injected clock via tracer.add, so a fake engine clock yields a
        # coherent trace. None = tracing off with zero hot-path cost.
        self._tracer = tracer
        self._rid = 0
        # aggregate counters (window-bounded where they would otherwise grow)
        self._latencies_ms: collections.deque = collections.deque(
            maxlen=latency_window
        )
        # per-request traversal cost (SearchResult hops/ios), same window
        self._hops_win: collections.deque = collections.deque(
            maxlen=latency_window
        )
        self._ios_win: collections.deque = collections.deque(
            maxlen=latency_window
        )
        self._early_exits = 0
        self._sheds = 0
        self._inserts = 0
        self._deletes = 0
        self._compactions = 0
        self._completed = 0
        self._total_ios = 0.0
        self._batches = 0
        self._dispatched_rows = 0
        self._padded_rows = 0
        self._t_first: float | None = None
        self._t_last: float | None = None
        if search_fn is not None:
            # one-collection compatibility construction: the raw backend
            # becomes the "default" collection
            if dim is None:
                raise ValueError("dim is required when search_fn is given")
            self.add_collection(
                DEFAULT_COLLECTION,
                search_fn,
                dim=dim,
                default_k=default_k,
                default_params=default_params,
                insert_fn=insert_fn,
                delete_fn=delete_fn,
                compact_fn=compact_fn,
            )
        elif any(
            f is not None
            for f in (dim, default_k, default_params, insert_fn, delete_fn,
                      compact_fn)
        ):
            raise ValueError(
                "per-collection arguments need search_fn (or use "
                "add_collection on an empty engine)"
            )

    # ------------------------------------------------------- context manager
    def __enter__(self) -> "BatchingEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ---------------------------------------------------------- collections
    def add_collection(
        self,
        name: str,
        search_fn: Callable[[np.ndarray, int, SearchParams | None], Any]
        | None = None,
        *,
        index=None,
        dim: int | None = None,
        default_k: int | None = None,
        default_params: SearchParams | None = None,
        insert_fn: Callable | None = None,
        delete_fn: Callable | None = None,
        compact_fn: Callable | None = None,
        geometry: tuple | None = None,
        resolve_fn: Callable | None = None,
        mesh=None,
        priority: float = 1.0,
    ) -> None:
        """Register a named collection on the shared batching core.

        Either pass a raw ``search_fn`` + ``dim``, or ``index=`` anything
        speaking the :class:`repro_torch.core.protocol.VectorIndex`
        protocol — its search/write surface and compile-cache geometry are
        derived automatically (a ``MutableVectorIndex`` wires insert/
        delete/compact; with ``mesh=`` every dispatch passes the mesh to
        ``index.search``, e.g. ``shard_search`` over a ``PageANNIndex``).
        """
        if not name or not isinstance(name, str):
            raise ValueError("collection name must be a non-empty string")
        priority = float(priority)
        if not priority > 0:
            raise ValueError("priority must be > 0")
        accepts_filter = False
        if index is not None:
            if search_fn is not None:
                raise ValueError("pass either search_fn or index, not both")
            import inspect

            accepts_filter = "filter" in inspect.signature(
                index.search
            ).parameters

            def search_fn(queries, k_bin, p, flt=None, _index=index,
                          _mesh=mesh):
                kw = {}
                if _mesh is not None:
                    kw["mesh"] = _mesh
                if flt is not None:
                    kw["filter"] = flt
                return _index.search(queries, k=k_bin, params=p, **kw)

            dim = index.dim
            if default_params is None:
                default_params = getattr(index, "default_params", None)
            geometry = geometry if geometry is not None else geometry_of(index)
            if mesh is not None:
                # a mesh dispatch runs shard_search, not batch_search (the
                # reference's separate executable): same index geometry,
                # another compile identity
                geometry = geometry + (("mesh", mesh),)
            if resolve_fn is None:
                resolve_fn = getattr(index, "resolve_params", None)
            insert_fn = insert_fn or getattr(index, "insert", None)
            delete_fn = delete_fn or getattr(index, "delete", None)
            compact_fn = compact_fn or getattr(index, "compact", None)
            fetch_stats_fn = getattr(index, "fetch_stats", None)
            # hang the engine's tracer on the index, and on a streamed
            # index's host-side page fetcher, so the search's phases and
            # per-hop fetch callbacks show up as child spans of the
            # dispatch that triggered them
            fetcher = getattr(index, "fetcher", None)
            if fetcher is not None and self._tracer is not None:
                fetcher.tracer = self._tracer
            if hasattr(index, "tracer") and self._tracer is not None:
                index.tracer = self._tracer
        else:
            fetch_stats_fn = None
        if search_fn is None or dim is None:
            raise ValueError("add_collection needs (search_fn, dim) or index=")
        # same precedence as resolve_search_params: an explicit default_k
        # wins, otherwise the configured params speak, otherwise k=10
        if default_k is None:
            default_k = default_params.k if default_params is not None else 10
        if geometry is None:
            # a raw closure's compiled identity is the closure itself
            geometry = ("fn", unshared_token(search_fn))
        col = _Collection(
            name=name,
            search_fn=search_fn,
            dim=int(dim),
            default_k=int(default_k),
            default_params=default_params,
            geometry=geometry,
            resolve_fn=resolve_fn,
            insert_fn=insert_fn,
            delete_fn=delete_fn,
            compact_fn=compact_fn,
            fetch_stats_fn=fetch_stats_fn,
            accepts_filter=accepts_filter,
            priority=priority,
        )
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            if name in self._collections:
                raise ValueError(f"collection {name!r} already exists")
            self._collections[name] = col

    def remove_collection(self, name: str) -> None:
        """Unregister ``name`` after dispatching its pending groups. Later
        submits to it raise ``KeyError``; other collections are untouched.

        Loops flush -> check-empty-under-lock -> pop, because a concurrent
        ``submit`` that resolved the collection before this call may enqueue
        *between* a flush and the pop; popping only once the collection's
        pending set is observed empty under the lock (after which submit's
        own under-lock registration re-check raises) guarantees no future
        is stranded undispatched."""
        with self._lock:
            if name not in self._collections:
                raise KeyError(f"no collection {name!r}")
        while True:
            self.flush(collection=name)
            with self._lock:
                if not any(
                    grp and key[0] == name
                    for key, grp in self._pending.items()
                ):
                    self._collections.pop(name, None)
                    return

    def collections(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._collections))

    def _resolve_collection(self, name: str | None) -> _Collection:
        """Route a request: an explicit name must exist; ``None`` falls back
        to the sole registered collection (or one literally named
        "default"), so one-collection engines keep the old call shape."""
        with self._lock:
            if name is not None:
                try:
                    return self._collections[name]
                except KeyError:
                    raise KeyError(
                        f"no collection {name!r}; have "
                        f"{sorted(self._collections)}"
                    ) from None
            if len(self._collections) == 1:
                return next(iter(self._collections.values()))
            if DEFAULT_COLLECTION in self._collections:
                return self._collections[DEFAULT_COLLECTION]
            if not self._collections:
                raise RuntimeError("engine has no collections")
            raise ValueError(
                "multiple collections are registered; pass collection= "
                f"(one of {sorted(self._collections)})"
            )

    # ------------------------------------------------------------- requests
    def _bin_k(self, k: int) -> int:
        """Round k up to the engine's k grid (bounded compiled shapes)."""
        if self._k_bins is None:
            return k
        for b in self._k_bins:
            if b >= k:
                return b
        return k  # above the grid: its own exact shape

    def submit(
        self,
        query: np.ndarray,
        *,
        k: int | None = None,
        params: SearchParams | None = None,
        collection: str | None = None,
        filter=None,
        deadline_ms: float | None = None,
    ) -> Future:
        """Enqueue one (d,) query; returns a Future[RequestResult].

        ``k``/``params`` default to the target collection's; requests
        sharing a (collection, k-bin, params, filter) group share one
        fixed-shape dispatch. The filter expression is part of the group
        key: a batch is a SINGLE backend call, and the predicate is a
        static argument of its compiled program — two requests with
        different predicates can never share a dispatch.

        ``deadline_ms`` bounds QUEUE time: a request still pending when
        its deadline passes completes exceptionally with ``TimeoutError``
        (counted as ``sheds`` in :class:`EngineMetrics`) instead of
        waiting forever. Once taken into a batch it completes normally —
        the deadline sheds load, it does not cancel dispatched work.
        """
        if deadline_ms is not None and not deadline_ms > 0:
            raise ValueError("deadline_ms must be > 0")
        col = self._resolve_collection(collection)
        if filter is not None and not col.accepts_filter:
            raise ValueError(
                f"collection {col.name!r} does not support filtered "
                "search (raw search_fn backends take no filter)"
            )
        q = np.asarray(query, self._dtype).reshape(-1)
        if q.shape[0] != col.dim:
            raise ValueError(
                f"query dim {q.shape[0]} != collection {col.name!r} dim "
                f"{col.dim}"
            )
        if k is None:
            # an explicit SearchParams speaks for the request: its k wins
            # over the collection default unless the kwarg overrides it
            k = params.k if params is not None else col.default_k
        k = int(k)
        if k < 1:
            raise ValueError("k must be >= 1")
        params = params if params is not None else col.default_params
        key = (col.name, self._bin_k(k), params, filter)
        fut: Future = Future()
        batch = None
        tr = self._tracer
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            if col.name not in self._collections:
                # lost a race with remove_collection after resolving the
                # collection: refuse rather than strand the future in a
                # group nothing will ever dispatch
                raise KeyError(f"no collection {col.name!r}")
            if self._t_first is None:
                self._t_first = self._clock()
            self._rid += 1
            rid = self._rid
            t_submit = self._clock()
            deadline = (
                t_submit + deadline_ms / 1e3 if deadline_ms is not None
                else None
            )
            group = self._pending.setdefault(key, [])
            group.append(_Pending(fut, q, k, t_submit, rid, deadline))
            if len(group) >= self._batch_size:
                batch, shed = self._take_locked(key)
            else:
                shed = ()
                self._arm_timer_locked()
        if tr is not None and tr.enabled:
            tr.add("submit", t_submit, t_submit, cat="request",
                   track=f"req-{rid}",
                   args={"collection": col.name, "k": k})
        self._fail_shed(shed)
        if batch is not None:
            self._run_batch(key, batch)
        return fut

    def flush(self, collection: str | None = None) -> None:
        """Dispatch whatever is pending — in every group, or only the named
        collection's groups — padding ragged batches. When several groups
        are eligible the highest ``priority * queue-age`` dispatches
        first (weighted aging: see ``add_collection(priority=)``)."""
        while True:
            with self._lock:
                key = self._next_key_locked(collection)
                batch, shed = (
                    self._take_locked(key) if key is not None else (None, ())
                )
            self._fail_shed(shed)
            if batch is None:
                return
            self._run_batch(key, batch)

    def _next_key_locked(self, collection: str | None = None):
        """Pick the next pending group to dispatch: weighted aging over
        collection priorities. Caller must hold the lock."""
        now = self._clock()
        best_key, best_rank = None, -1.0
        for key, grp in self._pending.items():
            if not grp or (collection is not None and key[0] != collection):
                continue
            col = self._collections.get(key[0])
            weight = col.priority if col is not None else 1.0
            # +1ms age floor so brand-new groups still rank by priority
            rank = weight * (now - grp[0].t_submit + 1e-3)
            if rank > best_rank:
                best_key, best_rank = key, rank
        return best_key

    def search(
        self,
        queries: np.ndarray,
        *,
        k: int | None = None,
        params: SearchParams | None = None,
        collection: str | None = None,
        filter=None,
    ) -> list[RequestResult]:
        """Synchronous convenience: submit a (Q, d) batch, flush, gather."""
        futs = [
            self.submit(
                q, k=k, params=params, collection=collection, filter=filter
            )
            for q in np.asarray(queries)
        ]
        self.flush(collection=collection)
        return [f.result() for f in futs]

    # --------------------------------------------------------------- writes
    # Write requests run inline against the collection's mutable backend;
    # the backend (``repro_torch.core.delta.MutableIndex``) publishes each mutation as
    # ONE atomic state swap, so in-flight search dispatches — which
    # snapshot that state lock-free at backend-call time — interleave
    # safely: a search sees either the pre- or post-write index, never a
    # half-applied one.

    def insert(
        self, vectors: np.ndarray, ids=None, *,
        collection: str | None = None, metadata=None,
    ) -> np.ndarray:
        """Insert vectors into a collection's mutable backend; returns their
        external ids. Raises if the collection wraps an immutable index.
        ``metadata`` (validated against the backend's schema) makes the new
        rows filterable immediately."""
        col = self._resolve_collection(collection)
        if col.insert_fn is None:
            raise RuntimeError(
                f"collection {col.name!r} does not support insert"
            )
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
        vectors = np.asarray(vectors, self._dtype).reshape(-1, col.dim)
        tr = self._tracer
        tracing = tr is not None and tr.enabled
        t0 = self._clock() if tracing else 0.0
        out = (
            col.insert_fn(vectors, ids, metadata=metadata)
            if metadata is not None
            else col.insert_fn(vectors, ids)
        )
        if tracing:
            tr.add("insert", t0, self._clock(), cat="write", track="writes",
                   args={"collection": col.name, "rows": vectors.shape[0]})
        with self._lock:
            self._inserts += vectors.shape[0]
        return out

    def delete(self, ids, *, collection: str | None = None) -> int:
        """Delete ids from a collection's mutable backend; returns how many
        were live."""
        col = self._resolve_collection(collection)
        if col.delete_fn is None:
            raise RuntimeError(
                f"collection {col.name!r} does not support delete"
            )
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
        tr = self._tracer
        tracing = tr is not None and tr.enabled
        t0 = self._clock() if tracing else 0.0
        removed = col.delete_fn(ids)
        if tracing:
            tr.add("delete", t0, self._clock(), cat="write", track="writes",
                   args={"collection": col.name, "removed": int(removed)})
        with self._lock:
            self._deletes += removed
        return removed

    def compact(self, *, collection: str | None = None) -> bool:
        """Fold a collection's delta tier into a fresh base artifact.
        Pending searches keep completing against the pre-compaction
        snapshot while the rebuild runs."""
        col = self._resolve_collection(collection)
        if col.compact_fn is None:
            raise RuntimeError(
                f"collection {col.name!r} does not support compact"
            )
        tr = self._tracer
        tracing = tr is not None and tr.enabled
        t0 = self._clock() if tracing else 0.0
        did = col.compact_fn()
        if tracing:
            tr.add("compact", t0, self._clock(), cat="write", track="writes",
                   args={"collection": col.name, "compacted": bool(did)})
        if did:
            with self._lock:
                self._compactions += 1
        return did

    def close(self) -> None:
        """Flush pending groups and shut down. Idempotent — a second
        ``close()`` (e.g. explicit call inside a ``with`` block) is a
        no-op."""
        with self._lock:
            if self._closed:
                return
        self.flush()
        with self._lock:
            self._closed = True
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    # ------------------------------------------------------------- dispatch
    def _flush_due(self, gen: int) -> None:
        """Timer callback: dispatch only the groups whose OLDEST request has
        aged past the timeout, then re-arm for whatever remains — a timer
        fired by one stale group must not flush a just-arrived group into a
        near-empty padded batch. A timer that raced a size-triggered
        dispatch (its generation was retired by _take_locked before it got
        the lock) must no-op, or it would prematurely flush the NEXT
        batch.

        One timer thread dispatches at a time: no timer is armed while it
        runs, and groups that come due meanwhile go out from its loop once
        its dispatch returns (with what they gathered in the meantime), or
        from the timer it arms on leaving. The reference re-arms at each
        take, so every dispatch slower than the timeout starts another
        timer thread; the port's search is a host-bound loop, and on an
        H100 that piled up 82 concurrent dispatches of 3.7 requests each
        at 25 QPS (ROADMAP C3)."""
        with self._lock:
            if gen != self._timer_gen or self._closed:
                return
            self._timer = None
            self._timer_running = True
        try:
            self._dispatch_due()
        finally:
            with self._lock:
                self._timer_running = False
                self._arm_timer_locked()

    def _dispatch_due(self) -> None:
        """The timer thread's loop: reap expired requests, then dispatch
        the due group of highest priority, until none is due."""
        timeout_s = (
            self._timeout_ms / 1e3 if self._timeout_ms is not None else None
        )
        while True:
            with self._lock:
                now = self._clock()
                # reap requests whose per-request deadline expired while
                # queued — they complete with TimeoutError, not a dispatch
                shed = self._reap_expired_locked(now)
                key = None
                if timeout_s is not None:
                    due = [
                        key
                        for key, grp in self._pending.items()
                        if grp and now - grp[0].t_submit >= timeout_s
                    ]
                    if due:
                        # among due groups, weighted priority picks first
                        key = max(
                            due,
                            key=lambda kk: (
                                getattr(
                                    self._collections.get(kk[0]), "priority",
                                    1.0,
                                )
                                * (now - self._pending[kk][0].t_submit)
                            ),
                        )
                if key is not None:
                    batch, shed2 = self._take_locked(key)
                    shed += shed2
                else:
                    batch = None
            self._fail_shed(shed)
            if batch is None:
                return
            self._run_batch(key, batch)

    def _reap_expired_locked(self, now: float) -> list[_Pending]:
        """Drop every queued request whose deadline has passed; returns
        them for the caller to fail OUTSIDE the lock (Future callbacks run
        inline). Caller must hold the lock."""
        shed: list[_Pending] = []
        for key in list(self._pending):
            grp = self._pending[key]
            keep = [p for p in grp if p.deadline is None or p.deadline > now]
            if len(keep) != len(grp):
                shed.extend(
                    p for p in grp if p.deadline is not None
                    and p.deadline <= now
                )
                if keep:
                    self._pending[key] = keep
                else:
                    self._pending.pop(key, None)
        self._sheds += len(shed)
        return shed

    def _fail_shed(self, shed) -> None:
        """Complete shed requests exceptionally — never under the engine
        lock (``Future.set_exception`` runs done-callbacks inline)."""
        tr = self._tracer
        for p in shed:
            if tr is not None and tr.enabled:
                now = self._clock()
                tr.add("shed", p.t_submit, now, cat="request",
                       track=f"req-{p.rid}")
            p.future.set_exception(
                TimeoutError(
                    f"request {p.rid} deadline passed after "
                    f"{(self._clock() - p.t_submit) * 1e3:.1f}ms in queue"
                )
            )

    def _arm_timer_locked(self) -> None:
        """Start the timeout timer if requests are pending and none is live.
        The delay is measured from the OLDEST pending submit, not reset to
        the full duration — otherwise steady full-batch traffic in one
        group would push a sparse group's deadline out forever. Pending
        per-request deadlines arm the timer too (even with no engine
        timeout configured), so an expired request is reaped promptly
        rather than on the next unrelated dispatch. Caller must hold the
        lock."""
        if (
            self._timer is not None
            or self._timer_running
            or self._closed
            or not any(self._pending.values())
        ):
            return
        now = self._clock()
        delays = []
        if self._timeout_ms is not None:
            oldest = min(
                p.t_submit for grp in self._pending.values() for p in grp
            )
            delays.append(self._timeout_ms / 1e3 - (now - oldest))
        deadlines = [
            p.deadline
            for grp in self._pending.values()
            for p in grp
            if p.deadline is not None
        ]
        if deadlines:
            delays.append(min(deadlines) - now)
        if not delays:
            return
        delay = max(0.0, min(delays))
        gen = self._timer_gen
        self._timer = threading.Timer(
            delay, self._flush_due, args=(gen,)
        )
        self._timer.daemon = True
        self._timer.start()

    def _take_locked(
        self, key: tuple
    ) -> tuple[tuple[int, list[_Pending]] | None, list[_Pending]]:
        """Pop up to batch_size pending requests of one group and retire the
        live timer — re-arming it when OTHER groups still hold pending
        requests, so a size-triggered dispatch of one (collection, k-bin,
        params) group never strands another group's waiters. Requests
        whose deadline already passed are pruned here (returned as the
        second element for the caller to fail outside the lock), so an
        expired request never consumes a batch slot. Caller must hold the
        lock; the batch index is assigned here so dispatch order matches
        take order even with concurrent submitters. Returns
        ``((batch_index, take), shed)``; the batch is None when pruning
        left nothing to dispatch."""
        group = self._pending.get(key, [])
        now = self._clock()
        shed = [
            p for p in group if p.deadline is not None and p.deadline <= now
        ]
        if shed:
            self._sheds += len(shed)
            group = [
                p for p in group
                if p.deadline is None or p.deadline > now
            ]
        take = group[: self._batch_size]
        rest = group[self._batch_size:]
        if rest:
            self._pending[key] = rest
        else:
            # drop drained keys: distinct (collection, k, params)
            # combinations must not accumulate empty entries in a
            # long-lived server
            self._pending.pop(key, None)
        self._timer_gen += 1
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._arm_timer_locked()
        if not take:
            return None, shed
        batch_index = self._batches
        self._batches += 1
        return (batch_index, take), shed

    def _run_batch(self, key: tuple, batch: tuple[int, list[_Pending]]) -> None:
        """Pad, search (outside the lock), record counters, demux."""
        name, k_bin, params, flt = key
        batch_index, take = batch
        n = len(take)
        tr = self._tracer
        tracing = tr is not None and tr.enabled
        t_take = self._clock() if tracing else 0.0
        with self._lock:
            col = self._collections.get(name)
        if col is None:
            # the collection was dropped between take and run (concurrent
            # remove_collection): fail this group's waiters, not the engine
            exc = RuntimeError(f"collection {name!r} was dropped")
            with self._lock:
                self._dispatched_rows += self._batch_size
                self._padded_rows += self._batch_size - n
            for p in take:
                p.future.set_exception(exc)
            return
        padded = np.zeros((self._batch_size, col.dim), self._dtype)
        for i, p in enumerate(take):
            padded[i] = p.query
        # compiled-executable accounting: the cache key is the collection's
        # GEOMETRY (not its name) plus everything else static in the
        # signature — batch shape and the resolved runtime knobs — so two
        # same-geometry collections register as one executable
        try:
            resolved = (
                col.resolve_fn(k_bin, params)
                if col.resolve_fn is not None
                else (k_bin, params)
            )
        except Exception:
            resolved = (k_bin, params)
        warm = self._compile_cache.note(
            col.geometry + (self._batch_size, resolved)
            + ((("filter", flt),) if flt is not None else ())
        )
        if tracing:
            t_pad = self._clock()
            tr.add("batch_assemble", t_take, t_pad, cat="engine",
                   track="engine",
                   args={"collection": name, "batch_index": batch_index,
                         "n": n})
            for p in take:
                tr.add("queue_wait", p.t_submit, t_take, cat="request",
                       track=f"req-{p.rid}")
        t_call = self._clock() if tracing else 0.0
        try:
            out = (
                col.search_fn(padded, k_bin, params, flt)
                if col.accepts_filter
                else col.search_fn(padded, k_bin, params)
            )
            out = _tree_map(_host, out)
        except Exception as e:
            # a backend failure must reach every waiter of THIS group
            # through its future — not hang them, not vanish into the timer
            # thread's excepthook, and not poison other groups' dispatches
            # (submit/flush never raise backend errors)
            with self._lock:
                self._dispatched_rows += self._batch_size
                self._padded_rows += self._batch_size - n
            for p in take:
                p.future.set_exception(e)
            return

        t_done = self._clock()
        if tracing:
            # a cold dispatch (the first of its signature) pays the
            # one-time costs: overlay a "compile" span on it
            tr.add("device_dispatch", t_call, t_done, cat="engine",
                   track="engine",
                   args={"collection": name, "batch_index": batch_index,
                         "n": n, "compiled": not warm})
            if not warm:
                tr.add("compile", t_call, t_done, cat="compile",
                       track="engine", args={"collection": name})
        ios = getattr(out, "ios", None)
        hops = getattr(out, "hops", None)
        latencies = [(t_done - p.t_submit) * 1e3 for p in take]
        with self._lock:
            self._dispatched_rows += self._batch_size
            self._padded_rows += self._batch_size - n
            self._t_last = t_done
            self._completed += n
            self._latencies_ms.extend(latencies)
            if ios is not None:
                self._total_ios += float(np.sum(ios[:n]))
                self._ios_win.extend(np.asarray(ios[:n]).ravel().tolist())
            if hops is not None:
                self._hops_win.extend(np.asarray(hops[:n]).ravel().tolist())
                if isinstance(resolved, SearchParams):
                    # requests that exited the hop loop before the resolved
                    # params' bound: adaptive early termination (or natural
                    # beam exhaustion) visibly saving page reads
                    self._early_exits += int(
                        np.sum(np.asarray(hops[:n]) < resolved.max_hops)
                    )
        for i, p in enumerate(take):
            row = _tree_map(lambda a: a[i], out)
            if p.k < k_bin:
                # k was rounded up to the bin: trim the result axes back
                row = _tree_map(
                    lambda a: a[: p.k]
                    if getattr(a, "ndim", 0) >= 1 and a.shape[0] == k_bin
                    else a,
                    row,
                )
            p.future.set_result(
                RequestResult(
                    result=row,
                    latency_ms=latencies[i],
                    batch_size=n,
                    batch_index=batch_index,
                )
            )
        if tracing:
            t_end = self._clock()
            tr.add("demux", t_done, t_end, cat="engine", track="engine",
                   args={"batch_index": batch_index, "n": n})
            for i, p in enumerate(take):
                tr.add("request", p.t_submit, t_end, cat="request",
                       track=f"req-{p.rid}",
                       args={"latency_ms": latencies[i],
                             "batch_index": batch_index})

    # -------------------------------------------------------------- metrics
    def metrics(self) -> EngineMetrics:
        """One atomic, lock-consistent snapshot (see ``EngineMetrics``).

        Everything — windows, counters, compile-cache stats, and each
        streamed collection's live fetch counters — is captured under a
        SINGLE acquisition of the engine lock, so a snapshot taken while
        the dispatch/timer threads run never mixes a group of counters
        from before a batch with a group from after it (two separate
        lock sections here used to let ``fetch_wall_s`` run ahead of the
        ``requests`` it belonged to). The compile-cache and fetcher
        locks are leaf locks — their holders never call back into the
        engine — so taking them under the engine lock cannot deadlock.
        """
        with self._lock:
            cc = self._compile_cache.stats()
            pages_fetched = fetch_hits = 0
            fetch_wall_s = 0.0
            for c in self._collections.values():
                if c.fetch_stats_fn is None:
                    continue
                fs = c.fetch_stats_fn()
                pages_fetched += int(fs.get("pages_fetched", 0))
                fetch_hits += int(fs.get("fetch_hits", 0))
                fetch_wall_s += float(fs.get("fetch_wall_s", 0.0))
            lat = np.asarray(self._latencies_ms, np.float64)
            hops_win = np.asarray(self._hops_win, np.float64)
            ios_win = np.asarray(self._ios_win, np.float64)
            done = self._completed
            wall = (
                (self._t_last - self._t_first)
                if done and self._t_last is not None
                else 0.0
            )
            return EngineMetrics(
                requests=done,
                batches=self._batches,
                qps=done / wall if wall > 0 else 0.0,
                latency_ms_mean=float(lat.mean()) if len(lat) else 0.0,
                latency_ms_p50=float(np.percentile(lat, 50)) if len(lat) else 0.0,
                latency_ms_p99=float(np.percentile(lat, 99)) if len(lat) else 0.0,
                mean_ios=self._total_ios / done if done else 0.0,
                mean_batch_occupancy=(
                    (self._dispatched_rows - self._padded_rows) / self._batches
                    if self._batches
                    else 0.0
                ),
                padded_fraction=(
                    self._padded_rows / self._dispatched_rows
                    if self._dispatched_rows
                    else 0.0
                ),
                inserts=self._inserts,
                deletes=self._deletes,
                compactions=self._compactions,
                collections=len(self._collections),
                compile_hits=cc.hits,
                compile_misses=cc.misses,
                compiled_executables=cc.unique,
                pages_fetched=pages_fetched,
                fetch_hits=fetch_hits,
                fetch_wall_s=fetch_wall_s,
                mean_hops=float(hops_win.mean()) if len(hops_win) else 0.0,
                p99_hops=(
                    float(np.percentile(hops_win, 99)) if len(hops_win) else 0.0
                ),
                p99_ios=(
                    float(np.percentile(ios_win, 99)) if len(ios_win) else 0.0
                ),
                early_exits=self._early_exits,
                sheds=self._sheds,
            )

    def metrics_windows(self) -> dict:
        """The raw trailing windows behind the quantile gauges, as one
        atomic snapshot: ``latency_ms`` / ``hops`` / ``ios`` (the
        bounded per-request deques) plus ``fetch_wall_s`` (per-callback
        wall seconds from every streamed collection's fetcher, itself
        window-bounded). Feed of the exposition layer's histograms —
        window-scoped distributions, not cumulative series."""
        with self._lock:
            wall: list = []
            for c in self._collections.values():
                if c.fetch_stats_fn is None:
                    continue
                wall.extend(c.fetch_stats_fn().get("wall_window", ()))
            return dict(
                latency_ms=np.asarray(self._latencies_ms, np.float64),
                hops=np.asarray(self._hops_win, np.float64),
                ios=np.asarray(self._ios_win, np.float64),
                fetch_wall_s=np.asarray(wall, np.float64),
            )

    # ------------------------------------------------------------- builders
    @classmethod
    def from_index(
        cls,
        index,
        *,
        k: int | None = None,
        batch_size: int = 64,
        timeout_ms: float | None = None,
        params: SearchParams | None = None,
        k_bins: tuple[int, ...] | None = None,
        mesh=None,
        **kwargs,
    ) -> "BatchingEngine":
        """One-collection engine over any built/loaded ``VectorIndex``;
        results carry ORIGINAL vector ids.

        Thin compatibility wrapper over the multi-collection core: the
        index is registered as the collection named ``"default"``, so the
        pre-service call shape (``submit`` with no collection) keeps
        working. The backend is the protocol's ``index.search(queries, k,
        params)`` — PageANN, DiskANN, Starling, or a ``MutableIndex``
        alike. When the index speaks the ``MutableVectorIndex`` writes
        (insert/delete/compact), the engine exposes them as request types
        that interleave safely with in-flight searches. For a
        ``PageANNIndex``, passing a mesh (``repro_torch.launch.mesh``)
        dispatches ``shard_search`` with the query batch split across it.
        """
        eng = cls(
            batch_size=batch_size,
            timeout_ms=timeout_ms,
            k_bins=k_bins,
            **kwargs,
        )
        eng.add_collection(
            DEFAULT_COLLECTION,
            index=index,
            default_k=k,
            default_params=params,
            mesh=mesh,
        )
        return eng
