"""Semantic query cache: (query embedding, result) pairs keyed by cosine
similarity.

Port of ``repro.serve.semantic_cache`` (host-side numpy, as there: it sits
in front of dispatch, so no lookup touches the card).

RAG front-ends send near-duplicate queries — the same question rephrased,
re-embedded with jitter, retried. An exact-match cache misses all of
them; a *semantic* cache returns the stored result whenever a new query
embedding is within a cosine-similarity threshold of a cached one. It
sits in FRONT of :class:`repro_torch.serve.service.VectorService.submit`: a hit
skips the batching engine entirely (no queueing, no device dispatch), a
miss falls through and the completed result is inserted on the way out.

Entries are scoped per (collection, k, params, filter) — a hit must be an
answer to the *same question*, not just a nearby embedding — and the
whole collection scope is invalidated on any write (insert / delete /
compact / drop): a cached result may reference deleted ids or miss fresh
inserts, so correctness beats hit rate.

Lookup is a brute-force dot product over the scope's stored (normalized)
embeddings — numpy on host, O(entries x dim). At cache-sized entry counts
(thousands) this is microseconds, far below one engine batch; the point
of the cache is to skip the *index* scan, not to be an index itself.

Eviction: global LRU capacity bound plus optional per-entry TTL. All
methods are thread-safe (one lock; the engine submits from many
threads). Zero-norm query embeddings bypass the cache (cosine similarity
is undefined for them).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Hashable, NamedTuple

import numpy as np


class CacheStats(NamedTuple):
    """Counters since construction (monotonic; reads are lock-consistent)."""

    hits: int
    misses: int
    evictions: int
    invalidations: int
    entries: int


class _Entry(NamedTuple):
    vec: np.ndarray       # (d,) f32, unit-normalized
    result: Any
    expires: float        # monotonic deadline, +inf when no TTL


class SemanticCache:
    """Similarity-keyed result cache.

    ``threshold``: minimum cosine similarity for a hit (1.0 = exact
    match only). ``capacity``: global LRU bound on entries across all
    scopes. ``ttl``: seconds an entry stays valid (None = forever).
    """

    def __init__(
        self,
        threshold: float = 0.98,
        capacity: int = 4096,
        ttl: float | None = None,
        *,
        clock=time.monotonic,
    ):
        if not -1.0 <= threshold <= 1.0:
            raise ValueError(
                f"threshold must be a cosine in [-1, 1], got {threshold}"
            )
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if ttl is not None and ttl <= 0:
            raise ValueError(f"ttl must be positive, got {ttl}")
        self.threshold = float(threshold)
        self.capacity = int(capacity)
        self.ttl = ttl
        self._clock = clock
        self._lock = threading.Lock()
        # insertion/recency order across ALL scopes: key -> (scope, entry)
        self._lru: OrderedDict[tuple, tuple[Hashable, _Entry]] = OrderedDict()
        # scope -> {key: entry} for O(scope) lookup and O(1) invalidation
        self._scopes: dict[Hashable, dict[tuple, _Entry]] = {}
        self._seq = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._invalidations = 0
        # optional span tracer (duck-typed, see repro_torch.obs.trace.Tracer),
        # attached by VectorService; lookups emit "semantic_lookup" spans
        # stamped with the tracer's own clock
        self.tracer = None

    @staticmethod
    def _normalize(query: np.ndarray) -> np.ndarray | None:
        v = np.asarray(query, np.float32).reshape(-1)
        n = float(np.linalg.norm(v))
        if n == 0.0 or not np.isfinite(n):
            return None
        return v / n

    def get(self, scope: Hashable, query: np.ndarray):
        """Best cached result within ``threshold`` of ``query`` under
        ``scope``, or None. A hit refreshes the entry's LRU recency."""
        tr = self.tracer
        if tr is not None and tr.enabled:
            t0 = tr.now()
            out = self._get(scope, query)
            tr.add("semantic_lookup", t0, tr.now(), cat="cache",
                   track="semantic-cache", args={"hit": out is not None})
            return out
        return self._get(scope, query)

    def _get(self, scope: Hashable, query: np.ndarray):
        v = self._normalize(query)
        with self._lock:
            if v is None or not self._scopes.get(scope):
                self._misses += 1
                return None
            now = self._clock()
            entries = self._scopes[scope]
            expired = [k for k, e in entries.items() if e.expires < now]
            for k in expired:
                del entries[k]
                del self._lru[k]
                self._evictions += 1
            if not entries:
                self._misses += 1
                return None
            keys = list(entries)
            mat = np.stack([entries[k].vec for k in keys])
            sims = mat @ v
            best = int(np.argmax(sims))
            if float(sims[best]) < self.threshold:
                self._misses += 1
                return None
            self._hits += 1
            self._lru.move_to_end(keys[best])
            return entries[keys[best]].result

    def put(self, scope: Hashable, query: np.ndarray, result: Any) -> None:
        """Insert a completed result; evicts the global LRU tail when the
        capacity bound is hit."""
        v = self._normalize(query)
        if v is None:
            return
        with self._lock:
            self._seq += 1
            key = (scope, self._seq)
            deadline = (
                self._clock() + self.ttl if self.ttl is not None
                else float("inf")
            )
            entry = _Entry(vec=v, result=result, expires=deadline)
            self._lru[key] = (scope, entry)
            self._scopes.setdefault(scope, {})[key] = entry
            while len(self._lru) > self.capacity:
                old_key, (old_scope, _) = self._lru.popitem(last=False)
                bucket = self._scopes.get(old_scope)
                if bucket is not None:
                    bucket.pop(old_key, None)
                    if not bucket:
                        del self._scopes[old_scope]
                self._evictions += 1

    def invalidate(self, match=None) -> int:
        """Drop entries whose scope satisfies ``match`` (a predicate over
        scopes; None drops everything). Returns how many entries went.
        Writers call this with a per-collection predicate: any insert /
        delete / compact makes that collection's cached results stale."""
        with self._lock:
            if match is None:
                n = len(self._lru)
                self._lru.clear()
                self._scopes.clear()
            else:
                doomed = [s for s in self._scopes if match(s)]
                n = 0
                for s in doomed:
                    for key in self._scopes[s]:
                        del self._lru[key]
                        n += 1
                    del self._scopes[s]
            self._invalidations += n
            return n

    def stats(self) -> CacheStats:
        with self._lock:
            return CacheStats(
                hits=self._hits,
                misses=self._misses,
                evictions=self._evictions,
                invalidations=self._invalidations,
                entries=len(self._lru),
            )

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)
