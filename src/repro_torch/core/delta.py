"""Mutable index: an in-memory delta tier and tombstones over a frozen base.

Port of ``repro.core.delta``. The page-aligned artifact (``core.persist``)
is immutable: its layout is compiled at build time. This module makes the
index writable without touching that path:

  * :class:`DeltaTier`: an append-only host buffer of freshly inserted
    vectors. It has no graph: queries scan it by brute force through the
    ``l2_distance`` kernel (``kernels.ops.delta_scan``). The buffer grows by
    doubling and the scanned slice is padded to a power of two.
  * tombstones: deleted base ids are masked out of the base search's
    results (the artifact is never rewritten per delete). The base search
    is oversampled by the tombstone count rounded up to a power of two
    (capped by ``DeltaParams.max_tombstone_oversample``) so masking cannot
    leave fewer than k live results.
  * :class:`MutableIndex`: fans each query out to the page-file search and
    the delta scan, masks tombstoned base hits, and merges the two top-k
    streams (``core.search.merge_topk_streams``). ``insert`` / ``delete`` /
    ``compact`` make it writable; results carry EXTERNAL ids, stable across
    compactions.
  * ``compact()``: rebuilds the base over (base + inserts - deletes) with
    ``PageANNIndex.build`` on the base's device and, when the index is
    persisted, swaps the on-disk artifact atomically
    (``persist.swap_mutable``).

Concurrency: every piece of state a search reads lives in ONE immutable
:class:`_MutableState` tuple. ``search`` reads the current tuple (one
attribute load) and never takes the lock, so a search in flight across an
``insert`` / ``delete`` / ``compact`` sees a consistent (base, tombstones,
delta) snapshot. Writers serialize on the index lock; ``compact`` holds it
for the rebuild, so writes (not reads) wait during compaction. A snapshot's
delta rows reach the device once, on the first search that reads them
(:class:`_DeviceCache`); writers never upload.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import filter as filter_mod
from repro_torch.core import search as search_mod
from repro_torch.core.config import DeltaParams, SearchParams, resolve_search_params
from repro_torch.core.filter import CompiledFilter, FilterExpr, MetaArrays
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

PAD = -1
_INT32_MAX = np.iinfo(np.int32).max


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class _DeviceCache:
    """The device copy of one delta snapshot, made by the first search.

    Writers would otherwise pay an O(delta) host-to-device copy per
    mutation while holding the index lock; instead the first search of a
    fresh snapshot uploads once, under this cache's lock, and later searches
    share the tensors. Correct because the host buffer is append-only: rows
    past the snapshot's count may fill in later, but the live mask (a copy
    frozen at snapshot time) marks them dead in the scan.
    """

    def __init__(self, vecs: np.ndarray, live: np.ndarray,
                 device: torch.device):
        self._vecs = vecs
        self._live = live
        self._device = device
        self._lock = threading.Lock()
        self._dev: tuple[torch.Tensor, torch.Tensor] | None = None

    def get(self) -> tuple[torch.Tensor, torch.Tensor]:
        with self._lock:
            if self._dev is None:
                # torch.tensor copies, so a later append to the host
                # buffer never reaches a tensor a search holds
                self._dev = (torch.tensor(self._vecs, device=self._device),
                             torch.tensor(self._live, device=self._device))
            return self._dev


class DeltaView(NamedTuple):
    """An immutable snapshot of the delta tier (what a search reads).

    Host arrays are copies (``ids`` / ``live``) or slices of the append-only
    buffer whose rows past ``count`` are dead (``vecs``); the device copy is
    made by the first search and shared until the next write. The padded
    length is a power of two, as in the reference, so slot numbering and the
    scan's output shape match it.
    """

    count: int                # rows appended (live or dead)
    n_live: int               # rows not superseded or deleted
    vecs: np.ndarray          # (Cpad, d) f32 host buffer slice
    ids: np.ndarray           # (Cpad,) int64 external ids, PAD padded
    live: np.ndarray          # (Cpad,) bool
    device: _DeviceCache      # lazy (vecs, live) on the scan's device
    tags: np.ndarray          # (Cpad, T) int32 tag codes, -1 padded
    nums: np.ndarray          # (Cpad, N) f32 numerics, NaN padded


class DeltaTier:
    """Append-only fresh-vector store with external-id upsert semantics.

    Not thread-safe by itself: :class:`MutableIndex` serializes writers and
    hands searches immutable :class:`DeltaView` snapshots. Re-inserting a
    live external id kills the superseded row (last write wins); ``kill``
    marks rows dead without reclaiming them (compaction reclaims).
    ``device`` is where a snapshot's scan runs (default the GPU; a host
    without one raises unless ``device="cpu"`` is asked for).
    """

    def __init__(self, dim: int, capacity: int = 256, *,
                 n_tags: int = 0, n_nums: int = 0,
                 device: str | torch.device = "cuda"):
        cap = _pow2(max(int(capacity), 8))
        self.dim = int(dim)
        self.n_tags = int(n_tags)
        self.n_nums = int(n_nums)
        self.device = resolve_device(device)
        self._vecs = np.zeros((cap, self.dim), np.float32)
        self._ids = np.full((cap,), PAD, np.int64)
        self._live = np.zeros((cap,), bool)
        # metadata columns share the base tier's encoding: missing tag = -1,
        # missing numeric = NaN, so unannotated (and padded) rows match no
        # filter clause
        self._tags = np.full((cap, self.n_tags), -1, np.int32)
        self._nums = np.full((cap, self.n_nums), np.nan, np.float32)
        self._count = 0
        self._slot_of: dict[int, int] = {}   # live external id -> row
        self._view: DeltaView | None = None

    def __len__(self) -> int:
        return len(self._slot_of)

    @property
    def live_count(self) -> int:
        return len(self._slot_of)

    @property
    def memory_bytes(self) -> int:
        return int(self._vecs.nbytes + self._ids.nbytes + self._live.nbytes)

    def _grow(self, need: int) -> None:
        cap = self._ids.shape[0]
        if need <= cap:
            return
        new_cap = _pow2(need)
        # fresh buffers + copy: snapshots taken before the grow keep the old
        # buffer, whose first `count` rows never change again
        vecs = np.zeros((new_cap, self.dim), np.float32)
        ids = np.full((new_cap,), PAD, np.int64)
        live = np.zeros((new_cap,), bool)
        tags = np.full((new_cap, self.n_tags), -1, np.int32)
        nums = np.full((new_cap, self.n_nums), np.nan, np.float32)
        c = self._count
        vecs[:c], ids[:c], live[:c] = self._vecs[:c], self._ids[:c], self._live[:c]
        tags[:c], nums[:c] = self._tags[:c], self._nums[:c]
        self._vecs, self._ids, self._live = vecs, ids, live
        self._tags, self._nums = tags, nums

    def insert(self, vectors: np.ndarray, ids: np.ndarray, *,
               tags: np.ndarray | None = None,
               nums: np.ndarray | None = None) -> None:
        vectors = np.ascontiguousarray(vectors, np.float32).reshape(-1, self.dim)
        ids = np.asarray(ids, np.int64).reshape(-1)
        if vectors.shape[0] != ids.shape[0]:
            raise ValueError(
                f"{vectors.shape[0]} vectors for {ids.shape[0]} ids"
            )
        if np.unique(ids).shape[0] != ids.shape[0]:
            raise ValueError("duplicate ids within one insert batch")
        if (ids < 0).any():
            raise ValueError("ids must be non-negative")
        if (ids > _INT32_MAX).any():
            # the top-k merge carries ids as int32; a wider id would wrap
            # silently in search results
            raise ValueError("ids must fit int32 (the merge path's id space)")
        self.kill(ids)                        # last write wins
        n = ids.shape[0]
        self._grow(self._count + n)
        rows = slice(self._count, self._count + n)
        self._vecs[rows] = vectors
        self._ids[rows] = ids
        self._live[rows] = True
        if tags is not None:
            self._tags[rows] = np.asarray(tags, np.int32).reshape(
                n, self.n_tags
            )
        if nums is not None:
            self._nums[rows] = np.asarray(nums, np.float32).reshape(
                n, self.n_nums
            )
        for j, i in enumerate(ids.tolist()):
            self._slot_of[int(i)] = self._count + j
        self._count += n
        self._view = None

    def kill(self, ids: np.ndarray) -> int:
        """Mark rows of these external ids dead; returns how many were live."""
        killed = 0
        for i in np.asarray(ids, np.int64).reshape(-1).tolist():
            slot = self._slot_of.pop(int(i), None)
            if slot is not None:
                self._live[slot] = False
                killed += 1
        if killed:
            self._view = None
        return killed

    def snapshot(self) -> DeltaView:
        if self._view is None:
            cpad = _pow2(max(self._count, 8))
            vecs = self._vecs[:cpad]
            live = self._live[:cpad].copy()
            self._view = DeltaView(
                count=self._count,
                n_live=len(self._slot_of),
                vecs=vecs,
                ids=self._ids[:cpad].copy(),
                live=live,
                device=_DeviceCache(vecs, live, self.device),
                tags=self._tags[:cpad],
                nums=self._nums[:cpad],
            )
        return self._view


def scan_delta(
    view: DeltaView, queries, k: int,
    cfilter: CompiledFilter | None = None, *, impl: str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k of the delta tier: (ids (Q, kk) int64, dists (Q, kk) f32)
    with kk = min(k, padded rows); empty (Q, 0) streams when nothing is
    live. Non-finite distances carry PAD ids (fewer than kk live rows).
    ``cfilter`` masks rows failing the predicate exactly like dead rows, so
    a fresh insert is filterable at once; the row mask is evaluated on the
    host (the delta is small by construction) and uploaded as one (C,) bool.
    ``impl="plain"`` scans with the plain version of the L2 kernel."""
    qn = len(queries)
    if view.n_live == 0 or k == 0:
        return (
            np.full((qn, 0), PAD, np.int64),
            np.full((qn, 0), np.inf, np.float32),
        )
    vecs_dev, live_dev = view.device.get()
    dev = vecs_dev.device
    kk = min(k, vecs_dev.shape[0])
    mask = None
    if cfilter is not None:
        mask = torch.as_tensor(
            filter_mod.filter_mask_np(cfilter, view.tags, view.nums)
        ).to(dev)
    q = torch.as_tensor(np.asarray(queries, np.float32)).to(dev)
    dists, slots = ops.delta_scan(q, vecs_dev, live_dev, kk, mask=mask,
                                  impl=impl)
    dists = dists.cpu().numpy()
    ids = view.ids[slots.cpu().numpy()]
    return np.where(np.isfinite(dists), ids, PAD), dists


class _MutableState(NamedTuple):
    """Everything a search reads, swapped atomically as one tuple."""

    base: Any                 # the frozen base (PageANNIndex)
    base_ids: np.ndarray      # (n,) int64: base row -> external id
    identity: bool            # base_ids is arange(n) (no translation needed)
    tombstones: np.ndarray    # sorted int64 external ids deleted from base
    delta: DeltaView
    generation: int           # compaction counter (mirrors the manifest)
    vocab: dict | None = None  # unified tag vocabulary (None: no schema)


@dataclasses.dataclass
class MutableStats:
    """Footprint and shape of the mutable wrapper; ``base`` is the base
    index's own stats (on-disk bytes included, ``BuildStats.disk_bytes``)."""

    base: Any
    base_rows: int
    base_live: int
    delta_live: int
    tombstones: int
    delta_fraction: float
    generation: int
    delta_memory_bytes: int


class MutableIndex:
    """A writable :class:`~repro_torch.core.protocol.VectorIndex` over a
    frozen base and a delta tier.

    ``search`` results carry EXTERNAL ids: stable across compactions, equal
    to base row ids for an unwrapped index (``base_ids`` defaults to
    ``arange``). The base must expose ``cfg``, ``device``,
    ``vectors_by_original_id()`` and a ``build`` classmethod for compaction:
    :class:`repro_torch.core.index.PageANNIndex` does. The delta tier is
    scanned on the base's device.
    """

    def __init__(
        self,
        base,
        base_ids: np.ndarray | None = None,
        *,
        params: DeltaParams | None = None,
        auto_compact: bool = True,
    ):
        if base_ids is None:
            store = getattr(base, "store", None)
            n = getattr(store, "num_vectors", None)
            if n is None:
                raise ValueError(
                    "cannot infer the base row count; pass base_ids"
                )
            base_ids = np.arange(n, dtype=np.int64)
        base_ids = np.asarray(base_ids, np.int64).reshape(-1)
        if base_ids.size and int(base_ids.max()) > _INT32_MAX:
            raise ValueError(
                "external ids must fit int32 (the merge path's id space)"
            )
        self.delta_params = params or DeltaParams()
        self.auto_compact = auto_compact
        self._lock = threading.RLock()
        self._directory: str | None = None
        # unified append-only vocabulary: starts as the base's, grows as
        # inserts carry unseen tag values. Base codes never move, so the
        # base tier keeps compiling filters against its own vocab while the
        # delta tier encodes and compiles against this superset.
        self._vocab: dict[str, tuple[str, ...]] = dict(
            getattr(base, "vocab", None) or {}
        )
        self._delta = self._new_delta(base)
        self._next_id = int(base_ids.max()) + 1 if base_ids.size else 0
        self._state = _MutableState(
            base=base,
            base_ids=base_ids,
            identity=bool(
                np.array_equal(base_ids, np.arange(base_ids.size))
            ),
            tombstones=np.empty((0,), np.int64),
            delta=self._delta.snapshot(),
            generation=0,
            vocab=(
                dict(self._vocab)
                if getattr(base, "schema", None) is not None else None
            ),
        )

    def _new_delta(self, base) -> DeltaTier:
        schema = getattr(base, "schema", None)
        return DeltaTier(
            base.dim,
            self.delta_params.min_capacity,
            n_tags=len(schema.tags) if schema is not None else 0,
            n_nums=len(schema.numerics) if schema is not None else 0,
            device=base.device,
        )

    # ------------------------------------------------------------ protocol
    @property
    def base(self):
        return self._state.base

    @property
    def schema(self):
        return getattr(self._state.base, "schema", None)

    @property
    def vocab(self) -> dict[str, tuple[str, ...]]:
        """The unified (base + delta) tag vocabulary."""
        return dict(self._vocab)

    @property
    def dim(self) -> int:
        return self._state.base.dim

    @property
    def default_params(self) -> SearchParams:
        return self._state.base.default_params

    @property
    def generation(self) -> int:
        return self._state.generation

    @property
    def num_live(self) -> int:
        s = self._state
        return s.base_ids.size - s.tombstones.size + s.delta.n_live

    @property
    def delta_fraction(self) -> float:
        """Delta live rows / base live rows: the compaction trigger."""
        s = self._state
        base_live = max(1, s.base_ids.size - s.tombstones.size)
        return s.delta.n_live / base_live

    @property
    def stats(self) -> MutableStats:
        s = self._state
        return MutableStats(
            base=s.base.stats,
            base_rows=int(s.base_ids.size),
            base_live=int(s.base_ids.size - s.tombstones.size),
            delta_live=s.delta.n_live,
            tombstones=int(s.tombstones.size),
            delta_fraction=self.delta_fraction,
            generation=s.generation,
            delta_memory_bytes=self._delta.memory_bytes,
        )

    # -------------------------------------------------------------- search
    def _oversample(self, tombstones: int) -> int:
        """Extra base k covering tombstoned hits, bucketed to powers of two
        (as the reference buckets it, so the base search sees the same k)."""
        if tombstones == 0:
            return 0
        b = 8
        cap = self.delta_params.max_tombstone_oversample
        while b < tombstones and b < cap:
            b <<= 1
        return min(b, cap)

    def search(
        self,
        queries: np.ndarray,
        k: int | None = None,
        params: SearchParams | None = None,
        *,
        mesh=None,
        filter: FilterExpr | None = None,
        filter_params=None,
        impl: str | None = None,
    ) -> search_mod.SearchResult:
        """Unified fresh + disk search over (base + inserts - deletes).

        Lock-free: reads one immutable state snapshot, so it interleaves
        with writers and compaction without seeing partial state.
        ``filter`` applies to BOTH tiers: the base search pushes it into the
        page scan (under the base's vocabulary), the delta scan masks rows
        under the unified vocabulary, so an insert is filterable before any
        compaction. ``mesh`` goes to the base search (``shard_search``
        over its devices); the delta scan runs on the base's device.
        ``impl="plain"`` runs the base search and the delta scan through
        the kernels' plain versions.
        """
        s = self._state
        p = resolve_search_params(s.base.default_params, k, params)
        kwargs = {"impl": impl}
        if mesh is not None:
            kwargs["mesh"] = mesh
        delta_cf = None
        if filter is not None:
            kwargs.update(filter=filter, filter_params=filter_params)
            # compiled eagerly (not only when the delta is non-empty) so a
            # bad predicate fails the same way at any write load; against
            # the SNAPSHOT's vocab so it matches the delta codes it scans
            delta_cf = filter_mod.compile_filter(
                filter, getattr(s.base, "schema", None), s.vocab or {}
            )

        if s.tombstones.size == 0 and s.delta.n_live == 0:
            res = s.base.search(queries, params=p, **kwargs)
            if s.identity:
                return res                     # pure-read path, untouched
            return res._replace(ids=self._translate(s, np.asarray(res.ids)))

        k_base = p.k + self._oversample(s.tombstones.size)
        res = s.base.search(queries, params=p.replace(k=k_base), **kwargs)

        ext = self._translate(s, np.asarray(res.ids))
        dead = (
            np.isin(ext, s.tombstones) if s.tombstones.size
            else np.zeros(ext.shape, bool)
        )
        base_d = np.where(
            dead | (ext < 0), np.inf, np.asarray(res.dists, np.float32)
        )
        base_ids = np.where(dead, PAD, ext)

        delta_ids, delta_d = scan_delta(
            s.delta, queries, p.k, cfilter=delta_cf, impl=impl
        )
        # both streams are on the host already: a (Q, k_base + kk) merge
        ids, dists = search_mod.merge_topk_streams(
            torch.as_tensor(base_ids.astype(np.int32)),
            torch.as_tensor(base_d.astype(np.float32)),
            torch.as_tensor(delta_ids.astype(np.int32)),
            torch.as_tensor(delta_d.astype(np.float32)),
            k=p.k,
        )
        return search_mod.SearchResult(
            ids=ids.numpy(),
            dists=dists.numpy(),
            ios=np.asarray(res.ios),
            hops=np.asarray(res.hops),
            cache_hits=np.asarray(res.cache_hits),
        )

    @staticmethod
    def _translate(s: _MutableState, raw: np.ndarray) -> np.ndarray:
        """Base row ids -> external ids, PAD preserved."""
        if s.identity:
            return raw
        valid = raw >= 0
        ext = np.full(raw.shape, PAD, np.int64)
        ext[valid] = s.base_ids[raw[valid]]
        return ext

    # -------------------------------------------------------------- writes
    def insert(
        self,
        vectors: np.ndarray,
        ids: np.ndarray | None = None,
        *,
        metadata=None,
    ) -> np.ndarray:
        """Append vectors to the delta tier; returns their external ids.

        Re-inserting an existing id is an upsert: the base copy is
        tombstoned or the previous delta row killed, and the new vector
        wins. May trigger an automatic ``compact()`` when the delta exceeds
        ``DeltaParams.compact_fraction`` of the base.

        ``metadata`` (dict of columns or list of dicts, validated against
        the base's :class:`MetadataSchema`) makes the new rows filterable at
        once. Unseen tag values extend the unified vocabulary append-only,
        so existing codes, and the base tier's compiled filters, stay valid
        until compaction re-encodes everything.
        """
        vectors = np.ascontiguousarray(vectors, np.float32).reshape(
            -1, self.dim
        )
        columns = None
        if metadata is not None:
            schema = self.schema
            if schema is None:
                raise ValueError(
                    "insert metadata= requires the base index to have a "
                    "MetadataSchema (build it with schema=)"
                )
            columns = filter_mod.normalize_metadata(
                schema, metadata, vectors.shape[0]
            )
        with self._lock:
            s = self._state
            tags = nums = None
            if columns is not None:
                enc = self._encode_with_unified_vocab(
                    self.schema, columns, vectors.shape[0]
                )
                tags, nums = enc.tags, enc.nums
            if ids is None:
                ids = np.arange(
                    self._next_id, self._next_id + vectors.shape[0],
                    dtype=np.int64,
                )
            ids = np.asarray(ids, np.int64).reshape(-1)
            self._delta.insert(vectors, ids, tags=tags, nums=nums)
            self._next_id = max(self._next_id, int(ids.max()) + 1)
            in_base = np.isin(ids, s.base_ids)
            tombs = (
                np.union1d(s.tombstones, ids[in_base])
                if in_base.any() else s.tombstones
            )
            self._state = s._replace(
                tombstones=tombs,
                delta=self._delta.snapshot(),
                vocab=dict(self._vocab) if s.vocab is not None else None,
            )
            if (
                self.auto_compact
                and self.delta_fraction > self.delta_params.compact_fraction
            ):
                self._compact_locked()
        return ids

    def _encode_with_unified_vocab(
        self, schema, columns: dict, n: int
    ) -> MetaArrays:
        """Extend the unified vocabulary with unseen tag values (appended,
        never reordered: base codes stay stable) and encode. The caller
        holds the index lock."""
        for f in schema.tags:
            have = set(self._vocab.get(f, ()))
            new = sorted(
                {str(v) for v in columns.get(f, ()) if v is not None} - have
            )
            if new:
                self._vocab[f] = self._vocab.get(f, ()) + tuple(new)
        return filter_mod.encode_metadata(schema, self._vocab, columns, n)

    def delete(self, ids: np.ndarray) -> int:
        """Remove ids from the live set; returns how many were live.

        Base-resident ids become tombstones (masked at search time until
        compaction rewrites the artifact); delta rows are killed in place.
        Unknown ids are ignored.
        """
        ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
        with self._lock:
            s = self._state
            killed = self._delta.kill(ids)
            in_base = ids[np.isin(ids, s.base_ids)]
            fresh = (
                in_base[~np.isin(in_base, s.tombstones)]
                if s.tombstones.size else in_base
            )
            removed = killed + int(fresh.size)
            # an upserted id is both delta-live and already tombstoned in
            # the base: its delta kill counts once, the tombstone stands
            tombs = (
                np.union1d(s.tombstones, in_base)
                if in_base.size else s.tombstones
            )
            self._state = s._replace(
                tombstones=tombs, delta=self._delta.snapshot()
            )
        return removed

    # ---------------------------------------------------------- compaction
    def compact(self) -> bool:
        """Fold (base + inserts - deletes) into a fresh base artifact.

        Rebuilds through ``PageANNIndex.build`` with the base's own config
        on the base's device: results afterwards equal a cold build over the
        merged dataset. If the index is persisted, the new artifact is
        written to a sibling directory and renamed over the old one
        (manifest generation counter bumped); searches in flight keep their
        snapshot of the old state throughout. Returns False when there is
        nothing to fold in.
        """
        with self._lock:
            return self._compact_locked()

    def _compact_locked(self) -> bool:
        s = self._state
        if s.delta.n_live == 0 and s.tombstones.size == 0:
            return False
        x_base = s.base.vectors_by_original_id()
        keep = (
            ~np.isin(s.base_ids, s.tombstones)
            if s.tombstones.size else np.ones(s.base_ids.size, bool)
        )
        c = s.delta.count
        live = s.delta.live[:c]
        merged_x = np.concatenate(
            [x_base[keep], s.delta.vecs[:c][live]], axis=0
        )
        merged_ids = np.concatenate(
            [s.base_ids[keep], s.delta.ids[:c][live]], axis=0
        )
        schema = getattr(s.base, "schema", None)
        build_kwargs = {}
        if schema is not None:
            # decode both tiers to values (base under its vocab, delta under
            # the unified one) and let the rebuild mint a fresh vocabulary:
            # compaction is the code-space reclaim
            base_cols = s.base.metadata_by_original_id()
            delta_cols = filter_mod.decode_metadata(
                schema, self._vocab,
                MetaArrays(tags=s.delta.tags[:c], nums=s.delta.nums[:c]),
            )
            build_kwargs = dict(
                schema=schema,
                metadata={
                    f: list(itertools.compress(base_cols[f], keep))
                    + list(itertools.compress(delta_cols[f], live))
                    for f in schema.fields
                },
            )
        new_base = type(s.base).build(
            merged_x, s.base.cfg, device=s.base.device, **build_kwargs
        )
        self._vocab = dict(getattr(new_base, "vocab", None) or {})
        self._delta = self._new_delta(new_base)
        new_state = _MutableState(
            base=new_base,
            base_ids=merged_ids,
            identity=bool(
                np.array_equal(merged_ids, np.arange(merged_ids.size))
            ),
            tombstones=np.empty((0,), np.int64),
            delta=self._delta.snapshot(),
            generation=s.generation + 1,
            vocab=dict(self._vocab) if schema is not None else None,
        )
        if self._directory is not None:
            from repro_torch.core import persist

            persist.swap_mutable(new_state, self._directory)
        self._state = new_state
        return True

    # ------------------------------------------------------------ lifecycle
    def save(self, directory: str) -> None:
        """Persist base + delta sidecar (inserts, tombstones, id map), so a
        restarted server loses nothing: dirty (uncompacted) state reloads to
        bit-identical search results. The artifact is the reference's."""
        from repro_torch.core import persist

        with self._lock:
            persist.save_mutable(self._state, directory)
            self._directory = directory

    @classmethod
    def load(cls, directory: str, *, device: str | torch.device = "cuda",
             memory_budget=None) -> "MutableIndex":
        """Reload a saved mutable index onto ``device``. ``memory_budget``
        caps the frozen base's device-resident pages (see
        :meth:`PageANNIndex.load`); the delta tier is in memory by
        construction."""
        from repro_torch.core import persist

        return persist.load_mutable(directory, device=device,
                                    memory_budget=memory_budget)

    def fetch_stats(self) -> dict:
        """Streamed-tier counters of the frozen base (zeros when the base
        is fully resident)."""
        fn = getattr(self._state.base, "fetch_stats", None)
        if fn is None:
            return dict(pages_fetched=0, fetch_hits=0, fetch_wall_s=0.0)
        return fn()
