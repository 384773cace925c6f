"""High-level PageANN index: build / search / save (Fig. 3 pipeline).

Port of ``repro.core.index``. Pre-processing: Vamana vector graph ->
page-node grouping (Alg. 1) -> PQ codebooks (coarse on-page + fine
in-memory) -> id reassignment + page packing (Sec 4.2/5) -> LSH routing
index -> memory-disk coordination (Sec 4.3) with optional warm-up page
caching, and metadata columns for filtered search when a schema is given.
``search`` runs ``core.search.batch_search`` (``stream_search`` on an
index loaded under a memory budget, ``shard_search`` with a device mesh)
on the index's device and translates results back to original vector
ids; ``profile`` runs the same search with its per-hop trail kept.
``autotune`` finds the cheapest operating point meeting a recall (or p99
latency) target over the loaded index, and the winner becomes
``default_params`` (persisted in the manifest's ``tuned`` section).
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.core import filter as filter_mod
from repro_torch.core import layout as layout_mod
from repro_torch.core import lsh as lsh_mod
from repro_torch.core import page_graph as pg_mod
from repro_torch.core import pq as pq_mod
from repro_torch.core import search as search_mod
from repro_torch.core import vamana as vamana_mod
from repro_torch.core.config import (
    AdaptiveParams,
    FilterParams,
    PageANNConfig,
    SearchParams,
    resolve_search_params,
)
from repro_torch.core.filter import FilterExpr, MetaArrays, MetadataSchema
from repro_torch.device import resolve_device
from repro_torch.obs.trace import span

PAD = -1


@dataclasses.dataclass
class BuildStats:
    vamana_s: float
    grouping_s: float
    pq_s: float
    pack_s: float
    lsh_s: float
    pages: int
    capacity: int
    mean_page_degree: float
    logical_page_bytes: int
    padded_tile_bytes: int
    memory_bytes: int
    # total bytes of the disk tier: the projected pages.bin size for a
    # freshly built index, the file's actual size for a loaded one
    disk_bytes: int = 0
    # page records pinned on the device and their bytes: the whole store,
    # or under a memory budget the resident part (the rest streams from the
    # pages.bin memmap per hop)
    resident_pages: int = 0
    resident_bytes: int = 0


@dataclasses.dataclass
class PageANNIndex:
    cfg: PageANNConfig
    store: layout_mod.PageStore
    tier: layout_mod.MemoryTier
    lsh: lsh_mod.LSHIndex
    data: search_mod.SearchData
    stats: BuildStats
    device: torch.device
    # full residency priority, hottest page first (warm_cache access
    # counts); persisted so a budgeted load pins the hottest pages
    page_order: np.ndarray | None = None
    # streamed tier (set by a memory-budgeted load, None otherwise): the
    # host reader over the pages.bin memmap, and the budget it was loaded at
    fetcher: object | None = None
    memory_budget: object | None = None
    # autotuned operating points (``autotune``): measured {params, recall,
    # qps, p99_us, target, ...} dicts, persisted in the manifest's ``tuned``
    # section; ``tuned_default`` is the point searches resolve by default
    tuned: list = dataclasses.field(default_factory=list)
    tuned_default: SearchParams | None = None
    # filtered search: the metadata schema, the tag vocabularies (field ->
    # tuple of values; codes are positions), the page-slot-aligned columns
    # on the device the page scan masks from, and the original-order host
    # copy (selectivity probe, brute-force oracle). None/empty without a
    # schema.
    schema: MetadataSchema | None = None
    vocab: dict = dataclasses.field(default_factory=dict)
    meta: MetaArrays | None = None
    meta_host: MetaArrays | None = None
    # per-FilterExpr compiled form and measured selectivity
    _filter_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    # the streamed tier's pinned staging buffer, kept across searches
    _stage: search_mod.PinnedStage | None = dataclasses.field(
        default=None, repr=False)
    # span tracer (``obs.trace``; duck-typed) taking the search's phases;
    # a serving engine hangs its own here
    tracer: object | None = dataclasses.field(default=None, repr=False)

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(
        x: np.ndarray,
        cfg: PageANNConfig,
        mem_subspaces: int | None = None,
        warmup_queries: np.ndarray | None = None,
        schema: MetadataSchema | None = None,
        metadata=None,
        *,
        device: str | torch.device = "cuda",
    ) -> "PageANNIndex":
        """Build an index over ``x`` (N, d). The greedy searches of the
        Vamana build, PQ training and encoding run on ``device``; graph
        pruning, page grouping and packing run on the host.

        ``schema`` and ``metadata`` (dict of columns or list of dicts, one
        entry per vector) enable filtered search (``search(filter=...)``).
        """
        dev = resolve_device(device)
        x = np.ascontiguousarray(x, np.float32)
        n, d = x.shape
        if d != cfg.dim:
            raise ValueError(f"vectors have dim {d}, config says {cfg.dim}")
        if metadata is not None and schema is None:
            raise ValueError("metadata= requires a schema=")

        t0 = time.perf_counter()
        nbrs = vamana_mod.build_vamana(
            x,
            degree=cfg.graph_degree,
            beam=cfg.build_beam,
            alpha=cfg.alpha,
            rounds=cfg.build_rounds,
            seed=cfg.seed,
            device=dev,
        )
        t1 = time.perf_counter()

        capacity = cfg.resolve_capacity()
        grouping = pg_mod.group_pages(x, nbrs, capacity, cfg.hop_h)
        page_nbrs_old = pg_mod.derive_page_edges(x, nbrs, grouping, cfg.page_degree)
        t2 = time.perf_counter()

        # coarse codes travel on-page; fine codes live in the memory tier
        m_disk = cfg.pq_subspaces
        m_mem = mem_subspaces or min(d, 2 * m_disk)
        disk_books = pq_mod.train_pq(
            x, m_disk, cfg.pq_ksub, cfg.pq_iters, seed=cfg.seed, device=dev
        )
        mem_books = pq_mod.train_pq(
            x, m_mem, cfg.pq_ksub, cfg.pq_iters, seed=cfg.seed + 1, device=dev
        )
        disk_books_t = torch.as_tensor(disk_books).to(dev)
        mem_books_t = torch.as_tensor(mem_books).to(dev)
        disk_codes_old = pq_mod.pq_encode(
            torch.as_tensor(x).to(dev), disk_books_t
        ).cpu().numpy()
        t3 = time.perf_counter()

        store = layout_mod.pack_pages(
            x, grouping, page_nbrs_old, disk_codes_old, cfg, device=dev
        )
        x_new = torch.as_tensor(layout_mod.reassigned_vectors(store)).to(dev)
        mem_codes_new = pq_mod.pq_encode(x_new, mem_books_t).cpu().numpy()
        t4 = time.perf_counter()

        lsh = lsh_mod.build_lsh(
            x_new.cpu().numpy(),
            pq_mod.pq_encode(x_new, disk_books_t).cpu().numpy(),
            bits=cfg.lsh_bits,
            sample=cfg.lsh_sample,
            seed=cfg.seed,
            device=dev,
        )
        t5 = time.perf_counter()

        tier = layout_mod.build_memory_tier(
            mem_codes_new, mem_books, disk_books, cfg.memory_mode, device=dev
        )
        # metadata columns: encode in original-id order, scatter to page-
        # slot order alongside the member vectors
        vocab: dict = {}
        meta = meta_host = None
        if schema is not None:
            columns = filter_mod.normalize_metadata(
                schema, metadata if metadata is not None else {}, n
            )
            vocab = filter_mod.build_vocab(schema, columns)
            meta_host = filter_mod.encode_metadata(schema, vocab, columns, n)
            meta = MetaArrays(*layout_mod.reassign_metadata(
                meta_host.tags, meta_host.nums, store)).to(dev)

        tile = store.padded_tile_bytes()
        idx = PageANNIndex(
            cfg=cfg,
            store=store,
            tier=tier,
            lsh=lsh,
            data=search_mod.make_search_data(store, tier, lsh),
            stats=BuildStats(
                vamana_s=t1 - t0,
                grouping_s=t2 - t1,
                pq_s=t3 - t2,
                pack_s=t4 - t3,
                lsh_s=t5 - t4,
                pages=store.num_pages,
                capacity=capacity,
                mean_page_degree=pg_mod.page_graph_stats(
                    store.nbr_ids.cpu().numpy()
                )["mean_degree"],
                logical_page_bytes=store.logical_page_bytes(cfg),
                padded_tile_bytes=tile,
                memory_bytes=tier.memory_bytes + lsh.memory_bytes,
                disk_bytes=store.num_pages * tile,
                resident_pages=store.num_pages,
                resident_bytes=store.num_pages * tile,
            ),
            device=dev,
            schema=schema,
            vocab=vocab,
            meta=meta,
            meta_host=meta_host,
        )
        if warmup_queries is not None and cfg.cache_pages > 0:
            idx.warm_cache(warmup_queries)
        return idx

    # ------------------------------------------------------------ properties
    @property
    def dim(self) -> int:
        return self.cfg.dim

    @property
    def default_params(self) -> SearchParams:
        """The runtime parameter set searches resolve when none is given:
        the autotuned operating point if one is stored (``autotune`` / the
        manifest's ``tuned.default``), else the build config's knobs."""
        if self.tuned_default is not None:
            return self.tuned_default
        return SearchParams.from_config(self.cfg)

    def resolve_params(
        self, k: int | None, params: SearchParams | None
    ) -> SearchParams:
        return resolve_search_params(self.default_params, k, params)

    # ------------------------------------------------------------------ cache
    def warm_cache(self, queries: np.ndarray, params: SearchParams | None = None) -> None:
        """Sec 4.3: run a warm-up batch, cache the hottest pages.

        Also records the full access ordering over all pages as
        ``page_order`` (accessed pages by descending count, then the never-
        accessed rest in id order)."""
        p = self.resolve_params(None, params)
        ids = self._raw_search(self._queries(queries), p).ids.cpu().numpy()
        pages = ids // self.store.capacity
        pages = pages[ids >= 0]
        uniq, counts = np.unique(pages, return_counts=True)
        by_heat = uniq[np.argsort(-counts)].astype(np.int32)
        hot = by_heat[: self.cfg.cache_pages]
        cold = np.setdiff1d(
            np.arange(self.store.num_pages, dtype=np.int32), by_heat
        )
        self.page_order = np.concatenate([by_heat, cold])
        self.tier = dataclasses.replace(
            self.tier,
            cached_pages=torch.as_tensor(np.sort(hot).astype(np.int32)).to(self.device),
        )
        self.data = search_mod.make_search_data(self.store, self.tier, self.lsh)

    # ----------------------------------------------------------------- search
    def _queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(np.asarray(queries, np.float32)).to(self.device)

    def _raw_search(
        self, q: torch.Tensor, params: SearchParams, impl: str | None = None,
        meta: MetaArrays | None = None, cfilter=None, mesh=None,
    ) -> search_mod.SearchResult:
        kw = dict(capacity=self.store.capacity,
                  mode=self.cfg.memory_mode.value,
                  meta=meta, cfilter=cfilter, impl=impl, tracer=self.tracer)
        if mesh is not None:
            if self.fetcher is not None:
                raise ValueError(
                    "sharded search over a streamed (memory-budgeted) index "
                    "is not supported: reload without memory_budget to "
                    "search across a mesh"
                )
            return search_mod.shard_search(q, self.data, params, mesh=mesh, **kw)
        if self.fetcher is not None:
            if self._stage is None:
                self._stage = search_mod.PinnedStage(self.fetcher)
            return search_mod.stream_search(
                q, self.data, params, fetcher=self.fetcher, stage=self._stage,
                **kw)
        return search_mod.batch_search(q, self.data, params, **kw)

    # ----------------------------------------------------------------- filter
    def compiled_filter(self, expr: FilterExpr):
        """Resolve a ``FilterExpr`` against this index's schema/vocab and
        measure its selectivity (fraction of vectors passing) over the host
        metadata. Cached per expression; the selectivity sets the beam's
        oversampling. Returns (CompiledFilter, selectivity)."""
        cached = self._filter_cache.get(expr)
        if cached is not None:
            return cached
        cf = filter_mod.compile_filter(expr, self.schema, self.vocab)
        mask = filter_mod.filter_mask_np(
            cf, self.meta_host.tags, self.meta_host.nums
        )
        sel = float(mask.mean()) if mask.size else 0.0
        self._filter_cache[expr] = (cf, sel)
        return cf, sel

    @staticmethod
    def _filter_oversample(selectivity: float, cap: int) -> int:
        """Pow2 beam-widening factor for a predicate's selectivity: a
        filter passing 1/s of the corpus needs ~s x the frontier to surface
        as many passing candidates as the unfiltered search, bucketed to
        powers of two and clamped to ``cap``."""
        if selectivity <= 0.0:
            return cap
        need = 1.0 / selectivity
        b = 1
        while b < need and b < cap:
            b *= 2
        return min(b, cap)

    def metadata_by_original_id(self) -> dict[str, list] | None:
        """Decoded metadata columns in original id order (missing -> None);
        ``None`` when the index has no schema."""
        if self.schema is None:
            return None
        return filter_mod.decode_metadata(
            self.schema, self.vocab, self.meta_host
        )

    def fetch_stats(self) -> dict:
        """Streamed-tier counters (``pages_fetched`` / ``fetch_hits`` /
        ``fetch_wall_s``); zeros when fully resident."""
        if self.fetcher is None:
            return dict(pages_fetched=0, fetch_hits=0, fetch_wall_s=0.0)
        return self.fetcher.fetch_stats()

    def vectors_by_original_id(self) -> np.ndarray:
        """Member vectors in original id order: the inverse of the build's
        page packing and id reassignment, read from the host copy of the
        page store (the vectors verbatim as f32, an exact round trip). The
        dataset a compaction (``core.delta``) merges fresh inserts into."""
        flat = np.asarray(self.store.vecs).reshape(-1, self.store.dim)
        valid = self.store.new_to_old >= 0
        out = np.empty((self.store.num_vectors, self.store.dim), np.float32)
        out[self.store.new_to_old[valid]] = flat[valid]
        return out

    def translate_ids(self, ids: np.ndarray) -> np.ndarray:
        """Reassigned (page-packed) vector ids -> original ids, PAD kept."""
        ids = np.asarray(ids)
        valid = ids >= 0
        old = np.full_like(ids, PAD)
        old[valid] = self.store.new_to_old[ids[valid]]
        return old

    def search(
        self,
        queries: np.ndarray,
        k: int | None = None,
        params: SearchParams | None = None,
        *,
        mesh=None,
        filter: FilterExpr | None = None,
        filter_params: FilterParams | None = None,
        impl: str | None = None,
    ) -> search_mod.SearchResult:
        """Search; returns ORIGINAL vector ids as numpy arrays.

        ``params`` supplies the runtime knobs (``default_params`` when
        None: the autotuned point, else the build config's); ``k``
        overrides ``params.k`` when given. Passing a device mesh
        (``repro_torch.launch.mesh``) routes through ``shard_search``: the
        query batch split across its devices, the same results.
        ``impl="plain"`` runs the kernels' plain versions on the index's
        device (for comparing the two; the default runs the kernels on a
        GPU).

        ``filter`` restricts results to vectors whose metadata satisfies
        the predicate (``core.filter``): non-passing members score ``+inf``
        inside the page scan, and the beam is widened by a pow2 factor of
        the predicate's measured selectivity (at most
        ``filter_params.max_filter_oversample``) so recall matches a
        post-filter brute force. ``filter=None`` is the unfiltered search.

        The call is the span ``pageann.search`` (``obs.trace.span``, into
        ``tracer``), holding ``pageann.upload`` (the queries to the
        device), the search's own spans (``core.search``) and
        ``pageann.download`` (results to the host, ids translated).
        """
        tr = self.tracer
        with span(tr, "pageann.search", cat=search_mod.TRACK,
                  track=search_mod.TRACK) as sp:
            p, meta, cfilter = self._filtered(
                self.resolve_params(k, params), filter, filter_params)
            with span(tr, "pageann.upload", cat=search_mod.TRACK,
                      track=search_mod.TRACK):
                q = self._queries(queries)
            sp.note(queries=q.shape[0], k=p.k, mode=self.cfg.memory_mode.value)
            res = self._raw_search(q, p, impl=impl, meta=meta,
                                   cfilter=cfilter, mesh=mesh)
            with span(tr, "pageann.download", cat=search_mod.TRACK,
                      track=search_mod.TRACK):
                return self._host_result(res)

    def _filtered(self, p: SearchParams, filter: FilterExpr | None,
                  filter_params: FilterParams | None):
        """(params, meta, compiled filter) of a search: with a filter, the
        beam widened by the pow2 oversampling of its selectivity."""
        if filter is None:
            return p, None, None
        fp = filter_params if filter_params is not None else FilterParams()
        cfilter, sel = self.compiled_filter(filter)
        factor = self._filter_oversample(sel, fp.max_filter_oversample)
        if factor > 1:
            p = p.replace(beam_width=p.beam_width * factor)
        return p, self.meta, cfilter

    def _host_result(self, res: search_mod.SearchResult) -> search_mod.SearchResult:
        """A device result as numpy arrays, ids translated to original ones."""
        return search_mod.SearchResult(
            ids=self.translate_ids(res.ids.cpu().numpy()),
            dists=res.dists.cpu().numpy(),
            ios=res.ios.cpu().numpy(),
            hops=res.hops.cpu().numpy(),
            cache_hits=res.cache_hits.cpu().numpy(),
        )

    def profile(
        self,
        queries: np.ndarray,
        k: int | None = None,
        params: SearchParams | None = None,
        *,
        filter: FilterExpr | None = None,
        filter_params: FilterParams | None = None,
        save: str | None = None,
    ) -> tuple[search_mod.SearchResult, search_mod.HopProfile]:
        """``search`` with the per-hop trail kept (opt-in debug mode).

        Runs ``core.search.profile_search``, the same hops as ``search``,
        and returns the translated ``SearchResult`` plus a
        :class:`repro_torch.core.search.HopProfile` of numpy arrays holding,
        per query and hop: the scheduled page ids, the disk-I/O and
        cache-hit deltas, the worst of the running top-k and the adaptive
        stall counter. The results equal ``search``'s bit for bit.

        ``save=`` writes the profile as JSON that ``python -m
        repro_torch.obs.report`` (or the reference's report) renders. Not
        supported over a streamed (memory-budgeted) index.
        """
        if self.fetcher is not None:
            raise ValueError(
                "profile() over a streamed (memory-budgeted) index is not "
                "supported: reload without memory_budget to profile"
            )
        p, meta, cfilter = self._filtered(
            self.resolve_params(k, params), filter, filter_params)
        res, trail = search_mod.profile_search(
            self._queries(queries), self.data, p,
            capacity=self.store.capacity, mode=self.cfg.memory_mode.value,
            meta=meta, cfilter=cfilter,
        )
        res = self._host_result(res)
        trail = search_mod.HopProfile(*(t.cpu().numpy() for t in trail))
        if save is not None:
            from repro_torch.obs.report import profile_to_dict

            with open(save, "w") as f:
                json.dump(profile_to_dict(res, trail), f)
        return res, trail

    # -------------------------------------------------------------- autotune
    def _measure(
        self, queries: torch.Tensor, params: SearchParams, truth: np.ndarray
    ) -> dict:
        """One operating point: recall and the wall clock of one search of
        the batch, after one warm-up search. On the card the timed search
        lies between two ``torch.cuda.synchronize()`` calls. The p99
        latency is estimated from the hop distribution, as the reference
        does: a query's cost is hop-dominated, so ``mean_us * p99_hops /
        mean_hops`` prices the straggler lanes of one batched search."""
        self._raw_search(queries, params)                 # warm-up
        self._sync()
        t0 = time.perf_counter()
        res = self._raw_search(queries, params)
        self._sync()
        wall = time.perf_counter() - t0
        found = self.translate_ids(res.ids.cpu().numpy())
        recall = recall_at_k(found[:, : truth.shape[1]], truth)
        hops = res.hops.cpu().numpy()
        mean_us = wall / queries.shape[0] * 1e6
        mean_hops = float(hops.mean())
        p99_scale = (
            float(np.percentile(hops, 99)) / mean_hops if mean_hops else 1.0
        )
        return dict(
            params=params,
            recall=float(recall),
            qps=queries.shape[0] / wall if wall > 0 else float("inf"),
            mean_us=mean_us,
            p99_us=mean_us * p99_scale,
            mean_hops=mean_hops,
            mean_ios=float(res.ios.cpu().numpy().mean()),
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def autotune(
        self,
        queries: np.ndarray,
        *,
        recall_target: float | None = None,
        p99_target_us: float | None = None,
        k: int = 10,
        truth: np.ndarray | None = None,
        beam_grid: tuple | None = None,
        patience_grid: tuple = (None, 2, 4),
        io_batch_grid: tuple | None = None,
        entries_grid: tuple | None = None,
        store: bool = True,
    ) -> dict:
        """Find the cheapest operating point meeting a recall (or p99
        latency) target over this loaded index, without rebuilding it.

        Recall mode: recall is monotone in beam width, so binary-search the
        beam ladder for the cheapest rung meeting ``recall_target``, then
        refine around it with the adaptive knobs (early-termination
        patience, io_batch, entry count) and keep the highest-QPS variant
        still meeting the target. Latency mode (``p99_target_us``): the
        highest-recall measured point within budget. The grids and the
        selection rules are the reference's; which point wins a QPS race is
        measured on this device.

        The winner is appended to ``self.tuned`` and becomes
        ``default_params`` (``store=True``); ``save`` writes both to the
        manifest's ``tuned`` section. Returns the winning measurement dict
        (params, recall, qps, p99_us, ...).
        """
        if (recall_target is None) == (p99_target_us is None):
            raise ValueError(
                "autotune needs exactly one of recall_target= or "
                "p99_target_us="
            )
        q = self._queries(queries)
        if truth is None:
            truth = vamana_mod.brute_force_knn(
                self.vectors_by_original_id(), np.asarray(queries), k
            )
        truth = np.asarray(truth)[:, :k]

        base = SearchParams.from_config(self.cfg, k=k)
        t = base.lsh_entries
        if beam_grid is None:
            bw = base.beam_width
            beam_grid = tuple(sorted({max(t, bw // 4), max(t, bw // 2),
                                      bw, 2 * bw}))
        beam_grid = tuple(sorted(beam_grid))
        measured: list[dict] = []

        def probe(p: SearchParams) -> dict:
            m = self._measure(q, p, truth)
            measured.append(m)
            return m

        if recall_target is not None:
            # binary search the beam ladder: cheapest rung >= target
            lo, hi = 0, len(beam_grid) - 1
            best_rung = None
            while lo <= hi:
                mid = (lo + hi) // 2
                m = probe(base.replace(beam_width=beam_grid[mid]))
                if m["recall"] >= recall_target:
                    best_rung = m
                    hi = mid - 1
                else:
                    lo = mid + 1
            if best_rung is None:       # even the widest rung missed
                best_rung = max(measured, key=lambda m: m["recall"])
            # refine at the chosen rung: adaptive and cheaper-I/O variants
            rung = best_rung["params"]
            variants: list[SearchParams] = []
            for pat in patience_grid:
                if pat is not None:
                    variants.append(rung.replace(
                        adaptive=AdaptiveParams(patience=pat)))
            for iob in (io_batch_grid or ()):
                if iob != rung.io_batch:
                    variants.append(rung.replace(io_batch=iob))
            for ent in (entries_grid or ()):
                if ent != rung.lsh_entries and ent <= rung.beam_width:
                    variants.append(rung.replace(lsh_entries=ent))
            for v in variants:
                probe(v)
            ok = [m for m in measured if m["recall"] >= recall_target]
            pool = ok or [max(measured, key=lambda m: m["recall"])]
            winner = max(pool, key=lambda m: m["qps"])
            target = {"recall": recall_target}
        else:
            for b in beam_grid:
                probe(base.replace(beam_width=b))
                for pat in patience_grid:
                    if pat is not None:
                        probe(base.replace(
                            beam_width=b,
                            adaptive=AdaptiveParams(patience=pat)))
            ok = [m for m in measured if m["p99_us"] <= p99_target_us]
            pool = ok or [min(measured, key=lambda m: m["p99_us"])]
            winner = max(pool, key=lambda m: m["recall"])
            target = {"p99_us": p99_target_us}

        winner = dict(winner, target=target)
        if store:
            self.tuned.append(winner)
            self.tuned_default = winner["params"]
        return winner

    def params_for_target(
        self,
        recall_target: float | None = None,
        p99_target_us: float | None = None,
    ) -> SearchParams:
        """Resolve a stored tuned operating point for a serving target.

        Picks among the points ``autotune`` recorded (round-tripped through
        the manifest): for a recall target, the highest-QPS point whose
        measured recall meets it; for a latency target, the highest-recall
        point within budget. Raises ``LookupError`` when nothing stored
        qualifies."""
        if (recall_target is None) == (p99_target_us is None):
            raise ValueError(
                "need exactly one of recall_target= or p99_target_us="
            )
        if recall_target is not None:
            ok = [m for m in self.tuned if m["recall"] >= recall_target]
            if not ok:
                raise LookupError(
                    f"no tuned operating point reaches recall "
                    f"{recall_target}: run autotune(queries, recall_target="
                    f"{recall_target}) on this index and save it"
                )
            return max(ok, key=lambda m: m["qps"])["params"]
        ok = [m for m in self.tuned if m["p99_us"] <= p99_target_us]
        if not ok:
            raise LookupError(
                f"no tuned operating point meets p99 <= {p99_target_us}us: "
                f"run autotune(queries, p99_target_us={p99_target_us}) on "
                "this index and save it"
            )
        return max(ok, key=lambda m: m["recall"])["params"]

    # -------------------------------------------------------------- lifecycle
    def save(self, directory: str) -> None:
        """Persist to ``directory`` in the reference's artifact format."""
        from repro_torch.core import persist

        persist.save_pageann(self, directory)

    @classmethod
    def load(cls, directory: str, *, device: str | torch.device = "cuda",
             memory_budget=None) -> "PageANNIndex":
        """Reload a saved index (saved by this package or the reference).

        ``memory_budget`` (a ``MemoryBudget``, a byte count, a fraction or
        a string such as ``"512MB"``) keeps only the hottest pages that fit
        on the device and streams the rest from ``pages.bin`` per hop."""
        from repro_torch.core import persist

        return persist.load_pageann(
            directory, device=device, memory_budget=memory_budget
        )


def recall_at_k(found_ids: np.ndarray, truth_ids: np.ndarray) -> float:
    """Mean recall@k over a query batch (paper's Recall@10 metric).

    Set semantics per row (duplicates counted once on both sides, PAD ids
    included verbatim): a truth entry scores iff it appears anywhere in the
    found row and is the first occurrence of its value within the truth row.
    """
    found = np.asarray(found_ids)
    truth = np.asarray(truth_ids)
    q, k = truth.shape
    present = (truth[:, :, None] == found[:, None, :]).any(-1)     # (Q, k)
    j = np.arange(k)
    dup = ((truth[:, :, None] == truth[:, None, :])
           & (j[None, None, :] < j[None, :, None])).any(-1)        # (Q, k)
    return float((present & ~dup).sum() / (q * k))
