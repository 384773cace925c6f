"""PageANN graph search — Algorithm 2, as a batched PyTorch loop.

Port of ``repro.core.search``: fully resident and memory-budgeted
(streamed) search, with or without a metadata filter, with or without the
adaptive knobs (``AdaptiveParams``: query-sensitive entry selection and
per-query early termination), and the per-hop profile
(``profile_search``). The reference ``vmap``s a ``lax.while_loop`` over
queries; here every tensor of the per-query :class:`BeamState` carries a
leading query axis and one Python loop runs the hops for the whole batch.
Each hop applies the same three transitions:

  ``select_batch``      pick up to b closest unvisited candidates on fresh
                        pages (a stable sort of the beam by distance, then
                        one by page for the first occurrence of each),
  ``score_page_batch``  read those page records once through the
                        ``page_scan`` kernel (exact member L2 + on-page
                        neighbour ADC) and re-score neighbours with the
                        in-memory codes through ``pq_adc`` per mode,
  ``merge``             fold both score sets into the result top-k and the
                        beam.

A lane whose loop condition is false is frozen, as under ``vmap``: the hop
runs only on the active lanes and their new state is written back, so a
finished query's state never changes. The loop ends when no lane is active,
which costs one host sync per hop. Early termination is one more reason to
freeze a lane: its worst top-k distance stalled for ``patience`` hops.

Each phase is a span (``obs.trace.span``, on the ``search`` track):
``pageann.start`` (LUTs and routing), and one ``pageann.hop`` a loop
iteration, with its ``hop`` index and active ``lanes``, holding
``pageann.hop.sync`` (the blocking ``nonzero``) and, when a lane is active,
``pageann.hop.select``, ``pageann.hop.score`` and ``pageann.hop.merge``;
a streamed search's ``pageann.hop.score`` holds ``pageann.hop.fetch``.

Streamed search (``stream_search``) keeps only part of the page records on
the device. Each hop looks its pages up in ``resident_map``, reads the
missing records on the host through a ``core.stream.PageFetcher`` between
``select_batch`` and the scan, copies them to the device through a reused
pinned buffer, and scores them with ``page_scan_recs``: the same per-record
kernel code as ``page_scan``, so every result equals the resident search
bit for bit. Filtered search pushes the predicate into the scan as a member
mask; neighbour estimates stay unmasked so the graph stays traversable.

``shard_search`` splits a query batch over the devices of a mesh, each
block searched by ``batch_search`` against a copy of the index on its
device. ``merge_topk_streams`` folds two result streams into one top-k:
the mutable index's page-file search and delta scan, and the sharded
store's per-shard results (``repro_torch.dist``).

Ties break as in the reference: ``lax.top_k`` and ``lax.sort(is_stable=
True)`` both favour the lower index, so every selection here is a stable
ascending ``torch.sort`` and a prefix — never ``torch.topk``, whose order
among equal values is unspecified.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.config import MemoryMode, SearchParams
from repro_torch.core.filter import CompiledFilter, MetaArrays, filter_mask
from repro_torch.core.layout import MemoryTier, PageStore
from repro_torch.core.lsh import LSHIndex, hash_codes
from repro_torch.kernels import ops
from repro_torch.obs.trace import span

PAD = -1
INF = float("inf")
TRACK = "search"        # the spans' track (``obs.trace``)


class SearchData(NamedTuple):
    """All device tensors the search reads."""

    # under a memory budget page_recs holds only the R resident records and
    # resident_map routes each page id to its row there (-1: streamed);
    # fully resident, R == P and resident_map == arange(P)
    page_recs: torch.Tensor     # (R, rows, 128) f32 packed page records
    member_count: torch.Tensor  # (P,)
    nbr_ids: torch.Tensor       # (P, Rp)
    nbr_count: torch.Tensor     # (P,)
    resident_map: torch.Tensor  # (P,) int32: row of page_recs, or -1
    mem_codes: torch.Tensor     # (N_pad, M_mem) uint8
    mem_mask: torch.Tensor      # (N_pad,) bool
    mem_codebooks: torch.Tensor
    disk_codebooks: torch.Tensor
    cached_pages: torch.Tensor  # (C,) sorted
    lsh_planes: torch.Tensor
    lsh_ids: torch.Tensor
    lsh_codes: torch.Tensor     # (S, W) int32 (uint32 bit patterns)
    lsh_pq: torch.Tensor        # (S, M_disk) uint8


def make_search_data(store: PageStore, tier: MemoryTier, lsh: LSHIndex) -> SearchData:
    resident_map = store.resident_map
    if resident_map is None:
        resident_map = torch.arange(
            store.recs.shape[0], dtype=torch.int32, device=store.recs.device
        )
    return SearchData(
        page_recs=store.recs,
        member_count=store.member_count,
        nbr_ids=store.nbr_ids,
        nbr_count=store.nbr_count,
        resident_map=resident_map,
        mem_codes=tier.mem_codes,
        mem_mask=tier.mem_mask,
        mem_codebooks=tier.mem_codebooks,
        disk_codebooks=tier.disk_codebooks,
        cached_pages=tier.cached_pages,
        lsh_planes=lsh.planes,
        lsh_ids=lsh.sample_ids,
        lsh_codes=lsh.sample_codes,
        lsh_pq=lsh.sample_pq,
    )


class SearchResult(NamedTuple):
    ids: torch.Tensor       # (Q, k) reassigned vector ids
    dists: torch.Tensor     # (Q, k) exact squared distances
    ios: torch.Tensor       # (Q,) page reads that went to 'disk'
    hops: torch.Tensor      # (Q,) loop iterations
    cache_hits: torch.Tensor  # (Q,) page reads served by the warmed cache


class BeamState(NamedTuple):
    """Loop state of Algorithm 2 for a batch of queries (leading axis Q)."""

    cand_ids: torch.Tensor   # (Q, L) candidate vector ids, PAD padded
    cand_d: torch.Tensor     # (Q, L) estimated distances, INF padded
    cand_vis: torch.Tensor   # (Q, L) expanded/scheduled flags
    page_vis: torch.Tensor   # (Q, P) visited-page bitmap (the paper's V)
    res_ids: torch.Tensor    # (Q, k) running exact top-k ids
    res_d: torch.Tensor      # (Q, k) running exact top-k distances
    io: torch.Tensor         # (Q,) page reads served from 'disk'
    cache_hits: torch.Tensor  # (Q,) page reads served by the warmed cache
    hops: torch.Tensor       # (Q,) loop iterations
    # early termination (None unless patience is set): the worst running
    # top-k distance after the last hop, and how many consecutive hops
    # failed to improve it by more than epsilon
    frontier: torch.Tensor | None = None   # (Q,) f32
    stall: torch.Tensor | None = None      # (Q,) int32


def _top_k_merge(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Ascending top-k along the last axis, lower index first on ties
    (``lax.top_k``'s order): (dists, indices)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _mask_dups_keep_first(ids: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Set distance to INF for duplicate ids in each row, keeping the first
    occurrence: one stable sort, a segment-boundary compare, and the flags
    scattered back to their positions."""
    s, spos = torch.sort(ids, dim=-1, stable=True)
    dup_sorted = torch.zeros_like(s, dtype=torch.bool)
    dup_sorted[..., 1:] = s[..., 1:] == s[..., :-1]
    dup = torch.zeros_like(dup_sorted).scatter_(-1, spos, dup_sorted)
    return torch.where(dup & (ids != PAD), INF, d)


# --------------------------------------------------------------------------
# per-hop transition functions (batched over queries)
# --------------------------------------------------------------------------

def init_state(
    q: torch.Tensor,
    data: SearchData,
    disk_lut: torch.Tensor,
    *,
    beam: int,
    k: int,
    entries: int,
    entry_slack: int | None = None,
    min_entries: int = 1,
    patience: int | None = None,
    impl: str | None = None,
) -> BeamState:
    """In-memory routing (Alg. 2 line 4, Fig. 6 step 1): LSH entry points.

    q: (Q, d), disk_lut: (Q, M_disk, K). The Hamming sweep and its top-T
    run in one ``hamming_topk`` kernel, the entry estimates through
    ``pq_adc``. The top-T is stable (lower sample first on ties, as
    ``lax.top_k``), because small-integer Hamming scores tie often.

    With entry selection on (``entry_slack`` not None), only the entries
    within ``entry_slack`` bits of the query's best one seed the beam, and
    never fewer than ``min_entries`` by rank; the others are masked to
    PAD/INF in place, before duplicates are masked, as the reference does.
    The reference compares float32 casts of the Hamming values; for
    integers this small an int32 compare is the same.
    """
    nq = q.shape[0]
    dev = q.device
    num_pages = data.member_count.shape[0]
    qcode = hash_codes(q, data.lsh_planes)
    ham_top, top = ops.hamming_topk(data.lsh_codes, qcode, entries, impl=impl)
    top = top.long()                                            # (Q, T)
    entry_ids = data.lsh_ids[top].to(torch.int32)               # (Q, T)
    entry_d = ops.pq_adc_gather(data.lsh_pq, top, disk_lut, impl=impl)  # (Q, T)
    if entry_slack is not None:
        keep = ((ham_top <= ham_top[:, :1] + entry_slack)
                | (torch.arange(entries, device=dev) < min_entries))
        entry_ids = torch.where(keep, entry_ids, PAD)
        entry_d = torch.where(keep, entry_d, INF)
    entry_d = _mask_dups_keep_first(entry_ids, entry_d)

    cand_ids = torch.full((nq, beam), PAD, dtype=torch.int32, device=dev)
    cand_ids[:, :entries] = entry_ids
    cand_d = torch.full((nq, beam), INF, dtype=torch.float32, device=dev)
    cand_d[:, :entries] = entry_d
    zeros = torch.zeros((nq,), dtype=torch.int32, device=dev)
    return BeamState(
        cand_ids=cand_ids,
        cand_d=cand_d,
        cand_vis=torch.zeros((nq, beam), dtype=torch.bool, device=dev),
        page_vis=torch.zeros((nq, num_pages), dtype=torch.bool, device=dev),
        res_ids=torch.full((nq, k), PAD, dtype=torch.int32, device=dev),
        res_d=torch.full((nq, k), INF, dtype=torch.float32, device=dev),
        io=zeros,
        cache_hits=zeros.clone(),
        hops=zeros.clone(),
        frontier=(None if patience is None else
                  torch.full((nq,), INF, dtype=torch.float32, device=dev)),
        stall=None if patience is None else zeros.clone(),
    )


def select_batch(
    state: BeamState, *, capacity: int, io_batch: int
) -> tuple[BeamState, torch.Tensor]:
    """Pick up to b closest unvisited candidates whose pages are fresh.

    Stable-sort each beam by (masked distance, slot), keep the first
    occurrence of each page among finite entries, and take the first b —
    the pages the reference's serial argmin would have scheduled, in the
    same order. Returns the updated state (selected candidates expanded,
    their pages visited, candidates on stale pages retired) and the (Q, b)
    page ids to read, PAD padded. The reference's scatters with
    ``mode="drop"`` write to a sentinel column that is cut off afterwards.
    """
    cand_ids = state.cand_ids
    nq = cand_ids.shape[0]
    num_pages = state.page_vis.shape[1]
    b = io_batch
    dev = cand_ids.device

    cpages = torch.where(cand_ids >= 0, cand_ids // capacity, 0).long()
    # retire candidates whose page was visited before this hop
    stale = (cand_ids != PAD) & state.page_vis.gather(1, cpages)
    masked = torch.where(
        state.cand_vis | stale | (cand_ids == PAD), INF, state.cand_d
    )

    sd, sslot = torch.sort(masked, dim=1, stable=True)
    spages = cpages.gather(1, sslot)
    finite = torch.isfinite(sd)
    # first finite occurrence of each page in (distance, slot) order: a
    # stable sort by page keeps each page's sorted positions ascending, so
    # the head of a page's group is its first occurrence; the finite
    # entries are a prefix of the sorted beam, so the head is finite
    # whenever any entry of the page is. O(L log L), where a pairwise
    # compare of the beam would take O(L^2) memory.
    gpages, gpos = torch.sort(spages, dim=1, stable=True)
    head = torch.ones_like(finite)
    head[:, 1:] = gpages[:, 1:] != gpages[:, :-1]
    first = finite & torch.zeros_like(head).scatter_(1, gpos, head)
    rank = torch.cumsum(first, 1) - first.long()   # fresh pages before
    scheduled = first & (rank < b)
    n_sched = scheduled.sum(1)

    batch = torch.full((nq, b + 1), PAD, dtype=torch.int32, device=dev)
    batch.scatter_(1, torch.where(scheduled, rank, b), spages.to(torch.int32))
    batch = batch[:, :b]
    page_vis = torch.cat(
        [state.page_vis, torch.zeros((nq, 1), dtype=torch.bool, device=dev)], 1
    )
    page_vis.scatter_(1, torch.where(scheduled, spages, num_pages),
                      torch.ones_like(scheduled))
    page_vis = page_vis[:, :num_pages]

    # expanded flags: the b scheduled picks, plus co-page candidates of any
    # page scheduled before the final pick (the serial loop's stale marking
    # ran once more after each pick except the last)
    # (the pages of ranks < b - 1 are the first b - 1 columns of the batch)
    early = (cpages[:, :, None] == batch[:, None, : b - 1]).any(2)   # (Q, L)
    picked = torch.zeros_like(scheduled).scatter_(1, sslot, scheduled)
    cand_vis = state.cand_vis | stale | picked
    cand_vis = cand_vis | ((cand_ids != PAD) & early)
    # the serial argmin marked slot 0 on every exhausted pick (all-INF mask)
    cand_vis[:, 0] |= n_sched < b
    return state._replace(cand_vis=cand_vis, page_vis=page_vis), batch


def page_member_mask(
    meta: MetaArrays, cfilter: CompiledFilter, batch: torch.Tensor,
    *, capacity: int,
) -> torch.Tensor:
    """Evaluate a compiled filter over one hop's page batch.

    ``meta`` holds page-slot-aligned metadata columns ((P*cap, T) tags /
    (P*cap, N) numerics, the ``new_to_old`` layout of the page records), so
    a page's rows are one contiguous slice: gather the (Q, b) batch and
    evaluate the predicate to a (Q, b, cap) f32 mask (1 = passes). Pad
    slots carry the missing sentinels (-1 / NaN) and never pass.
    """
    # explicit page count: a zero-width column block (a schema with no tag
    # or no numeric fields) cannot infer it from a -1 reshape
    pages = meta.tags.shape[0] // capacity
    tags = meta.tags.reshape(pages, capacity, meta.tags.shape[-1])[batch]
    nums = meta.nums.reshape(pages, capacity, meta.nums.shape[-1])[batch]
    return filter_mask(cfilter, tags, nums).to(torch.float32)


class PinnedStage:
    """Moves a hop's missing page records from the host to the device.

    Calls the fetcher with the missing page ids as one 1-D array (so its
    counters see each request once, in row-major order), has it write the
    records straight into a host buffer that is pinned on a CUDA device and
    reused from hop to hop, and copies them to the device without blocking.
    Reuse is safe: the next hop's ids come back to the host through a copy
    on the same stream, which waits for this copy to finish.
    """

    def __init__(self, fetcher):
        self.fetcher = fetcher
        self._buf: torch.Tensor | None = None

    def __call__(self, ids: torch.Tensor) -> tuple[torch.Tensor, int]:
        """ids: (n,) page ids on the device -> ((n, rows, 128) f32 there,
        the pages the fetcher read off its file for them)."""
        dev = ids.device
        ids_np = ids.cpu().numpy()
        rows, lanes = self.fetcher.record_shape
        if self._buf is None or self._buf.shape[0] < ids_np.size:
            size = max(ids_np.size, 2 * (0 if self._buf is None else self._buf.shape[0]))
            self._buf = torch.empty((size, rows, lanes), dtype=torch.float32,
                                    pin_memory=dev.type == "cuda")
        _, misses = self.fetcher.read(ids_np, out=self._buf.numpy())
        return self._buf[: ids_np.size].to(dev, non_blocking=True), misses


def score_page_batch(
    q: torch.Tensor,
    data: SearchData,
    batch: torch.Tensor,
    state: BeamState,
    disk_lut: torch.Tensor,
    mem_lut: torch.Tensor | None,
    *,
    capacity: int,
    mode: str,
    fetch: PinnedStage | None = None,
    meta: MetaArrays | None = None,
    cfilter: CompiledFilter | None = None,
    impl: str | None = None,
    tracer=None,
):
    """Batched page-record read (Fig. 6 steps 2-4, THE I/O) -> both score
    sets from one read of each page.

    ``page_scan`` reads each scheduled record once and emits exact member
    L2 distances and on-page neighbour ADC estimates. MEM_ALL skips the
    on-page ADC; HYBRID/MEM_ALL re-score neighbours with the finer
    in-memory codes through ``pq_adc``.

    ``fetch`` is the streamed tier (``stream_search``): ``data.page_recs``
    then holds only the resident records. Resident lanes are scored by
    ``page_scan`` at their rows in it; the others are fetched from the host
    into a zeroed (Q, b, rows, 128) staging tensor and scored by
    ``page_scan_recs``, the same per-record kernel code; the two merge per
    lane, so every score equals the resident search's bit for bit. The
    missing ids' trip to the host, the fetch, the copy to the device and
    its scatter into the staging tensor are the span ``pageann.hop.fetch``
    (into ``tracer``), with the hop's page reads (``lanes``), those not
    resident (``streamed``), the fetcher's reads off its file for them
    (``misses``) and the bytes copied to the device (``bytes``).

    With a filter (``meta`` + ``cfilter``), the predicate is evaluated over
    the batch's metadata and pushed into the scan as a member mask:
    filtered-out members score ``+inf``, so the result top-k holds only
    passing vectors. Neighbour estimates stay unmasked.

    Returns (member_ids, member_dists) as (Q, b*cap), (neighbor_ids,
    estimated_dists) as (Q, b*Rp) INF-masked, plus this hop's disk-I/O and
    cache-hit deltas (Q,).
    """
    cap = capacity
    nq, b = batch.shape
    rp = data.nbr_ids.shape[1]
    dev = q.device
    safe = batch.clamp(min=0).long()
    fetched = batch >= 0

    member_mask = (
        page_member_mask(meta, cfilter, safe, capacity=cap)
        if meta is not None and cfilter is not None
        else None
    )
    compute_adc = mode != MemoryMode.MEM_ALL.value
    kw = dict(capacity=cap, dim=q.shape[1], rp=rp, compute_adc=compute_adc,
              member_mask=member_mask, impl=impl)
    if fetch is None:
        ex, est_disk = ops.page_scan(data.page_recs, safe, q, disk_lut, **kw)
    else:
        slot = data.resident_map[safe]                       # (Q, b)
        resident = slot >= 0
        miss = fetched & ~resident
        staged = torch.zeros((nq, b, *data.page_recs.shape[1:]),
                             dtype=torch.float32, device=dev)
        with span(tracer, "pageann.hop.fetch", cat=TRACK, track=TRACK) as sp:
            recs, misses = fetch(safe[miss])     # row-major: the fetch order
            staged[miss] = recs
            if sp.recording:
                sp.note(lanes=int(fetched.sum()), streamed=recs.shape[0],
                        misses=misses,
                        bytes=recs.numel() * recs.element_size())
            del recs            # in ``staged`` now: free it before the scans
        ex_r, est_r = ops.page_scan(
            data.page_recs, torch.where(resident, slot, 0), q, disk_lut, **kw)
        ex_s, est_s = ops.page_scan_recs(staged, q, disk_lut, **kw)
        lane = resident[:, :, None]
        ex = torch.where(lane, ex_r, ex_s)
        est_disk = None if est_r is None else torch.where(lane, est_r, est_s)
    slots = torch.arange(cap, device=dev)
    ex = torch.where(slots < data.member_count[safe][:, :, None], ex, INF)
    ex = torch.where(fetched[:, :, None], ex, INF)
    member_ids = (batch[:, :, None] * capacity + slots).to(torch.int32)

    # warmed page cache (Sec 4.3): sorted-membership test
    ncached = data.cached_pages.shape[0]
    if ncached > 0:
        pos = torch.searchsorted(data.cached_pages, safe.to(data.cached_pages.dtype))
        pos = pos.clamp(max=ncached - 1)
        in_cache = data.cached_pages[pos] == safe
    else:
        in_cache = torch.zeros_like(fetched)
    io_delta = (fetched & ~in_cache).sum(1).to(torch.int32)
    hit_delta = (fetched & in_cache).sum(1).to(torch.int32)

    # neighbor estimates (Fig. 6 steps 3-4) per the coordination mode
    flat_nids = data.nbr_ids[safe].reshape(nq, b * rp)               # (Q, b*Rp)
    valid_n = (
        (torch.arange(rp, device=dev) < data.nbr_count[safe][:, :, None])
        .reshape(nq, b * rp)
        & (flat_nids != PAD)
        & fetched.repeat_interleave(rp, dim=1)
    )
    safe_nids = flat_nids.clamp(min=0).long()
    if mode == MemoryMode.DISK_ONLY.value:
        est = est_disk.reshape(nq, b * rp)
    elif mode == MemoryMode.MEM_ALL.value:
        est = ops.pq_adc_gather(data.mem_codes, safe_nids, mem_lut, impl=impl)
    else:  # HYBRID: prefer the higher-accuracy in-memory codes
        est_mem = ops.pq_adc_gather(data.mem_codes, safe_nids, mem_lut,
                                    impl=impl)
        est = torch.where(data.mem_mask[safe_nids], est_mem,
                          est_disk.reshape(nq, b * rp))
    est = torch.where(valid_n, est, INF)
    # skip neighbors on already-visited pages
    est = torch.where(state.page_vis.gather(1, safe_nids // capacity), INF, est)
    # skip neighbors already in the candidate set: sorted membership probe
    sorted_cand = torch.sort(state.cand_ids, dim=1).values
    pos = torch.searchsorted(sorted_cand, flat_nids)
    pos = pos.clamp(max=sorted_cand.shape[1] - 1)
    est = torch.where(sorted_cand.gather(1, pos) == flat_nids, INF, est)
    # dedupe within this batch
    est = _mask_dups_keep_first(flat_nids, est)
    return (member_ids.reshape(nq, b * cap), ex.reshape(nq, b * cap),
            flat_nids, est, io_delta, hit_delta)


def merge(
    state: BeamState,
    member_ids: torch.Tensor,
    member_d: torch.Tensor,
    nbr_ids: torch.Tensor,
    nbr_d: torch.Tensor,
    io_delta: torch.Tensor,
    hit_delta: torch.Tensor,
    *,
    patience: int | None = None,
    epsilon: float = 0.0,
) -> BeamState:
    """Fold exact member scores into the result top-k and estimated
    neighbour scores into the beam (Alg. 2 line 12, Fig. 6 step 5).

    With early termination on (``patience``), the convergence signal
    updates here: the worst of the new top-k either improved on the
    frontier by more than ``epsilon`` (stall resets) or it did not (stall
    counts up); ``_active`` freezes the lane once stall reaches
    ``patience``."""
    k = state.res_ids.shape[1]
    beam = state.cand_ids.shape[1]

    res_d, order = _top_k_merge(torch.cat([state.res_d, member_d], 1), k)
    res_ids = torch.cat([state.res_ids, member_ids], 1).gather(1, order)

    cand_d, order = _top_k_merge(torch.cat([state.cand_d, nbr_d], 1), beam)
    cand_ids = torch.cat([state.cand_ids, nbr_ids], 1).gather(1, order)
    cand_vis = torch.cat(
        [state.cand_vis, torch.zeros_like(nbr_ids, dtype=torch.bool)], 1
    ).gather(1, order)
    frontier, stall = state.frontier, state.stall
    if patience is not None:
        # float32 throughout, as the reference's jnp.float32(epsilon): the
        # Python scalar holds epsilon rounded to float32 and the subtraction
        # runs in float32, so INF - epsilon stays INF on the opening hops
        worst = res_d[:, k - 1]
        improved = worst < state.frontier - float(np.float32(epsilon))
        frontier = worst
        stall = torch.where(improved, 0, state.stall + 1)
    return state._replace(
        cand_ids=cand_ids,
        cand_d=cand_d,
        cand_vis=cand_vis,
        res_ids=res_ids,
        res_d=res_d,
        io=state.io + io_delta,
        cache_hits=state.cache_hits + hit_delta,
        hops=state.hops + 1,
        frontier=frontier,
        stall=stall,
    )


class _Knobs(NamedTuple):
    """The hop loop's knobs: ``params`` resolved against the index's
    build-time ``capacity`` and ``mode`` (the reference's
    ``_impl_kwargs``)."""

    capacity: int
    mode: str
    beam: int
    io_batch: int
    k: int
    max_hops: int
    entries: int
    patience: int | None
    epsilon: float
    entry_slack: int | None
    min_entries: int


def _knobs(params: SearchParams, capacity: int, mode: str) -> _Knobs:
    """Every violated invariant of ``params`` in one ``ValueError``."""
    problems = params.pageann_violations()
    if problems:
        raise ValueError(
            "invalid SearchParams for PageANN search: " + "; ".join(problems)
        )
    a = params.adaptive
    return _Knobs(
        capacity=capacity,
        mode=mode,
        beam=params.beam_width,
        io_batch=params.io_batch,
        k=params.k,
        max_hops=params.max_hops,
        entries=params.lsh_entries,
        patience=None if a is None else a.patience,
        epsilon=0.0 if a is None else a.epsilon,
        entry_slack=None if a is None else a.entry_slack_bits,
        min_entries=1 if a is None else a.min_entries,
    )


def _active(state: BeamState, kn: _Knobs) -> torch.Tensor:
    """The reference's while-loop ``cond``, per lane: a live (unexpanded,
    finite) candidate remains, the hop budget is not spent and, with early
    termination on, the top-k has not stalled for ``patience`` hops."""
    live = (~state.cand_vis) & (state.cand_ids != PAD) & torch.isfinite(state.cand_d)
    go = live.any(1) & (state.hops < kn.max_hops)
    if kn.patience is not None:
        go = go & (state.stall < kn.patience)
    return go


def _start(
    queries: torch.Tensor, data: SearchData, kn: _Knobs, impl: str | None,
) -> tuple[BeamState, torch.Tensor, torch.Tensor | None]:
    """The ADC tables and the routed initial state: (state, disk_lut,
    mem_lut)."""
    disk_lut = ops.pq_lut(queries, data.disk_codebooks, impl=impl)  # (Q, M_disk, K)
    # the finer in-memory tables are dead weight in DISK_ONLY mode
    mem_lut = (
        ops.pq_lut(queries, data.mem_codebooks, impl=impl)        # (Q, M_mem, K)
        if kn.mode != MemoryMode.DISK_ONLY.value
        else None
    )
    state = init_state(
        queries, data, disk_lut, beam=kn.beam, k=kn.k, entries=kn.entries,
        entry_slack=kn.entry_slack, min_entries=kn.min_entries,
        patience=kn.patience, impl=impl,
    )
    return state, disk_lut, mem_lut


def _hop(
    state: BeamState,
    lanes: torch.Tensor,
    queries: torch.Tensor,
    disk_lut: torch.Tensor,
    mem_lut: torch.Tensor | None,
    data: SearchData,
    kn: _Knobs,
    *,
    fetch: PinnedStage | None,
    meta: MetaArrays | None,
    cfilter: CompiledFilter | None,
    impl: str | None,
    tracer=None,
) -> tuple[BeamState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One hop of the active ``lanes``; the other lanes stay frozen.
    Returns the new state (the input's tensors, written in place, when a
    lane is frozen), and the lanes' (n, b) page batch and I/O and cache-hit
    deltas."""
    everyone = lanes.numel() == queries.shape[0]
    if everyone:
        sub, q, dl, ml = state, queries, disk_lut, mem_lut
    else:
        sub = BeamState(*(None if t is None else t[lanes] for t in state))
        q, dl = queries[lanes], disk_lut[lanes]
        ml = None if mem_lut is None else mem_lut[lanes]
    with span(tracer, "pageann.hop.select", cat=TRACK, track=TRACK):
        sub, batch = select_batch(sub, capacity=kn.capacity,
                                  io_batch=kn.io_batch)
    with span(tracer, "pageann.hop.score", cat=TRACK, track=TRACK):
        scored = score_page_batch(
            q, data, batch, sub, dl, ml, capacity=kn.capacity, mode=kn.mode,
            fetch=fetch, meta=meta, cfilter=cfilter, impl=impl, tracer=tracer,
        )
    with span(tracer, "pageann.hop.merge", cat=TRACK, track=TRACK):
        sub = merge(sub, *scored, patience=kn.patience, epsilon=kn.epsilon)
    if not everyone:
        # frozen lanes keep their state; the loop owns these tensors
        for full, part in zip(state, sub):
            if full is not None:
                full[lanes] = part
        sub = state
    return sub, batch, scored[4], scored[5]


def _result(state: BeamState) -> SearchResult:
    return SearchResult(
        ids=state.res_ids, dists=state.res_d, ios=state.io,
        hops=state.hops, cache_hits=state.cache_hits,
    )


def batch_search(
    queries: torch.Tensor,
    data: SearchData,
    params: SearchParams,
    *,
    capacity: int,
    mode: str,
    meta: MetaArrays | None = None,
    cfilter: CompiledFilter | None = None,
    impl: str | None = None,
    fetch: PinnedStage | None = None,
    tracer=None,
) -> SearchResult:
    """Search a batch of queries. queries: (Q, d) on the data's device.

    ``params`` carries the per-call runtime knobs (beam L, io batch b, max
    hops, LSH top-T, k, and the adaptive knobs); ``capacity`` and ``mode``
    are build-time properties of the index. An all-default
    ``AdaptiveParams()`` runs exactly the non-adaptive loop. Filtered search
    passes ``meta`` (the index's page-slot-aligned metadata on the device)
    and ``cfilter`` (the compiled predicate); with both ``None`` the search
    is the unfiltered one. ``impl="plain"`` runs every kernel's plain
    version (tests and the chip smoke compare the two). ``fetch`` is the
    streamed tier's hook; callers go through ``stream_search``. ``tracer``
    takes the phases' spans (``obs.trace.span``).
    """
    kn = _knobs(params, capacity, mode)
    with span(tracer, "pageann.start", cat=TRACK, track=TRACK):
        state, disk_lut, mem_lut = _start(queries, data, kn, impl)
    h = 0
    while True:
        with span(tracer, "pageann.hop", cat=TRACK, track=TRACK) as hop:
            with span(tracer, "pageann.hop.sync", cat=TRACK, track=TRACK):
                lanes = _active(state, kn).nonzero().squeeze(1)
                n = lanes.numel()              # the hop's one host sync
            hop.note(hop=h, lanes=n)
            if n == 0:
                break
            state = _hop(state, lanes, queries, disk_lut, mem_lut, data, kn,
                         fetch=fetch, meta=meta, cfilter=cfilter, impl=impl,
                         tracer=tracer)[0]
        h += 1
    return _result(state)


def stream_search(
    queries: torch.Tensor,
    data: SearchData,
    params: SearchParams,
    *,
    capacity: int,
    mode: str,
    fetcher,
    meta: MetaArrays | None = None,
    cfilter: CompiledFilter | None = None,
    impl: str | None = None,
    stage: PinnedStage | None = None,
    tracer=None,
) -> SearchResult:
    """``batch_search`` over a budgeted index: ``data.page_recs`` holds
    only the resident pages, and each hop's misses are read from the host
    memmap by ``fetcher`` (a ``core.stream.PageFetcher``), once per hop for
    the whole batch. ``stage`` is the pinned buffer to move them through
    (the index keeps one across calls; a new one by default).

    Results equal the fully resident ``batch_search`` on the same artifact
    bit for bit. The fetcher's counters count only active lanes: a
    finished query is frozen and fetches nothing, where the reference's
    vmapped loop keeps fetching for it, so they may be lower than the
    reference's for the same queries.
    """
    if stage is None:
        stage = PinnedStage(fetcher)
    return batch_search(
        queries, data, params, capacity=capacity, mode=mode, meta=meta,
        cfilter=cfilter, impl=impl, fetch=stage, tracer=tracer,
    )


def shard_search(
    queries: torch.Tensor,
    data: SearchData,
    params: SearchParams,
    *,
    mesh=None,
    capacity: int,
    mode: str,
    meta: MetaArrays | None = None,
    cfilter: CompiledFilter | None = None,
    impl: str | None = None,
    tracer=None,
) -> SearchResult:
    """``batch_search`` with the query batch split across a device mesh.

    The index (``data``) is replicated on every device of ``mesh`` (a
    ``repro_torch.launch.mesh.Mesh``; the (1, 1) mesh on the queries'
    device when None): the (Q, d) batch is split over all mesh positions,
    row-major, in blocks of ceil(Q / devices), the paper's "query threads"
    mapped onto cards. A device named more than once searches each of its
    blocks in turn against one copy of the index. The reference pads a
    ragged batch with ``valid=False`` rows; the port's lanes are
    independent, so the last block is simply shorter. The results are
    gathered back onto the queries' device and equal ``batch_search``'s bit
    for bit. (Index sharding, partitioning the vectors themselves, is the
    orthogonal axis and lives in ``core.distributed``.)
    """
    if mesh is None:
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(queries.device)
    out = queries.device
    step = max(1, -(-queries.shape[0] // mesh.size))
    copies: dict = {}
    parts = []
    for dev, q_blk in zip(mesh.flat, torch.split(queries, step)):
        if dev not in copies:
            copies[dev] = (
                SearchData(*(t.to(dev) for t in data)),
                None if meta is None else meta.to(dev),
            )
        d, m = copies[dev]
        res = batch_search(q_blk.to(dev), d, params, capacity=capacity,
                           mode=mode, meta=m, cfilter=cfilter, impl=impl,
                           tracer=tracer)
        parts.append(SearchResult(*(t.to(out) for t in res)))
    return SearchResult(*(torch.cat(ts) for ts in zip(*parts)))


def merge_topk_streams(
    ids_a: torch.Tensor,
    d_a: torch.Tensor,
    ids_b: torch.Tensor,
    d_b: torch.Tensor,
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two per-query top-k result streams into one (Q, k) top-k.

    The fresh + disk unification point of the mutable index
    (``core.delta``): stream *a* is the page-file search (tombstones
    already masked to PAD/INF), stream *b* the delta scan, (Q, ka) and
    (Q, kb), PAD ids carrying INF. One stable ascending top-k over the
    concatenation, so on a tie the lower column wins and the base stream
    beats the delta (``lax.top_k``'s order); non-finite winners are
    re-masked to PAD. Returns (ids (Q, k) int32, dists (Q, k) f32).
    """
    d = torch.cat([d_a, d_b], dim=1)
    ids = torch.cat([ids_a, ids_b], dim=1).to(torch.int32)
    vals, idx = _top_k_merge(d, k)
    merged = torch.gather(ids, 1, idx)
    return torch.where(torch.isfinite(vals), merged, PAD), vals


# --------------------------------------------------------------------------
# profiling entry point: the same hops, with the per-hop trail kept
# --------------------------------------------------------------------------

class HopProfile(NamedTuple):
    """Per-hop trail of a profiled search (leading dims (Q, max_hops)).

    Hops past a query's exit carry ``active=False`` with PAD pages and
    zero deltas. ``worst_topk`` is the worst running top-k distance after
    the hop (the early-termination frontier); ``stall`` is the adaptive
    patience counter after the hop (zeros when the params are not
    adaptive). A frozen lane records its frozen state's worst and stall,
    on every hop up to ``max_hops``, as the reference's ``lax.scan`` does.
    """

    pages: torch.Tensor       # (Q, H, b) int32 page ids scheduled, PAD padded
    ios: torch.Tensor         # (Q, H) int32 disk page reads this hop
    cache_hits: torch.Tensor  # (Q, H) int32 cached page reads this hop
    active: torch.Tensor      # (Q, H) bool: did the lane hop
    worst_topk: torch.Tensor  # (Q, H) f32 worst running top-k distance
    stall: torch.Tensor       # (Q, H) int32 patience counter after the hop


def profile_search(
    queries: torch.Tensor,
    data: SearchData,
    params: SearchParams,
    *,
    capacity: int,
    mode: str,
    meta: MetaArrays | None = None,
    cfilter: CompiledFilter | None = None,
) -> tuple[SearchResult, HopProfile]:
    """``batch_search`` plus the per-hop trail (opt-in debug mode).

    The same loop over the same hop (``select_batch`` -> ``score_page_batch``
    -> ``merge``), so ids, distances, ios, hops and cache hits equal
    ``batch_search``'s bit for bit; the trail is written as the loop runs,
    so an unprofiled search pays nothing for it. Resident indexes only.
    """
    kn = _knobs(params, capacity, mode)
    nq, dev, h_max = queries.shape[0], queries.device, kn.max_hops
    pages = torch.full((nq, h_max, kn.io_batch), PAD, dtype=torch.int32,
                       device=dev)
    ios = torch.zeros((nq, h_max), dtype=torch.int32, device=dev)
    hits = torch.zeros_like(ios)
    active = torch.zeros((nq, h_max), dtype=torch.bool, device=dev)
    worst = torch.empty((nq, h_max), dtype=torch.float32, device=dev)
    stall = torch.zeros_like(ios)

    state, disk_lut, mem_lut = _start(queries, data, kn, None)
    h = 0
    while True:
        lanes = _active(state, kn).nonzero().squeeze(1)
        if lanes.numel() == 0:
            break
        state, batch, io_delta, hit_delta = _hop(
            state, lanes, queries, disk_lut, mem_lut, data, kn,
            fetch=None, meta=meta, cfilter=cfilter, impl=None)
        pages[lanes, h] = batch
        ios[lanes, h] = io_delta
        hits[lanes, h] = hit_delta
        active[lanes, h] = True
        worst[:, h] = state.res_d[:, kn.k - 1]
        if kn.patience is not None:
            stall[:, h] = state.stall
        h += 1
    # every lane is frozen from here on: its trail repeats its final state
    worst[:, h:] = state.res_d[:, kn.k - 1:kn.k]
    if kn.patience is not None:
        stall[:, h:] = state.stall[:, None]
    return _result(state), HopProfile(
        pages=pages, ios=ios, cache_hits=hits, active=active,
        worst_topk=worst, stall=stall,
    )
