"""Distributed PageANN: independent sharding over a device mesh.

Port of ``repro.core.distributed``. The index is partitioned into S shards
(S == size of the mesh's ``data`` axis); each shard is a complete PageANN
sub-index over a slice of the vectors. Queries are split over the
``model`` axis (the paper's "query threads"). A query runs as

  local beam search on the shard's device    (``core.search.batch_search``)
  -> every shard's k local results gathered onto one device
  -> one stable top-k merge

which is the "independent sharding" design of the paper's §7. The
reference runs it as one ``shard_map`` program with an ``all_gather``;
here one host process drives the mesh, visiting its positions in turn, so
the fan-out is a plain loop and the gather a copy to the output device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import search as search_mod
from repro_torch.core.config import PageANNConfig, SearchParams

PAD = -1
# cached_pages pad: beyond every page id, so a pad never matches a page
_CACHE_SENTINEL = 2**31 - 1


class ShardedIndex(NamedTuple):
    """``SearchData`` with a leading shard axis on every tensor, plus the
    per-shard id -> original-id maps (host side)."""

    data: search_mod.SearchData        # every tensor: (S, ...)
    new_to_old: np.ndarray             # (S, P*cap) original ids, PAD padded
    capacity: int


def partition_vectors(x: np.ndarray, num_shards: int, seed: int = 0):
    """Balanced random partition (independent sharding): numpy's seeded
    permutation split into ``num_shards`` near-equal parts."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    return np.array_split(perm, num_shards)


def build_sharded_index(
    x: np.ndarray, cfg: PageANNConfig, num_shards: int, *,
    device: str | torch.device = "cuda",
) -> ShardedIndex:
    """Build per-shard sub-indexes on ``device`` and stack them to
    identical shapes."""
    from repro_torch.core.index import PageANNIndex

    parts = partition_vectors(x, num_shards, cfg.seed)
    idxs = [PageANNIndex.build(x[p], cfg, device=device) for p in parts]
    return stack_shards(idxs, parts)


def _pad_rows(t: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """``t`` grown to ``rows`` along axis 0 with ``fill``."""
    pad = rows - t.shape[0]
    if pad == 0:
        return t
    tail = torch.full((pad, *t.shape[1:]), fill, dtype=t.dtype, device=t.device)
    return torch.cat([t, tail])


def stack_shards(idxs, parts) -> ShardedIndex:
    """Stack already-built per-shard sub-indexes (``PageANNIndex`` each,
    over the id slices in ``parts``) into one ``ShardedIndex`` whose
    tensors carry a leading shard axis. Ragged shards are padded to the
    largest shard's page count; the pad slots carry member_count 0 and PAD
    neighbours, and :func:`make_sharded_search` masks them out before its
    merge. The stack lives on the first shard's device.

    Every shard must be fully resident: a shard loaded under a memory
    budget holds only part of its page records, which no stacked page axis
    can address (the reference stacks such shards and then reads the wrong
    records; this raises instead)."""
    for s, i in enumerate(idxs):
        if i.fetcher is not None:
            raise ValueError(
                f"shard {s} streams its pages (loaded under a memory "
                "budget); a sharded mesh search needs every shard fully "
                "resident: reload without memory_budget"
            )
    num_shards = len(idxs)
    max_pages = max(i.store.num_pages for i in idxs)
    cap = idxs[0].store.capacity
    nmax = max_pages * cap
    cmax = max(i.data.cached_pages.shape[0] for i in idxs)
    dev = idxs[0].data.page_recs.device

    def padded(d: search_mod.SearchData) -> search_mod.SearchData:
        d = search_mod.SearchData(*(t.to(dev) for t in d))
        return d._replace(
            page_recs=_pad_rows(d.page_recs, max_pages, 0.0),
            member_count=_pad_rows(d.member_count, max_pages, 0),
            nbr_ids=_pad_rows(d.nbr_ids, max_pages, PAD),
            nbr_count=_pad_rows(d.nbr_count, max_pages, 0),
            # stacked shards are fully resident: identity residency over
            # the padded page axis (pad pages map to their zero records)
            resident_map=torch.arange(max_pages, dtype=torch.int32, device=dev),
            # mem_codes are sized P*cap per shard
            mem_codes=_pad_rows(d.mem_codes, nmax, 0),
            mem_mask=_pad_rows(d.mem_mask, nmax, False),
            cached_pages=_pad_rows(d.cached_pages, cmax, _CACHE_SENTINEL),
        )

    datas = [padded(i.data) for i in idxs]
    stacked = search_mod.SearchData(*(torch.stack(ts) for ts in zip(*datas)))

    n2o = np.full((num_shards, nmax), PAD, np.int64)
    for s, (i, p) in enumerate(zip(idxs, parts)):
        local = i.store.new_to_old  # local original ids within shard slice
        valid = local != PAD
        row = np.full(nmax, PAD, np.int64)
        row[: len(local)][valid] = np.asarray(p)[local[valid]]
        n2o[s] = row
    return ShardedIndex(data=stacked, new_to_old=n2o, capacity=cap)


def _mask_pad_slots(res: search_mod.SearchResult, member_count: torch.Tensor,
                    capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A shard's (ids, dists) with every candidate that is not a real member
    (PAD, a slot past its page's member count, a wholly padded page) set to
    PAD / +inf. The search already scores pad slots +inf, but the merge must
    not depend on that: a pad candidate that ranked would displace another
    shard's real one and surface as PAD."""
    safe = res.ids.clamp(min=0).long()
    real = (res.ids >= 0) & (safe % capacity < member_count[safe // capacity])
    return (torch.where(real, res.ids, PAD),
            torch.where(real, res.dists, search_mod.INF))


def make_sharded_search(
    mesh,
    cfg: PageANNConfig,
    capacity: int,
    k: int,
    *,
    params: SearchParams | None = None,
    shard_axis: str = "data",
    query_axis: str = "model",
    impl: str | None = None,
):
    """Returns ``(fn, placement)`` executing the sharded search.

    ``fn(stacked_data, queries) -> (ids, tag, dists, ios)``: shard s of
    ``stacked_data`` (a ``ShardedIndex.data``) searches on the devices of
    position s of ``shard_axis``, the (Q, d) queries split in blocks of
    ceil(Q / M) over the M positions of ``query_axis``. ``ids`` are
    shard-local reassigned ids, ``tag`` the shard each came from (both
    (Q, k) int32), ``dists`` (Q, k) f32 and ``ios`` (Q,) the summed page
    reads, all on the queries' device. ``placement[s][m]`` is the device
    that runs shard s for query block m. A shard is copied once to each
    distinct device it runs on; where that is the stack's own device it
    is a view, so a mesh that names one card S times holds one copy of
    the stack. ``params`` defaults to the config's search knobs;
    ``impl="plain"`` runs the kernels' plain versions.
    """
    p = (params or SearchParams.from_config(cfg)).replace(k=k)
    mode = cfg.memory_mode.value
    names = tuple(mesh.axis_names)
    if sorted(names) != sorted((shard_axis, query_axis)):
        raise ValueError(
            f"mesh axes {names} must be ({shard_axis!r}, {query_axis!r})")
    grid = mesh.devices
    if names.index(shard_axis) != 0:
        grid = grid.T
    placement = tuple(tuple(row) for row in grid)
    num_shards, blocks = grid.shape

    def fn(data: search_mod.SearchData, queries: torch.Tensor):
        if data.page_recs.shape[0] != num_shards:
            raise ValueError(
                f"{data.page_recs.shape[0]} stacked shards on a mesh whose "
                f"{shard_axis!r} axis is {num_shards}")
        out = queries.device
        placed: dict = {}

        def shard_on(s: int, dev) -> search_mod.SearchData:
            if (s, dev) not in placed:
                placed[s, dev] = search_mod.SearchData(
                    *(t[s].to(dev) for t in data))
            return placed[s, dev]

        step = max(1, math.ceil(queries.shape[0] / blocks))
        results = []
        for m, q_blk in enumerate(torch.split(queries, step)):
            ids, dists, ios = [], [], []
            for s in range(num_shards):
                dev = placement[s][m]
                shard = shard_on(s, dev)
                res = search_mod.batch_search(
                    q_blk.to(dev), shard, p, capacity=capacity, mode=mode,
                    impl=impl)
                i, d = _mask_pad_slots(res, shard.member_count, capacity)
                ids.append(i.to(out))
                dists.append(d.to(out))
                ios.append(res.ios.to(out))
            results.append(_merge_shards(torch.stack(ids), torch.stack(dists),
                                         torch.stack(ios), p.k))
        return tuple(torch.cat(parts) for parts in zip(*results))

    return fn, placement


def _merge_shards(all_ids, all_d, all_io, k: int):
    """(S, q, k) per-shard candidates -> the (q, k) top-k over the
    shard-major flattening: one stable ascending sort, so on a tie the
    lower shard (then the lower rank) wins, as the reference's
    ``jnp.argsort`` has it."""
    s, qn, kk = all_ids.shape
    tag = torch.arange(s, dtype=torch.int32, device=all_ids.device)
    flat_ids = all_ids.permute(1, 0, 2).reshape(qn, s * kk)
    flat_tag = tag[None, :, None].expand(qn, s, kk).reshape(qn, s * kk)
    flat_d = all_d.permute(1, 0, 2).reshape(qn, s * kk)
    flat_d = torch.where(flat_ids == PAD, search_mod.INF, flat_d)
    order = torch.sort(flat_d, dim=1, stable=True).indices[:, :k]
    return (torch.gather(flat_ids, 1, order), torch.gather(flat_tag, 1, order),
            torch.gather(flat_d, 1, order), all_io.sum(0, dtype=torch.int32))


def translate_ids(
    sharded: ShardedIndex, top_ids: np.ndarray, top_tag: np.ndarray
) -> np.ndarray:
    """(Q, k) shard-local reassigned ids + shard tags -> original ids."""
    out = np.full_like(top_ids, PAD, dtype=np.int64)
    valid = top_ids >= 0
    out[valid] = sharded.new_to_old[top_tag[valid], top_ids[valid]]
    return out
