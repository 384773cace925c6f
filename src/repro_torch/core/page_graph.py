"""Page-node graph construction — Algorithm 1 of the paper.

Phase 1 (lines 1-13): greedily group vectors into page nodes of capacity n.
Each seed pulls its n-1 closest *ungrouped* vectors found within h hops of
the Vamana graph; leftover capacity is filled from the ungrouped pool.

Phase 2 (lines 14-26): derive page-level connectivity. For every page,
aggregate the vector-level out-edges of its members, drop intra-page edges,
merge duplicates, and keep up to R_p external neighbor *vectors* (Fig. 5
stores neighbor vector ids + their compressed values on the page). Neighbors
are ranked by incoming edge multiplicity (connectivity strength), tie-broken
by distance to the page centroid — this is the "merging technique" that frees
page bytes for more search-relevant data.

Build-time code, so plain numpy; the hot loops are vectorized.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PAD = -1


@dataclasses.dataclass
class PageGrouping:
    pages: np.ndarray        # (P, capacity) int32 original vector ids, PAD-padded
    page_of: np.ndarray      # (N,) int32 page index of each original vector
    slot_of: np.ndarray      # (N,) int32 slot within its page


def _hop_candidates(nbrs: np.ndarray, seed: int, h: int, ungrouped: np.ndarray) -> np.ndarray:
    """Ungrouped vector ids within h hops of seed (excluding seed)."""
    frontier = np.array([seed], np.int64)
    seen = {int(seed)}
    out: list[np.ndarray] = []
    for _ in range(h):
        nxt = nbrs[frontier].ravel()
        nxt = nxt[nxt != PAD]
        if nxt.size == 0:
            break
        nxt = np.unique(nxt)
        fresh = np.array([u for u in nxt if u not in seen], np.int64)
        if fresh.size == 0:
            break
        seen.update(int(u) for u in fresh)
        out.append(fresh)
        frontier = fresh
    if not out:
        return np.empty((0,), np.int64)
    cand = np.concatenate(out)
    return cand[ungrouped[cand]]


def group_pages(
    x: np.ndarray, nbrs: np.ndarray, capacity: int, h: int = 2
) -> PageGrouping:
    """Algorithm 1, lines 1-13."""
    n = len(x)
    ungrouped = np.ones(n, bool)
    # seeds in degree-descending order: well-connected vectors make good
    # page anchors and their hop-neighborhoods are dense.
    seed_order = np.argsort(-(nbrs != PAD).sum(1), kind="stable")
    pool_ptr = 0
    pool = np.arange(n)
    pages: list[np.ndarray] = []
    page_of = np.full(n, PAD, np.int32)
    slot_of = np.full(n, PAD, np.int32)

    for seed in seed_order:
        if not ungrouped[seed]:
            continue
        members = [int(seed)]
        ungrouped[seed] = False
        cand = _hop_candidates(nbrs, int(seed), h, ungrouped)
        if cand.size:
            d = ((x[cand] - x[seed]) ** 2).sum(-1)
            take = cand[np.argsort(d)[: capacity - 1]]
            members.extend(int(u) for u in take)
            ungrouped[take] = False
        # fill leftovers from the global ungrouped pool (lines 9-11)
        while len(members) < capacity:
            while pool_ptr < n and not ungrouped[pool[pool_ptr]]:
                pool_ptr += 1
            if pool_ptr >= n:
                break
            u = int(pool[pool_ptr])
            members.append(u)
            ungrouped[u] = False
        row = np.full(capacity, PAD, np.int32)
        row[: len(members)] = members
        pid = len(pages)
        pages.append(row)
        for s, u in enumerate(members):
            page_of[u] = pid
            slot_of[u] = s

    return PageGrouping(
        pages=np.stack(pages).astype(np.int32),
        page_of=page_of,
        slot_of=slot_of,
    )


def derive_page_edges(
    x: np.ndarray,
    nbrs: np.ndarray,
    grouping: PageGrouping,
    page_degree: int,
) -> np.ndarray:
    """Algorithm 1, lines 14-26: external neighbor vectors per page.

    Returns (P, page_degree) int32 of *original vector ids*, PAD-padded.
    """
    pages, page_of = grouping.pages, grouping.page_of
    p = len(pages)
    out = np.full((p, page_degree), PAD, np.int32)
    for pid in range(p):
        members = pages[pid][pages[pid] != PAD]
        ext = nbrs[members].ravel()
        ext = ext[ext != PAD]
        ext = ext[page_of[ext] != pid]          # drop intra-page edges
        if ext.size == 0:
            continue
        uniq, counts = np.unique(ext, return_counts=True)  # merge duplicates
        centroid = x[members].mean(0)
        d = ((x[uniq] - centroid) ** 2).sum(-1)
        # strong connectivity first, then proximity
        order = np.lexsort((d, -counts))
        keep = uniq[order][:page_degree]
        out[pid, : len(keep)] = keep
    return out


def page_graph_stats(page_nbrs: np.ndarray) -> dict:
    deg = (page_nbrs != PAD).sum(1)
    return {
        "pages": int(len(page_nbrs)),
        "mean_degree": float(deg.mean()),
        "max_degree": int(deg.max()),
        "min_degree": int(deg.min()),
    }
