"""Vamana graph construction (DiskANN's graph; the substrate of Alg. 1).

Port of ``repro.core.vamana``. The batched greedy beam searches — the part
the reference jits — run as one batched torch loop on the device. Robust
pruning, the reverse-edge pass, the medoid and the brute-force ground truth
stay numpy on the host, exactly as in the reference; that host loop is
where a build spends almost all of its time.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

PAD = -1


def l2_sq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared L2 distance matrix between rows of a and rows of b."""
    return (
        (a * a).sum(-1)[:, None]
        - 2.0 * a @ b.T
        + (b * b).sum(-1)[None, :]
    )


def medoid(x: np.ndarray) -> int:
    """Point closest to the dataset mean (the fixed search entry point)."""
    mean = x.mean(axis=0, keepdims=True)
    return int(np.argmin(l2_sq(mean, x)[0]))


def _greedy_search_batch(
    x: torch.Tensor, nbrs: torch.Tensor, queries: torch.Tensor, entry: int,
    *, beam: int, iters: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy beam search over a fixed-degree vector graph.

    Returns for every query the visited/expanded node ids and their exact
    distances (the candidate pool Vamana prunes from). Fixed shapes:
    ids (Q, beam + iters*R), dists likewise; unexpanded slots are PAD/inf.
    Ties keep the reference's order: ``argmin`` takes the first minimum and
    the merge is a stable ascending sort.
    """
    nq = queries.shape[0]
    r = nbrs.shape[1]
    dev = queries.device
    rows = torch.arange(nq, device=dev)
    ids = torch.full((nq, beam), PAD, dtype=torch.int32, device=dev)
    ids[:, 0] = entry
    d = torch.full((nq, beam), float("inf"), device=dev)
    d[:, 0] = ((x[entry][None, :] - queries) ** 2).sum(-1)
    exp = torch.zeros((nq, beam), dtype=torch.bool, device=dev)
    t_ids = torch.full((nq, iters * r), PAD, dtype=torch.int32, device=dev)
    t_d = torch.full((nq, iters * r), float("inf"), device=dev)
    for i in range(iters):
        masked = torch.where(exp | (ids == PAD), float("inf"), d)
        slot = masked.argmin(1)
        done = torch.isinf(masked[rows, slot])
        cur = ids[rows, slot]
        exp[rows, slot] = True
        cand = nbrs[cur.clamp(min=0).long()]                   # (Q, R)
        cand = torch.where(done[:, None], PAD, cand)
        cd = ((x[cand.clamp(min=0).long()] - queries[:, None, :]) ** 2).sum(-1)
        cd = torch.where(cand == PAD, float("inf"), cd)
        # drop candidates already in beam
        dup = (cand[:, :, None] == ids[:, None, :]).any(-1)
        cd = torch.where(dup, float("inf"), cd)
        t_ids[:, i * r:(i + 1) * r] = cand
        t_d[:, i * r:(i + 1) * r] = cd
        # merge candidates into beam
        all_ids = torch.cat([ids, cand], 1)
        all_d = torch.cat([d, cd], 1)
        all_exp = torch.cat([exp, torch.zeros_like(cand, dtype=torch.bool)], 1)
        order = torch.argsort(all_d, dim=1, stable=True)[:, :beam]
        ids = all_ids.gather(1, order)
        d = all_d.gather(1, order)
        exp = all_exp.gather(1, order)
    return torch.cat([ids, t_ids], 1), torch.cat([d, t_d], 1)


def robust_prune(
    point: int,
    cand_ids: np.ndarray,
    cand_d: np.ndarray,
    x: np.ndarray,
    degree: int,
    alpha: float,
) -> np.ndarray:
    """DiskANN robust prune: keep diverse close neighbors."""
    keep_mask = (cand_ids != PAD) & (cand_ids != point) & np.isfinite(cand_d)
    ids, d = cand_ids[keep_mask], cand_d[keep_mask]
    ids, first = np.unique(ids, return_index=True)
    d = d[first]
    order = np.argsort(d)
    ids, d = ids[order], d[order]
    out: list[int] = []
    alive = np.ones(len(ids), bool)
    for i in range(len(ids)):
        if not alive[i]:
            continue
        p = ids[i]
        out.append(int(p))
        if len(out) >= degree:
            break
        # kill candidates closer (x alpha) to p than to the point
        rest = alive & (np.arange(len(ids)) > i)
        if rest.any():
            rid = ids[rest]
            d_pc = ((x[rid] - x[p]) ** 2).sum(-1)
            alive[rest] &= ~(alpha * d_pc <= d[rest])
    res = np.full((degree,), PAD, np.int32)
    res[: len(out)] = out
    return res


def build_vamana(
    x: np.ndarray,
    degree: int = 32,
    beam: int = 64,
    alpha: float = 1.2,
    rounds: int = 2,
    batch: int = 256,
    seed: int = 0,
    *,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Build a Vamana graph; returns (N, degree) int32 adjacency, PAD-padded.

    The greedy searches of each batch run on ``device``; the adjacency lives
    on the host, where the prune and reverse-edge pass rewrite it point by
    point, and is copied to the device once per batch.
    """
    device = resolve_device(device)
    x = np.asarray(x, np.float32)
    n = len(x)
    rng = np.random.default_rng(seed)
    degree = min(degree, n - 1)
    # random regular init
    nbrs = np.full((n, degree), PAD, np.int32)
    for i in range(n):
        c = rng.choice(n - 1, size=min(degree, n - 1), replace=False)
        c[c >= i] += 1
        nbrs[i, : len(c)] = c
    start = medoid(x)
    iters = max(8, beam // 2)
    xt = torch.as_tensor(x).to(device)

    for rnd in range(rounds):
        a = 1.0 if rnd < rounds - 1 else alpha
        order = rng.permutation(n)
        for lo in range(0, n, batch):
            pts = order[lo : lo + batch]
            cand_ids, cand_d = _greedy_search_batch(
                xt, torch.as_tensor(nbrs).to(device), xt[torch.as_tensor(pts).to(device)],
                start, beam=beam, iters=iters,
            )
            cand_ids = cand_ids.cpu().numpy()
            cand_d = cand_d.cpu().numpy()
            for j, p in enumerate(pts):
                p = int(p)
                # prune candidate pool + current neighbors into new adjacency
                pool_ids = np.concatenate([cand_ids[j], nbrs[p]])
                cur = nbrs[p][nbrs[p] != PAD]
                pool_d = np.concatenate(
                    [cand_d[j], ((x[cur] - x[p]) ** 2).sum(-1)]
                    if len(cur)
                    else [cand_d[j], np.zeros((degree - len(cur),)) + np.inf]
                )
                if len(pool_d) < len(pool_ids):
                    pool_d = np.concatenate(
                        [pool_d, np.full(len(pool_ids) - len(pool_d), np.inf)]
                    )
                nbrs[p] = robust_prune(p, pool_ids, pool_d, x, degree, a)
                # reverse edges
                for u in nbrs[p]:
                    if u == PAD:
                        continue
                    row = nbrs[u]
                    if p in row:
                        continue
                    free = np.where(row == PAD)[0]
                    if len(free):
                        nbrs[u, free[0]] = p
                    else:
                        pool = np.concatenate([row, [p]]).astype(np.int32)
                        pd = ((x[pool] - x[u]) ** 2).sum(-1)
                        nbrs[u] = robust_prune(int(u), pool, pd, x, degree, a)
    return nbrs


def brute_force_knn(x: np.ndarray, q: np.ndarray, k: int) -> np.ndarray:
    """Exact kNN ids (ground truth for recall@k)."""
    d = l2_sq(np.asarray(q, np.float32), np.asarray(x, np.float32))
    return np.argsort(d, axis=1)[:, :k].astype(np.int32)
