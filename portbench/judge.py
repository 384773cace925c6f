"""The comparison that decides ``correct``.

Every batch the window answered is judged once the window has closed:
its queries are drawn again from their seed, the reference computes the
exact top-k and the exact distance of every id returned, and each query's
answer is held to the configuration's guarantees:

* ``unanswered``: queries with no row of results (limit 0);
* ``bad_ids``: a returned id outside the collection, twice in a row, or a
  padding slot (-1) with a finite distance (limit 0);
* ``dist_gap``: the widest relative gap between a returned distance and
  the exact squared L2 of the id it names (the program sums in float32;
  the limit is set from sound runs and the TF32 control, ``PERF.md``);
* ``recall_at_10``: the share of the exact top-10 that came back, over
  every query of the window, at least the configuration's stated recall.

A query fails when it is unanswered or breaks any of the first three.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import reference


class Judge:
    def __init__(self, x: torch.Tensor, k: int, limits: dict):
        self.x, self.k, self.limits = x, k, limits
        self.attempted = 0
        self.failed = 0
        self.unanswered = 0
        self.bad_ids = 0
        self.dist_gap = 0.0
        self.hits = 0

    def add(self, q: torch.Tensor, ids, dists) -> None:
        """Judge one batch: ``q`` its (Q, d) queries, ``ids`` / ``dists``
        what the search returned for them (anything array-like)."""
        nq, k, dev = q.shape[0], self.k, q.device
        self.attempted += nq
        ids = np.asarray(ids)
        dists = np.asarray(dists)
        rows = 0
        if (ids.ndim == 2 and ids.shape[1] == k and dists.shape == ids.shape
                and np.issubdtype(ids.dtype, np.integer)):
            rows = min(nq, ids.shape[0])
        self.unanswered += nq - rows
        self.failed += nq - rows
        if rows == 0:
            return
        q = q[:rows]
        ids_t = torch.as_tensor(ids[:rows], dtype=torch.int64, device=dev)
        got = torch.as_tensor(dists[:rows], dtype=torch.float64, device=dev)
        n = self.x.shape[0]
        valid = ids_t >= 0
        # an id outside the collection; a padding slot (-1) carries +inf
        bad = (valid & (ids_t >= n)) | (ids_t < -1) | (
            (ids_t == -1) & torch.isfinite(got))
        srt = torch.sort(torch.where(valid, ids_t, -1 - torch.arange(
            k, device=dev)), dim=1).values
        dup = torch.zeros_like(valid)
        dup[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
        bad_row = bad.any(1) | dup.any(1)

        exact = reference.exact_distances(self.x, q, ids_t)
        ok = valid & ~bad
        gap = torch.where(
            ok, (got - exact).abs() / exact.clamp(min=1e-30), 0.0)
        gap = torch.where(ok & ~torch.isfinite(got), torch.inf, gap)
        row_gap = gap.max(1).values
        limit = float(self.limits["dist_gap"])
        failed = bad_row | (row_gap > limit)

        truth = reference.exact_topk(self.x, q, k)
        hit = (truth[:, :, None] == torch.where(valid, ids_t, -1)[:, None, :])
        self.hits += int(hit.any(-1).sum())
        self.bad_ids += int(bad_row.sum())
        self.dist_gap = max(self.dist_gap, float(row_gap.max()))
        self.failed += int(failed.sum())

    @property
    def recall(self) -> float:
        return self.hits / max(1, self.attempted * self.k)

    def checks(self) -> dict:
        """Each number compared, beside its limit and the way it is held."""
        lim = self.limits
        return {
            "unanswered": {"value": self.unanswered, "limit": 0, "held": "<="},
            "bad_ids": {"value": self.bad_ids, "limit": 0, "held": "<="},
            "dist_gap": {"value": self.dist_gap, "limit": lim["dist_gap"],
                         "held": "<="},
            "recall_at_10": {"value": self.recall,
                             "limit": lim["recall_at_10"], "held": ">="},
        }

    def correct(self) -> bool:
        if self.attempted == 0:
            return False
        for c in self.checks().values():
            v, lim = c["value"], c["limit"]
            if not (v <= lim if c["held"] == "<=" else v >= lim):
                return False
        return True
