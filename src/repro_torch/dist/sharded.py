"""Data-sharded PageANN collection: S complete sub-indexes over slices of
one dataset, presented as a single ``VectorIndex``.

Port of ``repro.dist.sharded``. Independent sharding (paper §7): every
query runs against ALL shards and the per-shard top-k streams merge with
:func:`repro_torch.core.search.merge_topk_streams`. The true global top-k
is a subset of the union of the per-shard top-k (each shard holds a
disjoint slice of the corpus and returns its k best), so the merge is
exact: recall differs from the unsharded index only through each shard's
beam search, which is why :func:`shard_params_for` can shrink the
per-shard beam (a 1/S-size corpus needs a smaller beam for the same
recall).

Two execution paths share one artifact:

* **host fan-out** (default, any number of devices): one ``search`` per
  shard in turn, the ids translated to global ones on the host, the
  streams folded shard by shard.
* **mesh fan-out** (``search(..., mesh=)``): the stacked
  :class:`~repro_torch.core.distributed.ShardedIndex` searched through
  ``make_sharded_search``, one shard on each position of the mesh's
  ``data`` axis and one merge over all of them.

Persistence: ``save`` writes each sub-index as a full PageANN artifact
under ``shard-<i>/`` plus ``shards.npz`` (the global-id slice per shard)
under one ``kind="sharded"`` manifest; ``repro_torch.core.persist.
load_index`` dispatches back here, and ``memory_budget`` applies per shard.
Both packages read each other's sharded artifacts.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core import persist
from repro_torch.core.config import (
    PageANNConfig,
    SearchParams,
    resolve_search_params,
)
from repro_torch.core.index import PageANNIndex
from repro_torch.core.search import PAD, SearchResult, merge_topk_streams

SHARD_SUBDIR = "shard-{i}"
SHARDS_NPZ = "shards.npz"


def shard_params_for(base: SearchParams, num_shards: int) -> SearchParams:
    """Per-shard search knobs for a 1/S-size corpus.

    The exact cross-shard merge means each shard only has to be accurate
    about ITS slice, and a smaller corpus needs a smaller beam for the
    same recall — this is where data sharding buys throughput even on one
    device (each query does less total page-scoring work).  The scaling
    here (beam halved per doubling of shards, floored at the legal
    minimum; smaller io_batch so the shorter walks waste less speculative
    I/O) was measured on the benchmark corpus at recall parity; the
    parity gate in ``benchmarks/scaleout.py`` keeps it honest for other
    configs.
    """
    if num_shards <= 1:
        return base
    beam = max(
        base.k, base.lsh_entries,
        math.ceil(base.beam_width / (2 * num_shards)),
    )
    return base.replace(
        beam_width=beam,
        io_batch=min(base.io_batch, 3),
        max_hops=max(16, base.max_hops // 2),
    )


@dataclasses.dataclass
class ShardedPageStore:
    """S per-shard :class:`PageANNIndex` sub-indexes + their global-id
    slices, speaking the ``VectorIndex`` protocol."""

    shards: list
    parts: list                      # list[np.ndarray] global ids per shard
    cfg: PageANNConfig

    def __post_init__(self):
        if len(self.shards) != len(self.parts):
            raise ValueError(
                f"{len(self.shards)} shards but {len(self.parts)} id slices"
            )
        if len(self.shards) < 1:
            raise ValueError("need at least one shard")

    # ------------------------------------------------------------- build
    @classmethod
    def build(
        cls, x: np.ndarray, cfg: PageANNConfig, num_shards: int, *,
        device: str | torch.device = "cuda",
    ) -> "ShardedPageStore":
        """Balanced random partition (seeded by the config), one full
        PageANN build per shard on ``device``."""
        x = np.asarray(x, np.float32)
        parts = dist.partition_vectors(x, num_shards, cfg.seed)
        shards = [PageANNIndex.build(x[p], cfg, device=device) for p in parts]
        return cls(shards=shards, parts=list(parts), cfg=cfg)

    # ---------------------------------------------------------- protocol
    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def dim(self) -> int:
        return self.cfg.dim

    @property
    def default_params(self) -> SearchParams:
        """UNSHARDED-space defaults: callers think in whole-collection
        knobs; the per-shard scaling happens inside ``search``."""
        return SearchParams.from_config(self.cfg)

    def resolve_params(
        self, k: int | None, params: SearchParams | None
    ) -> SearchParams:
        return resolve_search_params(self.default_params, k, params)

    @property
    def stats(self) -> dict:
        """Aggregate footprint over the fleet of shards (a dict, so the
        service's stats flattener namespaces the fields as they are)."""
        subs = [s.stats for s in self.shards]
        return dict(
            num_shards=self.num_shards,
            num_vectors=sum(len(p) for p in self.parts),
            pages=sum(st.pages for st in subs),
            disk_bytes=sum(st.disk_bytes for st in subs),
            memory_bytes=sum(st.memory_bytes for st in subs),
            resident_pages=sum(st.resident_pages for st in subs),
        )

    def fetch_stats(self) -> dict:
        out = dict(pages_fetched=0, fetch_hits=0, fetch_wall_s=0.0)
        for s in self.shards:
            fs = s.fetch_stats()
            for key in out:
                out[key] += fs.get(key, 0)
        return out

    # ------------------------------------------------------------ search
    def _translate(self, shard: int, local_ids: np.ndarray) -> np.ndarray:
        """Shard-local ORIGINAL ids -> global dataset ids, PAD kept."""
        part = self.parts[shard]
        out = np.full(local_ids.shape, PAD, np.int64)
        valid = local_ids >= 0
        out[valid] = part[local_ids[valid]]
        return out

    def search(
        self,
        queries: np.ndarray,
        k: int | None = None,
        params: SearchParams | None = None,
        *,
        mesh=None,
        impl: str | None = None,
    ) -> SearchResult:
        """Fan a query batch out to every shard, merge per-shard top-k.

        Returns GLOBAL dataset ids as numpy arrays. ``ios``/``cache_hits``
        sum over shards (total fleet I/O per query); ``hops`` is the max
        across shards (the critical path). With ``mesh=`` the fan-out runs
        over the mesh's ``data`` axis (one shard per position) instead of
        shard by shard on the host. ``impl="plain"`` runs the kernels'
        plain versions.
        """
        p = self.resolve_params(k, params)
        if mesh is not None:
            return self._mesh_search(queries, p, mesh, impl)
        sp = shard_params_for(p, self.num_shards)
        merged_ids = merged_d = None
        ios = hops = hits = None
        for i, sub in enumerate(self.shards):
            # per-shard searches return shard-local ORIGINAL ids; k stays
            # the caller's k (the exact-merge property needs each shard's
            # full k best, no more)
            r = sub.search(queries, k=p.k, params=sp, impl=impl)
            gids = self._translate(i, np.asarray(r.ids))
            # PAD must carry +inf into the merge (merge_topk_streams
            # re-masks non-finite winners back to PAD)
            d = np.where(gids < 0, np.inf, np.asarray(r.dists))
            gi = torch.as_tensor(gids.astype(np.int32))
            dj = torch.as_tensor(d.astype(np.float32))
            if merged_ids is None:
                merged_ids, merged_d = gi, dj
                ios = np.asarray(r.ios).copy()
                hops = np.asarray(r.hops).copy()
                hits = np.asarray(r.cache_hits).copy()
            else:
                merged_ids, merged_d = merge_topk_streams(
                    merged_ids, merged_d, gi, dj, k=p.k
                )
                ios += np.asarray(r.ios)
                hops = np.maximum(hops, np.asarray(r.hops))
                hits += np.asarray(r.cache_hits)
        ids = merged_ids.numpy().astype(np.int64)
        d = merged_d.numpy()
        if self.num_shards == 1:
            # single shard: nothing was merged, mask PAD distances for the
            # same contract as the merged path
            d = np.where(ids < 0, np.inf, d)
        return SearchResult(
            ids=ids, dists=d, ios=ios, hops=hops, cache_hits=hits
        )

    def _mesh_search(self, queries, p: SearchParams, mesh,
                     impl: str | None) -> SearchResult:
        """The fan-out over the mesh's ``data`` axis — the multi-device
        path; requires ``mesh`` with axes ("data", "model") and data-axis
        size == num_shards. Like the reference's, it reports ``hops`` and
        ``cache_hits`` as zeros (its merge gathers ids, distances and ios
        only)."""
        data_size = mesh.shape.get("data")
        if data_size != self.num_shards:
            raise ValueError(
                f"mesh data axis is {data_size} but index has "
                f"{self.num_shards} shards"
            )
        sp = shard_params_for(p, self.num_shards)
        sh = self.to_sharded_index()
        fn, _ = dist.make_sharded_search(
            mesh, self.cfg, sh.capacity, k=p.k, params=sp, impl=impl
        )
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(mesh.flat[0])
        ids, tag, d, ios = (t.cpu().numpy() for t in fn(sh.data, q))
        # the stacked new_to_old maps each shard's reassigned ids to its
        # shard-local original ids; each shard's slice maps those to
        # global dataset ids
        local = dist.translate_ids(sh, ids, tag)
        out = np.full(local.shape, PAD, np.int64)
        valid = local >= 0
        for s in range(self.num_shards):
            m = valid & (tag == s)
            out[m] = self.parts[s][local[m]]
        dd = np.where(out < 0, np.inf, d)
        zeros = np.zeros((out.shape[0],), np.int64)
        return SearchResult(
            ids=out, dists=dd, ios=ios, hops=zeros, cache_hits=zeros,
        )

    def to_sharded_index(self) -> dist.ShardedIndex:
        """Stack the sub-indexes into the mesh search's input layout. The
        stacked ``new_to_old`` maps shard-local reassigned ids back to
        shard-local ORIGINAL ids (indexes into ``parts[s]``)."""
        local_parts = [np.arange(len(p), dtype=np.int64) for p in self.parts]
        return dist.stack_shards(self.shards, local_parts)

    # ----------------------------------------------------------- persist
    def save(self, directory: str) -> None:
        """``shard-<i>/`` full PageANN artifacts + ``shards.npz`` id
        slices under one ``kind="sharded"`` manifest (written last, so a
        crash mid-save leaves a directory ``load_index`` refuses)."""
        os.makedirs(directory, exist_ok=True)
        for i, sub in enumerate(self.shards):
            sub.save(os.path.join(directory, SHARD_SUBDIR.format(i=i)))
        np.savez(
            os.path.join(directory, SHARDS_NPZ),
            **{f"part_{i}": np.asarray(p, np.int64)
               for i, p in enumerate(self.parts)},
        )
        persist.write_manifest(directory, dict(
            kind="sharded",
            num_shards=self.num_shards,
            config=persist.config_to_json(self.cfg),
        ))

    @classmethod
    def load(
        cls, directory: str, *, device: str | torch.device = "cuda",
        memory_budget=None,
    ) -> "ShardedPageStore":
        """Reload onto ``device``; each shard's searches equal the saved
        one's bit for bit, and ``memory_budget`` caps each shard's resident
        page tier independently."""
        doc = persist.read_manifest(directory)
        if doc.get("kind") != "sharded":
            raise persist.IndexFormatError(
                f"{directory}: manifest kind is {doc.get('kind')!r}, "
                "not 'sharded'"
            )
        num = doc["num_shards"]
        if not isinstance(num, int) or num < 1:
            raise persist.IndexFormatError(
                f"{directory}: bad num_shards {num!r}"
            )
        npz_path = os.path.join(directory, SHARDS_NPZ)
        if not os.path.exists(npz_path):
            raise persist.IndexFormatError(f"{directory}: missing {SHARDS_NPZ}")
        with np.load(npz_path) as z:
            parts = [z[f"part_{i}"] for i in range(num)]
        shards = [
            PageANNIndex.load(
                os.path.join(directory, SHARD_SUBDIR.format(i=i)),
                device=device, memory_budget=memory_budget,
            )
            for i in range(num)
        ]
        cfg = persist.config_from_json(doc["config"])
        return cls(shards=shards, parts=parts, cfg=cfg)
