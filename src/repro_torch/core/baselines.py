"""Baselines the paper compares against: DiskANN and Starling on the card.

Port of ``repro.core.baselines``.

* ``diskann_search`` — DiskANN-style traversal: a vector-granularity Vamana
  beam search where next hops are chosen with in-memory PQ estimates and
  every expanded node costs one disk read of its (vector + adjacency)
  record. With id-ordered placement several unrelated vectors share an SSD
  page, so each node read drags a full page: the read-amplification regime
  of the paper's Table 1.

* ``starling_search`` — Starling-style variant: the same traversal, but the
  disk layout packs *similar* vectors per page (PageANN's grouping) and a
  page, once read, is not read again (unique-page accounting).

Both count "Mean I/Os" as the paper's Table 3 does, so they compare
directly with ``core.search`` on the same data.

The reference ``vmap``s a ``lax.while_loop`` over one query. Here every
state tensor carries a leading query axis and one Python loop runs the hops
for the whole batch, as ``core.search``'s hop loop does: a lane whose loop
condition is false (no live candidate, or ``max_hops`` spent) is frozen,
and the loop costs one host sync a hop. Each hop:

  picks     the io_batch closest unexpanded candidates: the first io_batch
            entries of a *stable* sort of the masked beam, which are the
            reference's sequential ``argmin``s, lower slot first on ties;
  read      Starling counts each page once per query (a visited-page
            bitmap); DiskANN counts one page a node;
  rerank    exact distances of the expanded nodes through the
            ``page_gather_l2`` kernel, the vectors viewed as pages of
            capacity 1, merged into the result top-k;
  expand    PQ estimates of their neighbours through the ``pq_adc`` kernel
            (``ops.pq_adc_gather``: code rows read by id against the
            query's table), merged into the beam.

The visited-node and visited-page bitmaps are ``(Q, N)`` bools, as in the
reference: 10 MB each for 1,000 queries over 10,000 vectors, but 1 GB each
for a 1,000-query batch over 1,000,000 vectors. Ties break toward the lower
index everywhere (stable sorts, never ``torch.topk``).

:class:`DiskANNIndex` / :class:`StarlingIndex` wrap the searches in the
:class:`repro_torch.core.protocol.VectorIndex` lifecycle — build/from_data
-> save -> load -> ``search(queries, k, params)`` returning a
``SearchResult`` of numpy arrays — so the serving engine drives them and
PageANN through one code path. Their artifacts are the reference's
``arrays.npz`` and manifest, readable by either package.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import pq as pq_mod
from repro_torch.core.config import (
    PageANNConfig,
    SearchParams,
    resolve_search_params,
)
from repro_torch.core.search import SearchResult, _mask_dups_keep_first
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

PAD = -1
INF = float("inf")


class BaselineData(NamedTuple):
    x: torch.Tensor          # (N, d) f32 full vectors ('on disk')
    nbrs: torch.Tensor       # (N, R) int32 Vamana adjacency ('on disk')
    codes: torch.Tensor      # (N, M) uint8 PQ codes (in memory)
    codebooks: torch.Tensor  # (M, ksub, dsub) f32
    page_of: torch.Tensor    # (N,) int32 page id of each vector
    entry: torch.Tensor      # () int32 medoid id


class BaselineResult(NamedTuple):
    ids: torch.Tensor    # (Q, k) int32
    dists: torch.Tensor  # (Q, k) f32 exact squared distances
    ios: torch.Tensor    # (Q,) int32 page reads
    hops: torch.Tensor   # (Q,) int32 loop iterations


class _State(NamedTuple):
    """Loop state for a batch of queries (leading axis Q). The two bitmaps
    carry one extra column that masked-out scatters write to."""

    cand_ids: torch.Tensor   # (Q, L) int32
    cand_d: torch.Tensor     # (Q, L) f32
    cand_vis: torch.Tensor   # (Q, L) bool
    node_vis: torch.Tensor   # (Q, N + 1) bool
    page_vis: torch.Tensor   # (Q, N + 1) bool (sized N >= pages)
    res_ids: torch.Tensor    # (Q, k) int32
    res_d: torch.Tensor      # (Q, k) f32
    io: torch.Tensor         # (Q,) int32
    hops: torch.Tensor       # (Q,) int32


def _init_state(q: torch.Tensor, data: BaselineData, lut: torch.Tensor, *,
                beam: int, k: int, impl: str | None) -> _State:
    nq, dev = q.shape[0], q.device
    n = data.x.shape[0]
    entry = data.entry.reshape(1, 1).expand(nq, 1).long()
    cand_ids = torch.full((nq, beam), PAD, dtype=torch.int32, device=dev)
    cand_ids[:, 0] = data.entry
    cand_d = torch.full((nq, beam), INF, dtype=torch.float32, device=dev)
    cand_d[:, :1] = ops.pq_adc_gather(data.codes, entry, lut, impl=impl)
    zeros = torch.zeros((nq,), dtype=torch.int32, device=dev)
    return _State(
        cand_ids=cand_ids,
        cand_d=cand_d,
        cand_vis=torch.zeros((nq, beam), dtype=torch.bool, device=dev),
        node_vis=torch.zeros((nq, n + 1), dtype=torch.bool, device=dev),
        page_vis=torch.zeros((nq, n + 1), dtype=torch.bool, device=dev),
        res_ids=torch.full((nq, k), PAD, dtype=torch.int32, device=dev),
        res_d=torch.full((nq, k), INF, dtype=torch.float32, device=dev),
        io=zeros,
        hops=zeros.clone(),
    )


def _active(s: _State, max_hops: int) -> torch.Tensor:
    """The reference's while-loop ``cond``, per lane."""
    live = (~s.cand_vis) & (s.cand_ids != PAD) & torch.isfinite(s.cand_d)
    return live.any(1) & (s.hops < max_hops)


def _pick(cand_ids, cand_d, cand_vis, io_batch: int):
    """The io_batch sequential argmins over the unexpanded slots as one
    stable sort: (batch (n, b) node ids PAD padded, ok (n, b), cand_vis).

    An argmin over an all-``inf`` mask returns slot 0, so each exhausted
    pick marks slot 0 expanded; a pick is ``ok`` only at a finite masked
    distance."""
    n, beam = cand_ids.shape
    b = io_batch
    masked = torch.where(cand_vis | (cand_ids == PAD), INF, cand_d)
    sd, sslot = torch.sort(masked, dim=1, stable=True)
    if b > beam:
        sd = torch.cat([sd, sd.new_full((n, b - beam), INF)], 1)
        sslot = torch.cat([sslot, sslot.new_zeros((n, b - beam))], 1)
    sd, sslot = sd[:, :b], sslot[:, :b]
    ok = torch.isfinite(sd)
    batch = torch.where(ok, cand_ids.gather(1, sslot), PAD)
    vis = torch.cat([cand_vis, cand_vis.new_zeros((n, 1))], 1)
    vis.scatter_(1, torch.where(ok, sslot, beam), True)
    vis = vis[:, :beam]
    vis[:, 0] |= ~ok.all(1)
    return batch, ok, vis


def _page_reads(s: _State, rows: torch.Tensor, pages: torch.Tensor,
                ok: torch.Tensor) -> torch.Tensor:
    """Starling's unique-page accounting for one hop: the per-lane I/O
    delta; marks the hop's pages visited in ``s.page_vis`` (in place).

    A pick reads its page when the page was not visited before this hop
    and no earlier ``ok`` pick of the batch is on it. The reference then
    scatters ``page_vis[where(ok, page, 0)] = page_vis[...] | ok``; its
    scatter keeps the LAST write of a repeated index, so a non-``ok`` slot
    after a pick on page 0 writes page 0's old bit back. ``ok`` slots are a
    prefix of the batch, so page 0 is marked only when every slot is
    ``ok``. That is reproduced here without a scatter of repeated indices,
    whose order is not defined on CUDA."""
    b = pages.shape[1]
    trash = s.page_vis.shape[1] - 1
    fresh = ok & ~s.page_vis[rows, pages]
    earlier = torch.ones((b, b), dtype=torch.bool,
                         device=pages.device).tril(-1)         # j' < j
    seen = ((pages[:, :, None] == pages[:, None, :]) & ok[:, None, :]
            & earlier).any(2)
    first = fresh & ~seen
    on0 = ok & (pages == 0)
    s.page_vis[rows, torch.where(ok & ~on0, pages, trash)] = True
    s.page_vis[rows[:, 0], 0] |= on0.any(1) & ok.all(1)
    return first.sum(1).to(torch.int32)


def _hop(s: _State, lanes: torch.Tensor, q: torch.Tensor, lut: torch.Tensor,
         data: BaselineData, *, beam: int, k: int, io_batch: int,
         unique_pages: bool, impl: str | None) -> _State:
    """One hop of the active ``lanes``; the other lanes stay frozen. The
    bitmaps are updated in place at (lane, column) pairs; the rest of the
    state is gathered for the lanes and written back."""
    everyone = lanes.numel() == q.shape[0]
    if everyone:
        cand_ids, cand_d, cand_vis = s.cand_ids, s.cand_d, s.cand_vis
        res_ids, res_d, qs, luts = s.res_ids, s.res_d, q, lut
    else:
        cand_ids, cand_d, cand_vis = (s.cand_ids[lanes], s.cand_d[lanes],
                                      s.cand_vis[lanes])
        res_ids, res_d = s.res_ids[lanes], s.res_d[lanes]
        qs, luts = q[lanes], lut[lanes]
    n = lanes.numel()
    n_vec, dim = data.x.shape
    r = data.nbrs.shape[1]
    rows = lanes[:, None]
    trash = s.node_vis.shape[1] - 1

    batch, ok, cand_vis = _pick(cand_ids, cand_d, cand_vis, io_batch)
    safe = batch.clamp(min=0).long()
    s.node_vis[rows, torch.where(ok, safe, trash)] = True

    # the disk read: vector + adjacency record of each expanded node
    if unique_pages:
        io_delta = _page_reads(s, rows.expand(n, io_batch),
                               data.page_of[safe].long(), ok)
    else:
        io_delta = ok.sum(1).to(torch.int32)    # one page read a node

    # exact rerank of the expanded nodes: pages of capacity 1
    ex = ops.page_gather_l2(data.x.view(n_vec, 1, dim), safe, qs,
                            impl=impl)[:, :, 0]
    ex = torch.where(ok, ex, INF)
    res_d, order = torch.sort(torch.cat([res_d, ex], 1), dim=1, stable=True)
    res_d = res_d[:, :k]
    res_ids = torch.cat([res_ids, batch], 1).gather(1, order[:, :k])

    # PQ estimates of the expanded nodes' neighbours
    flat = data.nbrs[safe].reshape(n, io_batch * r)
    valid = (flat != PAD) & ok.repeat_interleave(r, dim=1)
    safe_n = flat.clamp(min=0).long()
    est = ops.pq_adc_gather(data.codes, safe_n, luts, impl=impl)
    est = torch.where(valid, est, INF)
    est = torch.where(s.node_vis[rows, safe_n], INF, est)
    # skip neighbours already in the beam: a sorted membership probe
    sorted_cand = torch.sort(cand_ids, dim=1).values
    pos = torch.searchsorted(sorted_cand, flat).clamp(max=beam - 1)
    est = torch.where(sorted_cand.gather(1, pos) == flat, INF, est)
    est = _mask_dups_keep_first(flat, est)

    cand_d, order = torch.sort(torch.cat([cand_d, est], 1), dim=1,
                               stable=True)
    order = order[:, :beam]
    cand_d = cand_d[:, :beam]
    cand_ids = torch.cat([cand_ids, flat], 1).gather(1, order)
    cand_vis = torch.cat([cand_vis, torch.zeros_like(valid)], 1).gather(
        1, order)

    io, hops = s.io[lanes] + io_delta, s.hops[lanes] + 1
    if everyone:
        return s._replace(cand_ids=cand_ids, cand_d=cand_d, cand_vis=cand_vis,
                          res_ids=res_ids, res_d=res_d, io=io, hops=hops)
    for full, part in ((s.cand_ids, cand_ids), (s.cand_d, cand_d),
                       (s.cand_vis, cand_vis), (s.res_ids, res_ids),
                       (s.res_d, res_d), (s.io, io), (s.hops, hops)):
        full[lanes] = part
    return s


def baseline_search(
    queries: torch.Tensor, data: BaselineData, *, beam: int, k: int,
    max_hops: int, io_batch: int, unique_pages: bool,
    impl: str | None = None,
) -> BaselineResult:
    """Search a batch of queries, (Q, d) f32 on the data's device.
    ``impl="plain"`` runs the kernels' plain versions (the tests and the
    chip smoke compare the two)."""
    lut = ops.pq_lut(queries, data.codebooks, impl=impl)       # (Q, M, K)
    s = _init_state(queries, data, lut, beam=beam, k=k, impl=impl)
    while True:
        lanes = _active(s, max_hops).nonzero().squeeze(1)
        if lanes.numel() == 0:                 # the hop's one host sync
            break
        s = _hop(s, lanes, queries, lut, data, beam=beam, k=k,
                 io_batch=io_batch, unique_pages=unique_pages, impl=impl)
    return BaselineResult(ids=s.res_ids, dists=s.res_d, ios=s.io,
                          hops=s.hops)


def make_baseline_data(
    x: np.ndarray,
    nbrs: np.ndarray,
    codebooks: np.ndarray,
    page_of: np.ndarray | None = None,
    vectors_per_page: int | None = None,
    *,
    device: str | torch.device = "cuda",
) -> BaselineData:
    """id-order layout when page_of is None (DiskANN); else custom layout.
    The PQ codes are encoded on ``device``."""
    from repro_torch.core.vamana import medoid

    dev = resolve_device(device)
    x = np.array(x, np.float32)             # a writable copy for torch
    xt = torch.as_tensor(x).to(dev)
    books = torch.as_tensor(np.array(codebooks, np.float32)).to(dev)
    if page_of is None:
        vpp = vectors_per_page or max(1, 4096 // (x.shape[1] * 4))
        page_of = np.arange(len(x)) // vpp
    return BaselineData(
        x=xt,
        nbrs=torch.as_tensor(np.array(nbrs, np.int32)).to(dev),
        codes=pq_mod.pq_encode(xt, books),
        codebooks=books,
        page_of=torch.as_tensor(np.asarray(page_of).astype(np.int32)).to(dev),
        entry=torch.tensor(medoid(x), dtype=torch.int32, device=dev),
    )


def diskann_search(queries, data: BaselineData, *, beam=64, k=10, max_hops=64,
                   io_batch=5, impl=None) -> BaselineResult:
    return baseline_search(queries, data, beam=beam, k=k, max_hops=max_hops,
                           io_batch=io_batch, unique_pages=False, impl=impl)


def starling_search(queries, data: BaselineData, *, beam=64, k=10,
                    max_hops=64, io_batch=5, impl=None) -> BaselineResult:
    return baseline_search(queries, data, beam=beam, k=k, max_hops=max_hops,
                           io_batch=io_batch, unique_pages=True, impl=impl)


# --------------------------------------------------------------------------
# VectorIndex lifecycle wrappers (protocol shared with PageANNIndex)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class BaselineStats:
    num_vectors: int
    pages: int
    memory_bytes: int   # in-memory PQ codes + codebooks (what DiskANN keeps)


class _BaselineIndex:
    """Shared ``VectorIndex`` plumbing over a :class:`BaselineData`.

    Ids are never reassigned by the baselines, so ``search`` results are
    already ORIGINAL vector ids; ``cache_hits`` is always zero (no warmed
    page cache in either baseline).
    """

    kind: str = ""
    _unique_pages: bool = False

    def __init__(self, data: BaselineData):
        self.data = data

    # ------------------------------------------------------------ properties
    @property
    def device(self) -> torch.device:
        return self.data.x.device

    @property
    def dim(self) -> int:
        return int(self.data.x.shape[1])

    @property
    def default_params(self) -> SearchParams:
        return SearchParams()

    def resolve_params(
        self, k: int | None, params: SearchParams | None
    ) -> SearchParams:
        return resolve_search_params(self.default_params, k, params)

    @property
    def stats(self) -> BaselineStats:
        return BaselineStats(
            num_vectors=int(self.data.x.shape[0]),
            pages=int(self.data.page_of.max()) + 1,
            memory_bytes=int(
                self.data.codes.numel() + self.data.codebooks.numel() * 4
            ),
        )

    # ----------------------------------------------------------------- search
    def search(
        self,
        queries: np.ndarray,
        k: int | None = None,
        params: SearchParams | None = None,
        *,
        impl: str | None = None,
    ) -> SearchResult:
        """Search; returns numpy arrays. ``impl="plain"`` runs the kernels'
        plain versions on the index's device."""
        p = self.resolve_params(k, params)
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(self.device)
        res = baseline_search(
            q, self.data, beam=p.beam_width, k=p.k, max_hops=p.max_hops,
            io_batch=p.io_batch, unique_pages=self._unique_pages, impl=impl,
        )
        ios = res.ios.cpu().numpy()
        return SearchResult(
            ids=res.ids.cpu().numpy(),
            dists=res.dists.cpu().numpy(),
            ios=ios,
            hops=res.hops.cpu().numpy(),
            cache_hits=np.zeros_like(ios),
        )

    # -------------------------------------------------------------- lifecycle
    def save(self, directory: str) -> None:
        from repro_torch.core import persist

        os.makedirs(directory, exist_ok=True)
        np.savez(
            os.path.join(directory, persist.ARRAYS_NPZ),
            **{name: t.cpu().numpy() for name, t in self.data._asdict().items()},
        )
        persist.write_manifest(
            directory,
            dict(kind=self.kind, dim=self.dim,
                 stats=dataclasses.asdict(self.stats)),
        )

    @classmethod
    def load(cls, directory: str, *,
             device: str | torch.device = "cuda") -> "_BaselineIndex":
        from repro_torch.core import persist

        dev = resolve_device(device)
        doc = persist.read_manifest(directory)
        if doc["kind"] != cls.kind:
            raise ValueError(
                f"{directory}: kind={doc['kind']!r}, expected {cls.kind!r}"
            )
        with np.load(os.path.join(directory, persist.ARRAYS_NPZ)) as z:
            data = BaselineData(*(
                torch.as_tensor(np.ascontiguousarray(z[name])).to(dev)
                for name in BaselineData._fields))
        return cls(data)

    # --------------------------------------------------------------- builders
    @classmethod
    def from_data(
        cls,
        x: np.ndarray,
        nbrs: np.ndarray,
        codebooks: np.ndarray,
        *,
        page_of: np.ndarray | None = None,
        vectors_per_page: int | None = None,
        device: str | torch.device = "cuda",
    ) -> "_BaselineIndex":
        """Wrap a prebuilt Vamana graph + PQ codebooks (shared with PageANN
        sweeps so all systems search the same graph)."""
        return cls(make_baseline_data(
            x, nbrs, codebooks, page_of=page_of,
            vectors_per_page=vectors_per_page, device=device,
        ))

    @classmethod
    def build(cls, x: np.ndarray, cfg: PageANNConfig, *,
              device: str | torch.device = "cuda") -> "_BaselineIndex":
        """Full build from raw vectors using the config's graph/PQ knobs:
        the Vamana searches and PQ training run on ``device``."""
        from repro_torch.core.vamana import build_vamana

        dev = resolve_device(device)
        x = np.ascontiguousarray(x, np.float32)
        nbrs = build_vamana(
            x, degree=cfg.graph_degree, beam=cfg.build_beam,
            alpha=cfg.alpha, rounds=cfg.build_rounds, seed=cfg.seed,
            device=dev,
        )
        books = pq_mod.train_pq(
            x, cfg.pq_subspaces, cfg.pq_ksub, cfg.pq_iters, seed=cfg.seed,
            device=dev,
        )
        return cls.from_data(x, nbrs, books, page_of=cls._layout(x, nbrs, cfg),
                             device=dev)

    @classmethod
    def _layout(cls, x, nbrs, cfg: PageANNConfig):
        return None  # id-order pages (DiskANN); Starling overrides


class DiskANNIndex(_BaselineIndex):
    kind = "diskann"
    _unique_pages = False


class StarlingIndex(_BaselineIndex):
    kind = "starling"
    _unique_pages = True

    @classmethod
    def _layout(cls, x, nbrs, cfg: PageANNConfig):
        from repro_torch.core.page_graph import group_pages

        return group_pages(x, nbrs, cfg.resolve_capacity(), cfg.hop_h).page_of


BASELINE_KINDS = {
    DiskANNIndex.kind: DiskANNIndex,
    StarlingIndex.kind: StarlingIndex,
}


def load_baseline(directory: str, *,
                  device: str | torch.device = "cuda") -> _BaselineIndex:
    from repro_torch.core import persist

    kind = persist.read_manifest(directory)["kind"]
    return BASELINE_KINDS[kind].load(directory, device=device)
