"""On-disk index persistence: port of ``repro.core.persist``.

The artifact is the reference's, byte for byte in layout:

  <dir>/manifest.json   versioned JSON: kind, config, geometry, build stats,
                        residency, autotuned operating points, metadata
                        schema and vocabulary
  <dir>/pages.bin       the packed page records as raw page-aligned f32,
                        opened with ``np.memmap`` on load
  <dir>/arrays.npz      numpy sidecars: memory tier, LSH router, id maps,
                        per-page counts and neighbour ids
  <dir>/meta.npz        page-slot-aligned metadata columns (only with a
                        schema)

A mutable index (``core.delta.MutableIndex``) persists as
``kind="mutable"``: the frozen base as a nested artifact under ``base/``, a
``delta.npz`` sidecar (inserted vectors, liveness, tombstones, external id
map, metadata codes) and a manifest ``generation`` counter; compaction
replaces the whole directory atomically (``swap_mutable``). The DiskANN
and Starling baselines (``core.baselines``) persist as ``kind="diskann"`` /
``"starling"``: a manifest and an ``arrays.npz``. A sharded store
(``repro_torch.dist.ShardedPageStore``) persists as ``kind="sharded"``:
one PageANN artifact per shard under ``shard-<i>/`` and a ``shards.npz``
of global-id slices. ``load_index`` opens any of these kinds; a database
(``save_database``) is a ``db.json`` over one such artifact per named
collection.

It is framework-neutral, so ``load_pageann`` / ``load_mutable`` are how an
index built and saved by the JAX package reaches the port (and the reverse
through ``save_pageann`` / ``save_mutable``). uint32 LSH codes are stored as uint32 and held in torch
as int32 views of the same bits. A load under a memory budget pins the
hottest pages on the device and serves the rest from the memmap per hop
(``core.stream.PageFetcher``). Unreadable artifacts raise
:class:`IndexFormatError` as the reference does.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
import zipfile

import numpy as np
import torch

from repro_torch.core import layout as layout_mod
from repro_torch.core import page_graph as pg_mod
from repro_torch.core import search as search_mod
from repro_torch.core import stream as stream_mod
from repro_torch.core.config import (
    MemoryBudget,
    MemoryMode,
    PageANNConfig,
    SearchParams,
)
from repro_torch.core.filter import MetaArrays, MetadataSchema
from repro_torch.core.lsh import LSHIndex
from repro_torch.device import resolve_device

FORMAT = "repro.vector_index"
VERSION = 1

MANIFEST = "manifest.json"
PAGES_BIN = "pages.bin"
ARRAYS_NPZ = "arrays.npz"
META_NPZ = "meta.npz"
DELTA_NPZ = "delta.npz"
BASE_SUBDIR = "base"

# ---- database layout (a directory of named collections, see save_database)
DB_FORMAT = "repro.vector_database"
DB_VERSION = 1
DB_MANIFEST = "db.json"
DB_COLLECTIONS_SUBDIR = "collections"

# collection names double as artifact subdirectory names, so they are
# restricted to a filesystem- and manifest-safe alphabet up front: a
# rejected create_collection beats a corrupted db.json or a path traversal
_NAME_ALLOWED = (
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-"
)


def check_collection_name(name: str) -> str:
    """Validate a collection name (also used as its on-disk subdirectory):
    1-64 chars of [A-Za-z0-9._-], not starting with a dot or dash."""
    if (
        not isinstance(name, str)
        or not 0 < len(name) <= 64
        or name[0] in ".-"
        or any(c not in _NAME_ALLOWED for c in name)
    ):
        raise ValueError(
            f"invalid collection name {name!r}: need 1-64 chars of "
            "[A-Za-z0-9._-] not starting with '.' or '-'"
        )
    return name


class IndexFormatError(ValueError):
    """A saved index artifact this library cannot read: corrupted or
    truncated files, a missing/garbled manifest, or a format version ahead
    of what this build supports."""


def is_index_dir(directory: str) -> bool:
    """Whether ``directory`` holds an index manifest."""
    return os.path.isfile(os.path.join(directory, MANIFEST))


def write_manifest(directory: str, doc: dict) -> None:
    doc = dict(doc, format=FORMAT, version=VERSION)
    with open(os.path.join(directory, MANIFEST), "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)


def _read_versioned(path: str, fmt: str, version: int, *, noun: str,
                    author: str, counter: str) -> dict:
    """Load a versioned JSON manifest: a missing file raises
    ``FileNotFoundError``; garbled JSON, another ``format`` or a version
    other than ``version`` raise :class:`IndexFormatError` naming what was
    found against what this build supports."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {noun} at {path}")
    try:
        with open(path) as f:
            doc = json.load(f)
    except json.JSONDecodeError as e:
        raise IndexFormatError(f"{path}: {noun} is not valid JSON: {e}")
    if doc.get("format") != fmt:
        raise IndexFormatError(f"{path}: not a {fmt} manifest")
    found = doc.get("version")
    if found != version:
        ahead = isinstance(found, int) and found > version
        hint = (
            f"; {author} was written by a newer library — upgrade to read it"
            if ahead else ""
        )
        raise IndexFormatError(
            f"{path}: found {counter} {found}, this build supports "
            f"version {version}{hint}"
        )
    return doc


def read_manifest(directory: str) -> dict:
    return _read_versioned(os.path.join(directory, MANIFEST), FORMAT, VERSION,
                           noun="index manifest", author="artifact",
                           counter="format version")


def _check_pages_bin(directory: str, doc: dict) -> str:
    """The page file must exist and hold exactly the manifest's geometry."""
    path = os.path.join(directory, PAGES_BIN)
    if not os.path.isfile(path):
        raise IndexFormatError(f"{path}: missing page file")
    want = doc["pages"] * doc["record_rows"] * doc["record_lanes"] * 4
    got = os.path.getsize(path)
    if got != want:
        raise IndexFormatError(
            f"{path}: corrupted or truncated page file — {got} bytes on "
            f"disk, manifest geometry needs {want} "
            f"({doc['pages']} pages x {doc['page_record_bytes']} B)"
        )
    return path


def _schema_to_json(index) -> dict | None:
    """The manifest ``schema`` section: field declaration + tag
    vocabulary. ``None`` when the index carries no metadata."""
    if index.schema is None:
        return None
    doc = index.schema.to_json()
    doc["vocab"] = {f: list(vs) for f, vs in index.vocab.items()}
    return doc


def _load_meta(directory: str, doc: dict, store, dev):
    """(schema, vocab, meta on ``dev``, meta_host) from the manifest
    ``schema`` section and the ``meta.npz`` sidecar. The two must agree; a
    sidecar from another collection or a hand-edited manifest fails here
    as :class:`IndexFormatError`, not deep inside a filtered search."""
    schema_doc = doc.get("schema")
    path = os.path.join(directory, META_NPZ)
    if schema_doc is None:
        if os.path.isfile(path):
            raise IndexFormatError(
                f"{path}: metadata sidecar present but the manifest has "
                "no schema section"
            )
        return None, {}, None, None
    if not os.path.isfile(path):
        raise IndexFormatError(
            f"{path}: manifest declares a metadata schema but the "
            "metadata sidecar is missing"
        )
    try:
        schema = MetadataSchema.from_json(schema_doc)
        vocab = {
            f: tuple(vs) for f, vs in schema_doc.get("vocab", {}).items()
        }
    except (TypeError, ValueError, AttributeError) as e:
        raise IndexFormatError(
            f"{directory}: garbled manifest schema section: {e}"
        )
    unknown = sorted(set(vocab) - set(schema.tags))
    if unknown:
        raise IndexFormatError(
            f"{directory}: manifest vocab names fields not in the "
            f"schema: {unknown}"
        )
    try:
        with np.load(path) as z:
            arrays = {name: z[name] for name in z.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
        raise IndexFormatError(f"{path}: unreadable metadata sidecar: {e}")
    if not {"tags", "nums"} <= set(arrays):
        raise IndexFormatError(
            f"{path}: metadata sidecar is missing arrays "
            f"(found {sorted(arrays)}, need ['nums', 'tags'])"
        )
    slot_tags = np.asarray(arrays["tags"], np.int32)
    slot_nums = np.asarray(arrays["nums"], np.float32)
    rows = int(store.new_to_old.shape[0])          # pages * capacity
    want_tags = (rows, len(schema.tags))
    want_nums = (rows, len(schema.numerics))
    if slot_tags.shape != want_tags or slot_nums.shape != want_nums:
        raise IndexFormatError(
            f"{path}: metadata shapes {slot_tags.shape}/{slot_nums.shape} "
            f"disagree with the manifest schema — expected "
            f"{want_tags}/{want_nums}"
        )
    host_tags, host_nums = layout_mod.unreassign_metadata(
        slot_tags, slot_nums, store
    )
    return (
        schema,
        vocab,
        MetaArrays(tags=slot_tags, nums=slot_nums).to(dev),
        MetaArrays(tags=host_tags, nums=host_nums),
    )


def config_to_json(cfg: PageANNConfig) -> dict:
    doc = dataclasses.asdict(cfg)
    doc["memory_mode"] = cfg.memory_mode.value
    return doc


def config_from_json(doc: dict) -> PageANNConfig:
    doc = dict(doc)
    doc["memory_mode"] = MemoryMode(doc["memory_mode"])
    return PageANNConfig(**doc)


# ------------------------------------------------------------------ PageANN
def save_pageann(index, directory: str) -> None:
    """Write a built :class:`PageANNIndex` under ``directory``."""
    os.makedirs(directory, exist_ok=True)
    store, tier, lsh = index.store, index.tier, index.lsh

    # a streamed store's device ``recs`` holds only the resident pages; the
    # host memmap is the full page file
    recs = (np.asarray(store.recs_host, np.float32)
            if store.recs_host is not None
            else np.ascontiguousarray(store.recs.cpu().numpy(), np.float32))
    recs.tofile(os.path.join(directory, PAGES_BIN))

    def host(t):
        return t.cpu().numpy()

    sidecars = {}
    if index.cfg.memory_mode == MemoryMode.MEM_ALL:
        # MEM_ALL records carry no code rows, so the host-side codes view
        # is not recoverable from pages.bin — persist it explicitly
        sidecars["nbr_codes"] = np.asarray(store.nbr_codes)
    if index.page_order is not None:
        sidecars["page_order"] = np.asarray(index.page_order, np.int32)
    np.savez(
        os.path.join(directory, ARRAYS_NPZ),
        **sidecars,
        member_count=host(store.member_count),
        nbr_ids=host(store.nbr_ids),
        nbr_count=host(store.nbr_count),
        new_to_old=np.asarray(store.new_to_old),
        old_to_new=np.asarray(store.old_to_new),
        mem_codes=host(tier.mem_codes),
        mem_mask=host(tier.mem_mask),
        mem_codebooks=host(tier.mem_codebooks),
        disk_codebooks=host(tier.disk_codebooks),
        cached_pages=host(tier.cached_pages),
        lsh_planes=host(lsh.planes),
        lsh_sample_ids=host(lsh.sample_ids),
        lsh_sample_codes=host(lsh.sample_codes).view(np.uint32),
        lsh_sample_pq=host(lsh.sample_pq),
    )
    if index.schema is not None:
        # page-slot-aligned columns: the row order of pages.bin, so a
        # page's metadata is one contiguous slice
        np.savez(
            os.path.join(directory, META_NPZ),
            tags=host(index.meta.tags).astype(np.int32),
            nums=host(index.meta.nums).astype(np.float32),
        )

    pages, rows, lanes = recs.shape
    write_manifest(
        directory,
        dict(
            kind="pageann",
            config=config_to_json(index.cfg),
            pages=pages,
            record_rows=rows,
            record_lanes=lanes,
            page_record_bytes=rows * lanes * 4,
            capacity=store.capacity,
            dim=store.dim,
            stats=dataclasses.asdict(index.stats),
            hot_pages=host(tier.cached_pages).tolist(),
            # how this index was loaded; a fresh load picks its own budget
            residency=dict(
                memory_budget=(index.memory_budget.to_json()
                               if index.memory_budget is not None else None),
                resident_pages=store.resident_pages,
                total_pages=pages,
            ),
            # autotuned operating points (index.autotune) and the one
            # searches resolve as the default SearchParams
            tuned=_tuned_to_json(index),
            schema=_schema_to_json(index),
        ),
    )


def _tuned_to_json(index) -> dict:
    points = []
    for m in index.tuned:
        doc = {key: val for key, val in m.items() if key != "params"}
        doc["params"] = m["params"].to_json()
        points.append(doc)
    default = index.tuned_default
    return dict(
        default=default.to_json() if default is not None else None,
        points=points,
    )


def _tuned_from_json(doc: dict | None) -> tuple[list, SearchParams | None]:
    if not doc:            # artifacts from before autotuning carry none
        return [], None
    points = []
    for entry in doc.get("points", []):
        m = dict(entry)
        m["params"] = SearchParams.from_json(m["params"])
        points.append(m)
    default = doc.get("default")
    return points, (
        SearchParams.from_json(default) if default is not None else None
    )


def index_from_arrays(
    cfg: PageANNConfig,
    arrays: dict,
    device: str | torch.device = "cuda",
    *,
    stats=None,
    memory_budget=None,
):
    """Assemble a :class:`PageANNIndex` on ``device`` from host arrays.

    ``arrays`` holds the ``arrays.npz`` sidecars under their file names
    plus ``recs``, the (P, rows, 128) f32 page records (an array or the
    ``pages.bin`` memmap). LSH codes may come as uint32 (as saved) or
    int32; either way the device holds the same bits as int32. ``stats``
    defaults to one derived from the arrays.

    ``memory_budget`` (``MemoryBudget.parse`` accepts bytes, a fraction or
    a string) pins the hottest pages that fit on the device, by
    ``page_order`` and in sorted id order, and leaves the rest to a
    ``PageFetcher`` over ``recs``. A budget that covers every page loads
    fully resident, with no fetcher.
    """
    from repro_torch.core.index import BuildStats, PageANNIndex

    dev = resolve_device(device)
    recs = arrays["recs"]
    num_pages, rows, lanes = recs.shape
    new_to_old = np.asarray(arrays["new_to_old"])
    capacity = new_to_old.shape[0] // num_pages
    dim = cfg.dim
    nbr_ids = np.asarray(arrays["nbr_ids"])
    if "nbr_codes" in arrays:                     # MEM_ALL sidecar
        nbr_codes = np.asarray(arrays["nbr_codes"])
    else:                                         # recover from the records
        nbr_codes = layout_mod.unpack_neighbor_codes(
            recs, capacity, dim, rp=nbr_ids.shape[1], m=cfg.pq_subspaces,
        )

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    page_order = _page_order_of(arrays, num_pages)
    n_res = num_pages
    if memory_budget is not None:
        memory_budget = MemoryBudget.parse(memory_budget)
        n_res = memory_budget.resolve_pages(num_pages, rows * lanes * 4)
    fetcher = resident_map = recs_host = None
    if n_res >= num_pages:
        recs_dev = put(np.array(recs, np.float32))     # one read of the file
    else:
        # sorted ids keep the resident region in page order
        resident_ids = np.sort(page_order[:n_res])
        rmap = np.full(num_pages, stream_mod.PAD, np.int32)
        rmap[resident_ids] = np.arange(n_res, dtype=np.int32)
        resident_map = put(rmap)
        recs_dev = put(np.asarray(recs[resident_ids], np.float32))
        recs_host = recs
        fetcher = stream_mod.PageFetcher(recs)

    store = layout_mod.PageStore(
        vecs=layout_mod.unpack_member_vectors(recs, capacity, dim),
        member_count=put(arrays["member_count"]),
        nbr_ids=put(nbr_ids),
        nbr_codes=nbr_codes,
        nbr_count=put(arrays["nbr_count"]),
        recs=recs_dev,
        capacity=capacity,
        dim=dim,
        new_to_old=new_to_old,
        old_to_new=np.asarray(arrays["old_to_new"]),
        resident_map=resident_map,
        recs_host=recs_host,
    )
    tier = layout_mod.MemoryTier(
        mem_codes=put(arrays["mem_codes"]),
        mem_mask=put(arrays["mem_mask"]),
        mem_codebooks=put(arrays["mem_codebooks"]),
        disk_codebooks=put(arrays["disk_codebooks"]),
        cached_pages=put(np.sort(np.asarray(arrays["cached_pages"], np.int32))),
    )
    codes = np.ascontiguousarray(arrays["lsh_sample_codes"])
    lsh = LSHIndex(
        planes=put(arrays["lsh_planes"]),
        sample_ids=put(arrays["lsh_sample_ids"]),
        sample_codes=put(codes.view(np.int32)),
        sample_pq=put(arrays["lsh_sample_pq"]),
    )
    if stats is None:
        tile = store.padded_tile_bytes()
        stats = BuildStats(
            vamana_s=0.0, grouping_s=0.0, pq_s=0.0, pack_s=0.0, lsh_s=0.0,
            pages=num_pages,
            capacity=capacity,
            mean_page_degree=pg_mod.page_graph_stats(nbr_ids)["mean_degree"],
            logical_page_bytes=store.logical_page_bytes(cfg),
            padded_tile_bytes=tile,
            memory_bytes=tier.memory_bytes + lsh.memory_bytes,
            disk_bytes=num_pages * tile,
        )
    stats.resident_pages = store.resident_pages
    stats.resident_bytes = store.resident_bytes
    return PageANNIndex(
        cfg=cfg,
        store=store,
        tier=tier,
        lsh=lsh,
        data=search_mod.make_search_data(store, tier, lsh),
        stats=stats,
        device=dev,
        page_order=page_order,
        fetcher=fetcher,
        memory_budget=memory_budget,
    )


def _page_order_of(arrays: dict, num_pages: int) -> np.ndarray:
    """Full residency priority, hottest page first: the persisted
    ``page_order`` sidecar (warm_cache access counts) when there is one,
    else the cached (hot) pages followed by the rest in id order."""
    if "page_order" in arrays:
        return np.asarray(arrays["page_order"], np.int32)
    hot = np.asarray(arrays["cached_pages"], np.int32)
    rest = np.setdiff1d(np.arange(num_pages, dtype=np.int32), hot)
    return np.concatenate([hot, rest])[:num_pages]


def load_pageann(directory: str, *, device: str | torch.device = "cuda",
                 memory_budget=None):
    """Reload a saved PageANN index onto ``device``.

    Reads artifacts written by this package or by ``repro`` (the JAX
    reference): the port searches a loaded JAX-built index exactly as the
    reference does. ``pages.bin`` is opened as a memmap. ``memory_budget``
    (see :func:`index_from_arrays`) keeps only the hottest pages on the
    device and streams the rest per hop; results equal a fully resident
    load bit for bit. The manifest's ``tuned`` section (``autotune``'s
    operating points) comes back as ``tuned`` and ``tuned_default``.
    """
    from repro_torch.core.index import BuildStats

    doc = read_manifest(directory)
    if doc["kind"] != "pageann":
        raise ValueError(f"{directory}: kind={doc['kind']!r}, not a PageANN index")
    cfg = config_from_json(doc["config"])

    pages_path = _check_pages_bin(directory, doc)
    recs = np.memmap(
        pages_path, dtype=np.float32, mode="r",
        shape=(doc["pages"], doc["record_rows"], doc["record_lanes"]),
    )
    with np.load(os.path.join(directory, ARRAYS_NPZ)) as z:
        arrays = {name: z[name] for name in z.files}
    arrays["recs"] = recs
    # warm-cache persistence: the manifest's hot page ids pre-populate the
    # cache (the npz copy is the fallback for artifacts without hot_pages)
    arrays["cached_pages"] = np.asarray(
        doc.get("hot_pages", arrays["cached_pages"]), np.int32
    )
    stats = BuildStats(**doc["stats"])
    stats.disk_bytes = os.path.getsize(pages_path)
    index = index_from_arrays(cfg, arrays, device, stats=stats,
                              memory_budget=memory_budget)
    (index.schema, index.vocab, index.meta,
     index.meta_host) = _load_meta(directory, doc, index.store, index.device)
    index.tuned, index.tuned_default = _tuned_from_json(doc.get("tuned"))
    return index


# ----------------------------------------------------------------- mutable
def save_mutable(state, directory: str) -> None:
    """Write a :class:`repro_torch.core.delta.MutableIndex` state under
    ``directory``: the frozen base as a full nested artifact plus the
    ``delta.npz`` sidecar, in the reference's format, so a restarted server
    (of either package) reloads the dirty index losslessly."""
    os.makedirs(directory, exist_ok=True)
    state.base.save(os.path.join(directory, BASE_SUBDIR))
    dv = state.delta
    c = dv.count
    extra = {}
    if getattr(state.base, "schema", None) is not None:
        extra = dict(
            delta_tags=np.asarray(dv.tags[:c], np.int32),
            delta_nums=np.asarray(dv.nums[:c], np.float32),
        )
    np.savez(
        os.path.join(directory, DELTA_NPZ),
        delta_vecs=np.asarray(dv.vecs[:c], np.float32),
        delta_ids=np.asarray(dv.ids[:c], np.int64),
        delta_live=np.asarray(dv.live[:c], bool),
        tombstones=np.asarray(state.tombstones, np.int64),
        base_ids=np.asarray(state.base_ids, np.int64),
        **extra,
    )
    write_manifest(
        directory,
        dict(
            kind="mutable",
            base_kind=read_manifest(os.path.join(directory, BASE_SUBDIR))[
                "kind"
            ],
            dim=state.base.dim,
            generation=state.generation,
            base_rows=int(state.base_ids.size),
            delta_rows=int(c),
            delta_live=int(dv.n_live),
            tombstones=int(state.tombstones.size),
            # the UNIFIED vocabulary (base + values seen only in delta
            # inserts): delta tag codes are positions in these tuples
            vocab=(
                {f: list(vs) for f, vs in state.vocab.items()}
                if state.vocab is not None else None
            ),
        ),
    )


def swap_mutable(state, directory: str) -> None:
    """Replace the artifact at ``directory`` with ``state`` (the compaction
    swap): write a sibling tmp dir, then two renames. Both sides of the swap
    are intact on disk at every moment, and readers holding memmaps of the
    old files keep valid file descriptors. The canonical path is briefly
    absent between the two renames: a crash there leaves the previous
    artifact complete under ``<dir>.old.<gen>`` and the new one under
    ``<dir>.tmp.<gen>``. Stale ``.tmp`` / ``.old`` siblings of an earlier
    crashed swap are swept first."""
    clean = directory.rstrip(os.sep)
    for leftover in glob.glob(f"{glob.escape(clean)}.tmp.*") + glob.glob(
        f"{glob.escape(clean)}.old.*"
    ):
        if os.path.isdir(leftover):
            shutil.rmtree(leftover)
    tmp = f"{clean}.tmp.{state.generation}"
    old = f"{clean}.old.{state.generation}"
    save_mutable(state, tmp)
    os.rename(clean, old)
    os.rename(tmp, clean)
    shutil.rmtree(old)


def load_mutable(directory: str, *, device: str | torch.device = "cuda",
                 memory_budget=None):
    """Reload a saved mutable index (base + delta sidecar) onto ``device``;
    searches on it equal the saved dirty state's bit for bit.
    ``memory_budget`` applies to the frozen base (the delta tier is in
    memory by construction)."""
    from repro_torch.core.delta import MutableIndex

    doc = read_manifest(directory)
    if doc["kind"] != "mutable":
        raise ValueError(
            f"{directory}: kind={doc['kind']!r}, not a mutable index"
        )
    base = load_index(os.path.join(directory, BASE_SUBDIR), device=device,
                      memory_budget=memory_budget)
    npz_path = os.path.join(directory, DELTA_NPZ)
    if not os.path.isfile(npz_path):
        raise IndexFormatError(f"{npz_path}: missing delta sidecar")
    with np.load(npz_path) as z:
        arrays = {name: z[name] for name in z.files}

    index = MutableIndex(base, base_ids=arrays["base_ids"])
    live = arrays["delta_live"]
    if live.size:
        # restore the append log verbatim (it may hold dead rows of
        # superseded or deleted ids): slot numbering, and so the scan's
        # output, equals the saved index's
        c = int(live.size)
        tier = index._delta
        tier._grow(c)
        tier._vecs[:c] = arrays["delta_vecs"]
        tier._ids[:c] = arrays["delta_ids"]
        tier._live[:c] = live
        if "delta_tags" in arrays:
            tier._tags[:c] = arrays["delta_tags"]
            tier._nums[:c] = arrays["delta_nums"]
        tier._count = c
        tier._slot_of = {
            int(arrays["delta_ids"][i]): i for i in range(c) if live[i]
        }
        tier._view = None
    vocab_doc = doc.get("vocab")
    if vocab_doc is not None:
        # the persisted UNIFIED vocabulary supersedes the base's copy the
        # constructor installed: delta tag codes index into this one
        index._vocab = {f: tuple(vs) for f, vs in vocab_doc.items()}
    index._state = index._state._replace(
        tombstones=np.asarray(arrays["tombstones"], np.int64),
        delta=index._delta.snapshot(),
        generation=int(doc.get("generation", 0)),
        vocab=dict(index._vocab) if vocab_doc is not None else (
            index._state.vocab
        ),
    )
    index._next_id = int(
        max(
            arrays["base_ids"].max(initial=-1),
            arrays["delta_ids"].max(initial=-1),
        )
        + 1
    )
    index._directory = directory
    return index


# ----------------------------------------------------------------- database
def is_database_dir(directory: str) -> bool:
    return os.path.isfile(os.path.join(directory, DB_MANIFEST))


def read_db_manifest(directory: str) -> dict:
    """Read and validate ``db.json``, versioned like index manifests."""
    path = os.path.join(directory, DB_MANIFEST)
    doc = _read_versioned(path, DB_FORMAT, DB_VERSION,
                          noun="database manifest", author="database",
                          counter="database version")
    if not isinstance(doc.get("collections"), dict):
        raise IndexFormatError(f"{path}: manifest has no collections table")
    return doc


def _collection_subdir(name: str) -> str:
    # stored with a literal "/" so db.json is platform-independent
    return f"{DB_COLLECTIONS_SUBDIR}/{name}"


def save_database(collections, directory: str) -> None:
    """Persist a whole multi-collection service under one directory:

      <dir>/db.json                versioned JSON: collection name -> subdir
      <dir>/collections/<name>/    one full per-collection index artifact
                                   (whatever kind each index persists as)

    ``collections`` maps name -> any ``VectorIndex`` with ``save``. The
    manifest is written last (tmp + rename), so a crash mid-save of a fresh
    directory leaves one that ``load_database`` refuses (no db.json), not a
    silently partial database. Re-saving over an existing database
    overwrites the per-collection artifacts in place under the old
    manifest; to replace a live database atomically, save to a fresh
    sibling and rename. The format is the reference's: either package
    loads what the other saved.
    """
    for name in collections:
        check_collection_name(name)
    os.makedirs(directory, exist_ok=True)
    table = {}
    for name, index in sorted(collections.items()):
        index.save(os.path.join(directory, DB_COLLECTIONS_SUBDIR, name))
        table[name] = _collection_subdir(name)
    doc = dict(format=DB_FORMAT, version=DB_VERSION, collections=table)
    path = os.path.join(directory, DB_MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def load_database(directory: str, *, device: str | torch.device = "cuda",
                  memory_budget=None) -> dict:
    """Reload every collection of a saved database onto ``device``: name ->
    loaded ``VectorIndex`` (each through :func:`load_index` on its manifest
    kind); searches on them equal the saved ones'. ``memory_budget``
    applies to each collection on its own.

    Artifact paths are derived from the VALIDATED collection names, never
    from manifest values: a tampered ``db.json`` that maps a name outside
    ``collections/`` is rejected, not followed."""
    doc = read_db_manifest(directory)
    out = {}
    for name, sub in sorted(doc["collections"].items()):
        check_collection_name(name)
        want = _collection_subdir(name)
        if sub != want:
            raise IndexFormatError(
                f"{directory}: collection {name!r} maps to unexpected "
                f"path {sub!r} (expected {want!r})"
            )
        out[name] = load_index(
            os.path.join(directory, DB_COLLECTIONS_SUBDIR, name),
            device=device, memory_budget=memory_budget,
        )
    return out


# ------------------------------------------------------------------ any kind
def load_index(directory: str, *, device: str | torch.device = "cuda",
               memory_budget=None):
    """Load whichever index kind saved ``directory`` onto ``device``:
    ``"pageann"`` as a :class:`PageANNIndex`, ``"mutable"`` as a
    :class:`MutableIndex`, ``"diskann"`` / ``"starling"`` as a baseline
    index. ``memory_budget`` caps the device-resident pages of the page
    tier (a mutable index's base tier); the baselines have none and reject
    a budget rather than ignore it. ``"sharded"`` loads as a
    :class:`repro_torch.dist.ShardedPageStore`, the budget applying to each
    shard."""
    from repro_torch.core import baselines as bl

    kind = read_manifest(directory)["kind"]
    if kind == "pageann":
        return load_pageann(directory, device=device,
                            memory_budget=memory_budget)
    if kind == "mutable":
        return load_mutable(directory, device=device,
                            memory_budget=memory_budget)
    if kind == "sharded":
        # lazy: repro_torch.dist sits above core and imports this module
        from repro_torch.dist.sharded import ShardedPageStore

        return ShardedPageStore.load(directory, device=device,
                                     memory_budget=memory_budget)
    if kind in bl.BASELINE_KINDS:
        if memory_budget is not None:
            raise ValueError(
                f"{directory}: kind={kind!r} baseline indexes are fully "
                "in-memory; memory_budget is not supported"
            )
        return bl.load_baseline(directory, device=device)
    raise ValueError(f"{directory}: unknown index kind {kind!r}")
