"""Page-aligned data layout (paper Sec 4.2, Fig. 5) + vector id reassignment
(Sec 5): port of ``repro.core.layout``.

Vector ids are reassigned so that ``page_id(v) = v // capacity`` and
``slot(v) = v % capacity``. Each page is one packed ``(rows, 128)`` f32
record (members + transposed neighbour PQ codes), byte-identical to the
reference's, so an artifact saved by either package loads in the other.
The arrays the search reads are torch tensors on the index's device; the
unpacked views and id maps stay host-side numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import pq as pq_mod
from repro_torch.core.config import MemoryMode, PageANNConfig
from repro_torch.core.page_graph import PAD, PageGrouping
from repro_torch.device import resolve_device

# record geometry is owned by kernels.record_layout (the kernel and its
# plain version read the same tile this module packs); re-exported here
from repro_torch.kernels.record_layout import (  # noqa: F401  (re-exports)
    PAGE_LANES,
    member_rows,
    record_rows,
    rows_per_vector,
    vectors_per_row,
)


@dataclasses.dataclass
class PageStore:
    """The 'disk tier': the page records the search reads.

    ``recs`` is the physical page record the search reads through the
    ``page_scan`` kernel; neighbour ids and the count vectors ride as small
    int tensors beside it. ``vecs`` / ``nbr_codes`` are host-side numpy
    views for build tooling and tests; they never reach the device.

    Under a memory budget (``persist.load_pageann(memory_budget=...)``)
    ``recs`` holds only the resident subset, ``resident_map[p]`` is the row
    of ``recs`` holding page p or -1, and ``recs_host`` is the full page
    file (the ``pages.bin`` memmap) the misses are read from per hop.
    """

    vecs: np.ndarray           # (P, capacity, d) f32 — member vectors (host)
    member_count: torch.Tensor  # (P,) int32
    nbr_ids: torch.Tensor      # (P, R_p) int32, REASSIGNED vector ids, PAD=-1
    nbr_codes: np.ndarray      # (P, R_p, M_disk) uint8 — unpacked codes (host)
    nbr_count: torch.Tensor    # (P,) int32
    recs: torch.Tensor         # (P, rows, 128) f32 — packed page records
    capacity: int
    dim: int
    # id reassignment maps (host-side numpy; not used on the search path)
    new_to_old: np.ndarray     # (P * capacity,), PAD for empty slots
    old_to_new: np.ndarray     # (N,)
    # streamed tier (None: fully resident, ``recs`` holds every page)
    resident_map: torch.Tensor | None = None   # (P,) int32, -1 = streamed
    recs_host: np.ndarray | None = None        # (P, rows, 128) f32 memmap

    @property
    def num_pages(self) -> int:
        return int(self.vecs.shape[0])

    @property
    def resident_pages(self) -> int:
        """Pages pinned on the device (== num_pages when fully resident)."""
        return int(self.recs.shape[0])

    @property
    def resident_bytes(self) -> int:
        """Device bytes of the pinned page-record region."""
        return self.resident_pages * self.padded_tile_bytes()

    @property
    def num_vectors(self) -> int:
        """Real (non-pad) vectors in the store."""
        return int(self.old_to_new.shape[0])

    def logical_page_bytes(self, cfg: PageANNConfig) -> int:
        """Bytes per page under the paper's Sec 4.2 equation (pre-padding)."""
        n_cv = self.nbr_codes.shape[1] if cfg.memory_mode != MemoryMode.MEM_ALL else 0
        if cfg.memory_mode == MemoryMode.HYBRID:
            n_cv //= 2
        return int(
            2 * 4
            + self.capacity * self.dim * cfg.dtype_bytes
            + self.nbr_ids.shape[1] * cfg.id_bytes
            + n_cv * self.nbr_codes.shape[2]
        )

    def padded_tile_bytes(self) -> int:
        """Bytes per page of the packed record read per hop."""
        return int(self.recs.shape[1] * self.recs.shape[2] * 4)


def reassign_ids(grouping: PageGrouping) -> tuple[np.ndarray, np.ndarray]:
    """new_id = page * capacity + slot. Returns (new_to_old, old_to_new)."""
    pages = grouping.pages
    p, cap = pages.shape
    n = int((pages != PAD).sum())
    new_to_old = np.full(p * cap, PAD, np.int64)
    flat = pages.ravel()
    valid = flat != PAD
    new_to_old[valid] = flat[valid]
    old_to_new = np.full(n, PAD, np.int64)
    old_to_new[flat[valid]] = np.nonzero(valid)[0]
    return new_to_old, old_to_new


def pack_page_records(vecs: np.ndarray, nbr_codes: np.ndarray) -> np.ndarray:
    """Pack per-page arrays into one (P, rows, 128) f32 record tile.

    Member block, with ``vpr = 128 // d`` vectors per row for d <= 128 and
    ``rpv = ceil(d / 128)`` rows per vector for d > 128:

      rows [0, Rv)       member vectors: vector i at row i // vpr, cols
                         [(i % vpr)*d, (i % vpr + 1)*d) (d <= 128), or
                         spanning rows [i*rpv, (i+1)*rpv) with the tail row
                         zero-padded (d > 128); Rv = member_rows(cap, d)
      rows [Rv, Rv+M)    neighbor PQ codes, subspace-major (row Rv+j holds
                         code j of neighbors 0..Rp-1 in cols [0, Rp))
      rows padded up to a multiple of 8

    Unused lanes are zero; consumers mask via the side-array counts.
    """
    p, cap, d = vecs.shape
    rp, m = nbr_codes.shape[1:]
    if rp > PAGE_LANES:
        raise ValueError(
            f"packed page record needs page_degree<={PAGE_LANES}, got Rp={rp}"
        )
    mrows = member_rows(cap, d)
    rows = record_rows(cap, d, m)
    rec = np.zeros((p, rows, PAGE_LANES), np.float32)
    if d <= PAGE_LANES:
        vpr = vectors_per_row(d)
        padded = np.zeros((p, mrows * vpr, d), np.float32)
        padded[:, :cap] = vecs
        rec[:, :mrows, : vpr * d] = padded.reshape(p, mrows, vpr * d)
    else:
        rpv = rows_per_vector(d)
        padded = np.zeros((p, cap, rpv * PAGE_LANES), np.float32)
        padded[:, :, :d] = vecs
        rec[:, :mrows, :] = padded.reshape(p, mrows, PAGE_LANES)
    rec[:, mrows:mrows + m, :rp] = nbr_codes.transpose(0, 2, 1)
    return rec


def unpack_member_vectors(
    recs: np.ndarray, capacity: int, dim: int
) -> np.ndarray:
    """Inverse of ``pack_page_records`` for the member block: (P, cap, d),
    bit-exact (members are stored as verbatim f32 lanes)."""
    recs = np.asarray(recs, np.float32)
    p = recs.shape[0]
    mrows = member_rows(capacity, dim)
    if dim <= PAGE_LANES:
        vpr = vectors_per_row(dim)
        flat = recs[:, :mrows, : vpr * dim].reshape(p, mrows * vpr, dim)
        return np.ascontiguousarray(flat[:, :capacity])
    rpv = rows_per_vector(dim)
    flat = recs[:, :mrows].reshape(p, capacity, rpv * PAGE_LANES)
    return np.ascontiguousarray(flat[:, :, :dim])


def unpack_neighbor_codes(
    recs: np.ndarray, capacity: int, dim: int, rp: int, m: int
) -> np.ndarray:
    """Inverse of ``pack_page_records`` for the code block: (P, Rp, M) u8.
    Only valid when the record carries code rows (not MEM_ALL)."""
    recs = np.asarray(recs, np.float32)
    mrows = member_rows(capacity, dim)
    block = recs[:, mrows:mrows + m, :rp]               # (P, M, Rp)
    return np.ascontiguousarray(block.transpose(0, 2, 1).astype(np.uint8))


def pack_pages(
    x: np.ndarray,
    grouping: PageGrouping,
    page_nbrs_old: np.ndarray,
    disk_codes_old: np.ndarray,
    cfg: PageANNConfig,
    *,
    device: str | torch.device = "cuda",
) -> PageStore:
    """Assemble the page-record arrays in the reassigned id space.

    x: (N, d) original vectors (original id space).
    page_nbrs_old: (P, R_p) external neighbor *original* vector ids.
    disk_codes_old: (N, M_disk) on-page PQ codes, original id order.
    """
    device = resolve_device(device)
    pages = grouping.pages
    p, cap = pages.shape
    d = x.shape[1]
    new_to_old, old_to_new = reassign_ids(grouping)

    vecs = np.zeros((p, cap, d), np.float32)
    member_count = (pages != PAD).sum(1).astype(np.int32)
    flat = pages.ravel()
    valid = flat != PAD
    vecs.reshape(p * cap, d)[valid] = x[flat[valid]]

    nbr_valid = page_nbrs_old != PAD
    nbr_ids = np.full_like(page_nbrs_old, PAD)
    nbr_ids[nbr_valid] = old_to_new[page_nbrs_old[nbr_valid]]
    nbr_count = nbr_valid.sum(1).astype(np.int32)

    m_disk = disk_codes_old.shape[1]
    nbr_codes = np.zeros((*page_nbrs_old.shape, m_disk), np.uint8)
    nbr_codes[nbr_valid] = disk_codes_old[page_nbrs_old[nbr_valid]]

    # MEM_ALL keeps every compressed vector in the memory tier (Sec 4.3(3));
    # the search never ADC-scores on-page codes, so the record drops them
    rec_codes = (
        nbr_codes[:, :, :0]
        if cfg.memory_mode == MemoryMode.MEM_ALL
        else nbr_codes
    )

    return PageStore(
        vecs=vecs,
        member_count=torch.as_tensor(member_count).to(device),
        nbr_ids=torch.as_tensor(nbr_ids.astype(np.int32)).to(device),
        nbr_codes=nbr_codes,
        nbr_count=torch.as_tensor(nbr_count).to(device),
        recs=torch.as_tensor(pack_page_records(vecs, rec_codes)).to(device),
        capacity=cap,
        dim=d,
        new_to_old=new_to_old,
        old_to_new=old_to_new,
    )


@dataclasses.dataclass
class MemoryTier:
    """The 'host memory' tier (Sec 4.3): always-resident arrays.

    mem_codes are the *high-accuracy* PQ codes (more subspaces than the
    on-page codes) for vectors cached in memory; mem_mask marks which
    reassigned vector ids are covered (all of them in MEM_ALL mode).
    """

    mem_codes: torch.Tensor      # (N_pad, M_mem) uint8, reassigned order
    mem_mask: torch.Tensor       # (N_pad,) bool
    mem_codebooks: torch.Tensor  # (M_mem, ksub, dsub)
    disk_codebooks: torch.Tensor  # (M_disk, ksub, dsub)
    cached_pages: torch.Tensor   # (C,) int32 sorted page ids ('warmed' cache)

    @property
    def memory_bytes(self) -> int:
        covered = int(self.mem_mask.sum())
        return covered * self.mem_codes.shape[1] + self.mem_codebooks.numel() * 4


def build_memory_tier(
    mem_codes: np.ndarray,
    mem_codebooks: np.ndarray,
    disk_codebooks: np.ndarray,
    mode: MemoryMode,
    *,
    device: str | torch.device = "cuda",
) -> MemoryTier:
    """mem_codes are in reassigned order, padded to P*cap rows. HYBRID
    covers the first half of the vectors; the page cache starts empty
    (``PageANNIndex.warm_cache`` fills it)."""
    device = resolve_device(device)
    n_pad = mem_codes.shape[0]
    mask = np.zeros(n_pad, bool)
    if mode == MemoryMode.MEM_ALL:
        mask[:] = True
    elif mode == MemoryMode.HYBRID:
        mask[: n_pad // 2] = True

    def dev(a):
        return torch.as_tensor(np.asarray(a)).to(device)

    return MemoryTier(
        mem_codes=dev(mem_codes),
        mem_mask=dev(mask),
        mem_codebooks=dev(mem_codebooks),
        disk_codebooks=dev(disk_codebooks),
        cached_pages=torch.zeros((0,), dtype=torch.int32, device=device),
    )


def reassigned_vectors(store: PageStore) -> np.ndarray:
    """Vectors in reassigned order, zero rows for padded slots: (P*cap, d)."""
    return np.asarray(store.vecs).reshape(-1, store.dim)


def reassigned_codes(
    x: np.ndarray, store: PageStore, codebooks: np.ndarray, *,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """PQ codes of all vectors in reassigned order (padded slots encode the
    zero vector): (P*cap, M) uint8, encoded on ``device``.

    ``x`` is the vectors in original id order; it is kept for the
    reference's argument list and not read, because the store's pages
    already hold every vector in slot order (``reassigned_vectors``)."""
    device = resolve_device(device)
    xr = torch.as_tensor(reassigned_vectors(store)).to(device)
    books = torch.as_tensor(np.asarray(codebooks, np.float32)).to(device)
    return pq_mod.pq_encode(xr, books).cpu().numpy()


def reassign_metadata(tags: np.ndarray, nums: np.ndarray, store: PageStore):
    """Scatter original-id metadata columns into page-slot order.

    tags: (N, T) int32 codes, nums: (N, Nn) f32 in original id order (as
    ``filter.encode_metadata`` makes them). Returns the (P*cap, T) /
    (P*cap, Nn) slot-aligned arrays the filtered page scan gathers from:
    row ``page * capacity + slot`` holds the metadata of the vector placed
    there, the same ``new_to_old`` scatter the member vectors use. Pad
    slots keep the missing sentinels (-1 / NaN), which match no clause.
    """
    n2o = store.new_to_old
    rows = n2o.shape[0]
    out_tags = np.full((rows, tags.shape[1]), -1, np.int32)
    out_nums = np.full((rows, nums.shape[1]), np.nan, np.float32)
    valid = n2o != PAD
    out_tags[valid] = tags[n2o[valid]]
    out_nums[valid] = nums[n2o[valid]]
    return out_tags, out_nums


def unreassign_metadata(
    slot_tags: np.ndarray, slot_nums: np.ndarray, store: PageStore
):
    """Inverse of :func:`reassign_metadata`: slot-aligned columns back to
    original-id order (what ``load`` rebuilds the host copy from)."""
    n2o = store.new_to_old
    n = store.num_vectors
    tags = np.full((n, slot_tags.shape[1]), -1, np.int32)
    nums = np.full((n, slot_nums.shape[1]), np.nan, np.float32)
    valid = n2o != PAD
    tags[n2o[valid]] = slot_tags[valid]
    nums[n2o[valid]] = slot_nums[valid]
    return tags, nums
