"""Host-side streaming page tier: the memmap as the source of truth.

Port of ``repro.core.stream``. A :class:`PageFetcher` wraps the
``np.memmap`` of ``pages.bin`` and serves the per-hop record requests of a
memory-budgeted search (``core.search.stream_search``). The search loop
already syncs with the host once per hop, so the fetch is plain host code
between the hop's page selection and its scan (no callback out of a
compiled program, as the reference needs):

  * requested page ids arrive with arbitrary leading batch axes,
    ``PAD``/-1 marking slots the device does not need — those rows come
    back zeroed without touching the file;
  * a bounded LRU **staging cache** of recently fetched records absorbs
    the re-reads a beam search naturally produces (the same hub pages are
    requested hop after hop, query after query), so a miss costs one page
    read, a re-request costs a memcpy;
  * ``pages_fetched`` / ``fetch_hits`` / ``fetch_wall_s`` counters make
    budget pressure observable end to end (``PageANNIndex.fetch_stats``);
  * a call is served by one compiled host routine
    (``kernels/csrc/page_fetch.cpp``: the gather and the same exact LRU,
    run with the interpreter lock released) wherever the host could build
    it and the records are C-contiguous float32, as every loaded page file
    is; else by the per-page Python loop, which stays as its reference
    (``impl="plain"``). The ``page_fetch`` span notes which (``native``).

The fetcher is deliberately dumb about *placement*: which pages are
resident on the device is decided once at load time
(``persist.load_pageann``); everything the device does not hold is this
module's problem, every hop.
"""
from __future__ import annotations

import collections
import threading
import time
import weakref

import numpy as np

from repro_torch.kernels import _build
from repro_torch.obs.trace import span

PAD = -1

# default staging-cache size (pages). Big enough to absorb the hub-page
# re-reads of a beam search over a small index, small enough that the
# host-side footprint stays a fraction of the resident region for any
# realistic page count.
DEFAULT_STAGE_PAGES = 256


class PageFetcher:
    """Thread-safe streaming reader over a memmapped page-record file.

    ``recs`` is the (P, rows, lanes) f32 source of truth (typically an
    ``np.memmap`` of ``pages.bin``; any ndarray works). Calling the
    fetcher with an int array of page ids returns the packed records as
    f32, shape ``ids.shape + (rows, lanes)``; ids < 0 yield zero records.

    ``out``, when given, is a float32 array of at least ``ids.size``
    records that the records are written into (the search hands it a
    pinned host buffer, so the copy to the device needs no second copy on
    the host); its first ``ids.size`` records are returned, reshaped.
    """

    def __init__(
        self,
        recs: np.ndarray,
        *,
        stage_pages: int = DEFAULT_STAGE_PAGES,
    ):
        if recs.ndim != 3:
            raise ValueError(
                f"PageFetcher needs (P, rows, lanes) records, got {recs.shape}"
            )
        if stage_pages < 1:
            raise ValueError("stage_pages must be >= 1")
        self._recs = recs
        self._stage_pages = int(stage_pages)
        self._lock = threading.Lock()
        # page id -> (rows, lanes) f32 copy, most-recently-used last
        self._stage: collections.OrderedDict[int, np.ndarray] = (
            collections.OrderedDict()
        )
        self._pages_fetched = 0
        self._fetch_hits = 0
        self._fetch_wall_s = 0.0
        # trailing window of per-callback wall seconds — the exposition
        # layer's fetch-latency histogram feed (bounded, like the engine's
        # latency window)
        self._wall_window: collections.deque = collections.deque(maxlen=4096)
        # the compiled routine and its own LRU state (None: the plain loop
        # serves every call); the path that has served, since each keeps
        # its own staging cache
        self._lib = self._native_stage = None
        self._path: str | None = None
        if recs.dtype == np.float32 and recs.flags.c_contiguous:
            self._lib = _build.host_library()
        if self._lib is not None:
            self._native_stage = self._lib.pageann_stage_new(self._stage_pages)
            if not self._native_stage:
                raise MemoryError("could not allocate the staging cache")
            weakref.finalize(self, self._lib.pageann_stage_free,
                             self._native_stage)
        # optional span tracer (duck-typed: ``enabled``, ``now()``,
        # ``add(...)``); a caller may attach one so per-hop host fetches
        # show up as ``page_fetch`` spans (``obs.trace.span``), stamped
        # with the tracer's own clock.
        self.tracer = None

    @property
    def num_pages(self) -> int:
        return int(self._recs.shape[0])

    @property
    def record_shape(self) -> tuple[int, int]:
        return int(self._recs.shape[1]), int(self._recs.shape[2])

    def __call__(self, ids, out: np.ndarray | None = None, *,
                 impl: str | None = None) -> np.ndarray:
        return self.read(ids, out, impl=impl)[0]

    def read(self, ids, out: np.ndarray | None = None, *,
             impl: str | None = None) -> tuple[np.ndarray, int]:
        """``self(ids, out)`` and the staging-cache misses of this call:
        the pages it read off the memmap.

        ``impl=None`` takes the compiled routine where it is loaded (else
        the plain loop); ``impl="plain"`` forces the loop. A fetcher serves
        through one of the two for its life: each keeps its own staging
        cache."""
        if impl not in (None, "plain"):
            raise ValueError(f"impl must be None or 'plain', got {impl!r}")
        with span(self.tracer, "page_fetch", cat="host-fetch",
                  track="host-fetch") as sp:
            t0 = time.perf_counter()
            ids = np.asarray(ids)
            flat = ids.reshape(-1).astype(np.int64)
            rows, lanes = self.record_shape
            native = impl is None and self._lib is not None
            if out is None:
                out = (np.empty if native else np.zeros)(
                    (flat.size, rows, lanes), np.float32)
            else:
                out = out.reshape(-1, rows, lanes)[: flat.size]
                if not native:
                    out[flat < 0] = 0.0
            if native and flat.size and flat.max() >= self.num_pages:
                raise IndexError(
                    f"page id {int(flat.max())} is out of bounds for "
                    f"{self.num_pages} pages")
            path = "native" if native else "plain"
            with self._lock:
                if self._path not in (None, path):
                    raise ValueError(
                        f"this fetcher has served through its {self._path} "
                        f"path; a {path} read would start another staging "
                        "cache")
                self._path = path
                fetched0, hits0 = self._pages_fetched, self._fetch_hits
                if native:
                    self._read_native(flat, out)
                else:
                    self._read_plain(flat, out)
                wall = time.perf_counter() - t0
                self._fetch_wall_s += wall
                self._wall_window.append(wall)
                misses = self._pages_fetched - fetched0
                hits = self._fetch_hits - hits0
            sp.note(requested=misses + hits, misses=misses, native=int(native))
        return out.reshape(ids.shape + (rows, lanes)), misses

    def _read_plain(self, flat: np.ndarray, out: np.ndarray) -> None:
        """The reference: one page at a time, in Python."""
        for j, pid in enumerate(flat):
            if pid < 0:
                continue
            pid = int(pid)
            rec = self._stage.get(pid)
            if rec is not None:
                self._stage.move_to_end(pid)
                self._fetch_hits += 1
            else:
                # THE disk read: one page record off the memmap
                rec = np.asarray(self._recs[pid], np.float32)
                self._pages_fetched += 1
                self._stage[pid] = rec
                if len(self._stage) > self._stage_pages:
                    self._stage.popitem(last=False)     # evict LRU
            out[j] = rec

    def _read_native(self, flat: np.ndarray, out: np.ndarray) -> None:
        """The same in one call of the compiled routine, PAD rows zeroed
        there too. An ``out`` it cannot write through a pointer (not
        C-contiguous float32) gets the records through a fresh buffer."""
        rows, lanes = self.record_shape
        direct = out.dtype == np.float32 and (
            out.flags.c_contiguous and out.flags.writeable)
        dst = out if direct else np.empty(out.shape, np.float32)
        counts = np.zeros(2, np.int64)
        rc = self._lib.pageann_page_fetch(
            self._native_stage, flat.ctypes.data, flat.size,
            self._recs.ctypes.data, rows * lanes * 4, dst.ctypes.data,
            counts.ctypes.data)
        self._pages_fetched += int(counts[0])
        self._fetch_hits += int(counts[1])
        if rc != 0:
            raise MemoryError("the staging cache could not grow")
        if not direct:
            out[...] = dst

    # ------------------------------------------------------------- counters
    def fetch_stats(self) -> dict:
        """Cumulative counters: pages read off disk, staging-cache hits,
        and wall seconds spent inside the host callback — plus
        ``wall_window``, the bounded trailing window of per-callback wall
        seconds feeding the exposition layer's fetch-latency histogram."""
        with self._lock:
            return dict(
                pages_fetched=self._pages_fetched,
                fetch_hits=self._fetch_hits,
                fetch_wall_s=self._fetch_wall_s,
                wall_window=tuple(self._wall_window),
            )

    def reset_stats(self) -> None:
        with self._lock:
            self._pages_fetched = 0
            self._fetch_hits = 0
            self._fetch_wall_s = 0.0
            self._wall_window.clear()

    def __repr__(self) -> str:
        return (
            f"PageFetcher(pages={self.num_pages}, "
            f"stage_pages={self._stage_pages})"
        )
