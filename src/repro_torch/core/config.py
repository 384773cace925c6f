"""Configuration for the PageANN index (the port's copy of
``repro.core.config``; same dataclasses, same JSON round trip).

Mirrors the knobs in the paper (Secs. 4.1-4.4, 6.1):
  - Vamana build: degree R, build beam L_build, alpha.
  - Page-node graph: page capacity n, hop parameter h, page degree R_p.
  - PQ compression: M subspaces x 256 centroids (8-bit codes).
  - LSH routing: B hyperplane bits, S sampled vectors, top-T entries.
  - Search: beam L, I/O batch b (paper fixes b=5), result k.
  - Memory-disk coordination mode (Sec 4.3).
"""
from __future__ import annotations

import dataclasses
import enum


class MemoryMode(enum.Enum):
    """Memory-disk coordination regimes from Sec 4.3.

    DISK_ONLY: compressed neighbor vectors live on the SSD page next to the
        page node (severely constrained memory; paper's ~0% memory ratio).
    HYBRID:    a slice of compressed vectors is cached in host memory, the
        remainder stays on-page (moderate budgets).
    MEM_ALL:   all compressed vectors live in memory; the freed page bytes are
        reallocated to raise the page capacity (sufficient memory).
    """

    DISK_ONLY = "disk_only"
    HYBRID = "hybrid"
    MEM_ALL = "mem_all"


@dataclasses.dataclass(frozen=True)
class AdaptiveParams:
    """Query-adaptive search knobs (the PR-7 adaptive engine). Frozen and
    hashable so a value can ride :class:`SearchParams` into a static jit
    argument. Every feature is off by default (``None``), and an
    all-``None`` value compiles to the exact non-adaptive program — results
    are bit-identical to a search with ``adaptive=None``.

    * **Early termination** (``patience`` / ``epsilon``): the hop loop
      carries a per-query stall counter that increments whenever the worst
      of the running top-k fails to improve by more than ``epsilon`` and
      resets on improvement; a query whose counter reaches ``patience``
      exits its lane instead of running to ``max_hops``. Easy queries stop
      paying worst-case page reads; hard ones keep hopping.
    * **Query-sensitive entry selection** (``entry_slack_bits`` /
      ``min_entries``): the LSH router's top-T Hamming distances are a
      per-query entry-quality signal. Only candidates within
      ``entry_slack_bits`` Hamming bits of the best candidate seed the
      beam (never fewer than ``min_entries``): a confidently-routed query
      starts from its few genuinely close entries instead of a fixed-size
      slice, while a poorly-routed (flat-profile) query keeps the whole
      top-T to hedge.
    """

    # early termination: consecutive non-improving hops before a query's
    # lane exits (None = run to max_hops, exactly the non-adaptive loop)
    patience: int | None = None
    # minimum improvement of the worst top-k distance that counts as
    # progress (absolute squared-L2; 0.0 = any strict improvement)
    epsilon: float = 0.0
    # entry selection: Hamming slack (in bits) around the best entry
    # candidate that keeps a candidate as a beam seed (None = disabled,
    # seed all top-T as before)
    entry_slack_bits: int | None = None
    # floor on per-query seeded entries when entry selection is on
    min_entries: int = 1

    def __post_init__(self):
        problems = []
        if self.patience is not None and self.patience < 1:
            problems.append(f"patience must be >= 1 (got {self.patience})")
        if not self.epsilon >= 0.0:
            problems.append(f"epsilon must be >= 0 (got {self.epsilon})")
        if self.entry_slack_bits is not None and self.entry_slack_bits < 0:
            problems.append(
                f"entry_slack_bits must be >= 0 (got {self.entry_slack_bits})"
            )
        if self.min_entries < 1:
            problems.append(f"min_entries must be >= 1 (got {self.min_entries})")
        if problems:
            raise ValueError(
                "invalid AdaptiveParams: " + "; ".join(problems)
            )
        object.__setattr__(self, "epsilon", float(self.epsilon))

    @property
    def enabled(self) -> bool:
        """Whether any adaptive feature is actually on."""
        return self.patience is not None or self.entry_slack_bits is not None

    def replace(self, **kw) -> "AdaptiveParams":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, doc: dict) -> "AdaptiveParams":
        return cls(**doc)


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Runtime search knobs (Alg. 2), decoupled from the build-time config.

    Frozen and hashable so a ``SearchParams`` value can be a *static* jit
    argument: each distinct value keys one compiled executable, and a
    recall-vs-beam sweep compiles a few executables over ONE built index
    instead of rebuilding it per point. Everything that shapes the on-disk
    artifact (page geometry, PQ, memory mode) stays in
    :class:`PageANNConfig`; everything here may vary per search call.

    ``adaptive`` carries the query-adaptive knobs (:class:`AdaptiveParams`:
    per-query early termination + entry selection); ``None`` — and an
    all-default ``AdaptiveParams()`` — compile to the exact non-adaptive
    program.
    """

    k: int = 10              # result set size
    beam_width: int = 64     # L: candidate set size
    io_batch: int = 5        # b: batched I/O size (paper uses 5)
    max_hops: int = 64       # safety bound on the search while_loop
    lsh_entries: int = 16    # T: top-T Hamming entry candidates
    adaptive: AdaptiveParams | None = None  # query-adaptive knobs (off=None)

    def __post_init__(self):
        # beam_width >= lsh_entries is a PageANN-path invariant, enforced
        # where the LSH router is actually used (core.search) — baseline
        # indexes ignore lsh_entries and accept any positive beam. Every
        # violated field is reported in ONE error, not first-wins.
        problems = [
            f"{name} must be positive (got {getattr(self, name)})"
            for name in ("k", "beam_width", "io_batch", "max_hops",
                         "lsh_entries")
            if getattr(self, name) <= 0
        ]
        if self.adaptive is not None and not isinstance(
            self.adaptive, AdaptiveParams
        ):
            problems.append(
                "adaptive must be an AdaptiveParams or None "
                f"(got {type(self.adaptive).__name__})"
            )
        if problems:
            raise ValueError("invalid SearchParams: " + "; ".join(problems))

    def pageann_violations(self) -> list:
        """Cross-field invariants of the PageANN search path (the LSH
        router actually seeds the beam there; baselines ignore these).
        Returns ALL violations so the caller can raise them in one error."""
        problems = []
        if self.beam_width < self.lsh_entries:
            problems.append(
                "beam_width >= lsh_entries is required: the top-T LSH "
                f"entry candidates seed the beam (got L={self.beam_width}, "
                f"T={self.lsh_entries})"
            )
        a = self.adaptive
        if a is not None and a.entry_slack_bits is not None \
                and a.min_entries > self.lsh_entries:
            problems.append(
                "adaptive.min_entries <= lsh_entries is required: the "
                "entry floor cannot exceed the candidate pool (got "
                f"min_entries={a.min_entries}, T={self.lsh_entries})"
            )
        return problems

    @classmethod
    def from_config(cls, cfg: "PageANNConfig", k: int = 10) -> "SearchParams":
        """The config's build-time defaults as a runtime parameter set."""
        return cls(
            k=k,
            beam_width=cfg.beam_width,
            io_batch=cfg.io_batch,
            max_hops=cfg.max_hops,
            lsh_entries=cfg.lsh_entries,
        )

    def replace(self, **kw) -> "SearchParams":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> dict:
        doc = dataclasses.asdict(self)
        doc["adaptive"] = (
            self.adaptive.to_json() if self.adaptive is not None else None
        )
        return doc

    @classmethod
    def from_json(cls, doc: dict) -> "SearchParams":
        doc = dict(doc)
        if doc.get("adaptive") is not None:
            doc["adaptive"] = AdaptiveParams.from_json(doc["adaptive"])
        return cls(**doc)


def resolve_search_params(
    default: SearchParams,
    k: int | None,
    params: "SearchParams | None",
) -> SearchParams:
    """The protocol-wide resolution rule for ``search(queries, k, params)``:
    ``params`` wins over the index default, an explicit ``k`` wins over
    ``params.k``. One definition so every ``VectorIndex`` implementation
    resolves identically."""
    p = params if params is not None else default
    if k is not None and k != p.k:
        p = p.replace(k=k)
    return p


_UNIT_BYTES = {
    "B": 1,
    "KB": 10**3, "MB": 10**6, "GB": 10**9, "TB": 10**12,
    "KIB": 2**10, "MIB": 2**20, "GIB": 2**30, "TIB": 2**40,
}


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    """Device-memory budget for the resident page region at load time.

    Exactly one of ``bytes`` (absolute budget for resident page records)
    or ``fraction`` (of the artifact's page file) must be set. Passing
    ``memory_budget=None`` to the load surface means "no budget": the whole
    page file is materialized on device, exactly today's behavior. A budget
    caps how many packed page records are pinned resident (chosen hottest
    first by the artifact's recorded access order); every other page is
    streamed from the host memmap per hop through the staging path.

    Frozen and hashable so a budget can ride static jit closures and be
    serialized losslessly into the artifact manifest (``to_json`` /
    ``from_json`` — the ``residency`` section).
    """

    bytes: int | None = None
    fraction: float | None = None

    def __post_init__(self):
        if (self.bytes is None) == (self.fraction is None):
            raise ValueError(
                "MemoryBudget needs exactly one of bytes= or fraction="
            )
        if self.bytes is not None:
            if not isinstance(self.bytes, int) or isinstance(self.bytes, bool):
                raise ValueError("MemoryBudget.bytes must be an int")
            if self.bytes <= 0:
                raise ValueError("MemoryBudget.bytes must be positive")
        if self.fraction is not None:
            if not 0.0 < float(self.fraction) <= 1.0:
                raise ValueError(
                    "MemoryBudget.fraction must be in (0, 1]"
                )
            object.__setattr__(self, "fraction", float(self.fraction))

    def resolve_pages(self, num_pages: int, page_bytes: int) -> int:
        """How many page records fit this budget: at least 1 (the search
        needs a non-empty resident array), at most every page."""
        if self.bytes is not None:
            fit = self.bytes // max(1, page_bytes)
        else:
            fit = int(num_pages * self.fraction)
        return max(1, min(int(num_pages), int(fit)))

    def to_json(self) -> dict:
        return {"bytes": self.bytes, "fraction": self.fraction}

    @classmethod
    def from_json(cls, doc: dict) -> "MemoryBudget":
        return cls(bytes=doc.get("bytes"), fraction=doc.get("fraction"))

    @classmethod
    def parse(cls, spec: "str | int | float | MemoryBudget") -> "MemoryBudget":
        """Parse a CLI-style budget: ``"512MB"`` / ``"1GiB"`` / a byte
        count, or a bare number in (0, 1] meaning a fraction of the page
        file (``"0.25"``)."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, bool):
            raise ValueError(f"cannot parse memory budget from {spec!r}")
        if isinstance(spec, int):
            return cls(bytes=spec)
        if isinstance(spec, float):
            return cls(fraction=spec)
        s = str(spec).strip()
        unit = ""
        num = s
        for i, c in enumerate(s):
            if c.isalpha():
                num, unit = s[:i], s[i:]
                break
        try:
            value = float(num)
        except ValueError:
            raise ValueError(f"cannot parse memory budget {spec!r}") from None
        if unit:
            mult = _UNIT_BYTES.get(unit.strip().upper())
            if mult is None:
                raise ValueError(
                    f"unknown memory budget unit {unit!r} in {spec!r} "
                    f"(use one of {sorted(_UNIT_BYTES)})"
                )
            return cls(bytes=int(value * mult))
        if value <= 1.0 and "." in num:
            return cls(fraction=value)
        return cls(bytes=int(value))


@dataclasses.dataclass(frozen=True)
class DeltaParams:
    """Knobs of the mutable-index delta tier (``repro.core.delta``).

    The delta tier keeps freshly inserted vectors in memory and deleted ids
    as tombstones; the page-aligned disk artifact stays frozen until
    compaction folds the delta back in. These knobs bound the two costs the
    tier introduces: the brute-force scan over the delta, and the top-k
    oversampling that compensates for tombstoned base results.
    """

    # delta live-vector count / base live-vector count above which
    # ``MutableIndex.insert`` triggers an automatic ``compact()`` (set to
    # None / rely on explicit compact() by passing auto_compact=False)
    compact_fraction: float = 0.25
    # base-search k is oversampled by the tombstone count rounded up to a
    # power of two so jit shapes stay bounded; this caps the bucket — past
    # it, heavily-deleted results may crowd out live ones until compaction
    max_tombstone_oversample: int = 256
    # initial delta buffer capacity (rows); grows by doubling
    min_capacity: int = 256

    def __post_init__(self):
        if not 0.0 < self.compact_fraction:
            raise ValueError("compact_fraction must be positive")
        if self.max_tombstone_oversample < 1:
            raise ValueError("max_tombstone_oversample must be >= 1")
        if self.min_capacity < 1:
            raise ValueError("min_capacity must be >= 1")


@dataclasses.dataclass(frozen=True)
class FilterParams:
    """Knobs of the filtered-search path (``repro.core.filter``).

    Filtered-out page members are scored to ``+inf`` inside the page
    scan, so a selective predicate needs a wider beam to surface enough
    passing candidates — the same pow2-bucketed oversampling the
    tombstone path uses, driven by the predicate's measured selectivity.
    """

    # beam_width is multiplied by the next power of two of
    # (1 / selectivity), capped here so jit shapes stay bounded; past the
    # cap a very selective filter may under-recall until the caller
    # widens the beam explicitly
    max_filter_oversample: int = 64

    def __post_init__(self):
        if self.max_filter_oversample < 1:
            raise ValueError("max_filter_oversample must be >= 1")


@dataclasses.dataclass(frozen=True)
class PageANNConfig:
    dim: int
    # --- Vamana vector-graph build (Sec 4.1 starts from a Vamana graph) ---
    graph_degree: int = 32          # R
    build_beam: int = 64            # candidate pool size during construction
    alpha: float = 1.2              # robust-prune slack
    build_rounds: int = 2           # 1st round alpha=1.0, 2nd round alpha
    # --- page-node graph (Alg. 1) ---
    page_bytes: int = 4096          # S_page: SSD page size the layout targets
    page_capacity: int | None = None  # n; derived from page_bytes when None
    hop_h: int = 2                  # h: candidate-selection hop radius
    page_degree: int = 48           # R_p: max external neighbors kept per page
    # --- PQ compression ---
    pq_subspaces: int = 16          # M
    pq_ksub: int = 256              # centroids per subspace (8-bit codes)
    pq_iters: int = 12              # k-means Lloyd iterations
    # --- LSH routing index (Sec 4.3) ---
    lsh_bits: int = 64              # B hyperplane bits
    lsh_sample: int = 1024          # S sampled vectors
    lsh_entries: int = 16           # T entry candidates (top-T Hamming)
    # --- search (Alg. 2): per-call defaults only — the runtime values live
    # in SearchParams and may differ on every search() call ---
    beam_width: int = 64            # L: candidate set size
    io_batch: int = 5               # b: batched I/O size (paper uses 5)
    max_hops: int = 64              # safety bound on while_loop
    # --- memory-disk coordination ---
    memory_mode: MemoryMode = MemoryMode.HYBRID
    memory_budget_bytes: int | None = None  # drives mode selection when set
    cache_pages: int = 0            # warmed page cache entries (Sec 4.3)
    # --- misc ---
    dtype_bytes: int = 4            # S_dtype: vector element size (f32)
    id_bytes: int = 4               # S_nbrID
    seed: int = 0

    def __post_init__(self):
        if self.dim <= 0:
            raise ValueError("dim must be positive")
        if self.pq_subspaces > self.dim:
            raise ValueError("pq_subspaces cannot exceed dim")
        if self.dim % self.pq_subspaces != 0:
            raise ValueError("dim must be divisible by pq_subspaces")
        if self.lsh_bits % 32 != 0:
            raise ValueError("lsh_bits must be a multiple of 32 (packed words)")
        if self.page_degree > 128:
            raise ValueError(
                "page_degree must be <= 128: the packed page record stores "
                "one neighbor per f32 lane per PQ subspace (layout.pack_"
                "page_records); the paper uses R_p = 48"
            )

    @property
    def pq_code_bytes(self) -> int:
        return self.pq_subspaces  # one uint8 per subspace

    def resolve_capacity(self) -> int:
        """Paper Sec 4.2 page-capacity equation, resolved for this config.

        N_nodes = (S_page - 2*S_num_nbrs - S_nbrID*N_nbrs - S_CV*N_CV)
                  / (D * S_dtype)

        N_CV (compressed vectors co-located on the page) depends on the
        memory-disk coordination mode: DISK_ONLY keeps a code for every
        neighbor on-page, MEM_ALL keeps none (codes live in memory and the
        freed bytes buy more vectors per page), HYBRID keeps half.
        """
        if self.page_capacity is not None:
            return self.page_capacity
        if self.memory_mode == MemoryMode.DISK_ONLY:
            n_cv = self.page_degree
        elif self.memory_mode == MemoryMode.HYBRID:
            n_cv = self.page_degree // 2
        else:
            n_cv = 0
        s_num_nbrs = 4
        fixed = 2 * s_num_nbrs + self.id_bytes * self.page_degree \
            + self.pq_code_bytes * n_cv
        cap = (self.page_bytes - fixed) // (self.dim * self.dtype_bytes)
        return max(1, int(cap))
