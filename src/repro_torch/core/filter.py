"""Metadata schemas and filter expressions for filtered search.

Port of ``repro.core.filter``: the schema, expressions, compiling and
encoding are the reference's pure Python; ``filter_mask`` evaluates on
torch tensors on the index's device.

Production vector queries are rarely bare top-k: they carry predicates
("this user's docs", "created after T"). This module gives each
collection a declared :class:`MetadataSchema` (tag fields: small string
vocabularies; numeric fields: float64-representable scalars), stores the
per-vector metadata as packed **page-slot-aligned columns** (the same
``new_to_old`` scatter the page records use, so a page's metadata rows
sit at the page's slot offsets), and compiles a frozen/hashable
:class:`FilterExpr` into a :class:`CompiledFilter` — a pure-tuple value the
search threads through ``score_page_batch`` to mask filtered-out members
to ``+inf`` *inside* the page scan.

Layers:

  * ``MetadataSchema`` — declares the fields; validated like
    ``AdaptiveParams`` (every violation in one ``ValueError``);
    JSON round-trips through the index manifest.
  * ``Tag("field") == v`` / ``.isin(...)`` and ``Num("field").between/
    ge/le`` build ``FilterExpr`` clauses; ``&`` ANDs expressions.
    Expressions are frozen and hashable — the batching engine keys
    pending groups by them, and the index caches one compiled form per
    expression.
  * ``compile_filter(expr, schema, vocab)`` resolves field names to
    column indices and tag values to integer codes. Unknown *fields*
    are errors (reported together); unknown tag *values* simply match
    nothing — a predicate over a value no vector carries is a valid
    query with an empty answer, not a schema violation.
  * ``filter_mask`` (torch) / ``filter_mask_np`` (numpy) evaluate a
    compiled filter over metadata columns. The numpy twin is the
    brute-force oracle and the selectivity probe for oversampling.

Encoding invariants (shared with the delta tier and persistence):

  * tag codes are ``>= 0``; **missing/pad = -1** (matches no clause);
  * numeric missing/pad = ``NaN`` (range comparisons are False);
  * a vocabulary maps each tag field to a tuple of values; codes are
    positions in that tuple. ``MutableIndex`` extends vocabularies
    append-only, so codes stay stable across inserts until compaction.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

_MISSING_TAG = -1  # tag code for "no value": valid codes are >= 0


class MetaArrays(NamedTuple):
    """Packed metadata columns, page-slot-aligned like ``PageStore.vecs``.

    ``tags``: (rows, n_tag_fields) int32 codes (missing/pad = -1).
    ``nums``: (rows, n_num_fields) float32 (missing/pad = NaN).
    Either axis-1 may be 0 when the schema has no fields of that kind.
    Torch tensors on the index's device (``PageANNIndex.meta``) or numpy
    arrays on the host (``PageANNIndex.meta_host``).
    """

    tags: Any
    nums: Any

    def to(self, device) -> "MetaArrays":
        """These columns as torch tensors on ``device``."""
        return MetaArrays(tags=torch.as_tensor(self.tags).to(device),
                          nums=torch.as_tensor(self.nums).to(device))


# --------------------------------------------------------------------- schema
@dataclasses.dataclass(frozen=True)
class MetadataSchema:
    """Per-collection metadata declaration: which fields exist and their
    kinds. ``tags`` are categorical string fields (vocabulary-encoded);
    ``numerics`` are scalar float fields (range-filterable)."""

    tags: tuple[str, ...] = ()
    numerics: tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "tags", tuple(self.tags))
        object.__setattr__(self, "numerics", tuple(self.numerics))
        problems = []
        for kind, names in (("tags", self.tags), ("numerics", self.numerics)):
            for n in names:
                if not isinstance(n, str) or not n.isidentifier():
                    problems.append(
                        f"{kind} field names must be identifiers (got {n!r})"
                    )
            dup = sorted({n for n in names if names.count(n) > 1})
            if dup:
                problems.append(f"duplicate {kind} fields: {dup}")
        overlap = sorted(set(self.tags) & set(self.numerics))
        if overlap:
            problems.append(
                f"fields declared as both tag and numeric: {overlap}"
            )
        if not self.tags and not self.numerics:
            problems.append("schema must declare at least one field")
        if problems:
            raise ValueError(
                "invalid MetadataSchema: " + "; ".join(problems)
            )

    @property
    def fields(self) -> tuple[str, ...]:
        return self.tags + self.numerics

    def to_json(self) -> dict:
        return {"tags": list(self.tags), "numerics": list(self.numerics)}

    @classmethod
    def from_json(cls, obj: dict) -> "MetadataSchema":
        return cls(tags=tuple(obj.get("tags", ())),
                   numerics=tuple(obj.get("numerics", ())))


# ---------------------------------------------------------------- expressions
@dataclasses.dataclass(frozen=True)
class FilterExpr:
    """A conjunction of clauses over schema fields. Frozen and hashable:
    it keys the index's compiled-filter cache.

    ``tag_clauses``: ((field, (value, ...)), ...) — field's tag ∈ set.
    ``num_clauses``: ((field, lo, hi), ...) — lo <= field <= hi
    (``-inf``/``+inf`` for one-sided ranges). Clauses are sorted so two
    equal predicates hash equal regardless of construction order."""

    tag_clauses: tuple[tuple[str, tuple[str, ...]], ...] = ()
    num_clauses: tuple[tuple[str, float, float], ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self,
            "tag_clauses",
            tuple(sorted((f, tuple(sorted(vs)))
                         for f, vs in self.tag_clauses)),
        )
        object.__setattr__(
            self,
            "num_clauses",
            tuple(sorted((f, float(lo), float(hi))
                         for f, lo, hi in self.num_clauses)),
        )
        problems = []
        for f, vs in self.tag_clauses:
            if not vs:
                problems.append(f"tag clause on {f!r} has an empty value set")
            for v in vs:
                if not isinstance(v, str):
                    problems.append(
                        f"tag clause on {f!r} has a non-string value {v!r}"
                    )
        for f, lo, hi in self.num_clauses:
            if math.isnan(lo) or math.isnan(hi):
                problems.append(f"numeric clause on {f!r} has a NaN bound")
            elif lo > hi:
                problems.append(
                    f"numeric clause on {f!r} has lo > hi ({lo} > {hi})"
                )
        if not self.tag_clauses and not self.num_clauses:
            problems.append("filter must have at least one clause")
        if problems:
            raise ValueError("invalid FilterExpr: " + "; ".join(problems))

    def __and__(self, other: "FilterExpr") -> "FilterExpr":
        if not isinstance(other, FilterExpr):
            return NotImplemented
        return FilterExpr(
            tag_clauses=self.tag_clauses + other.tag_clauses,
            num_clauses=self.num_clauses + other.num_clauses,
        )

    @property
    def fields(self) -> tuple[str, ...]:
        return tuple(f for f, _ in self.tag_clauses) + tuple(
            f for f, _, _ in self.num_clauses
        )


class Tag:
    """Makes tag-field clauses: ``Tag("user") == "alice"`` or
    ``Tag("lang").isin("en", "de")``."""

    __slots__ = ("field",)

    def __init__(self, field: str):
        self.field = field

    def __eq__(self, value) -> FilterExpr:  # type: ignore[override]
        return self.isin(value)

    def __hash__(self):  # __eq__ is repurposed; keep Tag hashable
        return hash(("Tag", self.field))

    def isin(self, *values) -> FilterExpr:
        if len(values) == 1 and isinstance(values[0], (list, tuple, set,
                                                       frozenset)):
            values = tuple(values[0])
        return FilterExpr(tag_clauses=((self.field, tuple(values)),))


class Num:
    """Makes numeric-field clauses: ``Num("ts").between(a, b)``,
    ``.ge(lo)``, ``.le(hi)``."""

    __slots__ = ("field",)

    def __init__(self, field: str):
        self.field = field

    def between(self, lo: float, hi: float) -> FilterExpr:
        return FilterExpr(num_clauses=((self.field, float(lo), float(hi)),))

    def ge(self, lo: float) -> FilterExpr:
        return self.between(lo, math.inf)

    def le(self, hi: float) -> FilterExpr:
        return self.between(-math.inf, hi)


# ----------------------------------------------------------------- compiling
@dataclasses.dataclass(frozen=True)
class CompiledFilter:
    """A ``FilterExpr`` resolved against a schema + vocabulary: field
    names -> column indices, tag values -> integer codes. Pure nested
    tuples of ints/floats, hashable.

    ``tag_clauses``: ((col, (code, ...)), ...). An unknown tag value
    compiles to no code — if a clause's codes are empty the filter
    matches nothing (``empty`` is True and the mask is all-False).
    ``num_clauses``: ((col, lo, hi), ...)."""

    tag_clauses: tuple[tuple[int, tuple[int, ...]], ...] = ()
    num_clauses: tuple[tuple[int, float, float], ...] = ()

    @property
    def empty(self) -> bool:
        """True when some clause can match nothing (unknown tag value):
        the whole conjunction is unsatisfiable."""
        return any(not codes for _, codes in self.tag_clauses)


def compile_filter(
    expr: FilterExpr,
    schema: MetadataSchema | None,
    vocab: dict[str, tuple[str, ...]],
) -> CompiledFilter:
    """Resolve ``expr`` against ``schema``/``vocab``. Unknown or
    wrong-kind fields are errors — every violation reported in one
    ``ValueError``. Unknown tag *values* match nothing (empty codes)."""
    if schema is None:
        raise ValueError(
            "index has no MetadataSchema: build(..., schema=, metadata=) "
            "before searching with filter="
        )
    problems = []
    tag_pos = {f: i for i, f in enumerate(schema.tags)}
    num_pos = {f: i for i, f in enumerate(schema.numerics)}
    tag_clauses = []
    for f, vs in expr.tag_clauses:
        if f not in tag_pos:
            hint = " (declared numeric)" if f in num_pos else ""
            problems.append(f"unknown tag field {f!r}{hint}")
            continue
        codes = {v: i for i, v in enumerate(vocab.get(f, ()))}
        tag_clauses.append(
            (tag_pos[f], tuple(sorted(codes[v] for v in vs if v in codes)))
        )
    num_clauses = []
    for f, lo, hi in expr.num_clauses:
        if f not in num_pos:
            hint = " (declared tag)" if f in tag_pos else ""
            problems.append(f"unknown numeric field {f!r}{hint}")
            continue
        num_clauses.append((num_pos[f], lo, hi))
    if problems:
        raise ValueError(
            "filter does not match the collection schema: "
            + "; ".join(problems)
        )
    return CompiledFilter(tag_clauses=tuple(tag_clauses),
                          num_clauses=tuple(num_clauses))


# ----------------------------------------------------------------- evaluation
def filter_mask(cfilter: CompiledFilter, tags: torch.Tensor,
                nums: torch.Tensor) -> torch.Tensor:
    """Torch mask over metadata rows: True where every clause passes.
    ``tags`` (..., T) int32, ``nums`` (..., N) float32 on any device;
    missing values (-1 / NaN) never pass."""
    mask = torch.ones(tags.shape[:-1], dtype=torch.bool, device=tags.device)
    for col, codes in cfilter.tag_clauses:
        t = tags[..., col]
        ok = torch.zeros_like(t, dtype=torch.bool)
        for c in codes:  # small unrolled OR over the clause's codes
            ok = ok | (t == c)
        mask = mask & ok
    for col, lo, hi in cfilter.num_clauses:
        x = nums[..., col]
        mask = mask & (x >= lo) & (x <= hi)  # NaN fails both
    return mask


def filter_mask_np(cfilter: CompiledFilter, tags, nums) -> np.ndarray:
    """Numpy twin of :func:`filter_mask` — the post-filter brute-force
    oracle and the host-side selectivity probe."""
    tags = np.asarray(tags)
    nums = np.asarray(nums)
    mask = np.ones(tags.shape[:-1], bool)
    for col, codes in cfilter.tag_clauses:
        mask &= np.isin(tags[..., col], np.asarray(codes, np.int32))
    with np.errstate(invalid="ignore"):
        for col, lo, hi in cfilter.num_clauses:
            x = nums[..., col]
            mask &= (x >= lo) & (x <= hi)
    return mask


# ------------------------------------------------------------------- encoding
def build_vocab(
    schema: MetadataSchema, columns: dict[str, Any]
) -> dict[str, tuple[str, ...]]:
    """Sorted vocabulary per tag field from the observed values."""
    vocab = {}
    for f in schema.tags:
        vals = columns.get(f)
        if vals is None:
            vocab[f] = ()
        else:
            vocab[f] = tuple(sorted({str(v) for v in vals if v is not None}))
    return vocab


def normalize_metadata(
    schema: MetadataSchema, metadata, n: int
) -> dict[str, list]:
    """Accept dict-of-columns or list-of-dicts; return dict-of-columns of
    length ``n`` with ``None`` for missing entries. Unknown fields and
    length mismatches are errors — every violation in one ValueError."""
    problems = []
    known = set(schema.fields)
    columns: dict[str, list] = {}
    if isinstance(metadata, dict):
        for f, vals in metadata.items():
            if f not in known:
                problems.append(f"unknown metadata field {f!r}")
                continue
            vals = list(vals)
            if len(vals) != n:
                problems.append(
                    f"metadata column {f!r} has {len(vals)} entries for "
                    f"{n} vectors"
                )
                continue
            columns[f] = vals
    else:
        rows = list(metadata)
        if len(rows) != n:
            problems.append(
                f"metadata has {len(rows)} rows for {n} vectors"
            )
        else:
            bad = sorted(
                {f for row in rows for f in row if f not in known}
            )
            if bad:
                problems.append(f"unknown metadata fields {bad}")
            else:
                for f in known:
                    columns[f] = [row.get(f) for row in rows]
    if problems:
        raise ValueError(
            "metadata does not match the schema: " + "; ".join(problems)
        )
    for f in known:
        columns.setdefault(f, [None] * n)
    return columns


def encode_metadata(
    schema: MetadataSchema,
    vocab: dict[str, tuple[str, ...]],
    columns: dict[str, list],
    n: int,
) -> MetaArrays:
    """Dict-of-columns -> packed code arrays (original-id order). Values
    absent from the vocabulary encode to the missing sentinel (-1): they
    can only appear via vocabularies that predate the value, where
    "matches nothing" is the correct semantics."""
    tags = np.full((n, len(schema.tags)), _MISSING_TAG, np.int32)
    for j, f in enumerate(schema.tags):
        codes = {v: i for i, v in enumerate(vocab.get(f, ()))}
        col = columns.get(f, [None] * n)
        for i, v in enumerate(col):
            if v is not None:
                tags[i, j] = codes.get(str(v), _MISSING_TAG)
    nums = np.full((n, len(schema.numerics)), np.nan, np.float32)
    for j, f in enumerate(schema.numerics):
        col = columns.get(f, [None] * n)
        for i, v in enumerate(col):
            if v is not None:
                nums[i, j] = float(v)
    return MetaArrays(tags=tags, nums=nums)


def decode_metadata(
    schema: MetadataSchema,
    vocab: dict[str, tuple[str, ...]],
    meta: MetaArrays,
) -> dict[str, list]:
    """Inverse of :func:`encode_metadata` (missing -> None). Used by
    compaction to re-encode delta metadata under a fresh vocabulary."""
    tags = np.asarray(meta.tags)
    nums = np.asarray(meta.nums)
    out: dict[str, list] = {}
    for j, f in enumerate(schema.tags):
        vals = vocab.get(f, ())
        out[f] = [
            vals[c] if 0 <= c < len(vals) else None
            for c in tags[:, j].tolist()
        ]
    for j, f in enumerate(schema.numerics):
        col = nums[:, j]
        out[f] = [None if math.isnan(v) else float(v) for v in col.tolist()]
    return out
