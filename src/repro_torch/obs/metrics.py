"""Metrics registry + Prometheus text exposition over the serving stack.

Port of ``repro.obs.metrics`` (numpy only; copied, so the port needs no
JAX). A serving engine accumulates everything a scraper needs — its
``EngineMetrics`` snapshot (requests/latency/IO windows), compile-cache hit
counters, streaming-tier fetch counters, semantic-cache ``CacheStats`` —
but only as one-shot Python snapshots. This module turns those sources
into a scrapeable surface. Sources are duck-typed: anything whose
``metrics()`` returns an object with ``EngineMetrics``' fields.

  * :class:`MetricsRegistry` — named counters / gauges / histograms
    (explicit buckets), thread-safe, rendered via
    :meth:`MetricsRegistry.render` in Prometheus text exposition format
    (``text/plain; version=0.0.4``);
  * :func:`serve_registry` — the canonical wiring: a registry whose
    collector snapshots a ``BatchingEngine`` / ``VectorService``
    ``metrics()`` at scrape time and maps every field onto a series,
    plus per-collection residency gauges from ``VectorService.stats()``.

Counter semantics: every ``*_total`` series mirrors a cumulative,
monotone engine counter, and the engine captures all of its sources in
ONE lock-consistent snapshot (see ``BatchingEngine.metrics``), so two
scrapes never see e.g. ``fetch`` counters ahead of the ``requests`` they
belong to. Histograms are the exception: they expose the engine's
*trailing windows* (the same bounded deques behind the p50/p99 gauges),
recomputed per scrape — accurate for current-traffic quantiles, not
monotone across scrapes. They are labeled as such in HELP text; rate()
over them is meaningless, quantile estimation over them is exact.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Any, Callable, Iterable

import numpy as np

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# explicit default buckets for the serving-path distributions
LATENCY_MS_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0
)
HOP_BUCKETS = (1.0, 2.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0, 64.0)
IO_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
FETCH_WALL_S_BUCKETS = (
    1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 5e-1
)


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers without the trailing .0."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_str(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="' + v.replace("\\", "\\\\").replace('"', '\\"')
        .replace("\n", "\\n") + '"'
        for k, v in labels
    )
    return "{" + inner + "}"


class Metric:
    """One metric family: a name, a kind, and labeled samples.

    ``counter``/``gauge`` samples are scalars set via :meth:`set` /
    :meth:`inc`. ``histogram`` samples hold (bucket_counts, sum, count)
    against the family's explicit ``buckets``; fill them with
    :meth:`observe` (cumulative) or :meth:`observe_window` (replace with
    one window's distribution — the serving collector's mode).
    """

    def __init__(self, name: str, kind: str, help: str,
                 buckets: tuple[float, ...] | None = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        if kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"invalid metric kind {kind!r}")
        if kind == "histogram":
            if not buckets:
                raise ValueError(f"histogram {name!r} needs explicit buckets")
            b = tuple(float(x) for x in buckets)
            if list(b) != sorted(b) or len(set(b)) != len(b):
                raise ValueError(
                    f"histogram {name!r} buckets must be strictly increasing"
                )
            self.buckets = b
        else:
            if buckets is not None:
                raise ValueError(f"{kind} {name!r} takes no buckets")
            self.buckets = None
        self.name = name
        self.kind = kind
        self.help = help
        self._lock = threading.Lock()
        # labels tuple -> scalar, or -> [bucket_counts list, sum, count]
        self._samples: dict[tuple, Any] = {}

    @staticmethod
    def _key(labels: dict | None) -> tuple:
        if not labels:
            return ()
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    # ----------------------------------------------------- scalar instruments
    def set(self, value: float, labels: dict | None = None) -> None:
        if self.kind == "histogram":
            raise TypeError(f"{self.name} is a histogram; use observe*")
        with self._lock:
            self._samples[self._key(labels)] = float(value)

    def inc(self, value: float = 1.0, labels: dict | None = None) -> None:
        if self.kind == "histogram":
            raise TypeError(f"{self.name} is a histogram; use observe*")
        key = self._key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + float(value)

    def value(self, labels: dict | None = None) -> float:
        with self._lock:
            return self._samples.get(self._key(labels), 0.0)

    # -------------------------------------------------- histogram instruments
    def _bucketize(self, values: np.ndarray) -> list:
        counts = [
            int(np.count_nonzero(values <= b)) for b in self.buckets
        ]
        return [counts, float(values.sum()), int(values.size)]

    def observe(self, value: float, labels: dict | None = None) -> None:
        if self.kind != "histogram":
            raise TypeError(f"{self.name} is a {self.kind}; use set/inc")
        key = self._key(labels)
        v = float(value)
        with self._lock:
            cell = self._samples.get(key)
            if cell is None:
                cell = [[0] * len(self.buckets), 0.0, 0]
                self._samples[key] = cell
            for i, b in enumerate(self.buckets):
                if v <= b:
                    cell[0][i] += 1
            cell[1] += v
            cell[2] += 1

    def observe_window(self, values, labels: dict | None = None) -> None:
        """Replace the sample with one trailing window's distribution
        (cumulative bucket counts over ``values``). Used by scrape-time
        collectors exposing bounded serving windows."""
        if self.kind != "histogram":
            raise TypeError(f"{self.name} is a {self.kind}; use set/inc")
        arr = np.asarray(values, np.float64).ravel()
        with self._lock:
            self._samples[self._key(labels)] = self._bucketize(arr)

    def clear_samples(self) -> None:
        with self._lock:
            self._samples.clear()

    # --------------------------------------------------------------- render
    def render(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} {self.kind}"
        with self._lock:
            samples = dict(self._samples)
        for labels, v in sorted(samples.items()):
            if self.kind != "histogram":
                yield f"{self.name}{_labels_str(labels)} {_fmt(v)}"
                continue
            counts, total, count = v
            for b, c in zip(self.buckets, counts):
                lb = labels + (("le", _fmt(b)),)
                yield f"{self.name}_bucket{_labels_str(lb)} {c}"
            lb = labels + (("le", "+Inf"),)
            yield f"{self.name}_bucket{_labels_str(lb)} {count}"
            yield f"{self.name}_sum{_labels_str(labels)} {_fmt(total)}"
            yield f"{self.name}_count{_labels_str(labels)} {count}"


class MetricsRegistry:
    """Thread-safe registry of :class:`Metric` families plus scrape-time
    collectors. ``counter``/``gauge``/``histogram`` are create-or-get
    (re-declaring with a different kind raises); ``render()`` first runs
    every registered collector (which snapshots its source and updates
    instruments), then emits the exposition text in registration order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}
        self._collectors: list[Callable[["MetricsRegistry"], None]] = []

    def _declare(self, name: str, kind: str, help: str,
                 buckets=None) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"not {kind}"
                    )
                return m
            m = Metric(name, kind, help, buckets)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str) -> Metric:
        return self._declare(name, "counter", help)

    def gauge(self, name: str, help: str) -> Metric:
        return self._declare(name, "gauge", help)

    def histogram(self, name: str, help: str,
                  buckets: tuple[float, ...]) -> Metric:
        return self._declare(name, "histogram", help, buckets)

    def get(self, name: str) -> Metric:
        with self._lock:
            return self._metrics[name]

    def register_collector(
        self, fn: Callable[["MetricsRegistry"], None]
    ) -> None:
        """``fn(registry)`` runs at the top of every ``render()``."""
        with self._lock:
            self._collectors.append(fn)

    def render(self) -> str:
        with self._lock:
            collectors = list(self._collectors)
            metrics = list(self._metrics.values())
        for fn in collectors:
            fn(self)
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the canonical serving wiring
# ---------------------------------------------------------------------------

# EngineMetrics field -> (series suffix, kind, help). Cumulative counters
# keep the Prometheus *_total convention; instantaneous aggregates are
# gauges.
_ENGINE_FIELDS = {
    "requests": ("requests_total", "counter",
                 "Completed search requests demuxed to futures"),
    "batches": ("batches_total", "counter", "Dispatched fixed-shape batches"),
    "inserts": ("inserts_total", "counter",
                "Vectors inserted through the engine write path"),
    "deletes": ("deletes_total", "counter",
                "Ids deleted through the engine write path"),
    "compactions": ("compactions_total", "counter",
                    "Delta-tier compactions folded into the base"),
    "early_exits": ("early_exits_total", "counter",
                    "Requests whose search exited before params.max_hops"),
    "sheds": ("sheds_total", "counter",
              "Requests shed by deadline expiry while queued"),
    "compile_hits": ("compile_hits_total", "counter",
                     "Dispatches served by an already-warm executable"),
    "compile_misses": ("compile_misses_total", "counter",
                       "Dispatches that compiled a new executable"),
    "pages_fetched": ("pages_fetched_total", "counter",
                      "Page records read off the host memmap (streaming)"),
    "fetch_hits": ("fetch_hits_total", "counter",
                   "Page requests served by the host staging cache"),
    "fetch_wall_s": ("fetch_wall_seconds_total", "counter",
                     "Wall seconds inside the host page-fetch callback"),
    "semantic_hits": ("semantic_hits_total", "counter",
                      "Submits served from the semantic query cache"),
    "semantic_misses": ("semantic_misses_total", "counter",
                        "Submits that fell through to a dispatch"),
    "semantic_evictions": ("semantic_evictions_total", "counter",
                           "Semantic-cache entries dropped by LRU or TTL"),
    "semantic_invalidations": ("semantic_invalidations_total", "counter",
                               "Semantic-cache entries dropped by writes"),
    "qps": ("qps", "gauge",
            "Completed requests / wall-clock first-submit..last-demux"),
    "latency_ms_mean": ("latency_ms_mean", "gauge",
                        "Mean request latency over the trailing window"),
    "latency_ms_p50": ("latency_ms_p50", "gauge",
                       "p50 request latency over the trailing window"),
    "latency_ms_p99": ("latency_ms_p99", "gauge",
                       "p99 request latency over the trailing window"),
    "mean_ios": ("mean_ios", "gauge", "Mean disk page reads per request"),
    "mean_hops": ("mean_hops", "gauge",
                  "Mean hop-loop iterations per request (trailing window)"),
    "p99_hops": ("p99_hops", "gauge",
                 "p99 hop-loop iterations per request (trailing window)"),
    "p99_ios": ("p99_ios", "gauge",
                "p99 disk page reads per request (trailing window)"),
    "mean_batch_occupancy": ("batch_occupancy_mean", "gauge",
                             "Real requests per dispatched batch"),
    "padded_fraction": ("padded_fraction", "gauge",
                        "Pad rows / dispatched rows"),
    "collections": ("collections", "gauge", "Registered collections"),
    "compiled_executables": ("compiled_executables", "gauge",
                             "Distinct compiled search signatures seen"),
}

# per-collection residency gauges pulled from VectorService.stats()
_COLLECTION_FIELDS = {
    "pages": ("collection_pages", "Total pages in the collection's disk tier"),
    "resident_pages": ("collection_resident_pages",
                       "Pages pinned device-resident (streaming split)"),
    "disk_bytes": ("collection_disk_bytes",
                   "On-disk bytes of the collection's page file"),
    "resident_bytes": ("collection_resident_bytes",
                       "Device-resident bytes of the collection's page tier"),
    "delta_live": ("collection_delta_live",
                   "Live rows in the collection's mutable delta tier"),
    "tombstones": ("collection_tombstones",
                   "Tombstoned base rows awaiting compaction"),
}

_WINDOW_HELP = (
    " (trailing-window distribution, recomputed per scrape; "
    "quantile-accurate for current traffic, not monotone)"
)


def serve_registry(
    source, *, namespace: str = "pageann",
    registry: MetricsRegistry | None = None,
) -> MetricsRegistry:
    """A registry scraping ``source`` — a ``BatchingEngine`` or
    ``VectorService`` — at render time.

    Every ``EngineMetrics`` field maps onto a ``{namespace}_*`` series
    (cumulative counters keep their monotone semantics; the engine
    snapshots all sources atomically, so a scrape is self-consistent).
    When the source exposes ``metrics_windows()`` the trailing latency /
    hops / ios / fetch-wall windows render as explicit-bucket histograms;
    when it exposes ``stats()`` (``VectorService``) each collection gets
    residency gauges labeled ``{collection="name"}``.
    """
    reg = registry if registry is not None else MetricsRegistry()
    instruments: dict[str, Metric] = {}
    for field, (suffix, kind, help) in _ENGINE_FIELDS.items():
        fn = reg.counter if kind == "counter" else reg.gauge
        instruments[field] = fn(f"{namespace}_{suffix}", help)
    h_lat = reg.histogram(
        f"{namespace}_request_latency_ms",
        "Request latency, submit to demux, milliseconds" + _WINDOW_HELP,
        LATENCY_MS_BUCKETS,
    )
    h_hops = reg.histogram(
        f"{namespace}_request_hops",
        "Hop-loop iterations per request" + _WINDOW_HELP,
        HOP_BUCKETS,
    )
    h_ios = reg.histogram(
        f"{namespace}_request_ios",
        "Disk page reads per request" + _WINDOW_HELP,
        IO_BUCKETS,
    )
    h_fetch = reg.histogram(
        f"{namespace}_fetch_wall_seconds",
        "Host page-fetch callback wall seconds per hop" + _WINDOW_HELP,
        FETCH_WALL_S_BUCKETS,
    )
    col_gauges = {
        key: reg.gauge(f"{namespace}_{suffix}", help)
        for key, (suffix, help) in _COLLECTION_FIELDS.items()
    }

    def collect(_reg: MetricsRegistry) -> None:
        m = source.metrics()
        for field, inst in instruments.items():
            inst.set(float(getattr(m, field)))
        windows_fn = getattr(source, "metrics_windows", None)
        if callable(windows_fn):
            win = windows_fn()
            h_lat.observe_window(win.get("latency_ms", ()))
            h_hops.observe_window(win.get("hops", ()))
            h_ios.observe_window(win.get("ios", ()))
            h_fetch.observe_window(win.get("fetch_wall_s", ()))
        stats_fn = getattr(source, "stats", None)
        if callable(stats_fn):
            for name, st in stats_fn().items():
                flat = dict(st)
                base = st.get("base")
                if isinstance(base, dict):
                    for k, v in base.items():
                        flat.setdefault(k, v)
                for key, inst in col_gauges.items():
                    if key in flat and isinstance(flat[key], (int, float)):
                        inst.set(float(flat[key]),
                                 labels={"collection": name})

    reg.register_collector(collect)
    return reg


# ---------------------------------------------------------------------------
# exposition parsing (tests, self-checks, the CI scrape gate)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)\s*$"
)
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Parse text exposition into ``{series_name: [(labels, value), ...]}``.

    Strict enough to be a format gate: any non-comment, non-blank line
    that does not parse as a sample raises ``ValueError``."""
    out: dict[str, list[tuple[dict, float]]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparseable sample {line!r}")
        labels = {
            k: v.replace('\\"', '"').replace("\\n", "\n")
            .replace("\\\\", "\\")
            for k, v in _LABEL_PAIR_RE.findall(m.group("labels") or "")
        }
        raw = m.group("value")
        value = float("inf") if raw == "+Inf" else (
            float("-inf") if raw == "-Inf" else float(raw)
        )
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


def sample_value(
    parsed: dict[str, list[tuple[dict, float]]], name: str, **labels: str
) -> float:
    """The value of ``name`` whose labels are a superset of ``labels``;
    KeyError when absent (the scrape gate's assertion primitive)."""
    for got, value in parsed.get(name, ()):
        if all(got.get(k) == str(v) for k, v in labels.items()):
            return value
    raise KeyError(f"no sample {name} with labels {labels}")
