"""Observability: request tracing, metrics exposition, search profiling.

Port of ``repro.obs`` (pure Python; copied, so the port needs no JAX).
Three layers, each usable on its own:

  * :mod:`repro_torch.obs.trace` — a thread-safe span tracer (bounded ring
    buffer, injected monotonic clock, ~zero cost when disabled) with
    Chrome ``trace_event`` export, viewable in Perfetto. The streamed
    tier's page fetcher emits into one attached as its ``tracer``.
  * :mod:`repro_torch.obs.metrics` — a registry of named counters, gauges
    and histograms rendered as Prometheus text exposition, with
    ``serve_registry`` wiring a serving engine's ``metrics()`` snapshot
    onto it; :mod:`repro_torch.obs.server` serves it over a stdlib
    ``http.server`` sidecar (``/metrics``, ``/healthz``, ``/stats``).
  * per-hop search profiling — ``PageANNIndex.profile(queries)``
    (``core.search.profile_search``) keeps the beam's per-hop trail;
    ``python -m repro_torch.obs.report`` renders a saved trace or profile
    as a phase breakdown.

Tracers and registries are injected (duck-typed), so observability stays
an opt-in layer, not a dependency of the query loop.
"""
from repro_torch.obs.metrics import (
    MetricsRegistry,
    parse_prometheus_text,
    sample_value,
    serve_registry,
)
from repro_torch.obs.server import MetricsServer
from repro_torch.obs.trace import NULL_TRACER, Span, Tracer

__all__ = [
    "MetricsRegistry",
    "MetricsServer",
    "NULL_TRACER",
    "Span",
    "Tracer",
    "parse_prometheus_text",
    "sample_value",
    "serve_registry",
]
