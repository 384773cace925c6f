"""Lightweight request tracer: bounded span ring buffer, Chrome export.

Port of ``repro.obs.trace`` (pure Python; copied, so the port needs no
JAX). A serving stack emits one :class:`Span` per phase of a request's
life (``submit``, ``queue_wait``, ``device_dispatch``, …) plus child spans
for the host work hanging off a dispatch. The program emits its own spans
through :func:`span`: the streamed tier's ``core.stream.PageFetcher`` one
``page_fetch`` a hop, and the search (``core.index``, ``core.search``) its
phases on the ``search`` track: ``pageann.search`` around each
``PageANNIndex.search``, inside it ``pageann.upload``, ``pageann.start``,
one ``pageann.hop`` a loop iteration (its children ``pageann.hop.sync``,
``pageann.hop.select``, ``pageann.hop.score`` (holding
``pageann.hop.fetch`` in a memory-budgeted search), ``pageann.hop.merge``) and
``pageann.download``. Design constraints, in order:

  * **~zero cost when disabled** — every emission point guards on
    ``tracer.enabled`` (or on the tracer being ``None``) before touching
    the clock or building args, and :func:`span` (which
    :meth:`Tracer.span` is) returns one shared no-op context manager, so
    a disabled tracer adds two checks (its own and the profiler's) to the
    hot path;
  * **bounded** — spans land in a ring buffer (``capacity``); a server
    left tracing for a week drops the oldest spans, never grows;
  * **thread-safe** — the engine dispatches from submitter and timer
    threads concurrently; appends and snapshots take one small lock;
  * **testable** — the clock is injected (monotonic by contract). Spans
    recorded with :meth:`Tracer.add` carry caller-supplied timestamps,
    so the engine can stamp spans with ITS injected clock and the trace
    stays coherent under a fake clock. For a coherent multi-component
    trace, inject the same clock everywhere (the default everywhere is
    ``time.perf_counter``).

A span site records into the tracer attached to the object that emits it
(``tracer``, None by default), and, while ``torch.profiler`` records, also
opens ``torch.profiler.record_function(name)`` (so the span sits on the
profile's host timeline) and records into :data:`PROFILED`, a process-wide
tracer stamped on the realtime clock kineto stamps its events with: a
reader of a finished profile finds the program's spans there, on the
device trace's clock. With neither on, a site costs the two checks in
:func:`span`: no clock read and no ``record_function`` (an empty one costs
~10 us even with no profiler running).

Export: :meth:`Tracer.to_chrome_json` emits Chrome ``trace_event``
format — complete (``ph: "X"``) events in microseconds with one tid per
track name and thread-name metadata — loadable in Perfetto or
``chrome://tracing``, so "where did this request's 40 ms go" is a
zoomable timeline, not a log-grep.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Callable, NamedTuple

import torch


class Span(NamedTuple):
    """One timed phase. ``ts``/``dur`` are seconds on the tracer's clock;
    ``track`` names the Perfetto row the span renders on (``"engine"``,
    ``"req-17"``, ``"host-fetch"``, …)."""

    name: str
    cat: str
    track: str
    ts: float
    dur: float
    args: dict


class _NullSpan:
    """Shared no-op context manager returned by a disabled tracer."""

    __slots__ = ()
    recording = False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def note(self, **args):
        """Arguments known only inside the span; dropped here."""


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe span collector over a bounded ring buffer.

    ``capacity`` bounds retained spans (oldest dropped, ``dropped``
    counts them). ``enabled`` can be toggled at runtime; emission points
    are expected to guard on it so a disabled tracer costs one attribute
    read. ``clock`` must be monotonic; it is injected for testability
    and for timebase coherence with the serving engine's own clock.
    """

    def __init__(
        self,
        *,
        capacity: int = 65536,
        enabled: bool = True,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._clock = clock
        self._lock = threading.Lock()
        self._spans: collections.deque[Span] = collections.deque(
            maxlen=capacity
        )
        self._capacity = capacity
        self._dropped = 0
        self.enabled = bool(enabled)

    # -------------------------------------------------------------- recording
    def now(self) -> float:
        """The tracer's clock — for callers stamping spans themselves."""
        return self._clock()

    def span(self, name: str, *, cat: str = "", track: str = "main",
             **args: Any):
        """Context manager timing one span into this tracer: the
        program's emission point :func:`span` with this tracer attached."""
        return span(self, name, cat=cat, track=track, **args)

    def add(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        cat: str = "",
        track: str = "main",
        args: dict | None = None,
    ) -> None:
        """Record a span from caller-supplied timestamps (same timebase as
        the tracer's clock). No-op when disabled."""
        if not self.enabled:
            return
        span = Span(
            name=name, cat=cat, track=track,
            ts=float(t0), dur=max(0.0, float(t1) - float(t0)),
            args=args or {},
        )
        with self._lock:
            if len(self._spans) == self._capacity:
                self._dropped += 1
            self._spans.append(span)

    def instant(self, name: str, *, cat: str = "", track: str = "main",
                **args: Any) -> None:
        """Record a zero-duration marker at the current clock reading."""
        if not self.enabled:
            return
        t = self._clock()
        self.add(name, t, t, cat=cat, track=track, args=args)

    # -------------------------------------------------------------- querying
    def spans(self) -> list[Span]:
        """Snapshot of retained spans, in recording order."""
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    @property
    def dropped(self) -> int:
        """Spans evicted by the ring buffer since the last ``clear``."""
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    # --------------------------------------------------------------- export
    def to_chrome_json(self) -> str:
        """Chrome ``trace_event`` JSON (Perfetto / chrome://tracing).

        Each distinct ``track`` becomes one tid (named via thread-name
        metadata events); timestamps are microseconds relative to the
        earliest retained span, so a trace started hours into a process
        still opens at t=0."""
        spans = sorted(self.spans(), key=lambda s: s.ts)
        t0 = spans[0].ts if spans else 0.0
        tids: dict[str, int] = {}
        events: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": 1,
             "args": {"name": "repro-serve"}},
        ]
        body: list[dict] = []
        for s in spans:
            tid = tids.get(s.track)
            if tid is None:
                tid = len(tids) + 1
                tids[s.track] = tid
                events.append(
                    {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                     "args": {"name": s.track}}
                )
            body.append(
                {
                    "name": s.name,
                    "cat": s.cat or "default",
                    "ph": "X",
                    "pid": 1,
                    "tid": tid,
                    "ts": round((s.ts - t0) * 1e6, 3),
                    "dur": round(s.dur * 1e6, 3),
                    "args": s.args,
                }
            )
        return json.dumps(
            {"traceEvents": events + body, "displayTimeUnit": "ms"}
        )

    def save(self, path: str) -> None:
        """Write :meth:`to_chrome_json` to ``path``."""
        with open(path, "w") as f:
            f.write(self.to_chrome_json())

    def __repr__(self) -> str:
        return (
            f"Tracer(spans={len(self)}, capacity={self._capacity}, "
            f"enabled={self.enabled})"
        )


# A process-wide disabled tracer for call sites that want an always-valid
# tracer object rather than Optional handling. Never records anything.
NULL_TRACER = Tracer(capacity=1, enabled=False)


class ProfilerTracer(Tracer):
    """The tracer of spans taken while ``torch.profiler`` records.

    Its clock is the realtime clock (``time.time_ns``) that the profiler's
    kineto events carry, read as seconds since ``base_ns`` so that a span's
    float stamps keep nanosecond resolution: ``epoch_ns(span.ts)`` puts a
    span on a profile's timeline."""

    def __init__(self, *, capacity: int = 65536):
        base = time.time_ns()
        super().__init__(capacity=capacity,
                         clock=lambda: (time.time_ns() - base) * 1e-9)
        self.base_ns = base

    def epoch_ns(self, t: float) -> int:
        """A stamp of this tracer as Unix-epoch nanoseconds."""
        return self.base_ns + round(t * 1e9)


# The program's spans taken while torch's profiler records, whatever tracer
# their site has attached; bounded like any tracer.
PROFILED = ProfilerTracer()

_profiler_enabled = torch._C._autograd._profiler_enabled


class _ProgramSpan:
    """A span of the program: recorded into its site's tracer, if one is on,
    and while the profiler records, opened as a ``record_function`` and
    recorded into :data:`PROFILED`."""

    __slots__ = ("_tracer", "_name", "_cat", "_track", "args", "_rf", "_t0",
                 "_p0")
    recording = True        # ``note`` keeps its arguments: worth computing

    def __init__(self, tracer, name, cat, track, args, profiling):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._track = track
        self.args = args
        self._rf = torch.profiler.record_function(name) if profiling else None

    def __enter__(self):
        if self._rf is not None:
            self._rf.__enter__()
            self._p0 = PROFILED.now()
        if self._tracer is not None:
            self._t0 = self._tracer.now()
        return self

    def note(self, **args):
        """Add arguments known only inside the span."""
        self.args.update(args)

    def __exit__(self, exc_type, exc, tb):
        if self._tracer is not None:
            self._tracer.add(self._name, self._t0, self._tracer.now(),
                             cat=self._cat, track=self._track, args=self.args)
        if self._rf is not None:
            PROFILED.add(self._name, self._p0, PROFILED.now(), cat=self._cat,
                         track=self._track, args=self.args)
            self._rf.__exit__(exc_type, exc, tb)
        return False


def span(tracer, name: str, *, cat: str = "", track: str = "main",
         **args: Any):
    """The program's emission point: a context manager timing one span.

    ``tracer`` is the site's attached tracer (duck-typed: ``enabled``,
    ``now()``, ``add(...)``) or None. With it off and the profiler not
    recording, this is two checks and the shared no-op span. The span's
    ``note(**args)`` adds arguments known only inside it; its
    ``recording`` is False on the no-op span, so a site can skip work
    that only an argument needs."""
    on = tracer is not None and tracer.enabled
    profiling = _profiler_enabled()
    if not (on or profiling):
        return _NULL_SPAN
    return _ProgramSpan(tracer if on else None, name, cat, track, args,
                        profiling)
