"""The program's own spans in a traced run, laid over the device trace.

While ``torch.profiler`` records, the search emits its phases as spans
(``repro_torch.obs.trace.span``) into the process-wide tracer
``repro_torch.obs.trace.PROFILED``, stamped on the realtime clock that the
profile's events carry. ``trace.py`` keeps no host events in the record a
reader gets, so the readers of ``metrics/`` that split the card's idle time
by phase read the spans from that tracer, in the run's own process: this is
the one module of the yardstick that reads the program's state. It imports
nothing of the program (``system.py`` alone does): it looks the module up
among those the run has loaded. A program without that tracer (one older
than it) gives no spans, and its readers None.

The spans, on the track ``search``: ``pageann.search`` (one
``PageANNIndex.search``), inside it ``pageann.upload``, ``pageann.start``,
``pageann.hop`` (one loop iteration, with its ``hop`` index and active
``lanes``; its children ``pageann.hop.sync``, ``.select``, ``.score``,
``.merge``) and ``pageann.download``.
"""
from __future__ import annotations

import bisect
import sys
from typing import NamedTuple

from portbench import trace

PREFIX = "pageann."
PROGRAM_TRACE = "repro_torch.obs.trace"     # the module holding PROFILED


class Interval(NamedTuple):
    """One program span on the device trace's clock (seconds since the
    Unix epoch, to the resolution of a float there); ``dur`` is the span's
    length as its tracer measured it."""

    name: str
    start: float
    end: float
    dur: float
    args: dict


def program_spans(record) -> list[Interval]:
    """The process tracer's ``pageann.*`` spans that overlap the traced
    window's device events, in start order; [] when the window has none or
    the program keeps no such tracer."""
    tracer = getattr(sys.modules.get(PROGRAM_TRACE), "PROFILED", None)
    kernels = record["trace"]["kernels"]
    if tracer is None or not kernels:
        return []
    lo = min(s for _, s, _ in kernels)
    hi = max(e for _, _, e in kernels)
    out = []
    for s in tracer.spans():
        if not s.name.startswith(PREFIX):
            continue
        t0 = tracer.epoch_ns(s.ts) * 1e-9
        t1 = t0 + s.dur
        if t1 > lo and t0 < hi:
            out.append(Interval(s.name, t0, t1, s.dur, s.args))
    return sorted(out, key=lambda i: i.start)


def named(spans, name: str) -> list[Interval]:
    return [s for s in spans if s.name == name]


def split(spans, kernels) -> float:
    """Seconds of the union of ``spans`` ((start, end) pairs) in which the
    device ran nothing: no interval of ``kernels`` ((name, start, end), as
    the record's ``trace.kernels``) covered it."""
    busy = trace._union([(s, e) for _, s, e in kernels])
    ends = [e for _, e in busy]
    idle = 0.0
    for s0, s1 in trace._union([(s, e) for s, e in spans]):
        idle += s1 - s0
        i = bisect.bisect_right(ends, s0)
        while i < len(busy) and busy[i][0] < s1:
            idle -= min(s1, busy[i][1]) - max(s0, busy[i][0])
            i += 1
    return idle


def hop_parts(spans) -> list[tuple[Interval, Interval]]:
    """Each ``pageann.hop`` that hopped (``lanes`` > 0) with the
    ``pageann.hop.sync`` inside it."""
    syncs = named(spans, "pageann.hop.sync")
    starts = [s.start for s in syncs]
    out = []
    for hop in named(spans, "pageann.hop"):
        if not hop.args.get("lanes"):
            continue
        i = bisect.bisect_left(starts, hop.start)
        if i < len(syncs) and syncs[i].end <= hop.end:
            out.append((hop, syncs[i]))
    return out


def idle_share(record, outer: str, inner: str | None = None):
    """Idle share (%) of the traced window while the host is inside an
    ``outer`` span and outside every ``inner`` one; None when the window
    had no device activity or no program span."""
    s = record["trace"]
    if s["busy_s"] <= 0 or s["window_s"] <= 0:
        return None
    spans = program_spans(record)
    if not spans:
        return None

    def idle(name):
        return split([(i.start, i.end) for i in named(spans, name)],
                     s["kernels"])

    seconds = idle(outer) - (idle(inner) if inner is not None else 0.0)
    return 100.0 * seconds / s["window_s"]
