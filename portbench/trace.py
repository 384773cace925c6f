"""The traced run's device trace, read from ``torch.profiler``.

The benchmark profiles a few batches of the window (CPU and CUDA
activities) with a ``portbench.batch`` span around each, and reads the
profiler's raw (kineto) events: ``prof.events()`` would build an event tree
over every host op, which takes tens of seconds for this many launches.

From the events it derives what the per-layer readers and the result's
``device`` and ``breakdown`` need: the traced window (first span's start to
last span's end), the device's busy time (the union of every kernel, copy
and fill on the card inside it), device time by name, and the idle gaps,
each put down to the innermost host event running at its midpoint.
"""
from __future__ import annotations

import bisect
import collections

SPAN = "portbench.batch"
NAME_CHARS = 120        # of a name in the breakdown (kernel signatures run long)


def _device_type():
    from torch.autograd import DeviceType

    return DeviceType


def _on_device(e) -> bool:
    """Whether a device-side event is work on the card (a kernel, copy or
    fill), not the annotation the profiler mirrors from a host span: that
    one covers the whole span and would read the card as always busy."""
    note = getattr(e, "is_user_annotation", None)
    return not (note() if note is not None else e.name() == SPAN)


def read_events(prof) -> dict:
    """Host and device events of a finished profile as plain tuples
    (name, start s, end s)."""
    dt = _device_type()
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        item = (e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
        if e.device_type() == dt.CUDA:
            if _on_device(e):
                device.append(item)
        elif e.device_type() == dt.CPU:
            host.append(item)
    return summarize(host, device)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(host, device) -> dict:
    """The window, busy time, device time by name and idle gaps by host
    activity, from (name, start, end) events in seconds."""
    spans = [(s, e) for n, s, e in host if n == SPAN]
    if not spans:
        return dict(window_s=0.0, busy_s=0.0, device_by_name={},
                    idle_by_host={}, kernels=[])
    w0, w1 = min(s for s, _ in spans), max(e for _, e in spans)
    kernels = [(n, max(s, w0), min(e, w1)) for n, s, e in device
               if e > w0 and s < w1]
    by_name = collections.defaultdict(float)
    for n, s, e in kernels:
        by_name[n] += e - s
    busy = _union([(s, e) for _, s, e in kernels])
    busy_s = sum(e - s for s, e in busy)

    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    inner = sorted((s, e, n) for n, s, e in host if n != SPAN)
    starts = [s for s, _, _ in inner]
    idle = collections.defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        name = "host outside any op"
        i = bisect.bisect_right(starts, mid) - 1
        # walk back over the events that started before the midpoint; the
        # innermost one still running is the latest to have started
        for j in range(i, max(-1, i - 64), -1):
            if inner[j][1] >= mid:
                name = inner[j][2]
                break
        idle[name] += g1 - g0
    return dict(window_s=w1 - w0, busy_s=busy_s, device_by_name=dict(by_name),
                idle_by_host=dict(idle), kernels=kernels)


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    time by what the host was doing, each [name, seconds]."""
    def head(d):
        return [[n[:NAME_CHARS], s] for n, s in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return dict(device_ops=head(summary["device_by_name"]),
                idle_gaps=head(summary["idle_by_host"]))


def device_seconds(summary: dict, names) -> float:
    """Device time inside the window of every kernel whose name holds one
    of ``names``."""
    return sum(s for n, s in summary["device_by_name"].items()
               if any(part in n for part in names))
