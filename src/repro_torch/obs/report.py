"""Render a captured trace or search profile as a phase breakdown.

Port of ``repro.obs.report``. ``python -m repro_torch.obs.report
FILE.json`` sniffs the payload:

  * a Chrome ``trace_event`` capture (``Tracer.save`` /
    ``to_chrome_json``) renders per-phase aggregates — count, total /
    mean / p95 / max wall — grouped by span name, plus a per-track
    summary, answering "where did the wall time go" without opening
    Perfetto;
  * a search profile (``PageANNIndex.profile(..., save=...)``) renders
    the per-hop trail — pages scheduled, disk IOs vs cache hits, the
    shrinking worst-of-top-k frontier and the adaptive stall counter —
    per query, answering "why was THIS query slow".

The render functions are importable (``render_trace`` /
``render_profile``) so tests and notebooks can format in-memory captures
without the filesystem round-trip.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _quantile(vals: list[float], q: float) -> float:
    return float(np.quantile(np.asarray(vals, np.float64), q)) if vals else 0.0


def render_trace(payload: dict, *, top: int = 30) -> str:
    """Phase breakdown of a Chrome ``trace_event`` payload."""
    events = [
        e for e in payload.get("traceEvents", ())
        if e.get("ph") == "X"
    ]
    tid_names = {
        e.get("tid"): e["args"]["name"]
        for e in payload.get("traceEvents", ())
        if e.get("ph") == "M" and e.get("name") == "thread_name"
    }
    if not events:
        return "trace: no complete events\n"
    by_name: dict[str, list[float]] = {}
    by_track: dict[str, list[float]] = {}
    t_lo = min(e["ts"] for e in events)
    t_hi = max(e["ts"] + e.get("dur", 0.0) for e in events)
    for e in events:
        dur = float(e.get("dur", 0.0))
        by_name.setdefault(e["name"], []).append(dur)
        track = tid_names.get(e.get("tid"), f"tid-{e.get('tid')}")
        by_track.setdefault(track, []).append(dur)

    lines = [
        f"trace: {len(events)} spans over {(t_hi - t_lo) / 1e3:.3f} ms "
        f"wall, {len(by_name)} phases, {len(by_track)} tracks",
        "",
        f"{'phase':<28} {'count':>7} {'total_ms':>10} {'mean_us':>10} "
        f"{'p95_us':>10} {'max_us':>10}",
    ]
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for name, durs in ranked[:top]:
        lines.append(
            f"{name[:28]:<28} {len(durs):>7} {sum(durs) / 1e3:>10.3f} "
            f"{sum(durs) / len(durs):>10.1f} "
            f"{_quantile(durs, 0.95):>10.1f} {max(durs):>10.1f}"
        )
    if len(ranked) > top:
        lines.append(f"... {len(ranked) - top} more phases")
    lines += ["", f"{'track':<28} {'spans':>7} {'total_ms':>10}"]
    for track, durs in sorted(by_track.items(), key=lambda kv: -sum(kv[1])):
        lines.append(
            f"{track[:28]:<28} {len(durs):>7} {sum(durs) / 1e3:>10.3f}"
        )
    return "\n".join(lines) + "\n"


def profile_to_dict(result, profile) -> dict:
    """JSON-able dump of (``SearchResult``, ``HopProfile``) from
    ``core.search.profile_search`` — the on-disk profile format."""
    return {
        "kind": "pageann_profile",
        "ids": np.asarray(result.ids).tolist(),
        "dists": np.asarray(result.dists, np.float64).tolist(),
        "ios": np.asarray(result.ios).tolist(),
        "hops": np.asarray(result.hops).tolist(),
        "cache_hits": np.asarray(result.cache_hits).tolist(),
        "hop_pages": np.asarray(profile.pages).tolist(),
        "hop_ios": np.asarray(profile.ios).tolist(),
        "hop_cache_hits": np.asarray(profile.cache_hits).tolist(),
        "hop_active": np.asarray(profile.active).astype(bool).tolist(),
        "hop_worst_topk": np.asarray(
            profile.worst_topk, np.float64
        ).tolist(),
        "hop_stall": np.asarray(profile.stall).tolist(),
    }


def render_profile(payload: dict, *, queries: int | None = None) -> str:
    """Per-hop trail of a saved search profile, one block per query."""
    active = payload["hop_active"]
    nq = len(active)
    shown = nq if queries is None else min(queries, nq)
    lines = [f"profile: {nq} queries" +
             (f" (showing {shown})" if shown < nq else "")]
    for qi in range(shown):
        hops = int(payload["hops"][qi])
        lines += [
            "",
            f"query {qi}: hops={hops} ios={payload['ios'][qi]} "
            f"cache_hits={payload['cache_hits'][qi]} "
            f"top1={payload['dists'][qi][0]:.4f} "
            f"(id {payload['ids'][qi][0]})",
            f"  {'hop':>3} {'ios':>4} {'hits':>4} {'stall':>5} "
            f"{'worst_topk':>12}  pages",
        ]
        for h, act in enumerate(active[qi]):
            if not act:
                continue
            pages = [p for p in payload["hop_pages"][qi][h] if p >= 0]
            worst = payload["hop_worst_topk"][qi][h]
            worst_s = f"{worst:>12.4f}" if np.isfinite(worst) else (
                f"{'inf':>12}"
            )
            lines.append(
                f"  {h:>3} {payload['hop_ios'][qi][h]:>4} "
                f"{payload['hop_cache_hits'][qi][h]:>4} "
                f"{payload['hop_stall'][qi][h]:>5} {worst_s}  "
                f"{pages}"
            )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a Chrome trace or PageANN search profile "
        "as a human-readable phase breakdown.",
    )
    ap.add_argument("file", help="trace.json (Tracer.save) or profile.json "
                    "(PageANNIndex.profile save=)")
    ap.add_argument("--queries", type=int, default=None,
                    help="profile mode: show only the first N queries")
    ap.add_argument("--top", type=int, default=30,
                    help="trace mode: show only the top N phases")
    args = ap.parse_args(argv)

    with open(args.file) as f:
        payload = json.load(f)
    if payload.get("kind") == "pageann_profile":
        sys.stdout.write(render_profile(payload, queries=args.queries))
    elif "traceEvents" in payload:
        sys.stdout.write(render_trace(payload, top=args.top))
    else:
        sys.stderr.write(
            "unrecognized payload: expected traceEvents or "
            "kind=pageann_profile\n"
        )
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
