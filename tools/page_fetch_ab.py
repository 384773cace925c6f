#!/usr/bin/env python3
"""The streamed tier's page read, compiled routine against the plain loop,
on the host at the ``bigann-budget25.batch1k`` cell's shapes.

    PYTHONPATH=src python3 tools/page_fetch_ab.py [--seed N]

Writes a page file of 5,001 records of 24 x 128 float32 (12,288 B, the
cell's streamed pages) under ``build/page_fetch_ab/`` (deleted after; read
warm from the page cache), then for 40 calls of 3,000 page ids drawn
uniformly from it (about one streamed hop of the cell) with a 256-page
staging cache, into a pinned buffer where a CUDA device is present:

  - holds ``PageFetcher.read`` (the compiled routine) to
    ``PageFetcher.read(..., impl="plain")`` (the Python loop): records equal
    bit for bit and the same misses and hits every call, else exits 1;
  - times plain, native, native, plain (host clock, median ms a call), and
    a contiguous copy of the same bytes from the page file's mapping into
    the same buffer (the least of 40): the layer's bound, the host's
    memory-copy speed;
  - reports each path's share of that bound.

One JSON line per timing, then a summary line, the host's CPU model, and
the card's name and power limit from ``nvidia-smi`` where there is one.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PAGES, ROWS, LANES = 5001, 24, 128
IDS_PER_CALL, CALLS, STAGE = 3000, 40, 256


def cpu_model() -> str:
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        if line.startswith("model name"):
            return line.split(":", 1)[1].strip()
    return "unknown"


def time_calls(fetcher, calls, buf, impl) -> list[float]:
    """Per-call host seconds of reading every id array in ``calls``."""
    out = []
    for ids in calls:
        t0 = time.perf_counter()
        fetcher.read(ids, out=buf, impl=impl)
        out.append(time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src")]
    import torch

    from repro_torch.core.stream import PageFetcher
    from repro_torch.kernels import _build

    _, build_s = _build.build_host()
    if _build.host_library() is None:
        print("page_fetch_ab: no C++ compiler on this host", file=sys.stderr)
        return 2
    pinned = torch.cuda.is_available()
    rng = np.random.default_rng(args.seed)
    work = ROOT / "build" / "page_fetch_ab"
    work.mkdir(parents=True, exist_ok=True)
    path = work / "pages.bin"
    try:
        rng.standard_normal((PAGES, ROWS, LANES), np.float32).tofile(path)
        recs = np.memmap(path, np.float32, "r", shape=(PAGES, ROWS, LANES))
        buf = torch.empty((IDS_PER_CALL, ROWS, LANES), dtype=torch.float32,
                          pin_memory=pinned).numpy()
        calls = [rng.integers(0, PAGES, IDS_PER_CALL) for _ in range(CALLS)]

        # agreement, call after call, on one staging cache each
        native, plain = PageFetcher(recs, stage_pages=STAGE), PageFetcher(
            recs, stage_pages=STAGE)
        ref = np.empty_like(buf)
        agree = True
        for ids in calls:
            _, m_n = native.read(ids, out=buf)
            _, m_p = plain.read(ids, out=ref, impl="plain")
            agree &= bool(np.array_equal(buf, ref)) and m_n == m_p
        agree &= (native.fetch_stats()["fetch_hits"]
                  == plain.fetch_stats()["fetch_hits"])

        nbytes = IDS_PER_CALL * ROWS * LANES * 4
        copy_s = []
        for _ in range(CALLS):
            t0 = time.perf_counter()
            np.copyto(buf, recs[:IDS_PER_CALL])
            copy_s.append(time.perf_counter() - t0)
        bound_ms = min(copy_s) * 1e3
        medians = {"plain": [], "native": []}
        for label in ("plain", "native", "native", "plain"):
            f = PageFetcher(recs, stage_pages=STAGE)
            secs = time_calls(f, calls, buf,
                              "plain" if label == "plain" else None)
            ms = float(np.median(secs)) * 1e3
            medians[label].append(ms)
            fs = f.fetch_stats()
            print(json.dumps(dict(
                path=label, ms_per_call=ms, min_ms=min(secs) * 1e3,
                max_ms=max(secs) * 1e3, bound_share=bound_ms / ms,
                misses=fs["pages_fetched"], hits=fs["fetch_hits"])),
                flush=True)
        best = {k: min(v) for k, v in medians.items()}
        print(json.dumps(dict(
            pages=PAGES, record_bytes=ROWS * LANES * 4,
            ids_per_call=IDS_PER_CALL, calls=CALLS, stage_pages=STAGE,
            pinned=pinned, bytes_per_call=nbytes, copy_ms=bound_ms,
            copy_gb_s=nbytes / bound_ms / 1e6, agree=agree,
            plain_ms=medians["plain"], native_ms=medians["native"],
            speedup=best["plain"] / best["native"],
            native_bound_share=bound_ms / best["native"],
            host_build_s=build_s)), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(cpu_model(), flush=True)
    if shutil.which("nvidia-smi"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    if not agree:
        print("page_fetch_ab: the compiled routine and the plain loop differ",
              file=sys.stderr)
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
