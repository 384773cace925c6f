#!/usr/bin/env python3
"""The ``pq_lut`` kernel against its plain version on one card: agreement,
device time, bound and memory.

    PYTHONPATH=src python3 tools/pq_lut_ab.py [--seed N]

At the shapes the search builds its tables at, one (Q, M, K, dsub) table at
a time: both tables of the benchmark's two configurations at a batch of
10,000 queries (d = 128: M = 16 and 32; d = 192: M = 16 and 32), the
chip smoke's 1,000 queries at d = 128, and the RAG path's d = 2048 (M = 16
and 32) at 1,000 queries. For each it

  - holds ``ops.pq_lut`` to ``ops.pq_lut(..., impl="plain")`` (rtol = atol
    = 1e-5) and exits 1 if they differ by more;
  - times plain, kernel, kernel, plain (CUDA events behind a sleep kernel,
    ``chip_smoke.Smoke.time_ms``), with the tables' bound: the queries,
    the codebooks and the tables moved once over 3.35 TB/s, or 3 Q K d
    operations over 67 TFLOP/s, whichever is longer
    (``repro_torch.launch.roofline.kernel_bound``);
  - reads the device memory each route allocates for one call
    (``torch.cuda.max_memory_allocated`` over the live bytes before it);
  - counts the launches of one kernel call.

Then the kernel's registers and spills from the library's ``-Xptxas -v``
log. One JSON line per shape on standard output, then the card's name and
power limit from ``nvidia-smi``. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (label, queries, d, M): the benchmark's tables, the smoke's, the RAG path's
SHAPES = [
    ("bigann.disk", 10_000, 128, 16), ("bigann.mem", 10_000, 128, 32),
    ("yfcc.disk", 10_000, 192, 16), ("yfcc.mem", 10_000, 192, 32),
    ("smoke.disk", 1000, 128, 16), ("smoke.mem", 1000, 128, 32),
    ("rag.m16", 1000, 2048, 16), ("rag.m32", 1000, 2048, 32),
]
K = 256


def peak_bytes(torch, fn) -> int:
    """Device bytes ``fn`` allocates at its peak, over what was live."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - base
    del out
    return grew


def case(smoke, label: str, nq: int, d: int, m: int, gen) -> bool:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.pq_lut import launch_plan
    from repro_torch.launch.roofline import kernel_bound, pq_lut_counts

    q = torch.randn((nq, d), generator=gen, device="cuda")
    books = torch.randn((m, K, d // m), generator=gen, device="cuda")
    before = ops.launch_counts()["pq_lut"]
    got = ops.pq_lut(q, books)
    launches = ops.launch_counts()["pq_lut"] - before
    want = ops.pq_lut(q, books, impl="plain")
    err = (got - want).abs()
    ok = bool((err <= 1e-5 + 1e-5 * want.abs()).all())
    del got, want
    plain_ms, kernel_ms = [smoke.time_ms(
        lambda: ops.pq_lut(q, books, impl="plain"), 5)], []
    kernel_ms += [smoke.time_ms(lambda: ops.pq_lut(q, books), 20)
                  for _ in range(2)]
    plain_ms.append(smoke.time_ms(
        lambda: ops.pq_lut(q, books, impl="plain"), 5))
    bound = kernel_bound(*pq_lut_counts(nq, m, K, d // m))
    best = min(kernel_ms)
    print(json.dumps(dict(
        shape=label, q=nq, d=d, m=m, k=K, dsub=d // m,
        plan=launch_plan(nq, m, K, d // m)._asdict(), agree=ok,
        max_abs_err=float(err.max()), launches=launches,
        kernel_ms=kernel_ms, plain_ms=plain_ms, **bound,
        bound_share=bound["bound_ms"] / best,
        kernel_peak_bytes=peak_bytes(torch, lambda: ops.pq_lut(q, books)),
        plain_peak_bytes=peak_bytes(
            torch, lambda: ops.pq_lut(q, books, impl="plain")),
        table_bytes=nq * m * K * 4)), flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("pq_lut_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    path, build_s = _build.build()
    _build.library()
    smoke = cs.Smoke(torch, args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    ok = True
    for label, nq, d, m in SHAPES:
        ok &= case(smoke, label, nq, d, m, gen)
        torch.cuda.empty_cache()
    log = Path(str(path) + ".log").read_text()
    start = log.find("== pq_lut.cu")
    print(json.dumps(dict(build_s=build_s, ptxas=[
        line.strip() for line in log[start:].splitlines()[1:]
        if "pq_lut" in line or "registers" in line or "spill" in line][:8])),
        flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if not ok:
        print("pq_lut_ab: the kernel and the plain version differ",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
