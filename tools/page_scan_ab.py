#!/usr/bin/env python3
"""Two builds of the page-scan kernel on one card: same bits, and times.

    git show <rev>:src/repro_torch/kernels/csrc/page_scan.cu > build/ab/base.cu
    python3 tools/page_scan_ab.py --base build/ab/base.cu

``--base`` is a ``page_scan.cu`` whose C entry ``pageann_page_scan`` takes
the same launch plan as the current one; it is launched with the current
ADC plan and, members only, with one 128-thread block per (query, page)
that stages the query and the member rows in shared memory (grid Q * b,
(d + member rows x 128) x 4 bytes, one page a block and a chunk), the plan
of the block-per-page members kernel. Each ``--alt NAME=SRC`` is a variant
of the current source, launched with the current plan. They are compiled
with ``nvcc`` into ``build/page_scan_ab/``; the repository's kernels are
built as usual. For each of the eight variants (ADC or members only, masked
or not, by page id or staged) at the main path's HYBRID/MEM_ALL shapes
(d = 128, b = 5) with Q = 1,000 and Q = 64, and at SIFT1M size (1,000,000
vectors of pages, Q = 1,024), the script

  - requires the two kernels' member and neighbour scores to be equal
    (``torch.equal``), and exits 1 if any differ;
  - times base, new, new, base (CUDA events behind a sleep kernel, as
    ``chip_smoke.py`` times), and the new kernel under other launch plans
    (pages per block, threads).

Then, where ``cuobjdump`` is found, the SASS instructions of each page-scan
kernel of the base and the new build. One JSON line per measurement on
standard output, then the card's name and power limit from
``nvidia-smi``. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "page_scan_ab"

# the new kernel under other plans: (label, launch_plan overrides)
PLANS = {
    "adc": [("per (query, page)", dict(pages_per_block=1)),
            ("2 pages a block", dict(pages_per_block=2)),
            ("one block a query", dict(pages_per_block=64)),
            ("128 threads", dict(threads=128))],
    "members": [("1 warp a block", dict(threads=32)),
                ("2 warps a block", dict(threads=64)),
                ("4 warps a block", dict(threads=128)),
                ("8 warps a block", dict(threads=256))],
}


def build(src: Path, name: str) -> tuple[ctypes.CDLL, Path]:
    """``src`` compiled alone with the port's nvcc flags and loaded; the
    compiler's output (registers and spills a kernel) goes beside the
    library as ``.log``."""
    from repro_torch.kernels import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib = OUT_DIR / f"libpage_scan_{name}.so"
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-o", str(lib), str(src)], check=True,
                          capture_output=True, text=True)
    Path(str(lib) + ".log").write_text(done.stdout + done.stderr)
    dll = ctypes.CDLL(str(lib))
    dll.pageann_page_scan.argtypes = _build._SIGNATURES["pageann_page_scan"]
    dll.pageann_page_scan.restype = ctypes.c_int
    return dll, lib


def sass_counts(lib: Path) -> dict:
    """SASS instructions of each page-scan kernel in ``lib`` (demangled
    name -> count), from ``cuobjdump -sass``; empty without cuobjdump."""
    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).with_name("cuobjdump"))
    if not Path(tool).is_file():
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name] += 1
    filt = Path(tool).with_name("cu++filt")
    if filt.is_file() and counts:
        names = subprocess.run([str(filt)], input="\n".join(counts),
                               capture_output=True, text=True).stdout.split("\n")
        counts = dict(zip(names, counts.values()))
    return {n: c for n, c in counts.items() if "page_scan" in n}


def base_plan(nq, b, *, cap, dim, rp, m, k, adc):
    """The base kernel's plan: the current one with ADC; members only, one
    128-thread block per (query, page) staging the query and the member
    rows."""
    from repro_torch.kernels import page_scan as page_scan_k
    from repro_torch.kernels import record_layout as rl

    if adc:
        return page_scan_k.launch_plan(nq, b, capacity=cap, dim=dim, rp=rp,
                                       m=m, k=k, compute_adc=True)
    return page_scan_k.LaunchPlan(
        grid=nq * b, threads=128,
        smem_bytes=(dim + rl.member_rows(cap, dim) * rl.PAGE_LANES) * 4,
        pages_per_block=1, pages_per_chunk=1)


def base_scan(dll, recs, ids, q, lut, mask, *, cap, dim, rp, adc, staged):
    """The base kernel: the same inputs and outputs as ``page_scan``."""
    import torch

    from repro_torch.kernels import record_layout as rl

    nq, b = ids.shape
    md = torch.empty((nq, b, cap), device=q.device)
    nd = torch.empty((nq, b, rp), device=q.device) if adc else None
    m, k = lut.shape[1:] if adc else (0, 0)
    plan = base_plan(nq, b, cap=cap, dim=dim, rp=rp, m=m, k=k, adc=adc)
    rc = dll.pageann_page_scan(
        recs.data_ptr(), None if staged else ids.data_ptr(), q.data_ptr(),
        lut.data_ptr() if adc else None,
        mask.data_ptr() if mask is not None else None, md.data_ptr(),
        nd.data_ptr() if adc else None, nq, b,
        nq * b if staged else recs.shape[0], recs.shape[-2],
        rl.member_rows(cap, dim), m, k, cap, dim, rp, int(adc), int(staged),
        *plan, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"base kernel launch failed: cudaError {rc}")
    return md, nd


def compare(smoke, dll, alts, recs, ids, q, lut, *, cap, dim, rp, adc, label,
            reps) -> bool:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import page_scan as page_scan_k

    def with_library(lib, fn):
        """``fn`` with the wrappers launching from ``lib``'s kernel."""
        def run():
            library = _build.library
            _build.library = lambda: lib
            try:
                return fn()
            finally:
                _build.library = library
        return run

    nq, b = ids.shape
    gen = torch.Generator(device=q.device).manual_seed(1)
    mask = (torch.rand((nq, b, cap), generator=gen, device=q.device)
            < 0.5).float()
    recs_b = recs[ids.long()].contiguous()
    lut_k = lut if adc else None
    ok = True
    for masked in (False, True):
        for staged in (False, True):
            mk = mask if masked else None
            src = recs_b if staged else recs
            kw = dict(capacity=cap, dim=dim, rp=rp, compute_adc=adc,
                      member_mask=mk)

            def new():
                if staged:
                    return page_scan_k.page_scan_recs(recs_b, q, lut_k, **kw)
                return page_scan_k.page_scan(recs, ids, q, lut_k, **kw)

            def base():
                return base_scan(dll, src, ids, q, lut, mk, cap=cap, dim=dim,
                                 rp=rp, adc=adc, staged=staged)

            def same(x, y):
                return torch.equal(x[0], y[0]) and (
                    not adc or torch.equal(x[1], y[1]))

            got = new()
            equal = same(got, base())
            alt_runs = {n: with_library(lib, new) for n, lib in alts.items()}
            alts_equal = all(same(got, run()) for run in alt_runs.values())
            ok &= equal and alts_equal
            base_ms = [smoke.time_ms(base, reps)]
            new_ms = [smoke.time_ms(new, reps)]
            alts_ms = {n: [smoke.time_ms(run, reps)] for n, run in alt_runs.items()}
            for n, run in reversed(alt_runs.items()):
                alts_ms[n].append(smoke.time_ms(run, reps))
            new_ms.append(smoke.time_ms(new, reps))
            base_ms.append(smoke.time_ms(base, reps))
            name = ("page_scan" + ("_recs" if staged else "")
                    + ("" if adc else "_members") + ("_masked" if masked else ""))
            row = dict(shape=label, name=name, q=nq, b=b, equal=equal,
                       base_ms=base_ms, new_ms=new_ms,
                       speedup=(sum(base_ms) / sum(new_ms)))
            if alts:
                row.update(alts_equal=alts_equal, alts_ms=alts_ms)
            if not masked:
                plan = page_scan_k.launch_plan
                plans_ms = {}
                for alt, override in PLANS["adc" if adc else "members"]:
                    page_scan_k.launch_plan = (
                        lambda *a, _o=override, **k_: plan(*a, **k_, **_o))
                    try:
                        plans_ms[alt] = smoke.time_ms(new, reps)
                    finally:
                        page_scan_k.launch_plan = plan
                row["plans_ms"] = plans_ms
            print(json.dumps(row), flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, required=True,
                    help="a page_scan.cu with the current C entry, run "
                         "with the block-per-page members plan")
    ap.add_argument("--alt", action="append", default=[],
                    metavar="NAME=SRC",
                    help="also time a page_scan.cu with the current C entry "
                         "(repeatable); it must give the same bits")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("page_scan_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np

    import chip_smoke as cs
    from repro_torch.core import MemoryMode, PageANNConfig
    from repro_torch.kernels import _build

    _build.library()
    dll, base_lib = build(args.base, "base")
    alts, libs = {}, {"base": base_lib, "new": _build.library_path()}
    for spec in args.alt:
        name, src = spec.split("=", 1)
        alts[name], libs[name] = build(Path(src), name)
    smoke = cs.Smoke(torch, args.seed)
    dev = torch.device("cuda")
    ok = True
    rng = np.random.default_rng(args.seed)
    for mode, adc in ((MemoryMode.HYBRID, True), (MemoryMode.MEM_ALL, False)):
        cfg = PageANNConfig(dim=128, build_rounds=1, memory_mode=mode)
        cap, rows, mrows, m = cs._geometry(cfg)
        b, rp = cfg.io_batch, cfg.page_degree
        # the main path: 10,000 vectors of pages
        pages = -(-10_000 // cap)
        recs = torch.as_tensor(cs._records_np(rng, pages, cap, 128, rp, m)).to(dev)
        ids = torch.as_tensor(rng.integers(0, pages, (1000, b)).astype(np.int32)).to(dev)
        q = torch.as_tensor(rng.standard_normal((1000, 128)).astype(np.float32)).to(dev)
        lut = torch.as_tensor(rng.random((1000, max(m, 1), 256)).astype(np.float32)).to(dev)
        for nq in (1000, 64):
            ok &= compare(smoke, dll, alts, recs, ids[:nq], q[:nq], lut[:nq], cap=cap,
                          dim=128, rp=rp, adc=adc, label="main", reps=50)
        # SIFT1M size, made on the card as chip_smoke's sift1m phase does
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        pages = -(-1_000_000 // cap)
        recs = torch.zeros((pages, rows, 128), device=dev)
        recs[:, :mrows] = torch.randn((pages, mrows, 128), generator=gen, device=dev)
        if m:
            recs[:, mrows:mrows + m, :rp] = torch.randint(
                0, 256, (pages, m, rp), generator=gen, device=dev).float()
        ids = torch.randint(0, pages, (1024, b), generator=gen, device=dev,
                            dtype=torch.int32)
        q = torch.randn((1024, 128), generator=gen, device=dev)
        lut = torch.rand((1024, max(m, 1), 256), generator=gen, device=dev)
        ok &= compare(smoke, dll, alts, recs, ids, q, lut, cap=cap, dim=128, rp=rp,
                      adc=adc, label="sift1m", reps=20)
        del recs
        torch.cuda.empty_cache()
    for label, lib in libs.items():
        print(json.dumps(dict(sass=label, instructions=sass_counts(lib))),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if not ok:
        print("page_scan_ab: the two kernels' scores differ", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
