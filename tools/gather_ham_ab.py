#!/usr/bin/env python3
"""Earlier builds of ``page_gather_l2`` and ``hamming`` against the current
ones on one card: same bits, and times.

    python3 tools/gather_ham_ab.py --extract REV   # in a git checkout
    python3 tools/gather_ham_ab.py                 # on the card

``--extract REV`` writes REV's ``csrc/page_gather.cu``, ``csrc/hamming.cu``
and ``csrc/page_scan.cu`` (``git show``) into ``build/gather_ham_ab/base/``
and exits. Without it the script compiles those sources, each alone with
the port's nvcc flags, into ``build/gather_ham_ab/`` (the compiler's
``-Xptxas -v`` output beside each library as ``.log``). The base C entries
are ``pageann_page_gather_l2(pages, ids, q, out, nq, b, P, cap, d, stream)``,
``pageann_hamming(codes, qcodes, out, nq, s, w, stream)`` and the current
``pageann_page_scan``. ``--alt NAME=SRC`` (repeatable) adds a variant of the
current ``page_gather.cu`` or ``hamming.cu`` with the current C entries,
timed beside the new build at each shape and held to its bits (a variant is
easiest made with ``sed`` from the current source into the gitignored
``build/``; a header it includes is found beside it, then in ``csrc/``).
The repository's kernels are built as usual. At each shape it

  - requires equal outputs (``torch.equal``) and exits 1 if any differ:
    ``page_gather_l2`` new against base; ``hamming`` new against base;
    ``hamming_topk`` against the base route (the base distance kernel, the
    f32 cast, a stable ``torch.sort``, the first t); the members-only
    ``page_scan`` (whose member sum moved into ``csrc/member_l2.cuh``) new
    against base;
  - times base, new, new, base (CUDA events behind a sleep kernel, as
    ``chip_smoke.py`` times).

Shapes: ``page_gather_l2`` on 1,667 pages (10,000 vectors at capacity 6,
the main path's HYBRID store) at b = 5, d = 128 and Q = 1,000 and 64, then
d = 32 and d = 200 at Q = 1,000; ``hamming`` and the fused top-T (T = 16)
over 1,024 samples of 2 words at Q = 1,000, 1,024 (the SIFT1M phase's
batch) and 64; the members-only page scan at the main path's MEM_ALL
records (capacity 7, d = 128) and HYBRID records (capacity 6, with code
rows) at Q = 1,000 and 64; the device time of a 1-element PyTorch fill
(the least one launch costs). Then each kernel's SASS instruction count
(``cuobjdump``) and registers and spills (``ptxas``) in both builds, and
whether the members-only page-scan kernels' SASS is the same instruction
for instruction. One JSON line per measurement on standard output, then a
summary of one line per shape and build (mean ms, equal bits, SASS counts,
registers and spills), then the card's name and power limit from
``nvidia-smi``. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "tools")]
import adc_l2_ab as ab  # noqa: E402  (the shared build, timing and report helpers)

OUT_DIR = ROOT / "build" / "gather_ham_ab"
BASE_DIR = OUT_DIR / "base"
CSRC = "src/repro_torch/kernels/csrc"
SOURCES = ("page_gather.cu", "hamming.cu", "page_scan.cu")
HEADERS = ("member_l2.cuh",)
_P, _I = ctypes.c_void_p, ctypes.c_int
BASE_SIGNATURES = {
    "pageann_page_gather_l2": [_P] * 4 + [_I] * 5 + [_P],
    "pageann_hamming": [_P] * 3 + [_I] * 3 + [_P],
    "pageann_page_scan": [_P] * 7 + [_I] * 17 + [_P],
}
N_PAGES, CAP, B, T = 1667, 6, 5, 16
ROWS: list[dict] = []   # every timed shape, for the closing summary


def emit(row: dict) -> None:
    """One measurement: a JSON line now, a summary line at the end."""
    ROWS.append(row)
    print(json.dumps(row), flush=True)


def _mean(ms: list) -> float:
    return sum(ms) / len(ms)


def summary() -> list[str]:
    """One line per timed shape: mean device ms of each build and whether
    the bits were equal, so the end of the output carries every number."""
    lines = []
    for r in ROWS:
        line = (f"{r['kernel']} {r['shape']} q={r['q']}: base "
                f"{_mean(r['base_ms']):.5f} new {_mean(r['new_ms']):.5f} ms")
        if "fused_topk_ms" in r:
            line += (f"; route {_mean(r['base_route_ms']):.5f} "
                     f"fused {_mean(r['fused_topk_ms']):.5f} ms")
        lines.append(f"{line}; equal {all(r['equal'].values())}")
    return lines


def extract(rev: str) -> None:
    BASE_DIR.mkdir(parents=True, exist_ok=True)
    for name in SOURCES + HEADERS:
        shown = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"],
                               cwd=ROOT, capture_output=True, text=True)
        if shown.returncode != 0 and name in HEADERS:
            continue                  # a rev from before the header
        shown.check_returncode()
        (BASE_DIR / name).write_text(shown.stdout)
        print(f"wrote {(BASE_DIR / name).relative_to(ROOT)} from {rev}")


def build_base(name: str) -> tuple[ctypes.CDLL, Path]:
    src = BASE_DIR / name
    if not src.is_file():
        raise SystemExit(f"gather_ham_ab: {src} missing; run --extract REV first")
    return ab.compile_lib(src, f"base_{Path(name).stem}", BASE_SIGNATURES,
                          out_dir=OUT_DIR)


def _stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"base {what} launch failed: cudaError {rc}")


def time_alts(smoke, alts: dict, fn, reps: int, want) -> tuple[dict, dict]:
    """``fn`` run through each variant library: equal to ``want`` (a tensor
    or a tuple of them) or not, and two times each."""
    import torch

    equal, ms = {}, {}
    for name, lib in alts.items():
        run = ab.with_library(lib, fn)
        got = run()
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        equal[name] = all(torch.equal(g, w) for g, w in pairs)
        ms[name] = [smoke.time_ms(run, reps), smoke.time_ms(run, reps)]
    return equal, ms


def page_gather_case(smoke, dll, label, pages, ids, q, reps,
                     alts=None) -> bool:
    import torch

    from repro_torch.kernels import ops

    nq, b = ids.shape
    num_pages, cap, d = pages.shape

    def base():
        out = torch.empty((nq, b, cap), device=q.device)
        _check_rc(dll.pageann_page_gather_l2(
            pages.data_ptr(), ids.data_ptr(), q.data_ptr(), out.data_ptr(),
            nq, b, num_pages, cap, d, _stream()), "page_gather_l2")
        return out

    def new():
        return ops.page_gather_l2(pages, ids, q)

    want = new()
    equal = {"base": torch.equal(want, base())}
    base_ms, new_ms = ab.in_turns(smoke, base, new, reps)
    alt_equal, alts_ms = time_alts(smoke, alts or {}, new, reps, want)
    equal.update(alt_equal)
    emit(dict(
        kernel="page_gather_l2", shape=label, q=nq, b=b, capacity=cap, dim=d,
        pages=num_pages, equal=equal, base_ms=base_ms, new_ms=new_ms,
        speedup=sum(base_ms) / sum(new_ms), alts_ms=alts_ms))
    return all(equal.values())


def hamming_case(smoke, dll, label, codes, qcodes, t, reps,
                 alts=None) -> bool:
    import torch

    from repro_torch.kernels import ops

    (s, w), nq = codes.shape, qcodes.shape[0]

    def base():
        out = torch.empty((nq, s), dtype=torch.int32, device=codes.device)
        _check_rc(dll.pageann_hamming(codes.data_ptr(), qcodes.data_ptr(),
                                      out.data_ptr(), nq, s, w, _stream()),
                  "hamming")
        return out

    def base_route():
        vals, idx = torch.sort(base().to(torch.float32), dim=-1, stable=True)
        return vals[:, :t], idx[:, :t]

    new_vals, new_idx = ops.hamming_topk(codes, qcodes, t)
    old_vals, old_idx = base_route()
    equal = {
        "hamming": torch.equal(ops.hamming(codes, qcodes), base()),
        "hamming_topk": (torch.equal(new_vals.to(torch.float32), old_vals)
                         and torch.equal(new_idx.long(), old_idx)),
    }
    base_ms, new_ms = ab.in_turns(smoke, base,
                                  lambda: ops.hamming(codes, qcodes), reps)
    route_ms, fused_ms = ab.in_turns(
        smoke, base_route, lambda: ops.hamming_topk(codes, qcodes, t), reps)
    alt_equal, alts_ms = time_alts(
        smoke, alts or {}, lambda: ops.hamming_topk(codes, qcodes, t), reps,
        (new_vals, new_idx))
    equal.update({f"{n} topk": e for n, e in alt_equal.items()})
    emit(dict(
        kernel="hamming", shape=label, q=nq, s=s, w=w, t=t, equal=equal,
        base_ms=base_ms, new_ms=new_ms, speedup=sum(base_ms) / sum(new_ms),
        base_route_ms=route_ms, fused_topk_ms=fused_ms,
        fused_speedup=sum(route_ms) / sum(fused_ms),
        alts_topk_ms=alts_ms))
    return all(equal.values())


def members_case(smoke, lib, label, recs, ids, q, cap, reps) -> bool:
    """The members-only page scan, built from the base page_scan.cu and
    from the current one (which includes member_l2.cuh)."""
    import torch

    from repro_torch.kernels import ops

    def scan():
        return ops.page_scan(recs, ids, q, None, capacity=cap, dim=q.shape[1],
                             rp=1, compute_adc=False)[0]

    base = ab.with_library(lib, scan)
    equal = torch.equal(scan(), base())
    base_ms, new_ms = ab.in_turns(smoke, base, scan, reps)
    emit(dict(
        kernel="page_scan_members", shape=label, q=ids.shape[0],
        b=ids.shape[1], capacity=cap, dim=q.shape[1], equal={"base": equal},
        base_ms=base_ms, new_ms=new_ms, speedup=sum(base_ms) / sum(new_ms)))
    return equal


def _short(name: str) -> str:
    """A demangled kernel name without its namespace and arguments."""
    name = name.replace("void ", "").replace("<unnamed>::", "")
    return name.split(">(")[0] + ">" if ">(" in name else name.split("(")[0]


def sass_listing(lib: Path, pattern: str) -> dict:
    """The SASS instructions (addresses and encodings dropped) of each
    kernel in ``lib`` whose demangled name holds ``pattern``; empty without
    cuobjdump."""
    tool = ab._cuda_tool("cuobjdump")
    if not tool.is_file():
        return {}
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    listing, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            listing[name] = []
        elif name:
            instr = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*(?:/\*.*)?$", line)
            if instr and instr.group(1):
                listing[name].append(instr.group(1))
    names = ab._demangle(list(listing), tool)
    return {n: v for n, v in zip(names, listing.values()) if pattern in n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--extract", metavar="REV",
                    help="write REV's three sources into build/gather_ham_ab/"
                         "base/ and exit")
    ap.add_argument("--alt", action="append", default=[], metavar="NAME=SRC",
                    help="also time a variant of the current page_gather.cu "
                         "or hamming.cu (same C entries; repeatable); it "
                         "must give the same bits")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.extract:
        extract(args.extract)
        return 0
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gather_ham_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core.layout import pack_page_records
    from repro_torch.kernels import _build

    _build.library()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    base_pg, lib_pg = build_base("page_gather.cu")
    base_ham, lib_ham = build_base("hamming.cu")
    base_ps, lib_ps = build_base("page_scan.cu")
    # variants, by the C entry they export
    alts = {"page_gather": {}, "hamming": {}}
    alt_libs = {}
    for spec in args.alt:
        name, src = spec.split("=", 1)
        dll, alt_libs[name] = ab.compile_lib(
            Path(src), f"alt_{name}", _build._SIGNATURES, out_dir=OUT_DIR)
        kind = "hamming" if hasattr(dll, "pageann_hamming_topk") else "page_gather"
        alts[kind][name] = dll
    smoke = cs.Smoke(torch, args.seed)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ok = True

    def ids_for(nq, num_pages):
        return torch.randint(0, num_pages, (nq, B), generator=gen, device=dev,
                             dtype=torch.int32)

    for label, nq, d in (("main", 1000, 128), ("q64", 64, 128),
                         ("d32", 1000, 32), ("d200", 1000, 200)):
        pages = torch.randn((N_PAGES, CAP, d), generator=gen, device=dev)
        q = torch.randn((nq, d), generator=gen, device=dev)
        ok &= page_gather_case(smoke, base_pg, label, pages,
                               ids_for(nq, N_PAGES), q, 50,
                               alts["page_gather"])
    for label, nq in (("main", 1000), ("sift1m_batch", 1024), ("q64", 64)):
        codes = torch.randint(-2**31, 2**31 - 1, (1024, 2), generator=gen,
                              device=dev, dtype=torch.int32)
        qcodes = torch.randint(-2**31, 2**31 - 1, (nq, 2), generator=gen,
                               device=dev, dtype=torch.int32)
        ok &= hamming_case(smoke, base_ham, label, codes, qcodes, T, 50,
                           alts["hamming"])
    rng = np.random.default_rng(args.seed)
    for label, cap, m in (("memall", 7, 0), ("hybrid", 6, 16)):
        n_pages = -(-10_000 // cap)
        vecs = rng.standard_normal((n_pages, cap, 128)).astype("float32")
        codes = rng.integers(0, 256, (n_pages, 48, m)).astype("uint8")
        recs = torch.as_tensor(pack_page_records(vecs, codes)).to(dev)
        for nq in (1000, 64):
            q = torch.randn((nq, 128), generator=gen, device=dev)
            ok &= members_case(smoke, base_ps, f"{label}_q{nq}", recs,
                               ids_for(nq, n_pages), q, cap, 50)
    # the least a launch costs on this card: one 1-element PyTorch fill
    one = torch.zeros(1, device=dev)
    floor_ms = [smoke.time_ms(lambda: one.fill_(1.0), 50) for _ in range(2)]
    print(json.dumps(dict(launch_floor_ms=floor_ms)), flush=True)
    new_lib = _build.library_path()
    new_log = Path(str(new_lib) + ".log")
    builds = []
    for kernel, base_lib in (("page_gather_l2_kernel", lib_pg),
                             ("hamming", lib_ham)):
        sides = [("base", base_lib), ("new", new_lib)]
        sides += [(f"alt {n}", lib) for n, lib in alt_libs.items()
                  if n in alts["hamming" if kernel == "hamming" else "page_gather"]]
        for side, lib in sides:
            log = new_log if side == "new" else Path(str(lib) + ".log")
            sass = {n: len(v) for n, v in sass_listing(lib, kernel).items()}
            ptxas = ab.ptxas_usage(log, kernel)
            print(json.dumps(dict(kernel=kernel, build=side, sass=sass,
                                  ptxas=ptxas)), flush=True)
            builds.append(f"{kernel} {side}: " + ", ".join(
                f"{_short(n)} {c} SASS" for n, c in sass.items()) + "; " +
                ", ".join(f"{_short(n)} {u['registers']} regs "
                          f"{u['spill_stores']}/{u['spill_loads']} spills"
                          for n, u in ptxas.items()))
    base_members = sass_listing(lib_ps, "page_scan_members_kernel")
    new_members = sass_listing(new_lib, "page_scan_members_kernel")
    # kernel names in an anonymous namespace carry a hash of their file, so
    # the listings are compared without their names
    identical = bool(base_members) and sorted(
        base_members.values()) == sorted(new_members.values())
    print(json.dumps(dict(
        kernel="page_scan_members_kernel",
        sass_base={n: len(v) for n, v in base_members.items()},
        sass_new={n: len(v) for n, v in new_members.items()},
        sass_identical=identical,
        ptxas_base=ab.ptxas_usage(Path(str(lib_ps) + ".log"),
                                  "page_scan_members_kernel"),
        ptxas_new=ab.ptxas_usage(new_log, "page_scan_members_kernel"))),
        flush=True)
    for line in summary() + [f"launch floor {_mean(floor_ms):.5f} ms"] + \
            builds + [f"members-only page scan SASS identical {identical}"]:
        print(line)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if not ok:
        print("gather_ham_ab: the two builds' outputs differ", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
