#!/usr/bin/env python3
"""Earlier builds of ``pq_adc`` and ``l2_distance`` against the current ones
on one card: same bits, and times.

    python3 tools/adc_l2_ab.py --extract REV   # in a git checkout
    python3 tools/adc_l2_ab.py                 # on the card

``--extract REV`` writes REV's ``csrc/pq_adc.cu`` and ``csrc/l2_distance.cu``
(``git show``) into ``build/adc_l2_ab/base/`` and exits. Without it the
script compiles those two sources, each alone with the port's nvcc flags,
into ``build/adc_l2_ab/`` (the compiler's ``-Xptxas -v`` output beside each
library as ``.log``); their C entries are the earlier ones,
``pageann_pq_adc(codes, lut, out, nq, n, m, k, stream)`` on codes gathered
first and ``pageann_l2_distance(q, x, out, nq, nx, d, stream)``. The
repository's kernels are built as usual. At each shape it

  - requires equal outputs (``torch.equal``): for ``pq_adc`` the fused
    ``pq_adc_gather`` against the base kernel on ``table[ids]``, for
    ``l2_distance`` the new kernel against the base one and the
    keep-masked kernel against the base output with ``+inf`` in the
    dropped columns; it exits 1 if any differ;
  - times base, new, new, base (CUDA events behind a sleep kernel, as
    ``chip_smoke.py`` times): for ``pq_adc`` the base as the search ran it
    (a PyTorch gather, then the kernel) and its kernel alone on gathered
    codes, and the new fused call; for ``l2_distance`` each kernel alone
    and the masked scan's distances (base: kernel, then a ``torch.where``
    pass; new: one masked kernel).

Shapes: the HYBRID re-score (Q = 1,000, 240 rows of a 10,002 x 32 table),
the entry estimates (Q = 1,000, T = 16 of a 1,024 x 16 sample), the re-score
at SIFT1M size (Q = 1,024 of 1,000,002 rows); the delta scan at
1,000 x 4,096 (d = 32, 128, 200) and 1,024 x 262,144 (d = 128). Then each
kernel's SASS instruction count (``cuobjdump``) and registers and spills
(``ptxas``) in both builds, where the toolkit has them. One JSON line per
measurement on standard output, then the card's name and power limit from
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
OUT_DIR = ROOT / "build" / "adc_l2_ab"
BASE_DIR = OUT_DIR / "base"
CSRC = "src/repro_torch/kernels/csrc"
SOURCES = ("pq_adc.cu", "l2_distance.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
BASE_SIGNATURES = {
    "pageann_pq_adc": [_P] * 3 + [_I] * 4 + [_P],
    "pageann_l2_distance": [_P] * 3 + [_I] * 3 + [_P],
}


def extract(rev: str) -> None:
    BASE_DIR.mkdir(parents=True, exist_ok=True)
    for name in SOURCES:
        text = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"], cwd=ROOT,
                              check=True, capture_output=True, text=True).stdout
        (BASE_DIR / name).write_text(text)
        print(f"wrote {(BASE_DIR / name).relative_to(ROOT)} from {rev}")


def compile_lib(src: Path, name: str, signatures: dict,
                out_dir: Path = OUT_DIR) -> tuple[ctypes.CDLL, Path]:
    """``src`` compiled alone with the port's flags into ``out_dir`` and
    loaded, with the argument types of its C entries in ``signatures``; the
    compiler's output goes beside the library as ``.log``."""
    from repro_torch.kernels import _build

    lib = out_dir / f"lib{name}.so"
    # a header the source includes is found beside it first, then in the
    # repository's csrc/
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-shared", "-o", str(lib),
                           str(src)], check=True, capture_output=True,
                          text=True)
    Path(str(lib) + ".log").write_text(done.stdout + done.stderr)
    dll = ctypes.CDLL(str(lib))
    for fn, argtypes in signatures.items():
        if hasattr(dll, fn):
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = ctypes.c_int
    return dll, lib


def build_base(name: str) -> tuple[ctypes.CDLL, Path]:
    """The base ``name`` (earlier C entries) compiled and loaded."""
    src = BASE_DIR / name
    if not src.is_file():
        raise SystemExit(f"adc_l2_ab: {src} missing; run --extract REV first")
    return compile_lib(src, f"base_{Path(name).stem}", BASE_SIGNATURES)


def build_alt(src: Path, name: str) -> tuple[ctypes.CDLL, Path]:
    """A variant of the current ``l2_distance.cu`` (the current C entry)
    compiled and loaded."""
    from repro_torch.kernels import _build

    return compile_lib(src, f"alt_{name}", {
        "pageann_l2_distance": _build._SIGNATURES["pageann_l2_distance"]})


def with_library(lib, fn):
    """``fn`` with the port's wrappers launching from ``lib``."""
    from repro_torch.kernels import _build

    def run():
        library = _build.library
        _build.library = lambda: lib
        try:
            return fn()
        finally:
            _build.library = library
    return run


def _demangle(names: list[str], tool: Path) -> list[str]:
    filt = tool.with_name("cu++filt")
    if not filt.is_file() or not names:
        return names
    out = subprocess.run([str(filt)], input="\n".join(names),
                         capture_output=True, text=True).stdout.split("\n")
    return out[:len(names)]


def _cuda_tool(name: str) -> Path:
    from repro_torch.kernels import _build

    return Path(shutil.which(name) or Path(_build._nvcc()).with_name(name))


def sass_counts(lib: Path, pattern: str) -> dict:
    """SASS instructions of each kernel in ``lib`` whose demangled name
    holds ``pattern``; empty without cuobjdump."""
    tool = _cuda_tool("cuobjdump")
    if not tool.is_file():
        return {}
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name] += 1
    names = _demangle(list(counts), tool)
    return {n: c for n, c in zip(names, counts.values()) if pattern in n}


def ptxas_usage(log: Path, pattern: str) -> dict:
    """Registers and spill bytes of each kernel whose demangled name holds
    ``pattern``, from an ``nvcc -Xptxas -v`` log."""
    if not log.is_file():
        return {}
    usage, name = {}, None
    for line in log.read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            usage[name] = {}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            usage[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in line and "registers" in line:
            usage[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                     line).group(1))
    names = _demangle(list(usage), _cuda_tool("cuobjdump"))
    return {n: u for n, u in zip(names, usage.values()) if pattern in n}


def in_turns(smoke, base, new, reps: int) -> tuple[list, list]:
    """Device ms of ``base`` and ``new``, timed base, new, new, base."""
    b = [smoke.time_ms(base, reps)]
    n = [smoke.time_ms(new, reps), smoke.time_ms(new, reps)]
    b.append(smoke.time_ms(base, reps))
    return b, n


def pq_adc_case(smoke, dll, label, table, ids, lut, reps) -> bool:
    import torch

    from repro_torch.kernels import ops

    nq, n = ids.shape
    m, k = table.shape[1], lut.shape[2]

    def base_kernel(codes):
        out = torch.empty((nq, n), device=lut.device)
        rc = dll.pageann_pq_adc(codes.data_ptr(), lut.data_ptr(), out.data_ptr(),
                                nq, n, m, k, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"base pq_adc launch failed: cudaError {rc}")
        return out

    gathered = table[ids].contiguous()
    got = ops.pq_adc_gather(table, ids, lut)
    equal = torch.equal(got, base_kernel(gathered))
    base_ms, new_ms = in_turns(smoke, lambda: base_kernel(table[ids]),
                               lambda: ops.pq_adc_gather(table, ids, lut), reps)
    kernel_ms = [smoke.time_ms(lambda: base_kernel(gathered), reps)]
    print(json.dumps(dict(
        kernel="pq_adc", shape=label, q=nq, n=n, m=m, k=k,
        table_rows=table.shape[0], equal=equal,
        base_gather_and_kernel_ms=base_ms, base_kernel_ms=kernel_ms,
        new_fused_ms=new_ms, speedup=sum(base_ms) / sum(new_ms))), flush=True)
    return equal


def l2_case(smoke, dll, alts, label, q, x, keep, reps) -> bool:
    import torch

    from repro_torch.kernels import ops

    (nq, d), nx = q.shape, x.shape[0]

    def base_kernel():
        out = torch.empty((nq, nx), device=q.device)
        rc = dll.pageann_l2_distance(q.data_ptr(), x.data_ptr(), out.data_ptr(),
                                     nq, nx, d,
                                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"base l2_distance launch failed: cudaError {rc}")
        return out

    want = base_kernel()
    got = ops.l2_distance(q, x)
    masked = torch.where(keep[None, :], want, float("inf"))
    equal = {
        "unmasked": torch.equal(got, want),
        "keep": torch.equal(ops.l2_distance(q, x, keep), masked),
    }
    alt_runs, failed = {}, {}
    for n, lib in alts.items():
        run = with_library(lib, lambda: ops.l2_distance(q, x))
        try:
            equal[f"alt {n}"] = torch.equal(run(), want)
            alt_runs[n] = run
        except RuntimeError as err:       # a variant the card refuses
            failed[n] = str(err)
    base_ms, new_ms = in_turns(smoke, base_kernel,
                               lambda: ops.l2_distance(q, x), reps)
    alts_ms = {n: [smoke.time_ms(run, reps), smoke.time_ms(run, reps)]
               for n, run in alt_runs.items()}
    base_mask_ms, new_mask_ms = in_turns(
        smoke, lambda: torch.where(keep[None, :], base_kernel(), float("inf")),
        lambda: ops.l2_distance(q, x, keep), reps)
    row = dict(
        kernel="l2_distance", shape=label, q=nq, n=nx, dim=d, equal=equal,
        base_ms=base_ms, new_ms=new_ms,
        speedup=sum(base_ms) / sum(new_ms),
        base_then_mask_pass_ms=base_mask_ms, new_masked_ms=new_mask_ms)
    if alts:
        row.update(alts_ms=alts_ms, alts_failed=failed)
    print(json.dumps(row), flush=True)
    return all(equal.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--extract", metavar="REV",
                    help="write REV's two sources into build/adc_l2_ab/base/ "
                         "and exit")
    ap.add_argument("--alt", action="append", default=[], metavar="NAME=SRC",
                    help="also time a variant of the current l2_distance.cu "
                         "(same C entry; repeatable); it must give the same "
                         "bits")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.extract:
        extract(args.extract)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("adc_l2_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    _build.library()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    base_adc, lib_adc = build_base("pq_adc.cu")
    base_l2, lib_l2 = build_base("l2_distance.cu")
    alts, alt_libs = {}, {}
    for spec in args.alt:
        name, src = spec.split("=", 1)
        alts[name], alt_libs[name] = build_alt(Path(src), name)
    smoke = cs.Smoke(torch, args.seed)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ok = True

    def codes(rows, m):
        return torch.randint(0, 256, (rows, m), generator=gen, device=dev,
                             dtype=torch.uint8)

    def tables(nq, m):
        return torch.rand((nq, m, 256), generator=gen, device=dev)

    # the HYBRID re-score and the entry estimates of the main path, then the
    # re-score at SIFT1M size
    for label, rows, nq, n, m, reps in (("rescore", 10_002, 1000, 240, 32, 50),
                                        ("entry", 1024, 1000, 16, 16, 50),
                                        ("sift1m", 1_000_002, 1024, 240, 32, 20)):
        table = codes(rows, m)
        if label == "entry":       # the first T of a sorted (Q, S) matrix
            ids = torch.sort(torch.rand((nq, rows), generator=gen, device=dev),
                             dim=1).indices[:, :n]
        else:
            ids = torch.randint(0, rows, (nq, n), generator=gen, device=dev)
        ok &= pq_adc_case(smoke, base_adc, label, table, ids, tables(nq, m), reps)
        del table, ids
    for label, nq, nx, d, reps in (("delta", 1000, 4096, 128, 50),
                                   ("delta_d32", 1000, 4096, 32, 50),
                                   ("delta_d200", 1000, 4096, 200, 50),
                                   ("sift1m_delta", 1024, 262_144, 128, 5)):
        x = torch.randn((nx, d), generator=gen, device=dev)
        q = torch.randn((nq, d), generator=gen, device=dev)
        q[0] = x[0]
        keep = torch.rand((nx,), generator=gen, device=dev) < 0.9
        ok &= l2_case(smoke, base_l2, alts, label, q, x, keep, reps)
        del x, q
        torch.cuda.empty_cache()
    new_lib = _build.library_path()
    new_log = Path(str(new_lib) + ".log")
    builds = [("pq_adc", "base", lib_adc), ("pq_adc", "new", new_lib),
              ("l2_distance", "base", lib_l2), ("l2_distance", "new", new_lib)]
    builds += [("l2_distance", f"alt {n}", lib) for n, lib in alt_libs.items()]
    for kernel, side, lib in builds:
        log = new_log if side == "new" else Path(str(lib) + ".log")
        print(json.dumps(dict(kernel=kernel, build=side,
                              sass=sass_counts(lib, kernel + "_kernel"),
                              ptxas=ptxas_usage(log, kernel + "_kernel"))),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if not ok:
        print("adc_l2_ab: the two builds' outputs differ", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
