"""Build and load the port's CUDA kernels, and count their launches.

The kernels in ``csrc/*.cu`` have a plain C interface. At first use they are
compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per source, all
started together, then one link) into a single shared library under
``build/torch_kernels/`` at the repository root, named by a hash of the
sources and flags, and loaded with ``ctypes``. A library already built from
the same sources is reused. Nothing here runs at import time: a host
without ``nvcc`` imports the package and only fails when a kernel is asked
for.

One host routine, ``csrc/page_fetch.cpp`` (the streamed tier's page gather,
``core.stream.PageFetcher``), is built the same way by the host's C++
compiler into its own library under ``build/torch_host/``, also named by a
hash of its source and flags. A host with no C++ compiler gets ``None`` from
:func:`host_library`, and the fetcher reads through its plain loop.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

SOURCES = ("page_scan.cu", "pq_adc.cu", "hamming.cu", "l2_distance.cu",
           "page_gather.cu", "pq_lut.cu")
HEADERS = ("member_l2.cuh",)   # included by the sources; part of the hash
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"   # used when nvcc is not on PATH
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

HOST_SOURCES = ("page_fetch.cpp",)
CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared")
CXX_NAMES = ("c++", "g++")   # the host compiler, the first found on PATH
HOST_BUILD_DIR = BUILD_DIR.parent / "torch_host"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C entry points: name -> argument types (all return a cudaError_t as int)
_SIGNATURES = {
    "pageann_page_scan": [_P] * 7 + [_I] * 17 + [_P],
    "pageann_pq_adc": [_P] * 4 + [_I] * 8 + [_P],
    "pageann_pq_adc_blocks_per_sm": [_I] * 2 + [_P],
    "pageann_hamming": [_P] * 3 + [_I] * 3 + [_P],
    "pageann_hamming_topk": [_P] * 4 + [_I] * 4 + [_P],
    "pageann_l2_distance": [_P] * 4 + [_I] * 3 + [_P],
    "pageann_l2_distance_blocks_per_sm": [_P],
    "pageann_page_gather_l2": [_P] * 4 + [_I] * 6 + [_P],
    "pageann_pq_lut": [_P] * 3 + [_I] * 8 + [_P],
}

# host entry points: name -> (argument types, return type)
_HOST_SIGNATURES = {
    "pageann_stage_new": ([_L], _P),
    "pageann_stage_free": ([_P], None),
    "pageann_page_fetch": ([_P, _P, _L, _P, _L, _P, _P], _I),
}

# launches of each kernel since the last reset: every wrapper adds one where
# its launch succeeded, nowhere else
LAUNCHES = {
    name: 0 for name in (
        "page_scan", "page_scan_members", "page_scan_masked",
        "page_scan_members_masked", "page_scan_recs", "page_scan_recs_members",
        "page_scan_recs_masked", "page_scan_recs_members_masked",
        "pq_adc", "hamming", "l2_distance", "page_gather_l2", "pq_lut",
    )
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _digest(flags=NVCC_FLAGS, names=SOURCES + HEADERS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in names:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile(NVCC_DEFAULT):
        return NVCC_DEFAULT
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "repro_torch are built from source at first use"
    )


def library_path() -> Path:
    return BUILD_DIR / f"libpageann_kernels-{_digest()}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels if no library for these sources exists yet.

    Returns the library's path and the seconds spent building (0.0 when it
    was already there). The compiler's output, register and shared-memory
    use per kernel included, is kept beside the library as ``.log``.
    """
    out = library_path()
    if out.exists():
        return out, 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        log, failed = [], []
        for name, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {name} (rc={proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(log)
            )
        lib_tmp = os.path.join(tmp, out.name)
        link = subprocess.run(
            [nvcc, "-shared", "-o", lib_tmp, *(obj for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        Path(lib_tmp + ".log").write_text("\n".join(log))
        os.replace(lib_tmp + ".log", str(out) + ".log")
        os.replace(lib_tmp, out)
    return out, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call in a process)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error, else count the
    launch under ``kernel``."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
    LAUNCHES[kernel] += 1


def _cxx() -> str | None:
    for name in CXX_NAMES:
        found = shutil.which(name)
        if found:
            return found
    return None


def host_library_path() -> Path:
    digest = _digest(CXX_FLAGS, HOST_SOURCES)
    return HOST_BUILD_DIR / f"libpageann_host-{digest}.so"


def build_host() -> tuple[Path, float]:
    """Compile the host routines if no library for these sources exists yet.

    Returns the library's path and the seconds spent building (0.0 when it
    was already there); raises if no C++ compiler is on PATH or it fails.
    """
    out = host_library_path()
    if out.exists():
        return out, 0.0
    cxx = _cxx()
    if cxx is None:
        raise RuntimeError(
            f"no C++ compiler on PATH (tried {', '.join(CXX_NAMES)}): the "
            "host routines of repro_torch are built from source at first use"
        )
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=HOST_BUILD_DIR) as tmp:
        lib_tmp = os.path.join(tmp, out.name)
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", lib_tmp,
             *(str(CSRC / name) for name in HOST_SOURCES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the host routines failed:\n{proc.stdout}")
        os.replace(lib_tmp, out)
    return out, time.perf_counter() - t0


@functools.cache
def host_library() -> ctypes.CDLL | None:
    """The loaded host library (built on the first call in a process), or
    None on a host with no C++ compiler."""
    if not host_library_path().exists() and _cxx() is None:
        return None
    path, _ = build_host()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _HOST_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
