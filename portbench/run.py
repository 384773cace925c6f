"""The port's benchmark: one cell of ``BENCHMARK.json``, run once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU (it exits 3
without one, printing no result). A cell is one configuration under one
traffic mix. The run

1. draws the configuration's collection on the card from its
   ``data_seed``; loads the cell's index from ``portbench/.cache/``, or, on
   the first run of a checkout (or after any change to the program or to
   the harness's data and build code), builds it with
   ``PageANNIndex.build`` and saves it there first. The build is reported
   on the set-up line as ``index_build_s`` and left out of ``setup_s``, as
   a compile cache's first fill would be;
2. warms up one batch at the mix's shape;
3. drives the mix's loop (``portbench/loops/<loop>.py``) for
   ``--seconds``: the closed loop's one client sends a batch of fresh
   queries (drawn on the card from ``(--seed, batch index)`` and handed
   over as host arrays) to ``PageANNIndex.search`` and sends the next when
   the results are back;
4. reads the device's memory peak, frees the index, and judges every
   answer of the window against the plain reference (``judge.py``);
5. prints the set-up's parts and the window's counts on earlier lines, the
   numbers compared beside their limits as the last lines of standard
   error, and one JSON object as the last line of standard output: the
   cell's end-to-end metrics (``--trace 0``) or its per-layer metrics read
   from a ``torch.profiler`` trace of the first batches (``--trace 1``).

Adding to it takes new files and entries only, never an edit:

* a configuration: ``portbench/configs/<name>.json`` (source, sizes,
  the data model's parameters and seed (``data.Mixture``),
  ``PageANNConfig`` fields, ``memory_budget`` (null: every page resident;
  else what ``PageANNIndex.load`` takes), limits, ``reduced`` and
  ``assumed``) and an entry under ``configs`` in ``BENCHMARK.json``;
* a traffic mix: ``portbench/traffic/<name>.json``, parameters that
  ``data.Traffic`` reads (loop, batch, k, trace_batches);
* a loop: ``portbench/loops/<name>.py`` defining ``drive`` as
  ``loops/closed.py`` does, named by a mix's ``loop``;
* a cell: an entry under ``workloads`` naming a configuration and a mix;
* a per-layer metric: ``portbench/metrics/<name>.py`` defining
  ``read(record)`` (None when there is nothing to read) and an entry under
  ``per_layer``.

Some cells need more than files: a filtered mix (metadata for the
collection, a filter in data form and its mask in the judge) and a served
open loop (``BatchingEngine`` in ``system.py``) each need an edit here
first.

Building, loading and searching the index is ``system.py``, the only file
here that imports the program; the reference (``reference.py``) and the
yardstick (``data.py``, ``roofline.py``, ``trace.py``, ``metrics/``)
import nothing of it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()           # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NO_DEVICE = 3
FORBIDDEN_LOADED = 4


def load_cell(manifest: Path, workload: str) -> dict:
    """The cell's entry with its configuration, mix and metric names,
    found by name in ``manifest`` and its folder."""
    doc = json.loads(manifest.read_text())
    cells = {w["name"]: w for w in doc["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: one of "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in doc["configs"] if c["name"] == cell["config"])
    root = manifest.parent
    config_path = root / conf["file"]
    traffic_path = root / "portbench" / "traffic" / f"{cell['traffic']}.json"

    def metrics(kind):
        return [m["name"] for m in doc[kind]
                if workload in m.get("workloads", [workload])]

    return dict(
        name=workload, chips=int(cell["chips"]),
        config=json.loads(config_path.read_text()),
        config_bytes=config_path.read_bytes(),
        traffic=json.loads(traffic_path.read_text()),
        end_to_end={m["name"]: m for m in doc["end_to_end"]
                    if m["name"] in metrics("end_to_end")},
        per_layer={m["name"]: m for m in doc["per_layer"]
                   if m["name"] in metrics("per_layer")},
    )


class Inputs:
    """The cell's collection on the device, and its queries."""

    def __init__(self, cell: dict, device):
        from portbench import data

        cfg, d = cell["config"], cell["config"]["data"]
        self.model = data.Mixture(
            int(cfg["dim"]), clusters=int(d["clusters"]), rank=int(d["rank"]),
            scale=float(d["scale"]), noise=float(d["noise"]),
            seed=int(d["data_seed"]), device=device)
        self.x = self.model.collection(int(cfg["n"]))

    def queries(self, size: int, seed: int):
        return self.model.queries(size, seed)


def judge_window(window: dict, inputs, traffic, limits: dict):
    """Judge every batch of the window; returns the ``Judge``."""
    from portbench import data
    from portbench.judge import Judge

    j = Judge(inputs.x, traffic.k, limits)
    for i, ids, dists in window["batches"]:
        q = inputs.queries(traffic.batch, data.batch_seed(traffic.seed, i))
        j.add(q, ids, dists)
    return j


def setup_cell(cell: dict, *, seed: int, device, cache: Path) -> tuple:
    """Inputs, the loaded index warmed up at the mix's shape, the traffic
    of ``seed``, and the set-up's parts in seconds. The device's memory
    peak is reset before the index is loaded, after any build."""
    import torch

    from portbench import data, system as system_mod

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    setup = {}
    t = time.perf_counter()
    torch.zeros(1, device=dev)
    if cuda:
        torch.cuda.synchronize(dev)
    setup["device_init_s"] = time.perf_counter() - t

    t = time.perf_counter()
    inputs = Inputs(cell, dev)
    setup["data_s"] = time.perf_counter() - t
    cfg = cell["config"]

    def make(directory):
        return system_mod.build_index(inputs.x, cfg, directory, device=dev)

    directory, build_s = system_mod.cached_index_dir(
        cache, cfg["name"], cell["config_bytes"], make)
    # a checkout's first run builds once, as a compile cache fills once
    setup["index_build_s"] = build_s
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    t = time.perf_counter()
    system = system_mod.System(directory, cfg, device=dev)
    setup["index_load_s"] = time.perf_counter() - t

    traffic = data.Traffic(cell["traffic"], seed=seed)
    t = time.perf_counter()
    q = inputs.queries(traffic.batch, data.batch_seed(seed, 2**40))
    system.search(q.cpu().numpy(), traffic.k)
    if cuda:
        torch.cuda.synchronize(dev)
    setup["warmup_s"] = time.perf_counter() - t
    return inputs, system, traffic, setup


def geometry(cfg: dict, system) -> dict:
    """What the roofline counts need of the index's shape."""
    pa = cfg["pageann"]
    return dict(
        dim=int(cfg["dim"]), capacity=system.capacity, pages=system.pages,
        fill=int(cfg["n"]) / system.pages, rp=int(pa["page_degree"]),
        m_disk=int(pa["pq_subspaces"]),
        m_mem=min(int(cfg["dim"]), 2 * int(pa["pq_subspaces"])),
        ksub=int(pa["pq_ksub"]), io_batch=int(pa["io_batch"]),
        entries=int(pa["lsh_entries"]), adc=pa["memory_mode"] != "mem_all",
        mem_codes=pa["memory_mode"] != "disk_only")


def run_cell(cell: dict, *, seed: int, seconds: float, trace: bool, device,
             cache: Path, t_start: float, out=print) -> tuple:
    """One run of ``cell``. Returns (result dict, checks dict)."""
    import numpy as np
    import torch

    from portbench import trace as trace_mod

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = cell["config"]
    inputs, system, traffic, setup = setup_cell(cell, seed=seed, device=dev,
                                                cache=cache)
    setup_s = time.perf_counter() - t_start - (setup["index_build_s"] or 0.0)
    out("portbench setup " + json.dumps(dict(setup, setup_s=setup_s)))

    loop = importlib.import_module(f"portbench.loops.{traffic.loop}")
    window = loop.drive(system, inputs, traffic, seconds, trace=trace)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    geo = geometry(cfg, system)
    system.close()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    lat = np.asarray(window["latencies"])
    out("portbench window " + json.dumps(dict(
        batches=len(lat), queries=window["queries"],
        window_s=window["window_s"], harness_s=window["harness_s"],
        harness_share=window["harness_s"] / window["window_s"],
        batch_ms_median=float(np.median(lat) * 1e3) if len(lat) else None,
        ios_per_query=window["ios_sum"] / max(1, window["queries"]),
        hops_per_query=window["hops_sum"] / max(1, window["queries"]),
        geometry=geo)))

    t = time.perf_counter()
    judge = judge_window(window, inputs, traffic, cfg["limits"])
    out("portbench judge " + json.dumps(dict(
        seconds=time.perf_counter() - t, queries=judge.attempted)))

    device_info = dict(
        platform="gpu" if cuda else dev.type,
        kind=torch.cuda.get_device_name(dev) if cuda else dev.type,
        count=cell["chips"], memory_peak_bytes=int(peak))
    breakdown = None
    if not trace:
        values = dict(
            qps=window["queries"] / window["window_s"],
            batch_p95_ms=float(np.percentile(lat, 95) * 1e3),
            recall_at_10=judge.recall,
            peak_mem_mib=peak / 2**20,
            setup_s=setup_s)
        metrics = {n: {"value": values[n], "unit": m["unit"]}
                   for n, m in cell["end_to_end"].items()}
    else:
        summary = trace_mod.read_events(window["prof"])
        out("portbench trace " + json.dumps(dict(
            window_s=summary["window_s"], busy_s=summary["busy_s"],
            device_events=len(summary["kernels"]))))
        record = dict(trace=summary, traced=window["traced"],
                      geometry=geo, queries=window["queries"],
                      ios_sum=window["ios_sum"], hops_sum=window["hops_sum"])
        metrics = {}
        for name, m in cell["per_layer"].items():
            reader = importlib.import_module(f"portbench.metrics.{name}")
            value = reader.read(record)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": m["unit"]}
        device_info.update(busy_s=summary["busy_s"],
                           window_s=summary["window_s"])
        breakdown = trace_mod.breakdown(summary)
    result = dict(correct=judge.correct(), attempted=judge.attempted,
                  failed=judge.failed, metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, judge.checks()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    manifest = ROOT / "BENCHMARK.json"
    program = ROOT / "src" / "repro_torch"
    if not manifest.is_file() or not program.is_dir():
        print(f"portbench: needs {manifest} and the program at {program}",
              file=sys.stderr)
        return 2
    for p_ in (str(ROOT / "src"), str(ROOT)):
        if p_ not in sys.path:
            sys.path.insert(0, p_)
    cell = load_cell(manifest, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return NO_DEVICE

    from portbench.guard import forbidden_modules

    result, checks = run_cell(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device="cuda", cache=ROOT / "portbench" / ".cache",
        t_start=T_START, out=lambda s: print(s, flush=True))
    return finish(result, checks, forbidden_modules())


def finish(result: dict, checks: dict, forbidden: list) -> int:
    """Print the checks and the result line; refuse a run that loaded a
    forbidden module."""
    if forbidden:
        print("portbench: forbidden modules loaded: " + ", ".join(forbidden),
              file=sys.stderr)
        return FORBIDDEN_LOADED
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} {c['held']} {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
