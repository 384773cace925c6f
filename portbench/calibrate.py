"""Readings that the limits of ``correct`` are set from; not part of a run.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 --control-seeds 4,5,6 [--out FILE]

on the card (``--device cpu`` rehearses at a tiny size). In one process it
loads and warms the cell's index once, then for each of ``--seeds`` drives
the run's window for ``--seconds`` and judges it as a run does; then for
each of ``--control-seeds`` it puts the control in the program's place: the
plain reference one precision below the configuration's (TF32 products,
``reference.control_topk``), answering as many batches of that seed's
traffic as the program's windows answered on average, judged the same
way. It prints one JSON line per reading and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_window(inputs, traffic, batches: int) -> dict:
    """The control's answers to the first ``batches`` batches of
    ``traffic``, in the window's format."""
    from portbench import data, reference

    out = []
    for i in range(batches):
        q = inputs.queries(traffic.batch, data.batch_seed(traffic.seed, i))
        ids, dists = reference.control_topk(inputs.x, q, traffic.k)
        out.append((i, ids.cpu().numpy(), dists.cpu().numpy()))
    return dict(batches=out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--manifest", default=str(ROOT / "BENCHMARK.json"))
    p.add_argument("--cache", default=str(ROOT / "portbench" / ".cache"))
    p.add_argument("--out")
    args = p.parse_args(argv)
    for p_ in (str(ROOT / "src"), str(ROOT)):
        if p_ not in sys.path:
            sys.path.insert(0, p_)

    from portbench import data, run

    cell = run.load_cell(Path(args.manifest), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    inputs, system, _, setup = run.setup_cell(
        cell, seed=seeds[0], device=args.device, cache=Path(args.cache))
    readings = []

    def emit(kind, seed, window, seconds):
        traffic = data.Traffic(cell["traffic"], seed=seed)
        j = run.judge_window(window, inputs, traffic,
                             cell["config"]["limits"])
        r = dict(kind=kind, workload=args.workload, seed=seed,
                 batches=len(window["batches"]), seconds=seconds,
                 correct=j.correct(), attempted=j.attempted,
                 failed=j.failed, checks=j.checks())
        readings.append(r)
        print(json.dumps(r), flush=True)

    spec = cell["traffic"]
    for s in seeds:
        traffic = data.Traffic(spec, seed=s)
        loop = importlib.import_module(f"portbench.loops.{traffic.loop}")
        w = loop.drive(system, inputs, traffic, args.seconds, trace=False)
        emit("program", s, w, w["window_s"])
    batches = round(sum(r["batches"] for r in readings) / len(readings))
    system.close()
    for s in controls:
        traffic = data.Traffic(spec, seed=s)
        t = time.perf_counter()
        w = control_window(inputs, traffic, batches)
        emit("control_tf32", s, w, time.perf_counter() - t)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(setup=setup,
                                                  readings=readings)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
