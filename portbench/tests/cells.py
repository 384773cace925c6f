"""Tiny cells for rehearsing the harness on the CPU: a manifest in a
temporary root whose configurations and mixes keep the real ones' keys at
sizes a test can hold."""
from __future__ import annotations

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def tiny_config(name: str, mode: str, source: str) -> dict:
    cfg = json.loads((REPO / "portbench" / "configs" / source).read_text())
    cfg["name"] = name
    cfg["n"], cfg["dim"] = 600, 16
    cfg["data"] = dict(cfg["data"], clusters=8, rank=4)
    cfg["pageann"] = dict(cfg["pageann"], memory_mode=mode, graph_degree=12,
                          build_beam=32, page_capacity=5, page_degree=16,
                          pq_subspaces=4, pq_iters=4, lsh_sample=128,
                          lsh_entries=8, beam_width=32, build_rounds=1)
    return cfg


def make_root(tmp: Path, seconds_batches: int = 8) -> Path:
    """A root holding BENCHMARK.json and portbench/{configs,traffic}: two
    cells, ``tiny-hybrid.batch`` and ``tiny-memall.batch``."""
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "portbench" / "configs").mkdir(parents=True)
    (tmp / "portbench" / "traffic").mkdir(parents=True)
    configs = [("tiny-hybrid", "hybrid", "bigann-hybrid.json"),
               ("tiny-memall", "mem_all", "yfcc-memall.json")]
    for name, mode, source in configs:
        (tmp / "portbench" / "configs" / f"{name}.json").write_text(
            json.dumps(tiny_config(name, mode, source)))
    mix = dict(loop="closed", batch=64, k=10, trace_batches=2)
    (tmp / "portbench" / "traffic" / "batch.json").write_text(json.dumps(mix))
    cells = ["tiny-hybrid.batch", "tiny-memall.batch"]
    doc["configs"] = [dict(name=n, source="test", reduced=[], why="test",
                           file=f"portbench/configs/{n}.json")
                      for n, _, _ in configs]
    doc["workloads"] = [
        dict(name=cells[0], config="tiny-hybrid", traffic="batch", chips=1,
             why="test"),
        dict(name=cells[1], config="tiny-memall", traffic="batch", chips=1,
             why="test")]
    for m in doc["per_layer"]:
        m["workloads"] = cells
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp / "BENCHMARK.json"
