"""BENCHMARK.json resolves by name to the files the harness reads, and
keeps to the shape its contract sets."""
from __future__ import annotations

import importlib
import json
import re

import pytest

from portbench import run
from portbench.tests import cells

DOC = json.loads((cells.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in DOC["workloads"]]


def test_top_level_keys_and_command():
    assert list(DOC) == ["command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"]
    assert DOC["command"] == ["python3", "portbench/run.py"]
    assert DOC["paths"] == ["portbench"]
    assert 1 <= DOC["run_seconds"] <= 51
    # a full check of 24 cells fits its time: 2 + 14 x 24 runs at
    # run_seconds + 60 s each, 2 x 90 s a cell, 1,200 s spare
    runs = 2 + 14 * 24
    assert runs * (DOC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves_to_its_config_mix_and_metric_readers(workload):
    cell = run.load_cell(cells.REPO / "BENCHMARK.json", workload)
    entry = next(w for w in DOC["workloads"] if w["name"] == workload)
    assert cell["config"]["name"] == entry["config"]
    assert cell["traffic"]["loop"] == "closed"
    assert cell["chips"] == 1
    assert "setup_s" in cell["end_to_end"] and len(cell["end_to_end"]) >= 2
    assert cell["per_layer"]
    for name in cell["per_layer"]:
        reader = importlib.import_module(f"portbench.metrics.{name}")
        assert callable(reader.read)


def test_names_units_and_entries():
    seen = set()
    for kind, keys in (("configs", {"name", "source", "file", "reduced",
                                    "why"}),
                       ("workloads", {"name", "config", "traffic", "chips",
                                      "why"})):
        for e in DOC[kind]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    pairs = [(w["config"], w["traffic"]) for w in DOC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in DOC["end_to_end"])
    e2e = {m["name"] for m in DOC["end_to_end"]}
    for m in DOC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("conf", DOC["configs"], ids=lambda c: c["name"])
def test_each_config_file_states_its_cuts(conf):
    cfg = json.loads((cells.REPO / conf["file"]).read_text())
    assert cfg["name"] == conf["name"]
    assert sorted(cfg["reduced"]) == sorted(conf["reduced"])
    assert len(cfg["source"]) <= 200
    assert {"recall_at_10", "dist_gap"} <= set(cfg["limits"])
    assert sum(c["config"] == conf["name"] for c in DOC["workloads"]) >= 1
