"""The harness end to end on the CPU at a tiny size: the last line's
shape, and ``correct`` false under each fault a cell can have and under
the TF32 control."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests import cells

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cells.make_root(tmp_path_factory.mktemp("portbench")).parent


def rehearse(root, workload, *, seed=2**31 + 5, trace=0, fault="none"):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.tests.rehearse", str(root),
         workload, str(seed), str(trace), fault],
        capture_output=True, text=True, timeout=300, cwd=cells.REPO,
        env={**__import__("os").environ,
             "PYTHONPATH": f"{cells.REPO / 'src'}:{cells.REPO}"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-1]), proc.stderr.strip().splitlines()


@pytest.mark.parametrize("workload", ["tiny-hybrid.batch",
                                      "tiny-memall.batch"])
def test_a_sound_run_is_correct_and_its_last_line_has_the_keys(root,
                                                               workload):
    result, err = rehearse(root, workload)
    assert list(result) == KEYS
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert set(result["metrics"]) == {"qps", "batch_p95_ms", "recall_at_10",
                                      "peak_mem_mib", "setup_s"}
    assert all(m["value"] > 0 for n, m in result["metrics"].items()
               if n != "peak_mem_mib")
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    # the numbers compared are the last lines of standard error
    checks = list(result["checks"])
    assert [line.split()[1] for line in err[-len(checks):]] == checks


def test_a_traced_run_gives_per_layer_metrics_and_a_breakdown(root):
    result, _ = rehearse(root, "tiny-memall.batch", trace=1)
    assert list(result) == KEYS[:5] + ["breakdown", "checks"]
    assert result["correct"] is True
    # counters are read on any device; the device trace is empty here
    assert set(result["metrics"]) == {"ios_per_query", "hops_per_query"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault,check", [
    ("unchanged", "recall_at_10"),
    ("half", "unanswered"),
    ("altered", "dist_gap"),
    ("control", "dist_gap"),
])
@pytest.mark.parametrize("workload", ["tiny-hybrid.batch",
                                      "tiny-memall.batch"])
def test_a_broken_timed_path_is_not_correct(root, workload, fault, check):
    result, _ = rehearse(root, workload, fault=fault)
    assert result["correct"] is False
    c = result["checks"][check]
    assert (c["value"] > c["limit"] if c["held"] == "<="
            else c["value"] < c["limit"])
