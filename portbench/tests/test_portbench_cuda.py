"""A real cell end to end on the card, at its real sizes (skipped without
a CUDA device): run it on the card with
``PYTHONPATH=src python -m pytest -q portbench/tests -m cuda``."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests import cells


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_the_first_cell_runs_correct_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only there")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "bigann-hybrid.batch10k", "--seed", str(2**31 + 77 + trace),
         "--seconds", "5", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1200, cwd=cells.REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert "page_scan_roofline" in result["metrics"]
        assert 0 < result["metrics"]["page_scan_roofline"]["value"] <= 100
    else:
        assert result["metrics"]["qps"]["value"] > 0
