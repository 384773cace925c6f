"""Drive a tiny cell through the harness on the CPU, optionally with the
timed path broken underneath, and print the run's lines as ``run.py``
does. Run as a module in its own process (the import guard then sees only
what the run loaded):

    python -m portbench.tests.rehearse ROOT WORKLOAD SEED TRACE FAULT

FAULT is ``none``, or one of the faults a cell can have:

* ``unchanged``: every hop returns the beam state unchanged (``merge``);
* ``half``: the search answers only the first half of each batch;
* ``altered``: one answer of each batch altered where it is produced;
* ``control``: the plain reference in TF32 (emulated on the CPU) answers
  in the program's place.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path


def break_program(fault: str) -> None:
    import numpy as np
    import torch

    from portbench import reference
    from repro_torch.core import search as search_mod
    from repro_torch.core.index import PageANNIndex

    search = PageANNIndex.search
    if fault == "unchanged":
        search_mod.merge = lambda state, *a, **k: state
    elif fault == "half":
        def half(self, queries, *a, **k):
            return search(self, queries[: len(queries) // 2], *a, **k)
        PageANNIndex.search = half
    elif fault == "altered":
        def altered(self, queries, *a, **k):
            res = search(self, queries, *a, **k)
            res.ids[0, 0] = (res.ids[0, 0] + 1) % self.store.num_vectors
            return res
        PageANNIndex.search = altered
    elif fault == "control":
        def control(self, queries, k=None, params=None, **kw):
            x = torch.as_tensor(self.vectors_by_original_id())
            q = torch.as_tensor(np.asarray(queries, np.float32))
            ids, dists = reference.control_topk(x, q, k)
            zeros = np.zeros(len(q), np.int32)
            return search_mod.SearchResult(ids.numpy(), dists.numpy(),
                                           zeros, zeros, zeros)
        PageANNIndex.search = control
    elif fault != "none":
        raise SystemExit(f"unknown fault {fault!r}")


def main(argv) -> int:
    root, workload, seed, trace, fault = argv
    import torch

    torch.set_num_threads(2)
    from portbench import run
    from portbench.guard import forbidden_modules

    break_program(fault)
    root = Path(root)
    cell = run.load_cell(root / "BENCHMARK.json", workload)
    result, checks = run.run_cell(
        cell, seed=int(seed), seconds=0.5, trace=bool(int(trace)),
        device="cpu", cache=root / "cache", t_start=time.perf_counter())
    return run.finish(result, checks, forbidden_modules())


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
