"""Dry run of the production meshes: ``repro.launch.dryrun`` in PyTorch.

The reference lowers and compiles each (arch x shape x mesh) cell for 256
or 512 placeholder TPU devices and reads XLA's cost analysis. The port has
no compiler to ask, so it traces: one step of the cell runs on rank 0 of a
fake process group of 256 (``pod16x16``) or 512 (``pod2x16x16``) ranks
(``torch.testing._internal.distributed.fake_pg``: every collective returns
at once) under ``FakeTensorMode`` (no storage, no arithmetic), with the
parameters, optimizer state, caches and inputs laid out as DTensors by the
reference's specs. The step runs under ``roofline.TraceCounter`` (local
flops, bytes and collective bytes of this rank's shards) and
``MemTracker`` (peak bytes of this rank). A cell that traces is ``ok``:
every op of its step has a sharding strategy at the production layout.

An eager trace counts every loop trip, so no calibration is needed for
correctness; for speed ``dryrun_cell`` traces the step at one and two scan
units (layers; the hybrid's blocks) and, for training, one and two
microbatches, and extrapolates linearly, as the reference's
``calibrated_counters`` does (``tests/test_torch_dryrun.py`` holds the
extrapolation equal to the full trace).
``compile_s`` is ``trace_s``. The numbers are roofline estimates
over an H100 SXM's data sheet (``launch.mesh``), not measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out experiments/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import warnings

import torch

from repro_torch import tree as T
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import HBM_BYTES, make_production_mesh
from repro_torch.launch.shardings import cache_spec_tree, to_shardings
from repro_torch.models.frontend import decode_input_specs, train_input_specs
from repro_torch.models.sharding import Rules, to_layout

# >=400 GB of params: shard FSDP across the pod axis too
_FSDP_POD_THRESHOLD = 400e9


def _rules(mesh, arch) -> Rules:
    return Rules(
        mesh,
        fsdp_over_pod=arch.param_count() >= _FSDP_POD_THRESHOLD,
        replicate_kv=arch.replicate_kv,
    )


@contextlib.contextmanager
def fake_world(world_size: int):
    """Rank 0 of a fake process group of ``world_size`` ranks (no group
    may be open already); destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_inputs(specs: dict) -> dict:
    """Zero tensors (fake under the active FakeTensorMode) for meta specs."""
    return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in specs.items()}


def _trace(fn, external=()) -> dict:
    """Run ``fn`` under the counters; returns the counter and the
    tracker."""
    from torch.distributed._tools.mem_tracker import MemTracker

    tracker = MemTracker()
    if external:
        tracker.track_external(*external)
    counter = rf.TraceCounter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with rf.quiet_propagation(), tracker, counter:
            fn()
    return {"counter": counter, "tracker": tracker}


def _state_tensors(state) -> list:
    return [t for t in T.layer_leaves((state.params.param_tree(),
                                       tuple(state.opt_state)))
            if isinstance(t, torch.Tensor)]


def trace_train(arch, shape, mesh, zero1: bool = False) -> dict:
    """One train step of ``arch`` at ``shape`` on ``mesh``, traced."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.train.step import (
        init_train_state,
        make_train_step,
        shard_train_state,
    )

    rules = _rules(mesh, arch)
    with FakeTensorMode():
        state = shard_train_state(
            init_train_state(arch, torch.Generator(), device="cpu"), rules)
        batch = _fake_inputs(train_input_specs(arch, shape))
        step = make_train_step(arch, shape, rules, zero1=zero1)
        return _trace(lambda: step(state, batch), _state_tensors(state))


def _serving_model(arch, rules):
    from repro_torch.models.transformer import init_params
    from repro_torch.train.step import shard_model

    return shard_model(init_params(arch, torch.Generator(), device="cpu"),
                       rules)


def trace_serve(arch, shape, mesh) -> dict:
    """decode_* / long_*: one new token against a seq_len cache."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.transformer import decode_step, init_cache

    rules = _rules(mesh, arch)
    with FakeTensorMode():
        model = _serving_model(arch, rules)
        cache = init_cache(arch, shape.global_batch, shape.seq_len,
                           device="cpu")
        cache_pl = to_shardings(cache_spec_tree(cache, arch, rules),
                                rules.device_mesh)
        cache = _lay_out(cache, cache_pl, rules.device_mesh)
        ins = _fake_inputs(decode_input_specs(arch, shape))
        token = rules.shard(ins["token"], None)

        def step():
            with _implicit():
                decode_step(model, cache, token, shape.seq_len - 1, arch,
                            ins.get("positions3"))

        return _trace(step, list(model.parameters()) + T.leaves(cache))


def trace_prefill(arch, shape, mesh) -> dict:
    """prefill_32k: full forward over the prompt (logits)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.shardings import batch_specs
    from repro_torch.models.transformer import forward_train

    arch = dataclasses.replace(arch, attn_fwd_only=True)
    rules = _rules(mesh, arch)
    with FakeTensorMode():
        model = _serving_model(arch, rules)
        specs = train_input_specs(arch, shape)
        specs.pop("labels")
        b_pl = to_shardings({k: v for k, v in batch_specs(
            arch, shape, rules).items() if k != "labels"}, rules.device_mesh)
        batch = {k: to_layout(v, rules.device_mesh, b_pl[k])
                 for k, v in _fake_inputs(specs).items()}

        def step():
            with torch.no_grad(), _implicit():
                forward_train(model, batch, arch, rules=rules)

        return _trace(step, list(model.parameters()))


def _implicit():
    from repro_torch.models.sharding import implicit_replication

    return implicit_replication()


def _lay_out(tree, placements_tree, mesh):
    """Every tensor of ``tree`` (dicts) laid out by the matching
    placements."""
    if isinstance(tree, dict):
        return {k: _lay_out(v, placements_tree[k], mesh)
                for k, v in tree.items()}
    return to_layout(tree, mesh, placements_tree)


def _units(arch) -> int:
    """Scan units: hybrid archs scan blocks, everything else scans layers."""
    if arch.family == "hybrid":
        return (arch.num_layers - len(arch.tail_pattern)) // len(arch.block_pattern)
    return arch.num_layers


def _with_units(arch, n: int):
    if arch.family == "hybrid":
        L = n * len(arch.block_pattern) + len(arch.tail_pattern)
    else:
        L = n
    return dataclasses.replace(arch, num_layers=L)


_COST_KEYS = ("hlo_flops", "hlo_bytes", "collective_bytes")


def _lin(c1: dict, c2: dict, u1: int, u2: int, u: float) -> dict:
    """Linear extrapolation of cost counters in the unit count."""
    out = {}
    for k in _COST_KEYS:
        slope = (c2[k] - c1[k]) / (u2 - u1)
        out[k] = max(c1[k] + slope * (u - u1), 0.0)
    return out


def _sub(a: dict, b: dict) -> dict:
    return {k: a[k] - b[k] for k in _COST_KEYS}


def _add(a: dict, b: dict, scale: float = 1.0) -> dict:
    return {k: max(a[k] + scale * b[k], 0.0) for k in _COST_KEYS}


def _trace_cell(arch, shape, mesh, zero1=False) -> dict:
    if shape.kind == "train":
        return trace_train(arch, shape, mesh, zero1=zero1)
    if shape.kind == "prefill":
        return trace_prefill(arch, shape, mesh)
    return trace_serve(arch, shape, mesh)


def _peak(tr: dict) -> float:
    return float(rf.memory_stats(tr["tracker"]).get("peak_bytes_per_device",
                                                    0))


def calibrated_counters(arch, shape, mesh, zero1: bool = False,
                        traces: dict | None = None) -> dict:
    """Per-step flop/byte/collective counters (and peak bytes) of the full
    depth, extrapolated from traces at 1 and 2 scan units.

    Train: cost(L, m) = O(L) + m * S(L) with O, S linear in scan units —
    four trace points (microbatches of the full shape's size). Prefill /
    decode: linear in units — two points. ``traces`` collects the traces
    by (units, microbatches)."""
    from repro_torch.train.step import effective_microbatches

    traces = {} if traces is None else traces
    u1, u2 = 1, 2
    uf = _units(arch)
    if shape.kind == "train":
        num_mb = effective_microbatches(shape, _rules(mesh, arch))
        mb_batch = shape.global_batch // num_mb
        p = {}
        for u in (u1, u2):
            a = _with_units(arch, u)
            for m in (1, 2):
                sh = dataclasses.replace(shape, global_batch=m * mb_batch,
                                         num_microbatches=m)
                traces[(u, m)] = _trace_cell(a, sh, mesh, zero1=zero1)
                p[(u, m)] = traces[(u, m)]["counter"].counters()
        s1 = _sub(p[(u1, 2)], p[(u1, 1)])   # one extra microbatch at u1
        s2 = _sub(p[(u2, 2)], p[(u2, 1)])
        o1 = _sub(p[(u1, 1)], s1)           # mb-independent part at u1
        o2 = _sub(p[(u2, 1)], s2)
        out = _add(_lin(o1, o2, u1, u2, uf), _lin(s1, s2, u1, u2, uf),
                   scale=num_mb)
        peaks = (_peak(traces[(u1, 2)]), _peak(traces[(u2, 2)]))
    else:
        for u in (u1, u2):
            traces[(u, 1)] = _trace_cell(_with_units(arch, u), shape, mesh)
        out = _lin(traces[(u1, 1)]["counter"].counters(),
                   traces[(u2, 1)]["counter"].counters(), u1, u2, uf)
        peaks = (_peak(traces[(u1, 1)]), _peak(traces[(u2, 1)]))
    out["peak_bytes_per_device"] = peaks[0] + (peaks[1] - peaks[0]) * (uf - u1)
    return out


def dryrun_cell(
    arch_id: str, shape_id: str, multi_pod: bool, verbose=True,
    arch_overrides: dict | None = None, zero1: bool = False,
) -> dict:
    """The reference's record for one cell (``compile_s`` is ``trace_s``).
    Opens (and closes) the fake process group of the mesh's size."""
    arch = get_arch(arch_id)
    if arch_overrides:
        arch = dataclasses.replace(arch, **arch_overrides)
    shape = SHAPES[shape_id]
    ok, why = shape_applicable(arch, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {
        "arch": arch_id, "shape": shape_id, "mesh": mesh_name,
        "status": "skip" if not ok else None, "skip_reason": why or None,
    }
    if not ok:
        return rec
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        n_dev = mesh.size()
        t0 = time.perf_counter()
        traces: dict = {}
        counters = calibrated_counters(arch, shape, mesh, zero1=zero1,
                                       traces=traces)
        body = traces[(1, 1)]
        t1 = time.perf_counter()
    terms = rf.terms_from_counters(counters)
    raw = rf.cost_terms(body["counter"])
    mf = rf.model_flops(arch, shape)
    peak = counters["peak_bytes_per_device"]
    rec.update(
        status="ok",
        trace_s=round(t1 - t0, 2),
        devices=n_dev,
        model_flops_global=mf,
        model_flops_per_device=mf / n_dev,
        raw_loop_body_terms=raw,       # one scan unit, one microbatch
        collective_breakdown=raw["collective_breakdown"],
        collective_counts=raw["collective_counts"],
        memory=rf.memory_stats(body["tracker"]),
        **terms,
        useful_flops_ratio=(mf / n_dev) / terms["hlo_flops"]
        if terms["hlo_flops"] else None,
        fits_hbm=bool(peak <= HBM_BYTES),
        peak_gib_per_device=round(peak / 2**30, 3),
    )
    if verbose:
        print(json.dumps({k: v for k, v in rec.items() if k != "memory"}))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for aid in archs:
        for sid in shapes:
            for mp in meshes:
                tag = f"{aid}_{sid}_{'multi' if mp else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skip"):
                            continue
                try:
                    rec = dryrun_cell(aid, sid, mp)
                except Exception as e:
                    failures += 1
                    rec = {
                        "arch": aid, "shape": sid,
                        "mesh": "pod2x16x16" if mp else "pod16x16",
                        "status": "error", "error": repr(e),
                        "traceback": traceback.format_exc()[-4000:],
                    }
                    print(f"FAIL {tag}: {e!r}")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
