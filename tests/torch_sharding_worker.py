"""Four gloo ranks on a (2, 2) ``("data", "model")`` CPU DeviceMesh running
the port's sharded train step: the worker of ``tests/test_torch_sharding.py``.

    python tests/torch_sharding_worker.py WORKDIR

``WORKDIR/cases.pkl`` holds a list of cases: the arch id, its SMOKE
overrides, the shape's microbatches, ``zero1``, the initial state as the
reference's tree of numpy arrays (``params``, ``opt_state`` fields,
``step``) and the batch. Each rank lays the state out with
``Rules(mesh)``, takes one ``make_train_step(rules=)`` step and rank 0
writes the metrics and the full parameters after the step to
``WORKDIR/results.pkl``. The same world also restores ``WORKDIR/ckpt_in``
(written at ``rules=None``) under ``shardings=`` into a state whose shards
were zeroed, and saves the stepped state of the first case to
``WORKDIR/ckpt_out``, and decodes the first case's first tokens on the
sharded model with a cache laid out by ``cache_spec_tree`` (the last
entry of the results). The processes use torch and numpy only.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import socket
import sys

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

WORLD = 4
JaxState = collections.namedtuple("JaxState", "params opt_state step")


def as_state(tree: dict):
    """The reference's TrainState shape (attributes, opt fields) from the
    plain dict the test pickled."""
    opt = tree["opt_state"]
    Opt = collections.namedtuple("Opt", tuple(opt))
    return JaxState(tree["params"], Opt(**opt), tree["step"])


def _run(rank: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import tree as T
    from repro_torch.checkpoint import checkpointing as ckpt
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.shardings import state_specs, to_shardings
    from repro_torch.models.sharding import Rules, param_shardings
    from repro_torch.train.step import (
        TrainState,
        make_train_step,
        shard_train_state,
        train_state_from_jax,
        train_state_to_numpy,
    )

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = Rules(mesh)
    with open(os.path.join(workdir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    results = []
    for i, case in enumerate(cases):
        cfg = dataclasses.replace(get_arch(case["arch"], smoke=True),
                                  **case["overrides"])
        batch = case["batch"]
        b, t = batch["labels"].shape
        shape = ShapeConfig("t", t, b, "train",
                            num_microbatches=case["num_mb"])
        state = train_state_from_jax(as_state(case["state"]), cfg, "cpu")
        step = make_train_step(cfg, shape, rules, zero1=case["zero1"])
        state, metrics = step(state, batch)
        out = {"metrics": {k: float(v) for k, v in metrics.items()},
               "state": train_state_to_numpy(state)}
        if i == 0:
            ckpt.save(os.path.join(workdir, "ckpt_out"), 1, state)
            # restore the rules=None checkpoint into a zeroed sharded state
            fresh = shard_train_state(train_state_from_jax(
                as_state(case["state"]), cfg, "cpu"), rules)
            for leaf in T.layer_leaves((fresh.params.param_tree(),
                                        tuple(fresh.opt_state)[1:])):
                leaf.to_local().detach().zero_()
            shardings = TrainState(
                params=param_shardings(fresh.params, rules),
                opt_state=to_shardings(state_specs(fresh, rules).opt_state,
                                       rules.device_mesh),
                step=None)
            ckpt.restore(os.path.join(workdir, "ckpt_in"), 0, fresh,
                         shardings)
            out["restored"] = train_state_to_numpy(fresh)
        results.append(out)
    results.append(_decode(rules, cases[0], workdir))
    if rank == 0:
        with open(os.path.join(workdir, "results.pkl"), "wb") as f:
            pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def _decode(rules, case, workdir):
    """Greedy-free decoding of the case's tokens on the sharded model and a
    cache laid out by ``cache_spec_tree``: the full logits of each step."""
    import numpy as np

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.shardings import cache_spec_tree, to_shardings
    from repro_torch.models.sharding import implicit_replication, to_layout
    from repro_torch.models.transformer import decode_step, init_cache
    from repro_torch.train.step import shard_model, train_state_from_jax

    cfg = dataclasses.replace(get_arch(case["arch"], smoke=True),
                              **case["overrides"])
    model = train_state_from_jax(as_state(case["state"]), cfg, "cpu").params
    model = shard_model(model, rules)
    tokens = np.asarray(case["batch"]["tokens"])[:4, :DECODE_STEPS]
    cache = init_cache(cfg, tokens.shape[0], DECODE_STEPS, device="cpu")
    pl = to_shardings(cache_spec_tree(cache, cfg, rules), rules.device_mesh)

    def lay(tree, pls):
        if isinstance(tree, dict):
            return {k: lay(v, pls[k]) for k, v in tree.items()}
        return to_layout(tree, rules.device_mesh, pls)

    cache = lay(cache, pl)
    logits = []
    with torch.no_grad(), implicit_replication():
        for pos in range(DECODE_STEPS):
            tok = rules.shard(torch.as_tensor(tokens[:, pos]), None)
            out, cache = decode_step(model, cache, tok, pos, cfg)
            logits.append(out.full_tensor().numpy())
    return {"decode_logits": np.stack(logits), "decode_tokens": tokens}


DECODE_STEPS = 4


def main(workdir: str) -> None:
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_run, args=(port, workdir), nprocs=WORLD)


if __name__ == "__main__":
    main(sys.argv[1])
