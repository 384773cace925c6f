"""Input/state sharding builders for the dry run and the drivers:
``repro.launch.shardings`` in PyTorch.

Specs are the reference's, name for name (``models.sharding.PartitionSpec``
trees); ``to_shardings`` turns a spec tree into DTensor placements on a
``DeviceMesh``. One quirk is kept on purpose (ROADMAP C9): an Adafactor
moment takes the spec of the *first* parameter whose shape fits any of the
three shape rules, not necessarily its own parameter's, exactly as the
reference's ``state_specs`` derives it. It moves layout, never values.
"""
from __future__ import annotations

import math

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.sharding import (
    P,
    PartitionSpec,
    Rules,
    fix_spec,
    leaf_name,
    param_specs,
    placements,
    spec_leaves,
)


def _dp(rules: Rules, size: int):
    """dp axes if the dim is divisible, else replicate."""
    dp_size = math.prod(rules.sizes[a] for a in rules.dp)
    if size % dp_size == 0:
        return rules.dp if len(rules.dp) > 1 else rules.dp[0]
    return None


def batch_specs(arch: ArchConfig, shape: ShapeConfig, rules: Rules) -> dict:
    from repro_torch.models.frontend import train_input_specs

    specs = train_input_specs(arch, shape)
    out = {}
    for k, v in specs.items():
        if k == "positions3":
            out[k] = P(None, _dp(rules, v.shape[1]), None)
        else:
            out[k] = P(_dp(rules, v.shape[0]), *([None] * (len(v.shape) - 1)))
    return out


def state_specs(state, rules: Rules):
    """TrainState specs: params by PARAM_RULES; AdamW's ``m``/``v`` mirror
    them, Adafactor's ``vr``/``vc`` are derived by shape (C9)."""
    from repro_torch.optim import AdafactorState, AdamWState
    from repro_torch.train.step import TrainState

    params = state.params
    if hasattr(params, "param_tree"):
        params = params.param_tree()
    params_spec = param_specs(params, rules)
    flat_specs = [s for _, s in spec_leaves(params_spec)]
    by_shape = list(zip((tuple(p.shape) for p in T.leaves(params)),
                        flat_specs))

    def match(leaf):
        shape = tuple(leaf.shape)
        for ps, s in by_shape:
            if shape == ps:
                return s
            if shape == ps[:-1]:  # adafactor vr
                return P(*tuple(s)[:-1])
            if len(ps) >= 2 and shape == ps[:-2] + ps[-1:]:  # vc
                return P(*(tuple(s)[:-2] + tuple(s)[-1:]))
        return P()

    opt = state.opt_state
    if isinstance(opt, AdamWState):
        opt_spec = AdamWState(step=P(), m=params_spec, v=params_spec)
    elif isinstance(opt, AdafactorState):
        opt_spec = AdafactorState(step=P(), vr=T.map(match, opt.vr),
                                  vc=T.map(match, opt.vc))
    else:
        raise TypeError(f"unknown optimizer state {type(opt).__name__}")
    return TrainState(params=params_spec, opt_state=opt_spec, step=P())


def cache_spec_tree(cache, arch: ArchConfig, rules: Rules):
    """KV / SSM / RG-LRU cache specs: batch over dp when divisible; KV
    *sequence* over 'model' (flash-decoding style split-KV); SSM heads /
    recurrence width over 'model'."""
    del arch
    paths = {id(leaf): path for path, leaf in T.flatten(cache)}

    def leaf_spec(leaf):
        name = leaf_name(paths[id(leaf)])
        shape = tuple(leaf.shape)
        nd = len(shape)
        if name in ("k", "v"):
            core = (_dp(rules, shape[nd - 4]), "model", None, None)
            spec = P(*((None,) * (nd - 4) + core))
        elif name == "conv":
            core = (_dp(rules, shape[nd - 3]), None, "model")
            spec = P(*((None,) * (nd - 3) + core))
        elif name == "ssd":
            core = (_dp(rules, shape[nd - 4]), "model", None, None)
            spec = P(*((None,) * (nd - 4) + core))
        elif name == "h":
            core = (_dp(rules, shape[nd - 2]), "model")
            spec = P(*((None,) * (nd - 2) + core))
        else:
            raise KeyError(f"no cache rule for {name}")
        return fix_spec(spec, shape, rules.mesh)

    return T.map(leaf_spec, cache)


def to_shardings(spec_tree, device_mesh):
    """The placements of every spec in ``spec_tree`` (dicts, NamedTuples,
    or one spec) on ``device_mesh``, in the tree's structure."""
    if isinstance(spec_tree, PartitionSpec):
        return placements(spec_tree, device_mesh)
    if isinstance(spec_tree, dict):
        return {k: to_shardings(v, device_mesh) for k, v in spec_tree.items()}
    if hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(to_shardings(v, device_mesh)
                                 for v in spec_tree))
    if spec_tree is None:
        return None
    raise TypeError(f"not a spec tree: {type(spec_tree)}")
