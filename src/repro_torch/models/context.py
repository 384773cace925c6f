"""Sharding context: the counterpart of ``repro.models.context``.

``forward_train`` installs the active ``Rules`` here so that nested layers
(the MoE dispatch) can pin activation layouts without threading a mesh
through every call. Where the reference constrains a traced value with
``with_sharding_constraint``, ``act_shard`` redistributes a DTensor (or
distributes a plain tensor, the same global value on every rank) to
``fix_spec(rules.spec(...))``. With no rules installed ``current_dp_size``
is 1 and ``act_shard`` returns its tensor as it is.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

_rules = contextvars.ContextVar("repro_torch_sharding_rules", default=None)


@contextlib.contextmanager
def use_rules(rules):
    """Install ``rules``; while they are installed a plain tensor met
    beside a DTensor (a mask, a RoPE table) counts as replicated."""
    tok = _rules.set(rules)
    try:
        if rules is None:
            yield
        else:
            from repro_torch.models.sharding import implicit_replication

            with implicit_replication():
                yield
    finally:
        _rules.reset(tok)


def current_rules():
    """The installed ``Rules``, or None."""
    return _rules.get()


def current_dp_size() -> int:
    """Product of the active dp mesh axes (1 when no rules installed)."""
    rules = _rules.get()
    if rules is None:
        return 1
    return int(math.prod(rules.sizes[a] for a in rules.dp))


def act_shard(x, *logical):
    """Constrain activation ``x`` to the logical axes if rules are active."""
    rules = _rules.get()
    if rules is None:
        return x
    from repro_torch.models.sharding import fix_spec, to_layout

    spec = fix_spec(rules.spec(*logical), x.shape, rules.mesh)
    return to_layout(x, rules.device_mesh, rules.placements(spec))
