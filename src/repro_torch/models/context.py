"""Sharding context: the counterpart of ``repro.models.context``.

The reference's ``forward_train`` installs its sharding ``Rules`` here so
that nested layers (the MoE dispatch, the SSD scan) can pin activation
shardings without threading a mesh through every call. The port runs on
one device: with no rules installed ``current_dp_size`` is 1 and
``act_shard`` is the identity, which is all the model code asks of them.
Installing rules raises ``NotImplementedError``: sharding rules come with
ROADMAP A13d, as ``forward_train(rules=...)`` says.
"""
from __future__ import annotations

import contextlib
import contextvars

_rules = contextvars.ContextVar("repro_torch_sharding_rules", default=None)


def refuse_rules(rules) -> None:
    """Raise where sharding rules are given: they come with ROADMAP A13d."""
    if rules is not None:
        raise NotImplementedError(
            "sharding rules are not ported yet (ROADMAP A13d)")


@contextlib.contextmanager
def use_rules(rules):
    refuse_rules(rules)
    tok = _rules.set(rules)
    try:
        yield
    finally:
        _rules.reset(tok)


def current_dp_size() -> int:
    """Product of the active dp mesh axes: 1, since no rules are installed."""
    refuse_rules(_rules.get())
    return 1


def act_shard(x, *logical):
    """Constrain activation ``x`` to the logical axes: the identity, since
    no rules are installed."""
    refuse_rules(_rules.get())
    return x
