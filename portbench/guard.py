"""The import guard: no JAX and nothing of the JAX package in a run.

A module counts by its top-level name, the part before the first dot,
compared whole: ``repro_torch`` (the port) is not ``repro`` (the JAX
package).
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})


def forbidden_modules(modules=None) -> list[str]:
    """Names of loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in list(names) if m.split(".", 1)[0] in FORBIDDEN)
