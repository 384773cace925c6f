"""No JAX and nothing of the JAX package or its benchmarks in a run or
in the harness's sources; the reference and the yardstick import nothing
of the program."""
from __future__ import annotations

import ast

import pytest

from portbench.guard import FORBIDDEN, forbidden_modules
from portbench.tests import cells

SOURCES = sorted((cells.REPO / "portbench").rglob("*.py"))
# the adapter to the system under test, and the tests' fault injection
MAY_IMPORT_PROGRAM = {"system.py", "rehearse.py"}


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_guard_compares_whole_top_level_names():
    loaded = {"jax.numpy": 1, "repro": 1, "repro.core": 1, "repro_torch": 1,
              "repro_torch.core": 1, "jaxtyping": 1, "flax": 1,
              "benchmarks.run": 1, "numpy": 1}
    assert forbidden_modules(loaded) == ["benchmarks.run", "flax",
                                         "jax.numpy", "repro", "repro.core"]
    assert {"jax", "jaxlib", "flax", "repro"} <= FORBIDDEN


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(cells.REPO)))
def test_no_source_imports_jax_the_jax_package_or_its_benchmarks(path):
    roots = imported_roots(path)
    assert not roots & FORBIDDEN
    if path.name not in MAY_IMPORT_PROGRAM:
        assert "repro_torch" not in roots, path
