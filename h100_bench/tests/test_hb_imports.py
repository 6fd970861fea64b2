"""No module under h100_bench imports jax, jaxlib, flax or the JAX
package, by top-level name compared whole (the port's name begins with
the JAX package's); the references import nothing of the program
(only each other)."""

import ast
import os

from hb.common import FORBIDDEN_MODULES

from conftest import BENCH


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    seen = 0
    for path in _sources():
        bad = set(_imports(path)) & set(FORBIDDEN_MODULES)
        assert not bad, f"{path} imports {bad}"
        seen += 1
    assert seen > 20


def test_references_import_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = set(_imports(os.path.join(ref, f)))
            assert names <= {"__future__", "math", "typing", "numpy",
                             "torch", "reference"}, (f, names)
