"""No module of the benchmark imports JAX or the JAX package, compared
by whole top-level name (``ompi_tpu_torch`` is the port and passes;
``ompi_tpu`` does not); the plain reference imports nothing of the
port, directly or through the benchmark's own modules."""

import ast
import os

import pytest

from benchmark.tests.helpers import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "ompi_tpu"}


def _py_files(top):
    for dirpath, dirs, names in os.walk(top):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def imports(path):
    """Top-level names of every module a file imports (``from . import``
    resolved against the benchmark package)."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level:
                out.add("benchmark." + node.module)
            else:
                out.add(node.module)
                out |= {f"{node.module}.{a.name}" for a in node.names}
    return out


def top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", list(_py_files(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_by_whole_top_level_name(path):
    assert not {top(m) for m in imports(path)} & FORBIDDEN


def test_the_check_compares_whole_names():
    assert top("ompi_tpu_torch.zero") not in FORBIDDEN
    assert top("ompi_tpu.zero") in FORBIDDEN


def _module_file(name):
    parts = name.split(".")
    base = os.path.join(os.path.dirname(BENCH), *parts)
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(cand):
            return cand
    return None


def test_reference_imports_nothing_of_the_port():
    todo = list(_py_files(os.path.join(BENCH, "reference")))
    seen, names = set(), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for m in imports(path):
            names.add(m)
            if top(m) == "benchmark":
                f = _module_file(m)
                if f:
                    todo.append(f)
    assert "benchmark.lib.inputs" in names
    assert not {top(m) for m in names} & (FORBIDDEN | {"ompi_tpu_torch"})
