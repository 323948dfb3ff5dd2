"""No module of the benchmark imports JAX or the JAX package `repro`
(top-level names compared whole: the port `repro_torch` begins with
`repro`), the plain references import nothing of the port, and a run
refuses to report once such a module is loaded."""

import ast
import sys
import types

import pytest

from _tiny import ROOT

from bench import harness

BENCH = ROOT / "bench"
SOURCES = sorted(BENCH.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_found():
    assert BENCH / "run.py" in SOURCES and len(SOURCES) > 10


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert "repro_torch" not in tops, tops
    assert tops <= {"__future__", "contextlib", "math", "typing", "torch",
                    "bench"}, tops


def test_foreign_module_is_named():
    assert harness.foreign_modules() == []
    sys.modules["repro.planted"] = types.ModuleType("repro.planted")
    sys.modules["repro_torch_lookalike"] = types.ModuleType("x")
    try:
        assert harness.foreign_modules() == ["repro.planted"]
    finally:
        del sys.modules["repro.planted"], sys.modules["repro_torch_lookalike"]
