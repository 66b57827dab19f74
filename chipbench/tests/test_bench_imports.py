"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and no
reference imports anything of the port."""

import ast

import pytest

from chipbench.tests.tiny import ROOT

BENCH = ROOT / "chipbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert "repro_torch" not in tops
    assert tops <= {"__future__", "math", "torch", "chipbench"}, tops
    assert all(n == "chipbench.reference" or not n.startswith("chipbench")
               for n in _imports(path))


def test_the_scan_sees_imports():
    found = set(_imports(BENCH / "harness.py"))
    assert "torch" in found and any(n.startswith("repro_torch") for n in found)
