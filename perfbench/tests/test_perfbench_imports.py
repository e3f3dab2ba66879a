"""Nothing the benchmark runs imports JAX or the JAX package `repro`
(top-level names compared whole: `repro_torch` is the program), and
nothing reads the JAX reference's figure harness `benchmarks/`."""

import ast
import sys
import types

import pytest

from perfbench.harness import cell
from perfbench.tests.conftest import REPO

SOURCES = sorted(p for p in (REPO / "perfbench").rglob("*.py")
                 if "tests" not in p.parts)


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(REPO)))
def test_no_jax_and_no_jax_package(path):
    tops = {m.split(".", 1)[0] for m in _imported(path)}
    assert not tops & set(cell.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "perfbench" / "reference").glob("*.py"):
        tops = {m.split(".", 1)[0] for m in _imported(path)}
        assert "repro_torch" not in tops, path


def test_nothing_reads_the_figure_harness():
    for path in SOURCES:
        text = path.read_text()
        assert "benchmarks/" not in text and "benchmarks." not in text, path


def test_run_check_compares_top_level_names(monkeypatch):
    for name in ("repro_torch_probe", "repro.perfbench_probe",
                 "jaxlib_probe", "jax.perfbench_probe"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = cell.forbidden_modules()
    assert "repro.perfbench_probe" in found
    assert "jax.perfbench_probe" in found
    assert "repro_torch_probe" not in found and "jaxlib_probe" not in found
