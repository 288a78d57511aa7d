"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: both checked on the import
statements (whole top-level names) and by importing with them blocked."""

import ast
import importlib
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "scale_letkf_tpu"}
PROGRAM = "scale_letkf_torch"


def imported(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in imported(path)
    assert imported(path) <= {"__future__", "dataclasses", "typing", "numpy",
                              "torch", "benchmark"}


def test_names_compare_whole():
    # the program's name begins with the JAX package's: only the whole
    # top-level name counts
    assert PROGRAM.startswith("scale_letkf_t")
    assert PROGRAM not in JAX


def test_reference_imports_with_the_program_blocked(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in JAX | {PROGRAM} or name.startswith(
                "benchmark.reference"):
            monkeypatch.delitem(sys.modules, name)
    for name in JAX | {PROGRAM}:
        monkeypatch.setitem(sys.modules, name, None)
    for mod in ("model", "obsop", "letkf", "namelist"):
        importlib.import_module(f"benchmark.reference.{mod}")


def test_forbidden_modules_are_found_by_whole_name(monkeypatch):
    import types
    from benchmark import harness as H
    monkeypatch.setitem(sys.modules, "scale_letkf_torch_like", types.ModuleType("x"))
    assert "scale_letkf_torch_like" not in H.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert H.forbidden_modules() == ["jax"]
