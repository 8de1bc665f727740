"""No module of the benchmark imports JAX or the JAX package, judged by
the top-level name as a whole word (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark.harness import main as MAIN

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "webgl_raytracer_tpu"}
MODULES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "dataclasses", "math", "numpy", "torch"}


def test_the_run_refuses_loaded_jax_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "webgl_raytracer_tpu_torch_probe", object())
    assert MAIN.banned_modules() == []
    monkeypatch.setitem(sys.modules, "webgl_raytracer_tpu.ops.probe", object())
    monkeypatch.setitem(sys.modules, "jaxlib.probe", object())
    assert MAIN.banned_modules() == ["jaxlib", "webgl_raytracer_tpu"]
