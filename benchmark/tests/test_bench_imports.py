"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the port: each module's top-level name (the
part before the first dot) compared whole."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "jspsr_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert "jspsr_torch" not in names
    assert names <= {"__future__", "benchmark", "contextlib", "importlib",
                     "math", "numpy", "torch", "collections"}, names


def test_the_check_compares_whole_names():
    # the port's name begins with the JAX package's: only whole names count
    assert "jspsr_torch".split(".")[0] not in FORBIDDEN
    assert "jspsr_tpu.nn".split(".")[0] in FORBIDDEN
