"""What the benchmark may import: nothing under ``perfbench/`` imports
JAX, jaxlib, flax or the JAX package (whole top-level names: the port's
name begins with the JAX package's), and the reference's modules import
nothing of the port."""

import ast
from pathlib import Path

import pytest

from perfbench import harness

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "rag_foundation_tpu"}
PORT = "rag_foundation_tpu_torch"
# the plain reference and the yardstick: no module of the port
REFERENCE = ["corpus.py", "reference.py", "compare.py", "roofline.py",
             "traffic.py", "trace.py", "reference_decoder.py", "prompts.py"]


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(PKG)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_imports_nothing_of_the_port(name):
    assert PORT not in top_level_imports(PKG / name)


def test_metric_readers_import_nothing_of_the_port():
    for path in (PKG / "metrics").glob("*.py"):
        assert PORT not in top_level_imports(path), path.name


def test_the_run_refuses_the_same_names():
    assert set(harness.FORBIDDEN) == FORBIDDEN
    assert "rag_foundation_tpu_torch" not in FORBIDDEN


def test_the_guard_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "rag_foundation_tpu_torchx",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jaxlib"]
