"""The port and its chip smoke script stand alone: no JAX, nothing of the
JAX package. Checked statically (AST of every source) and dynamically
(importing the whole port in a fresh interpreter)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "rag_foundation_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "rag_foundation_tpu")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            mods.append(str(node.args[0].value))
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    ROOT)))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path}: {bad}"


def test_importing_the_port_loads_neither():
    mods = sorted(
        "rag_foundation_tpu_torch." + ".".join(
            p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_parallel_package_is_covered():
    # the sharded engine (mesh, top-k merge, sharded store and IVF), the
    # sharded training step and its dryrun tool are checked like every
    # other module of the port
    names = {p.stem for p in SOURCES if p.parent.name == "parallel"}
    assert {"mesh", "topk_merge", "sharded_index", "sharded_ivf",
            "train_step"} <= names
    assert PORT / "tools" / "dryrun_multichip.py" in SOURCES
