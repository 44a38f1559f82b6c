"""The port and its chip smoke script stand alone: no JAX, nothing of the
JAX package, and neither pydantic nor prometheus_client, which the card
machine lacks (the JAX app needs both; the port's app does without).
Checked statically (AST of every source) and dynamically (importing the
whole port in a fresh interpreter)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "rag_foundation_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "rag_foundation_tpu", "pydantic",
             "prometheus_client")


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


def test_the_app_is_covered():
    # the app, its runtime and its benchmark client are checked like
    # every other module of the port
    names = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"app/main.py", "app/config.py", "app/metrics.py",
            "app/routes/chat.py", "app/services/rag.py",
            "runtime/http.py", "benchmark/runner.py"} <= names


def test_the_parallel_package_is_covered():
    # the sharded engine (mesh, top-k merge, sharded store and IVF), the
    # sharded training step and its dryrun tool are checked like every
    # other module of the port
    names = {p.stem for p in SOURCES if p.parent.name == "parallel"}
    assert {"mesh", "topk_merge", "sharded_index", "sharded_ivf",
            "train_step"} <= names
    assert PORT / "tools" / "dryrun_multichip.py" in SOURCES


# the JAX package's modules whose counterpart in the port has another name
# or place: the Pallas kernels' wrappers (their kernels in ``csrc/``), the
# engine process, and the platform pin, which the port's rule of
# ``RAGTPU_ENGINE_PLATFORM`` (``app/services/rag.engine_device``) replaces
RENAMED = {
    "ops/pallas_ivf.py": "ops/ivf_scan.py",
    "ops/pallas_pq.py": "ops/pq_scan.py",
    "ops/pallas_gather.py": "ops/gather.py",
    "ops/pallas_topk.py": "ops/fused_topk.py",
    "ops/pallas_block_topk.py": "ops/block_topk.py",
    "app/engine_main.py": "engine_main.py",
    "utils/platform.py": "app/services/rag.py",
}


def test_every_jax_module_and_static_file_has_a_port_counterpart():
    jax_pkg = ROOT / "rag_foundation_tpu"
    files = sorted(str(p.relative_to(jax_pkg)) for p in jax_pkg.rglob("*")
                   if p.is_file() and "__pycache__" not in p.parts
                   and (p.suffix == ".py" or p.parent.name == "static"))
    missing = [f for f in files
               if not (PORT / RENAMED.get(f, f)).resolve().is_file()]
    assert missing == []
    assert {"app/worker_main.py", "app/routes/admin.py",
            "app/routes/documents.py", "app/routes/settings_routes.py",
            "app/routes/costs_routes.py", "benchmark/loadgen.py",
            "utils/sse.py", "utils/chatview.py", "utils/uploadview.py",
            "utils/clock.py", "app/static/index.html"} <= set(files)


def test_the_operator_tools_are_covered():
    names = {p.name for p in SOURCES if p.parent == PORT / "tools"}
    assert {"create_first_admin.py", "mark_stuck_documents_error.py",
            "cleanup_uploads.py"} <= names
