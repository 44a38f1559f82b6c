"""The repo's own gates, run over the port's files.

- The route table: the port app serves exactly the 34 routes of
  ``docs/api_spec.json``, taken from ``app._routes`` as
  ``scripts/export_api_spec.py`` takes them from the JAX app.
- The security gates of ``scripts/`` (admin patterns, SQL patterns, taint
  flows, XSS patterns) give the port's ``app/`` and ``runtime/`` the
  verdicts they give the JAX package's: clean where they scan by
  default, and the same findings, file by file, where the admin gate is
  pointed at the other routers.
- The twin-parity gate holds the port's static JavaScript and its
  Python twins in lockstep, and fires when one side alone changes.

The gates are imported as ``tests/test_twin_parity.py`` and
``tests/test_audit_gates.py`` import them; none is edited."""

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import check_admin_patterns as admin_gate  # noqa: E402
import check_sql_patterns as sql_gate  # noqa: E402
import check_taint_flows as taint_gate  # noqa: E402
import check_twin_parity as twin_gate  # noqa: E402
import check_xss_patterns as xss_gate  # noqa: E402

PORT = ROOT / "rag_foundation_tpu_torch"
JAX = ROOT / "rag_foundation_tpu"


def test_port_routes_equal_the_committed_api_spec(tmp_path):
    from rag_foundation_tpu_torch.app.config import Settings
    from rag_foundation_tpu_torch.app.main import build_context, create_app
    settings = Settings(ENVIRONMENT="test", DATABASE_PATH=":memory:",
                        DATA_DIR=str(tmp_path), MOCK_MODE=True)
    app = create_app(build_context(settings, with_worker=False),
                     start_worker=False)
    routes = sorted({f"{m} {raw}" for m, _pat, raw, _fn in app._routes})
    committed = json.loads((ROOT / "docs" / "api_spec.json").read_text())
    assert len(committed["routes"]) == 34
    assert routes == committed["routes"]


def _py(root: Path, *subdirs: str) -> list[Path]:
    return sorted(p for d in subdirs for p in (root / d).rglob("*.py"))


def test_admin_gate_passes_the_port_admin_router():
    assert admin_gate.check_file(PORT / "app" / "routes" / "admin.py") == []


def _findings_without_lines(findings: list[str]) -> list[str]:
    return sorted(re.sub(r":\d+ ", " ", f) for f in findings)


@pytest.mark.parametrize("name", sorted(
    p.name for p in (JAX / "app" / "routes").glob("*.py")))
def test_admin_gate_verdict_per_router_equals_the_jax_one(name):
    assert _findings_without_lines(admin_gate.check_file(
        PORT / "app" / "routes" / name)) == _findings_without_lines(
        admin_gate.check_file(JAX / "app" / "routes" / name))


def test_sql_gate_finds_nothing_in_the_port():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 100
    assert [f for p in files for f in sql_gate.scan(p)] == []


def test_taint_gate_finds_nothing_in_the_port_app_and_runtime():
    files = _py(PORT, "app", "runtime")
    assert PORT / "app" / "routes" / "documents.py" in files
    assert [f for p in files for f in taint_gate.scan(p)] == []
    assert taint_gate.main([str(PORT / "app"), str(PORT / "runtime")]) == 0


def test_xss_gate_passes_the_port_static_files():
    files = sorted((PORT / "app" / "static").glob("*.js"))
    assert len(files) == 7
    assert [f for p in files for f in xss_gate.lint_file(p)] == []
    assert xss_gate.main(PORT / "app" / "static") == 0


def test_twin_parity_gate_passes_the_port():
    assert twin_gate.check_parity(PORT / "app" / "static",
                                  PORT / "utils") == []


@pytest.mark.parametrize("rel,old,new,kind", [
    ("static/chat.js", 'case "source-document":', 'case "source-doc":',
     "frame-type branches"),
    ("utils/sse.py", 'line.startswith("data: ")', 'line.startswith("data:")',
     "sse wire literal 'prefix'"),
    ("utils/uploadview.py", 'f"done ({st.get(\'chunks\')} chunks, {secs}s)"',
     'f"finished ({st.get(\'chunks\')} chunks)"', "upload phase templates"),
], ids=["chat.js", "sse.py", "uploadview.py"])
def test_twin_parity_gate_fires_on_one_sided_port_changes(tmp_path, rel, old,
                                                         new, kind):
    static, utils = tmp_path / "static", tmp_path / "utils"
    shutil.copytree(PORT / "app" / "static", static)
    shutil.copytree(PORT / "utils", utils)
    target = tmp_path / rel
    src = target.read_text()
    assert old in src, f"mutation anchor {old!r} missing from {rel}"
    target.write_text(src.replace(old, new))
    assert any(kind in e for e in twin_gate.check_parity(static, utils))
