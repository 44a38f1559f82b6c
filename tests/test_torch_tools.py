"""The port's operator tools against the scripts they stand in for:
``python -m rag_foundation_tpu_torch.tools.<name>`` and
``python scripts/<name>.py``, each run on its own copy of one sqlite
database (and data dir) from the same ``RAGTPU_*`` variables, exit with
the same code, print the same lines and leave the same rows (the
password hashes are salted, so those compare by verification; the times
the tools write compare as written or not)."""

import os
import shutil
import sqlite3
import subprocess
import sys
import time
from pathlib import Path

import pytest

from rag_foundation_tpu_torch.app.auth import hash_password, verify_password
from rag_foundation_tpu_torch.app.dbschema import MIGRATIONS
from rag_foundation_tpu_torch.runtime.db import Database

ROOT = Path(__file__).resolve().parents[1]
PASSWORD = "Admin-Passw0rd-9"
NOW = time.time()


def _seed(root: Path) -> None:
    """A deployment's database and data dir: two users, a store, and
    documents in every state, some stale, some with payloads on disk."""
    db = Database(str(root / "app.db"), migrations=MIGRATIONS)
    db.execute("INSERT INTO users(email, password_hash, role, created_at)"
               " VALUES('old@example.com', ?, 'user', 1.0)",
               (hash_password("Old-Passw0rd-1"),))
    db.execute("INSERT INTO users(email, password_hash, role, is_active,"
               " created_at) VALUES('off@example.com', 'x', 'user', 0, 2.0)")
    db.execute("INSERT INTO stores(user_id, name, engine_key, created_at)"
               " VALUES(1, 's', 'stores/1-s-00000000', 3.0)")
    uploads = root / "data" / "uploads"
    uploads.mkdir(parents=True)
    docs = [("DONE", NOW - 9000), ("RUNNING", NOW - 9000),
            ("RUNNING", NOW - 30), ("PENDING", NOW - 9000),
            ("ERROR", NOW - 9000), ("RUNNING", NOW - 700)]
    for i, (status, t) in enumerate(docs, start=1):
        db.execute(
            "INSERT INTO documents(store_id, user_id, filename, status,"
            " status_updated_at, created_at) VALUES(1, 1, ?, ?, ?, ?)",
            (f"d{i}.txt", status, t, t))
        payload = uploads / f"doc-{i}"
        payload.write_text(f"payload {i}")
        os.utime(payload, (t, t))
    for name, age in (("doc-99", 90_000), ("doc-x", 90_000),
                      ("notes.txt", 90_000), ("doc-98", 60)):
        p = uploads / name
        p.write_text(name)
        os.utime(p, (NOW - age, NOW - age))


def _run(kind: str, name: str, root: Path, *args: str):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAGTPU_")}
    env.update(PYTHONPATH=str(ROOT), RAGTPU_ENVIRONMENT="development",
               RAGTPU_DATABASE_PATH=str(root / "app.db"),
               RAGTPU_DATA_DIR=str(root / "data"),
               RAGTPU_WATCHDOG_STALE_S="600")
    cmd = ([sys.executable, str(ROOT / "scripts" / f"{name}.py")]
           if kind == "script" else
           [sys.executable, "-m", f"rag_foundation_tpu_torch.tools.{name}"])
    out = subprocess.run(cmd + list(args), cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout.replace(str(root), "<root>"), \
        out.stderr.strip().splitlines()[-1:] if out.returncode else []


def _rows(root: Path) -> dict:
    conn = sqlite3.connect(root / "app.db")
    conn.row_factory = sqlite3.Row
    out = {}
    for table in ("users", "documents"):
        rows = [dict(r) for r in conn.execute(
            f"SELECT * FROM {table} ORDER BY id")]
        for r in rows:
            if "password_hash" in r:
                r["password_hash"] = verify_password(PASSWORD,
                                                     r["password_hash"])
                r["created_at"] = r["created_at"] > 100
            if "status_updated_at" in r:
                r["status_updated_at"] = r["status_updated_at"] > NOW
        out[table] = rows
    conn.close()
    out["payloads"] = sorted(p.name for p in
                             (root / "data" / "uploads").iterdir())
    return out


def _both(tmp_path, name: str, *args: str, runs: int = 1):
    results = {}
    for kind in ("script", "tool"):
        root = tmp_path / kind
        if not root.exists():
            _seed(root)
        results[kind] = [_run(kind, name, root, *args)
                         for _ in range(runs)], _rows(root)
    return results["script"], results["tool"]


@pytest.mark.parametrize("email,password", [
    ("New@Example.com ", PASSWORD), ("old@example.com", PASSWORD),
    ("off@example.com", PASSWORD), ("x@example.com", "short")],
    ids=["create", "promote", "reactivate", "weak password"])
def test_create_first_admin(tmp_path, email, password):
    script, tool = _both(tmp_path, "create_first_admin", "--email", email,
                         "--password", password)
    assert tool == script
    rc = tool[0][0][0]
    assert rc == (1 if password == "short" else 0)


def test_create_first_admin_needs_its_flags(tmp_path):
    script, tool = _both(tmp_path, "create_first_admin", "--email", "a@b.co")
    assert tool == script and tool[0][0][0] == 2


@pytest.mark.parametrize("args", [(), ("--stale-s", "60"),
                                  ("--stale-s", "100000")],
                         ids=["default", "60s", "none stale"])
def test_mark_stuck_documents_error(tmp_path, args):
    script, tool = _both(tmp_path, "mark_stuck_documents_error", *args,
                         runs=2)
    assert tool == script
    statuses = [d["status"] for d in tool[1]["documents"]]
    if args == ():
        assert statuses == ["DONE", "ERROR", "RUNNING", "PENDING", "ERROR",
                            "ERROR"]
        assert [r[1] for r in tool[0]] == [
            "reset 2 stuck document(s) to ERROR\n",
            "reset 0 stuck document(s) to ERROR\n"]


@pytest.mark.parametrize("args", [(), ("--dry-run",),
                                  ("--max-age-hours", "0"),
                                  ("--max-age-hours", "0.01")],
                         ids=["default", "dry run", "off", "36s"])
def test_cleanup_uploads(tmp_path, args):
    script, tool = _both(tmp_path, "cleanup_uploads", *args)
    assert tool == script
    if args == ("--max-age-hours", "0.01"):
        # active documents keep their payloads, as do names not doc-<id>
        assert tool[1]["payloads"] == ["doc-2", "doc-3", "doc-4", "doc-6",
                                       "doc-x", "notes.txt"]


def test_tools_run_without_the_jax_package_on_the_path(tmp_path):
    """The tools need neither JAX nor pydantic: run from a tree that
    holds the port alone."""
    tree = tmp_path / "tree"
    shutil.copytree(ROOT / "rag_foundation_tpu_torch",
                    tree / "rag_foundation_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    root = tmp_path / "deploy"
    _seed(root)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAGTPU_")}
    env.update(PYTHONPATH=str(tree),
               RAGTPU_DATABASE_PATH=str(root / "app.db"),
               RAGTPU_DATA_DIR=str(root / "data"))
    code = ("import sys, runpy\n"
            "sys.modules['pydantic'] = None\n"
            "sys.modules['jax'] = None\n"
            "sys.argv = sys.argv[1:]\n"
            "runpy.run_module(sys.argv[0], run_name='__main__')\n")
    for name, args in (("create_first_admin", ["--email", "a@b.co",
                                               "--password", PASSWORD]),
                       ("mark_stuck_documents_error", []),
                       ("cleanup_uploads", ["--dry-run"])):
        out = subprocess.run(
            [sys.executable, "-c", code,
             f"rag_foundation_tpu_torch.tools.{name}", *args],
            cwd=tree, env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
