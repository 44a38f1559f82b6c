"""The split topology on the CPU: a port ``engine_main`` owns the engine
(``RAGTPU_ENGINE_PLATFORM=cpu``), a port API process runs in connect mode
with ``WORKER_IN_PROCESS=0``, and two ``python -m
rag_foundation_tpu_torch.app.worker_main`` processes drain the shared
sqlite job queue and run the crons. Uploads reach DONE through the
workers, each job leased once; the recall audit cron logs
``recall_audit`` for the store; SIGTERM stops a worker with
``worker_stopped``. Without a card, without ``RAGTPU_ENGINE_PLATFORM=cpu``
and not in connect mode a worker exits non-zero."""

import json
import os
import signal
import sqlite3
import subprocess
import sys
import time
from pathlib import Path

from rag_foundation_tpu_torch.benchmark.runner import ApiClient
from tests.test_torch_app_quality import _app_env, _free_port, _wait_live

ROOT = Path(__file__).resolve().parents[1]
DOC = ("The glacier research station sits at four thousand meters and "
       "houses nine scientists through the winter season. " * 6)


def _spawn(args, env, log: Path):
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT,
                                env=env, stdout=f, stderr=subprocess.STDOUT)


def _events(log: Path) -> list[dict]:
    out = []
    for line in log.read_text().splitlines():
        if line.startswith("{"):
            try:
                out.append(json.loads(line))
            except ValueError:
                pass
    return out


def _wait_for(pred, timeout_s: float, what: str):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _stop(proc, timeout_s: float = 15.0) -> int:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait(5)


def test_split_topology_drains_uploads_and_audits_recall(tmp_path):
    sock = str(tmp_path / "engine.sock")
    env = _app_env(tmp_path, RAGTPU_ENGINE_RPC_SOCKET=sock,
                   RAGTPU_WORKER_IN_PROCESS="false",
                   RAGTPU_ENGINE_RECALL_AUDIT_S="1")
    engine_env = dict(env, RAGTPU_ENGINE_PLATFORM="cpu")
    connect_env = dict(env, RAGTPU_ENGINE_RPC_MODE="connect")
    logs = {n: tmp_path / f"{n}.log"
            for n in ("engine", "api", "worker0", "worker1")}
    procs = {"engine": _spawn(["rag_foundation_tpu_torch.engine_main"],
                              engine_env, logs["engine"])}
    try:
        _wait_for(lambda: os.path.exists(sock), 60, "the engine socket")
        port = _free_port()
        procs["api"] = _spawn(["rag_foundation_tpu_torch.app.main",
                               "--port", str(port)], connect_env,
                              logs["api"])
        for i in range(2):
            procs[f"worker{i}"] = _spawn(
                ["rag_foundation_tpu_torch.app.worker_main"], connect_env,
                logs[f"worker{i}"])
        _wait_live(port, procs["api"], 60)
        for i in range(2):
            started = _wait_for(
                lambda i=i: [e for e in _events(logs[f"worker{i}"])
                             if e["msg"] == "worker_started"], 60,
                "worker_started")
            assert started[0]["device"] == "remote"
        api = [e for e in _events(logs["api"]) if e["msg"] == "app_started"]
        assert api[0]["device"] == "remote"

        client = ApiClient.from_credentials(
            f"http://127.0.0.1:{port}", "split@example.com",
            "Split-Passw0rd-1", register=True)
        client.poll_interval_s = 0.05
        store = client.ensure_store("split")
        paths = []
        for i in range(3):
            p = tmp_path / f"glacier{i}.txt"
            p.write_text(DOC.replace("nine", ["nine", "ten", "six"][i]))
            paths.append(p)
        for p in paths:
            st = client.upload_and_poll(store["id"], p, timeout_s=60)
            assert st["status"] == "DONE", st
        out = client.ask("How many scientists live at the glacier "
                         "station?", [store["id"]])
        assert out["error"] is None and out["citations"]

        db = sqlite3.connect(tmp_path / "app.db")
        key = db.execute("SELECT engine_key FROM stores").fetchone()[0]
        chunks = db.execute("SELECT SUM(chunks) FROM documents").fetchone()[0]
        # the first audit after the last upload samples every chunk
        audits = _wait_for(
            lambda: [e for i in range(2)
                     for e in _events(logs[f"worker{i}"])
                     if e["msg"] == "recall_audit" and e["store"] == key
                     and e["sample"] == min(32, chunks)], 30,
            "recall_audit")
        # exact mode: the approximate path is the exact path
        assert audits[0]["recall"] == 1.0
        assert audits[0]["k"] == min(10, chunks)
        jobs = sqlite3.connect(tmp_path / "app.db").execute(
            "SELECT status, attempts FROM jobs").fetchall()
        assert jobs == [("done", 1)] * 3

        for i in range(2):
            assert _stop(procs.pop(f"worker{i}")) == 0
            msgs = [e["msg"] for e in _events(logs[f"worker{i}"])]
            assert msgs[-1] == "worker_stopped"
            assert not any(m == "recall_audit_failed" for m in msgs)
    finally:
        for proc in reversed(procs.values()):     # the engine last
            _stop(proc)


def test_worker_refuses_without_a_card(tmp_path):
    """Neither ``RAGTPU_ENGINE_PLATFORM=cpu`` nor connect mode: the
    worker's in-process engine asks for the card and the worker exits,
    no CPU fallback."""
    out = subprocess.run(
        [sys.executable, "-m", "rag_foundation_tpu_torch.app.worker_main"],
        cwd=ROOT, env=_app_env(tmp_path, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=60)
    assert out.returncode != 0
    assert "engine unavailable at startup" in out.stderr
    assert "no CUDA card" in out.stderr
    assert "worker_started" not in out.stderr + out.stdout
