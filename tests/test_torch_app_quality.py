"""The port's app end to end on the CPU.

- All 120 questions of ``benchmarks/quality/questions.jsonl`` over the
  ten documents of ``benchmarks/quality/docs``, uploaded through
  ``/api/upload`` and ingested by the worker, asked over SSE through the
  port app (its ``Engine`` in process, ``exact`` mode) and through the
  JAX app, from the same settings: the streamed answers and the cited
  titles and snippets are identical, in order, question by question.
- ``python -m rag_foundation_tpu_torch.app.main`` in its own process,
  driven over a real socket by the port's benchmark client
  (``benchmark.runner``: register, store, upload and poll, concurrent
  SSE chats, EM/F1): the SSE contract of every stream, the same answers
  as in process. It exits with an error where it has no card, unless
  ``RAGTPU_ENGINE_PLATFORM=cpu`` is set.
- ``RAGTPU_ENGINE_RPC_MODE=connect``: the app builds no engine of its
  own, serves chat over a port ``EngineRpcServer`` with the same answers,
  and its health probe goes over the socket.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

from rag_foundation_tpu_torch.benchmark.runner import (ApiClient,
                                                       run_benchmark)
from tests.test_torch_app_helpers import SETTINGS, App, build

ROOT = Path(__file__).resolve().parents[1]
QUALITY = ROOT / "benchmarks" / "quality"
DOCS = sorted((QUALITY / "docs").glob("*.md"))
QUESTIONS = [json.loads(line) for line in
             (QUALITY / "questions.jsonl").read_text().splitlines()
             if line.strip()]
CONTRACT_HEAD = ["start", "text-start"]
CONTRACT_TAIL = ["finish", "[DONE]"]


def _answers(app: App, questions) -> list:
    """(answer, [(title, snippet)]) of each question, asked over SSE."""
    h = app.signup()
    sid = app.create_store(h, "quality")["id"]
    for path in DOCS:
        r = app.client.post("/api/upload", headers=h,
                            data={"store_id": str(sid)},
                            files={"file": (path.name, path.read_bytes(),
                                            "text/markdown")})
        assert r.status_code == 201, r.text
    app.drain()
    out = []
    for q in questions:
        r = app.client.post("/api/chat", headers=h, json_body={
            "question": q["question"], "store_ids": [sid]})
        assert r.status_code == 200, r.text
        frames = [p if p == "[DONE]" else json.loads(p)
                  for p in r.iter_sse()]
        types = [f if f == "[DONE]" else f["type"] for f in frames]
        assert types[:2] == CONTRACT_HEAD and types[-2:] == CONTRACT_TAIL
        out.append(("".join(f.get("delta", "") for f in frames
                            if isinstance(f, dict)
                            and f["type"] == "text-delta"),
                    [(f["title"], f["snippet"]) for f in frames
                     if isinstance(f, dict)
                     and f["type"] == "source-document"]))
    return out


def test_quality_answers_and_citations_equal_the_jax_app(tmp_path):
    got = {}
    for pkg in ("jax", "port"):
        client, ctx = build(pkg, tmp_path / pkg)
        got[pkg] = _answers(App(pkg, client, ctx), QUESTIONS)
    assert len(got["port"]) == 120
    diffs = [(q["question"], a, b) for q, a, b in
             zip(QUESTIONS, got["port"], got["jax"]) if a != b]
    assert not diffs, diffs[:3]
    # the answers are the system's, not refusals across the board
    cited = sum(1 for q, (_, cits) in zip(QUESTIONS, got["port"])
                if any(t in q.get("expected_sources", [])
                       for t, _ in cits[:1]))
    assert cited >= 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _app_env(tmp_path, **extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAGTPU_") and k != "PYTHONSTARTUP"}
    env.update(PYTHONPATH=str(ROOT), RAGTPU_DATA_DIR=str(tmp_path / "data"),
               RAGTPU_DATABASE_PATH=str(tmp_path / "app.db"))
    for k, v in SETTINGS.items():
        env[f"RAGTPU_{k}"] = str(v).lower() if isinstance(v, bool) \
            else str(v)
    env.update(extra)
    return env


def _wait_live(port: int, proc, timeout_s: float = 120.0) -> None:
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"app exited {proc.returncode}: "
                                 f"{proc.stderr.read()[-2000:]}")
        try:
            with socket.create_connection(("127.0.0.1", port), 0.5):
                return
        except OSError:
            time.sleep(0.1)
    raise AssertionError("app did not start")


def test_entry_point_served_and_benchmarked_over_a_socket(tmp_path):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "rag_foundation_tpu_torch.app.main",
         "--port", str(port)], cwd=ROOT,
        env=_app_env(tmp_path, RAGTPU_ENGINE_PLATFORM="cpu"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        _wait_live(port, proc)
        base = f"http://127.0.0.1:{port}"
        client = ApiClient.from_credentials(base, "bench@example.com",
                                            "Bench-Passw0rd-1",
                                            register=True)
        client.poll_interval_s = 0.05
        store = client.ensure_store("quality")
        assert client.ensure_store("quality") == store
        wanted = {"telescope.md", "glacier_station.md"}
        for path in DOCS:
            if path.name in wanted:
                st = client.upload_and_poll(store["id"], path)
                assert st["status"] == "DONE"
        qs = [q for q in QUESTIONS
              if set(q.get("expected_sources", [])) <= wanted][:12]
        out = run_benchmark(client, store["id"], qs, concurrency=4)
        summary = out["summary"]
        assert summary["total"] == len(qs) == 12 and summary["errors"] == 0
        for r in out["results"]:
            assert r["frames"][:2] == CONTRACT_HEAD
            assert r["frames"][-2:] == CONTRACT_TAIL
            assert r["ttft_s"] is not None and r["latency_s"] >= r["ttft_s"]
        assert summary["em"] > 0.5 and summary["citation_hit"] > 0.5
        # the same answers as the port app in process
        client_ip, ctx = build("port", tmp_path / "inproc")
        app = App("port", client_ip, ctx)
        h = app.signup()
        sid = app.create_store(h, "quality")["id"]
        for path in DOCS:
            if path.name in wanted:
                app.client.post("/api/upload", headers=h,
                                data={"store_id": str(sid)},
                                files={"file": (path.name,
                                                path.read_bytes(),
                                                "text/markdown")})
        app.drain()
        for q, r in zip(qs, out["results"]):
            resp = app.client.post("/api/chat", headers=h, json_body={
                "question": q["question"], "store_ids": [sid]})
            text = "".join(json.loads(p).get("delta", "")
                           for p in resp.iter_sse() if p != "[DONE]")
            assert text == r["answer"], q["question"]
        m = client._request("GET", "/api/stores")
        assert m[0] == 200
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_entry_point_refuses_without_a_card(tmp_path):
    """No card and no ``RAGTPU_ENGINE_PLATFORM=cpu``: the in-process
    engine asks for the card and the app exits, no CPU fallback."""
    out = subprocess.run(
        [sys.executable, "-m", "rag_foundation_tpu_torch.app.main",
         "--port", str(_free_port())], cwd=ROOT,
        env=_app_env(tmp_path, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "engine unavailable at startup" in out.stderr
    assert "no CUDA card" in out.stderr


def test_connect_mode_serves_chat_over_the_engine_socket(tmp_path):
    from rag_foundation_tpu_torch.engine import Engine
    from rag_foundation_tpu_torch.engine.rpc import (EngineRpcServer,
                                                     RemoteEngine)

    inproc_client, inproc_ctx = build("port", tmp_path / "inproc")
    engine = inproc_ctx.rag.engine          # the same config, on the CPU
    sock = str(tmp_path / "engine.sock")
    server = EngineRpcServer(Engine(engine.config), sock).start()
    try:
        client, ctx = build("port", tmp_path / "connect",
                            ENGINE_RPC_MODE="connect",
                            ENGINE_RPC_SOCKET=sock)
        assert isinstance(ctx.rag.engine, RemoteEngine)
        qs = [q for q in QUESTIONS
              if q.get("expected_sources") == ["telescope.md"]][:6]
        answers = {}
        for name, (c, x) in {"connect": (client, ctx),
                             "inproc": (inproc_client,
                                        inproc_ctx)}.items():
            app = App("port", c, x)
            h = app.signup()
            sid = app.create_store(h, "quality")["id"]
            path = QUALITY / "docs" / "telescope.md"
            app.client.post("/api/upload", headers=h,
                            data={"store_id": str(sid)},
                            files={"file": (path.name, path.read_bytes(),
                                            "text/markdown")})
            app.drain()
            answers[name] = [app.client.post("/api/chat", headers=h,
                                             json_body={
                                                 "question": q["question"],
                                                 "store_ids": [sid]}).text
                             for q in qs]
            if name == "connect":
                assert client.get("/health").json()["engine"] is True
                assert len(server.engine.list_stores()) == 1
        strip = __import__("re").compile(r"(msg|txt)-[0-9a-f]{12}")
        assert [strip.sub("ID", a) for a in answers["connect"]] == \
            [strip.sub("ID", a) for a in answers["inproc"]]
    finally:
        server.shutdown()
    ctx.rag.engine.close()         # pooled connections outlive the server
    r = client.get("/health")
    assert r.status_code == 503 and r.json()["engine"] is False


def test_mock_rag_builds_no_engine(tmp_path):
    client, ctx = build("port", tmp_path, MOCK_MODE=True)
    assert not hasattr(ctx.rag, "engine")
    assert client.get("/health").json()["engine"] is True
