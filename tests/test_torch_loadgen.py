"""The port's load generator against the port app over a live socket: the
cases of ``tests/test_loadgen.py`` (mixed chat and upload traffic, no
errors), and ``python -m rag_foundation_tpu_torch.benchmark.loadgen``
prints the JSON the JAX package's loadgen prints for the same run, with
the same keys."""

import asyncio
import json
import os
import random
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

from rag_foundation_tpu_torch.benchmark.loadgen import _Stats, _user_loop
from rag_foundation_tpu_torch.benchmark.runner import ApiClient
from rag_foundation_tpu_torch.runtime.http import serve
from tests.test_torch_app_helpers import settings_for

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Served:
    """The port app served over a socket from a thread, its worker
    running."""

    def __init__(self, tmp_path):
        from rag_foundation_tpu_torch.app.main import (build_context,
                                                       create_app)
        old = os.environ.get("RAGTPU_ENGINE_PLATFORM")
        os.environ["RAGTPU_ENGINE_PLATFORM"] = "cpu"
        try:
            ctx = build_context(settings_for("port", tmp_path))
        finally:
            if old is None:
                os.environ.pop("RAGTPU_ENGINE_PLATFORM", None)
            else:
                os.environ["RAGTPU_ENGINE_PLATFORM"] = old
        self.app = create_app(ctx, start_worker=True)
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        async def main():
            self._stop = asyncio.Event()
            self._loop = asyncio.get_running_loop()
            ready = asyncio.Event()

            async def flag():
                await ready.wait()
                self._ready.set()
            task = asyncio.create_task(flag())
            await serve(self.app, "127.0.0.1", self.port, ready=ready,
                        stop=self._stop)
            task.cancel()
        asyncio.run(main())

    def __enter__(self):
        self._thread.start()
        assert self._ready.wait(15)
        return self

    def __exit__(self, *exc):
        self._loop.call_soon_threadsafe(self._stop.set)
        self._thread.join(10)


def test_loadgen_mixed_traffic(tmp_path):
    with _Served(tmp_path) as served:
        client = ApiClient.from_credentials(
            served.url, "load@example.com", "Load-Passw0rd-1",
            register=True)
        client.poll_interval_s = 0.05
        store = client.ensure_store("load-test")
        stats = _Stats()
        stop = threading.Event()
        users = [threading.Thread(
            target=_user_loop,
            args=(client, store["id"], stop, stats, random.Random(i),
                  Path(tmp_path), 0.8, 0.2))
            for i in range(3)]
        for u in users:
            u.start()
        # stop as soon as both tasks landed (bounded, no fixed sleep)
        deadline = time.time() + 30
        while time.time() < deadline:
            if all(stats.latencies.values()) and \
                    sum(len(v) for v in stats.latencies.values()) >= 4:
                break
            time.sleep(0.05)
        stop.set()
        for u in users:
            u.join(30)
    assert all(stats.latencies.values()), stats.latencies
    assert sum(stats.errors.values()) == 0, stats.errors


def test_loadgen_entry_point_prints_the_jax_loadgen_json(tmp_path):
    outs = {}
    with _Served(tmp_path) as served:
        for pkg in ("rag_foundation_tpu", "rag_foundation_tpu_torch"):
            env = dict(os.environ, PYTHONPATH=str(ROOT),
                       TMPDIR=str(tmp_path))
            cmd = [sys.executable, "-m", f"{pkg}.benchmark.loadgen",
                   "--base-url", f"{served.url},{served.url}",
                   "--users", "2", "--duration", "2", "--think", "0.2",
                   "--tmp", str(tmp_path / pkg)]
            if pkg == "rag_foundation_tpu":
                cmd.append("--register")   # the second run logs in
            out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                 text=True, timeout=90)
            assert out.returncode == 0, out.stderr[-2000:]
            outs[pkg] = json.loads(out.stdout)
    port, jax = outs["rag_foundation_tpu_torch"], outs["rag_foundation_tpu"]
    assert list(port) == list(jax) == ["chat", "upload"]
    for task in ("chat", "upload"):
        assert list(port[task]) == list(jax[task])
        assert port[task]["errors"] == 0 and port[task]["error_rate"] == 0.0
    assert port["chat"]["requests"] > 0
