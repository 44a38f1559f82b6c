"""Load generator: the reference's locust profile without locust.

Counterpart of ``rag_foundation_tpu/benchmark/loadgen.py`` (the same
flags and the same JSON out) on the port's benchmark client; it speaks
HTTP only, so it drives the port app and the JAX app alike. The
upload files go under ``--tmp``, by default ``ragtpu-load`` in the
system's temporary directory (``TMPDIR``).

Reference parity: scripts/load_test/locustfile.py —
4:1 chat:upload task mix, 0.5-2 s think time, streams consumed to
[DONE]. Thread-per-user; reports request rates, error rate, latency
avg/p95 per task.

Usage:
  python -m rag_foundation_tpu_torch.benchmark.loadgen \
      --base-url http://... --users 8 --duration 30 [--register]
"""

from __future__ import annotations

import argparse
import json
import random
import tempfile
import threading
import time
from pathlib import Path

from rag_foundation_tpu_torch.benchmark.metrics import mean, p95
from rag_foundation_tpu_torch.benchmark.runner import ApiClient

DOC_TEXT = ("The quarterly revenue grew twelve percent driven by cloud "
            "subscriptions. Operating margin expanded. " * 20)
QUESTIONS = [
    "How did revenue grow this quarter?",
    "What happened to the operating margin?",
    "Summarize the financial results.",
    "What drove subscription growth?",
]


class _Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.latencies: dict[str, list[float]] = {"chat": [], "upload": []}
        self.errors: dict[str, int] = {"chat": 0, "upload": 0}

    def record(self, task: str, latency: float | None):
        with self.lock:
            if latency is None:
                self.errors[task] += 1
            else:
                self.latencies[task].append(latency)


def _user_loop(client: ApiClient, store_id: int, stop: threading.Event,
               stats: _Stats, rng: random.Random, tmp: Path,
               chat_ratio: float = 0.8, think_max: float = 2.0):
    while not stop.is_set():
        task = "chat" if rng.random() < chat_ratio else "upload"
        t0 = time.perf_counter()
        try:
            if task == "chat":
                out = client.ask(rng.choice(QUESTIONS), [store_id])
                if out["error"]:  # SSE-level failure rides HTTP 200
                    raise RuntimeError(out["error"])
            else:
                p = tmp / f"load-{rng.randrange(1 << 30)}.txt"
                try:
                    p.write_text(DOC_TEXT)
                    client.upload_and_poll(store_id, p, timeout_s=60)
                finally:
                    p.unlink(missing_ok=True)
            stats.record(task, time.perf_counter() - t0)
        except Exception:  # noqa: BLE001 — load test records failures
            stats.record(task, None)
        if think_max > 0:
            stop.wait(rng.uniform(think_max / 4, think_max))  # think time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base-url", required=True,
                    help="target URL, or comma-separated URLs for a "
                         "multi-process topology (users round-robin)")
    ap.add_argument("--users", type=int, default=4)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--email", default="load@example.com")
    ap.add_argument("--password", default="Load-Passw0rd-1")
    ap.add_argument("--register", action="store_true")
    ap.add_argument("--tmp", type=Path,
                    default=Path(tempfile.gettempdir()) / "ragtpu-load")
    ap.add_argument("--chat-ratio", type=float, default=0.8,
                    help="fraction of chat tasks (1.0 = chat-only;"
                    " reference locust mix is 0.8)")
    ap.add_argument("--think", type=float, default=2.0,
                    help="max think time seconds (0 = closed-loop"
                    " capacity test)")
    args = ap.parse_args()

    urls = [u.strip() for u in args.base_url.split(",") if u.strip()]
    clients = [ApiClient.from_credentials(u, args.email, args.password,
                                          register=(args.register
                                                    and i == 0))
               for i, u in enumerate(urls)]
    store = clients[0].ensure_store("load-test")
    args.tmp.mkdir(parents=True, exist_ok=True)
    stats = _Stats()
    stop = threading.Event()
    threads = [
        threading.Thread(target=_user_loop,
                         args=(clients[i % len(clients)], store["id"],
                               stop, stats, random.Random(i), args.tmp,
                               args.chat_ratio, args.think), daemon=True)
        for i in range(args.users)]
    t0 = time.time()
    for t in threads:
        t.start()
    time.sleep(args.duration)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    wall = time.time() - t0
    out = {}
    for task in ("chat", "upload"):
        lat = stats.latencies[task]
        total = len(lat) + stats.errors[task]
        out[task] = {
            "requests": total,
            "errors": stats.errors[task],
            "error_rate": stats.errors[task] / total if total else 0.0,
            "rps": total / wall,  # offered load incl. failures
            "ok_rps": len(lat) / wall,
            "latency_avg_s": mean(lat),
            "latency_p95_s": p95(lat),
        }
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
