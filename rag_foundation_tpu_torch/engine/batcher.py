"""Micro-batching query admission.

SURVEY.md §7 "hard parts": keeping host latency out of the QPS path
needs batched query admission — concurrent requests within a small
window are coalesced into ONE device call (bucketed batch shapes bound
jit retraces). Requests are grouped by store-set + k; each waits at most
``window_s`` before the batch launches, or launches immediately when
``max_batch`` fills.

Thread-safe; callers are server worker threads (asyncio.to_thread in the
chat route). The reference's analog is its per-request semaphore only —
there was no device work to batch (SURVEY.md §2.4).
"""

from __future__ import annotations

import threading
from collections.abc import Callable, Sequence
from dataclasses import dataclass, field


@dataclass
class _Pending:
    query: str
    event: threading.Event = field(default_factory=threading.Event)
    result: object = None
    error: BaseException | None = None


class QueryBatcher:
    """Coalesces ``submit(group_key, query)`` calls into batched runs.

    ``run_batch(group_key, queries) -> list[result]`` executes once per
    flush with all collected queries for that group.
    """

    def __init__(self, run_batch: Callable[[object, Sequence[str]], list],
                 *, window_s: float = 0.004, max_batch: int = 64):
        self._run_batch = run_batch
        self.window_s = window_s
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._groups: dict[object, list[_Pending]] = {}
        self._timers: dict[object, threading.Timer] = {}

    # generous default: the first batch after start-up may wait for the
    # kernel build (nvcc) — a short wait would fail exactly those requests
    def submit(self, group_key: object, query: str,
               timeout: float = 600.0):
        pending = _Pending(query=query)
        flush_now = False
        with self._lock:
            batch = self._groups.setdefault(group_key, [])
            batch.append(pending)
            if len(batch) >= self.max_batch:
                flush_now = True
            elif len(batch) == 1:
                timer = threading.Timer(self.window_s,
                                        self._flush, args=(group_key,))
                timer.daemon = True
                self._timers[group_key] = timer
                timer.start()
        if flush_now:
            self._flush(group_key)
        if not pending.event.wait(timeout):
            raise TimeoutError("batched query timed out")
        if pending.error is not None:
            raise pending.error
        return pending.result

    def _flush(self, group_key: object) -> None:
        with self._lock:
            batch = self._groups.pop(group_key, [])
            timer = self._timers.pop(group_key, None)
            if timer is not None:
                timer.cancel()
        if not batch:
            return
        try:
            results = self._run_batch(group_key,
                                      [p.query for p in batch])
            if len(results) != len(batch):
                raise RuntimeError("run_batch returned wrong length")
            for p, r in zip(batch, results):
                p.result = r
        except BaseException as e:  # noqa: BLE001 — fan error out
            for p in batch:
                p.error = e
        finally:
            for p in batch:
                p.event.set()
