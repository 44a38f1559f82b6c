"""Durable job queue over sqlite — the ARQ/Redis analog.

The reference enqueued ingestion jobs into Redis via ARQ
(backend/app/worker.py:55-132) with max_jobs=10,
job_timeout=300 s, and a watchdog cron flipping stale RUNNING documents.
Here the queue is a sqlite table claimed with atomic UPDATE ... RETURNING,
so the API process and any number of worker processes/threads coordinate
through the database file. Jobs survive restarts; the claim is leased so a
crashed worker's job is re-claimable after ``lease_s``.
"""

from __future__ import annotations

import json
import random
import secrets
import threading
import time
import traceback
from collections.abc import Callable

from rag_foundation_tpu_torch.runtime.db import Database

_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  job_type TEXT NOT NULL,
  payload TEXT NOT NULL DEFAULT '{}',
  status TEXT NOT NULL DEFAULT 'queued',   -- queued|running|done|error
  attempts INTEGER NOT NULL DEFAULT 0,
  max_attempts INTEGER NOT NULL DEFAULT 3,
  error TEXT,
  enqueued_at REAL NOT NULL,
  leased_until REAL,
  finished_at REAL
);
CREATE INDEX IF NOT EXISTS jobs_status ON jobs(status, leased_until);
"""


class JobQueue:
    def __init__(self, db: Database, *, lease_s: float = 300.0,
                 retry_backoff_s: float = 20.0, clock=time.time):
        """``retry_backoff_s`` caps the jittered exponential delay before
        a failed job is re-claimable (0 disables — tests drain
        synchronously)."""
        self.db = db
        self.lease_s = lease_s
        self.retry_backoff_s = retry_backoff_s
        self._clock = clock  # injectable for deterministic lease tests
        # the migrate file lock serializes concurrent process boots:
        # executescript commits the enclosing transaction, so the
        # check-then-ALTER below would otherwise race a second process
        # into "duplicate column name" (seen with N SO_REUSEPORT API
        # processes on one fresh DB)
        with db._migrate_lock(), db.tx() as conn:
            conn.executescript(_SCHEMA)
            # retry backoff column (added after first release; ALTER is
            # the sqlite-idiomatic in-place migration for this table)
            cols = [r[1] for r in conn.execute(
                "PRAGMA table_info(jobs)").fetchall()]
            if "not_before" not in cols:
                conn.execute("ALTER TABLE jobs ADD COLUMN not_before"
                             " REAL NOT NULL DEFAULT 0")
            if "claim_token" not in cols:
                # lease ownership: finish() must be a no-op when the
                # lease expired and another worker re-claimed the job
                conn.execute("ALTER TABLE jobs ADD COLUMN claim_token"
                             " TEXT")

    def enqueue(self, job_type: str, payload: dict | None = None,
                *, max_attempts: int = 3) -> int:
        return self.db.execute(
            "INSERT INTO jobs(job_type, payload, enqueued_at, max_attempts)"
            " VALUES(?,?,?,?)",
            (job_type, json.dumps(payload or {}), self._clock(), max_attempts))

    def claim(self) -> dict | None:
        """Atomically claim one runnable job (queued, or running past its
        lease — the crashed-worker recovery path)."""
        now = self._clock()
        with self.db.tx() as conn:
            row = conn.execute(
                "SELECT id FROM jobs WHERE "
                " ((status='queued' AND not_before<=?)"
                "  OR (status='running' AND leased_until<?))"
                " ORDER BY id LIMIT 1", (now, now)).fetchone()
            if row is None:
                return None
            token = secrets.token_hex(8)
            conn.execute(
                "UPDATE jobs SET status='running', attempts=attempts+1,"
                " leased_until=?, claim_token=? WHERE id=?",
                (now + self.lease_s, token, row["id"]))
            job = conn.execute("SELECT * FROM jobs WHERE id=?",
                               (row["id"],)).fetchone()
            return dict(job)

    def finish(self, job_id: int, *, error: str | None = None,
               claim_token: str | None = None):
        """Record a job outcome. ``claim_token`` (from claim()) makes
        this a no-op when the lease expired and another worker took
        over — the overrunning original must not clobber the new
        owner's state. ``None`` skips the guard (tests/manual ops)."""
        guard = "" if claim_token is None else " AND claim_token=?"
        gargs = () if claim_token is None else (claim_token,)
        with self.db.tx() as conn:
            if claim_token is not None:
                cur = conn.execute(
                    "SELECT claim_token FROM jobs WHERE id=?",
                    (job_id,)).fetchone()
                if cur is None or cur["claim_token"] != claim_token:
                    return  # lease lost; the new owner reports
            if error is None:
                conn.execute(  # sql-ok: placeholder list, values bound
                    "UPDATE jobs SET status='done', finished_at=?, error=NULL"
                    " WHERE id=?" + guard,
                    (self._clock(), job_id) + gargs)
            else:
                row = conn.execute(
                    "SELECT attempts, max_attempts FROM jobs WHERE id=?",
                    (job_id,)).fetchone()
                terminal = row is not None and row["attempts"] >= row["max_attempts"]
                # jittered exponential retry delay (reference analog:
                # ingestion.py:106-139 2s->20s backoff; ARQ defer_by)
                delay = 0.0 if terminal else min(
                    self.retry_backoff_s,
                    2.0 ** row["attempts"]) * (0.5 + random.random())
                conn.execute(  # sql-ok: guard is a placeholder fragment
                    "UPDATE jobs SET status=?, finished_at=?, error=?,"
                    " leased_until=NULL, not_before=? WHERE id=?" + guard,
                    ("error" if terminal else "queued",
                     self._clock() if terminal else None, error[:2000],
                     self._clock() + delay, job_id) + gargs)

    def stats(self) -> dict[str, int]:
        rows = self.db.query(
            "SELECT status, COUNT(*) AS n FROM jobs GROUP BY status")
        return {r["status"]: r["n"] for r in rows}

    def pending(self) -> int:
        s = self.stats()
        return s.get("queued", 0) + s.get("running", 0)


class Worker:
    """Polls the queue and dispatches to registered handlers.

    Reference analog: the ARQ worker process with ``max_jobs=10`` and a
    watchdog cron (backend/app/worker.py:83-132). Cron
    hooks run between polls at their configured cadence.
    """

    def __init__(self, queue: JobQueue, *, poll_interval: float = 0.2,
                 concurrency: int = 1, mono=time.monotonic):
        self.queue = queue
        self.poll_interval = poll_interval
        self.concurrency = max(1, concurrency)  # reference max_jobs analog
        self.handlers: dict[str, Callable[[dict], None]] = {}
        self.crons: list[tuple[float, Callable[[], None], list[float]]] = []
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._mono = mono  # injectable for deterministic cron tests

    def register(self, job_type: str, fn: Callable[[dict], None]):
        self.handlers[job_type] = fn

    def cron(self, every_s: float, fn: Callable[[], None]):
        self.crons.append((every_s, fn, [self._mono()]))

    def run_once(self) -> bool:
        """Claim and run one job. Returns True if a job was processed."""
        job = self.queue.claim()
        if job is None:
            return False
        handler = self.handlers.get(job["job_type"])
        try:
            if handler is None:
                raise RuntimeError(f"no handler for {job['job_type']!r}")
            handler(json.loads(job["payload"]))
        except Exception as e:  # noqa: BLE001 — job isolation boundary
            self.queue.finish(job["id"],
                              error=f"{type(e).__name__}: {e}",
                              claim_token=job.get("claim_token"))
            traceback.print_exc()
            return True
        self.queue.finish(job["id"], claim_token=job.get("claim_token"))
        return True

    def _tick_crons(self):
        now = self._mono()
        for every_s, fn, last in self.crons:
            if now - last[0] >= every_s:
                last[0] = now
                try:
                    fn()
                except Exception:  # noqa: BLE001 — cron isolation
                    traceback.print_exc()

    def run_forever(self):
        """Run the claim loop (+ crons) in the calling thread; with
        ``concurrency > 1``, extra claim-only threads process jobs in
        parallel (ARQ ``max_jobs`` analog — the sqlite claim transaction
        keeps each job exclusive)."""
        extras = [threading.Thread(target=self._claim_loop, daemon=True,
                                   name=f"ragtpu-worker-{i}")
                  for i in range(1, self.concurrency)]
        for t in extras:
            t.start()
        try:
            while not self._stop.is_set():
                self._tick_crons()
                if not self._run_once_guarded():
                    self._stop.wait(self.poll_interval)
        finally:
            for t in extras:
                t.join(timeout=5)

    def _run_once_guarded(self) -> bool:
        """run_once that survives QUEUE-level errors (claim/finish db
        hiccups): one transient sqlite error must not silently kill the
        worker loop forever."""
        try:
            return self.run_once()
        except Exception:  # noqa: BLE001 — loop survival boundary
            traceback.print_exc()
            self._stop.wait(min(5.0, self.poll_interval * 5 + 1.0))
            return False

    def _claim_loop(self):
        while not self._stop.is_set():
            if not self._run_once_guarded():
                self._stop.wait(self.poll_interval)

    def start(self) -> threading.Thread:
        self._stop.clear()
        thread = threading.Thread(target=self.run_forever, daemon=True,
                                  name="ragtpu-worker")
        self._threads.append(thread)
        thread.start()
        return thread

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        self._threads.clear()
