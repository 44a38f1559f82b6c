"""sqlite3 persistence engine: WAL, thread-local connections, migrations.

Replaces SQLAlchemy + Alembic (reference: backend/app/db.py,
backend/alembic/). Migrations are ordered SQL scripts keyed
by ``PRAGMA user_version``; connections are per-thread with row factories,
and an injectable factory keeps tests hermetic exactly like the reference's
``get_session_factory`` (db.py:34-55).
"""

from __future__ import annotations

import sqlite3
import threading
import time
from collections.abc import Iterator
from contextlib import contextmanager
from pathlib import Path


class Database:
    """Thread-safe sqlite wrapper. One connection per thread, WAL mode."""

    def __init__(self, path: str | Path = ":memory:",
                 migrations: list[str] | None = None):
        self.path = str(path)
        self._local = threading.local()
        self._write_lock = threading.RLock()
        # ":memory:" would give every thread its own empty DB; use a
        # shared-cache URI so tests get one DB across threads.
        self._memory = self.path == ":memory:"
        if self._memory:
            self._uri = f"file:ragtpu-mem-{id(self)}?mode=memory&cache=shared"
            # Keep one anchor connection alive or the shared DB vanishes.
            self._anchor = sqlite3.connect(self._uri, uri=True,
                                           check_same_thread=False)
        else:
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
            self._uri = None
        if migrations:
            self.migrate(migrations)

    def _connect(self) -> sqlite3.Connection:
        if self._memory:
            conn = sqlite3.connect(self._uri, uri=True, timeout=30)
        else:
            conn = sqlite3.connect(self.path, timeout=30)
            conn.execute("PRAGMA journal_mode=WAL")
            # WAL + NORMAL is the durable-fast pairing: commits stop
            # fsyncing the WAL on every transaction (app crash loses
            # nothing; only an OS crash can drop the last batch). FULL
            # cost ~40-50 ms per chat finalize on this disk — the bulk
            # of the round-2 55.9 req/s serving wall (ENGINE.md budget
            # table)
            conn.execute("PRAGMA synchronous=NORMAL")
        conn.execute("PRAGMA foreign_keys=ON")
        conn.execute("PRAGMA busy_timeout=30000")
        conn.row_factory = sqlite3.Row
        return conn

    @property
    def conn(self) -> sqlite3.Connection:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = self._connect()
            self._local.conn = c
        return c

    # -- transactions ------------------------------------------------------
    @contextmanager
    def tx(self) -> Iterator[sqlite3.Connection]:
        """Serialized write transaction (sqlite has one writer anyway)."""
        with self._write_lock:
            conn = self.conn
            try:
                conn.execute("BEGIN IMMEDIATE")
                yield conn
                conn.commit()
            except Exception:
                conn.rollback()
                raise

    def _read(self, sql: str, params: tuple):
        # :memory: shared-cache readers can hit SQLITE_LOCKED ("database
        # table is locked") when a write tx is open — the busy handler
        # does NOT retry that class, so retry briefly here (WAL file
        # databases never take this path)
        for attempt in range(40):
            try:
                return self.conn.execute(sql, params)
            except sqlite3.OperationalError as e:
                if "locked" not in str(e) or attempt == 39:
                    raise
                time.sleep(0.025)

    def query(self, sql: str, params: tuple = ()) -> list[sqlite3.Row]:
        return self._read(sql, params).fetchall()

    def one(self, sql: str, params: tuple = ()) -> sqlite3.Row | None:
        return self._read(sql, params).fetchone()

    def execute(self, sql: str, params: tuple = ()) -> int:
        """Single-statement write; returns lastrowid."""
        with self.tx() as conn:
            cur = conn.execute(sql, params)
            return cur.lastrowid

    # -- migrations --------------------------------------------------------
    def migrate(self, migrations: list[str]) -> int:
        """Apply ordered migration scripts past the current user_version.

        Cross-process safe: N processes may point at one fresh DB file
        (the SO_REUSEPORT scale-out topology boots every API process at
        once); ``executescript`` commits implicitly so sqlite's own tx
        locking can't serialize whole scripts — an OS-level file lock
        around the version check + apply does.
        """
        with self._write_lock, self._migrate_lock():
            conn = self.conn
            current = conn.execute("PRAGMA user_version").fetchone()[0]
            for i, script in enumerate(migrations[current:], start=current + 1):
                conn.executescript(script)
                conn.execute(f"PRAGMA user_version = {i}")  # sql-ok: int index
                conn.commit()
            return len(migrations)

    @contextmanager
    def _migrate_lock(self) -> Iterator[None]:
        if self._memory:          # single-process by construction
            yield
            return
        import fcntl
        lock_path = self.path + ".migrate.lock"
        with open(lock_path, "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def ping(self) -> bool:
        try:
            self.conn.execute("SELECT 1")
            return True
        except sqlite3.Error:
            return False

    def close(self):
        c = getattr(self._local, "conn", None)
        if c is not None:
            c.close()
            self._local.conn = None


def now() -> float:
    return time.time()
