"""TTL key-value store — the Redis analog for rate limits and revocation.

The reference used Redis for fixed-window rate buckets
(backend/app/rate_limit.py:76-102) and ``revoked:{jti}``
JWT revocation keys (auth.py:157-168), with an in-memory fallback when
Redis degrades (rate_limit.py:26-73). Here the in-memory implementation is
the default (single-process deployments) and a sqlite-backed variant
provides cross-process sharing; both expose the same Redis-shaped surface
(get/set/setex/incr/expire/exists/delete/ping).
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
import sqlite3


class KVError(RuntimeError):
    """Backend unavailable (maps to the reference's fail-closed paths)."""


class MemoryKV:
    """Thread-safe in-memory KV with lazy TTL eviction."""

    def __init__(self, max_keys: int = 100_000, *, clock=time.monotonic):
        self._data: dict[str, tuple[str, float | None]] = {}
        self._lock = threading.Lock()
        self._max_keys = max_keys
        self._clock = clock  # injectable for deterministic TTL tests

    def _evict_locked(self):
        now = self._clock()
        if len(self._data) <= self._max_keys:
            return
        expired = [k for k, (_, exp) in self._data.items()
                   if exp is not None and exp <= now]
        for k in expired:
            del self._data[k]
        # FIFO-evict overflow, but NEVER live revocation markers: a
        # flood of rate-limit keys must not fail a revoked JWT back
        # OPEN (auth fail-closed contract). Revocation keys are bounded
        # by token TTL so they cannot themselves grow without limit.
        if len(self._data) > self._max_keys:
            for k in list(self._data):
                if len(self._data) <= self._max_keys:
                    break
                if not k.startswith("revoked:"):
                    del self._data[k]

    def _get_locked(self, key: str) -> str | None:
        item = self._data.get(key)
        if item is None:
            return None
        value, exp = item
        if exp is not None and exp <= self._clock():
            del self._data[key]
            return None
        return value

    def get(self, key: str) -> str | None:
        with self._lock:
            return self._get_locked(key)

    def set(self, key: str, value: str, ttl: float | None = None):
        with self._lock:
            exp = self._clock() + ttl if ttl else None
            self._data[key] = (str(value), exp)
            self._evict_locked()

    def setex(self, key: str, ttl: float, value: str):
        self.set(key, value, ttl)

    def exists(self, key: str) -> bool:
        return self.get(key) is not None

    def delete(self, key: str):
        with self._lock:
            self._data.pop(key, None)

    def incr(self, key: str) -> int:
        with self._lock:
            cur = self._get_locked(key)
            exp = self._data[key][1] if key in self._data and cur is not None \
                else None
            val = int(cur or 0) + 1
            self._data[key] = (str(val), exp)
            # incr is the rate-limit hot path: one NEW key per client
            # per window — without eviction here those buckets are
            # never touched again and accumulate forever
            self._evict_locked()
            return val

    def expire(self, key: str, ttl: float):
        with self._lock:
            cur = self._get_locked(key)
            if cur is not None:
                self._data[key] = (cur, self._clock() + ttl)

    def ping(self) -> bool:
        return True


class SqliteKV:
    """Cross-process KV over sqlite (WAL). Same surface as MemoryKV."""

    def __init__(self, path: str | Path, *, clock=time.time):
        self.path = str(path)
        self._clock = clock
        Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._local = threading.local()
        self._conn().execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            " key TEXT PRIMARY KEY, value TEXT NOT NULL, expires_at REAL)")
        self._conn().commit()

    def _conn(self) -> sqlite3.Connection:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = sqlite3.connect(self.path, timeout=30)
            c.execute("PRAGMA journal_mode=WAL")
            # rate-limit buckets + jti cache are hot-path writes; NORMAL
            # skips the per-commit WAL fsync (see runtime/db.py note)
            c.execute("PRAGMA synchronous=NORMAL")
            c.execute("PRAGMA busy_timeout=30000")
            self._local.conn = c
        return c

    def get(self, key: str) -> str | None:
        try:
            row = self._conn().execute(
                "SELECT value, expires_at FROM kv WHERE key=?", (key,)
            ).fetchone()
        except sqlite3.Error as e:
            raise KVError(str(e)) from e
        if row is None:
            return None
        value, exp = row
        if exp is not None and exp <= self._clock():
            try:
                # guarded: an unconditional DELETE would race a sibling
                # process's FRESH setex of the same key and remove it
                self._conn().execute(
                    "DELETE FROM kv WHERE key=? AND expires_at IS NOT"
                    " NULL AND expires_at<=?", (key, self._clock()))
                self._conn().commit()
            except sqlite3.Error:
                pass  # lazy cleanup only; the read result stands
            return None
        return value

    def set(self, key: str, value: str, ttl: float | None = None):
        exp = self._clock() + ttl if ttl else None
        try:
            with self._conn() as c:
                c.execute(
                    "INSERT INTO kv(key,value,expires_at) VALUES(?,?,?) "
                    "ON CONFLICT(key) DO UPDATE SET value=excluded.value,"
                    " expires_at=excluded.expires_at",
                    (key, str(value), exp))
        except sqlite3.Error as e:
            raise KVError(str(e)) from e

    def setex(self, key: str, ttl: float, value: str):
        self.set(key, value, ttl)

    def exists(self, key: str) -> bool:
        return self.get(key) is not None

    def delete(self, key: str):
        try:
            with self._conn() as c:
                c.execute("DELETE FROM kv WHERE key=?", (key,))
        except sqlite3.Error as e:
            raise KVError(str(e)) from e

    def incr(self, key: str) -> int:
        try:
            with self._conn() as c:
                c.execute(
                    "INSERT INTO kv(key,value,expires_at) VALUES(?, '0', NULL)"
                    " ON CONFLICT(key) DO NOTHING", (key,))
                # reset if expired
                c.execute(
                    "UPDATE kv SET value='0', expires_at=NULL WHERE key=? "
                    "AND expires_at IS NOT NULL AND expires_at<=?",
                    (key, self._clock()))
                c.execute(
                    "UPDATE kv SET value=CAST(CAST(value AS INTEGER)+1 AS TEXT)"
                    " WHERE key=?", (key,))
                return int(c.execute(
                    "SELECT value FROM kv WHERE key=?", (key,)).fetchone()[0])
        except sqlite3.Error as e:
            raise KVError(str(e)) from e

    def expire(self, key: str, ttl: float):
        try:
            with self._conn() as c:
                c.execute("UPDATE kv SET expires_at=? WHERE key=?",
                          (self._clock() + ttl, key))
        except sqlite3.Error as e:
            raise KVError(str(e)) from e

    def ping(self) -> bool:
        try:
            self._conn().execute("SELECT 1")
            return True
        except sqlite3.Error:
            return False


class FailingKV:
    """Test double: every call raises (exercises fail-closed paths)."""

    def _boom(self, *a, **kw):
        raise KVError("kv backend down")

    get = set = setex = exists = delete = incr = expire = _boom

    def ping(self) -> bool:
        return False
