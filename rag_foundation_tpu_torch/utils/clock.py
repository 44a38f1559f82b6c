"""Injectable time sources for deterministic tests.

The reference freezes time and bans sleeps in its suite
(backend/tests/conftest.py:246-313). Here the analog is
constructor-injected clocks: components that read wall/monotonic time
(job queue leases/backoff, KV TTLs, rate-limit windows) accept a
``clock`` callable, and tests drive a :class:`FakeClock` forward instead
of sleeping.
"""

from __future__ import annotations

import time


class FakeClock:
    """A manually-advanced clock, usable wherever ``time.time`` /
    ``time.monotonic`` is injected."""

    def __init__(self, start: float = 1_000_000.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += seconds

    def sleep(self, seconds: float) -> None:  # drop-in for time.sleep
        self.advance(seconds)


SYSTEM_TIME = time.time
SYSTEM_MONOTONIC = time.monotonic
