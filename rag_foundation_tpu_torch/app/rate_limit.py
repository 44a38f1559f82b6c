"""Fixed-window rate limiting over the KV store with in-memory fallback.

Reference parity: backend/app/rate_limit.py — Redis
INCR+EXPIRE buckets, graceful degradation to an in-process limiter with a
one-shot warning when the backend fails, trusted-proxy X-Forwarded-For
resolution, a global middleware keyed user-then-ip, and per-endpoint
``check_rate_limit``.
"""

from __future__ import annotations

import ipaddress
import logging
import threading
import time

from rag_foundation_tpu_torch.app.telemetry import log_json
from rag_foundation_tpu_torch.runtime.http import HTTPError, Request
from rag_foundation_tpu_torch.runtime.kv import KVError, MemoryKV


class RateLimiter:
    def __init__(self, kv, *, window_s: float = 60.0, clock=time.time):
        self.kv = kv
        self.window_s = window_s
        self._fallback = MemoryKV()
        self._warned = False
        self._lock = threading.Lock()
        self._clock = clock  # injectable: window-roll tests never sleep

    def _bucket(self, key: str) -> str:
        window = int(self._clock() // self.window_s)
        return f"rl:{key}:{window}"

    def hit(self, key: str, limit: int) -> tuple[bool, int]:
        """Count a hit; returns (allowed, current_count). Degrades to the
        in-memory limiter if the KV backend errors (reference:
        rate_limit.py:105-138)."""
        bucket = self._bucket(key)
        try:
            n = self.kv.incr(bucket)
            if n == 1:
                self.kv.expire(bucket, self.window_s * 2)
        except KVError:
            with self._lock:
                if not self._warned:
                    log_json(logging.WARNING, "rate_limit_kv_degraded")
                    self._warned = True
            n = self._fallback.incr(bucket)
            if n == 1:
                self._fallback.expire(bucket, self.window_s * 2)
        return n <= limit, n

    def check(self, key: str, limit: int, *, detail: str = "Rate limit "
              "exceeded") -> None:
        allowed, n = self.hit(key, limit)
        if not allowed:
            retry = self.window_s - (self._clock() % self.window_s)
            raise HTTPError(429, detail, headers={
                "retry-after": str(int(retry) + 1),
                "x-ratelimit-limit": str(limit),
                "x-ratelimit-remaining": "0",
            })


def _trusted_networks(trusted_proxies: list[str]):
    nets = []
    for entry in trusted_proxies:
        try:
            nets.append(ipaddress.ip_network(entry, strict=False))
        except ValueError:
            continue  # non-IP entries (e.g. "unknown") never match
    return nets


def client_ip(request: Request, trusted_proxies: list[str]) -> str:
    """Use X-Forwarded-For only when the peer is a trusted proxy; entries
    may be bare IPs or CIDR networks, matched via ipaddress (reference:
    rate_limit.py:151-175 — deploy/docker-compose.yml ships a CIDR)."""
    peer = request.client[0] or "unknown"
    try:
        peer_addr = ipaddress.ip_address(peer)
    except ValueError:
        return peer
    if any(peer_addr in net for net in _trusted_networks(trusted_proxies)):
        fwd = request.headers.get("x-forwarded-for", "")
        if fwd:
            # walk RIGHT to left, skipping trusted proxies: the proxy
            # APPENDS the true peer, while the leftmost entries are
            # client-supplied — trusting them let an attacker mint a
            # fresh rate bucket per spoofed value
            nets = _trusted_networks(trusted_proxies)
            for entry in reversed([e.strip() for e in fwd.split(",")]):
                try:
                    addr = ipaddress.ip_address(entry)
                except ValueError:
                    return entry or peer
                if not any(addr in net for net in nets):
                    return entry
            return fwd.split(",")[0].strip()  # all trusted: leftmost
    return peer


def global_rate_key(request: Request, settings) -> str:
    """Key the global limit per-user when a bearer token is present.

    The middleware runs before any handler sets request.state["user"], so
    the subject is decoded (signature-verified) from the token directly
    (reference keys user>ip the same way, rate_limit.py:187-219). An
    invalid token falls back to the IP key — auth proper rejects it later.
    """
    user = request.state.get("user")
    if user is not None:
        return f"user:{user.id}"
    authz = request.headers.get("authorization", "")
    if authz.startswith("Bearer "):
        from rag_foundation_tpu_torch.app.auth import peek_token_sub
        sub = peek_token_sub(authz[7:], settings)
        if sub is not None:
            return f"user:{sub}"
    return f"ip:{client_ip(request, settings.TRUSTED_PROXIES)}"
