"""Startup fail-fast security re-assertions.

Reference parity: backend/app/security_gate.py:14-100 —
re-assert production invariants at startup (belt to config validation's
suspenders) and require a live KV backend so rate limiting / revocation
can't silently start degraded in production.
"""

from __future__ import annotations

import logging

from rag_foundation_tpu_torch.app.telemetry import log_json


class SecurityGateError(RuntimeError):
    pass


def run_security_gate(settings, kv) -> None:
    problems: list[str] = []
    if settings.is_production:
        if not settings.STRICT_MODE:
            problems.append("STRICT_MODE must be on in production")
        if settings.DEV_LOGIN_ENABLED:
            problems.append("dev login enabled in production")
        if len(settings.JWT_SECRET) < 32:
            problems.append("weak JWT secret")
        if settings.MOCK_MODE and not settings.ALLOW_MOCK_IN_PROD:
            problems.append("mock mode in production")
        if not settings.CSRF_ENABLED:
            problems.append("CSRF disabled in production")
        if not kv.ping():
            problems.append("KV backend unreachable")
    if problems:
        log_json(logging.CRITICAL, "security_gate_failed", problems=problems)
        raise SecurityGateError("; ".join(problems))
    log_json(logging.INFO, "security_gate_passed",
             environment=settings.ENVIRONMENT)
