"""Structured JSON logging with contextvars and PII scrubbing.

Reference parity: backend/app/telemetry.py — JSON log
lines carrying request/user contextvars, auth-ish header redaction, email
hashing, and a ``log_json`` helper used across services.
"""

from __future__ import annotations

import contextvars
import hashlib
import json
import logging
import re
import time

request_id_var: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "request_id", default=None)
user_id_var: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "user_id", default=None)

_SENSITIVE_HEADER_RE = re.compile(
    r"^(authorization|cookie|x-api-key|proxy-authorization)$"
    r"|(-token|-secret|-key)$", re.IGNORECASE)

logger = logging.getLogger("ragtpu")


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "msg": record.getMessage(),
            "logger": record.name,
        }
        rid = request_id_var.get()
        if rid:
            out["request_id"] = rid
        uid = user_id_var.get()
        if uid is not None:
            out["user_id"] = uid
        extra = getattr(record, "fields", None)
        if extra:
            out.update(scrub_fields(extra))  # defense in depth
        if record.exc_info and record.exc_info[0] is not None:
            out["exc_type"] = record.exc_info[0].__name__
        return json.dumps(out, default=str)


def configure_logging(level: int = logging.INFO) -> None:
    handler = logging.StreamHandler()
    handler.setFormatter(JsonFormatter())
    root = logging.getLogger("ragtpu")
    root.handlers[:] = [handler]
    root.setLevel(level)
    root.propagate = False


def log_json(level: int, msg: str, **fields) -> None:
    logger.log(level, msg, extra={"fields": scrub_fields(fields)})


def scrub_headers(headers: dict[str, str]) -> dict[str, str]:
    """Redact Authorization/Cookie/etc. before logging (reference:
    telemetry.py:132-167)."""
    return {k: ("[REDACTED]" if _SENSITIVE_HEADER_RE.search(k) else v)
            for k, v in headers.items()}


def scrub_fields(fields: dict) -> dict:
    return {k: ("[REDACTED]" if _SENSITIVE_HEADER_RE.search(str(k)) else v)
            for k, v in fields.items()}


def hash_email(email: str) -> str:
    """Stable non-reversible email fingerprint for logs (reference:
    telemetry.py:124-129)."""
    return hashlib.sha256(email.strip().lower().encode()).hexdigest()[:16]


def bind_request(request_id: str | None = None,
                 user_id: int | None = None) -> None:
    if request_id is not None:
        request_id_var.set(request_id)
    if user_id is not None:
        user_id_var.set(user_id)


def clear_request() -> None:
    request_id_var.set(None)
    user_id_var.set(None)
