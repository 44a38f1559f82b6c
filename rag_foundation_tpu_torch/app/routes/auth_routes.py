"""Auth routes: register, login, dev-token, logout.

Reference parity: backend/app/routes/auth.py — policy-
checked registration, per-email login rate limit, dev-token endpoint hard-
gated off production (auth.py:61-84), logout revoking the token ``jti``.
"""

from __future__ import annotations

import time

from rag_foundation_tpu_torch.app.auth import (
    check_password_policy, get_current_user, hash_password, issue_token,
    revoke_token, verify_password)
from rag_foundation_tpu_torch.app import validation as v
from rag_foundation_tpu_torch.app.telemetry import hash_email, log_json
from rag_foundation_tpu_torch.runtime.http import HTTPError, Response
from rag_foundation_tpu_torch.runtime.kv import KVError


def _email(value, loc: tuple) -> str:
    s = v.to_str(value, loc).strip().lower()
    if "@" not in s or "." not in s.split("@")[-1] or len(s) > 254:
        raise v.FieldError(loc, "Value error, invalid email")
    return s


class Credentials:
    """The JAX route's pydantic model as a plain parser: ``email`` (an
    address, stripped and lower-cased) and ``password``, both required
    strings; other keys are ignored."""

    FIELDS = {"email": (_email, v.MISSING),
              "password": (v.to_str, v.MISSING)}

    def __init__(self, /, **payload):
        values, errors = v.parse_fields(payload, self.FIELDS)
        if errors:
            raise _Invalid(errors)
        self.email = values["email"]
        self.password = values["password"]


class _Invalid(ValueError):
    def __init__(self, errors: list[v.FieldError]):
        super().__init__("; ".join(str(e) for e in errors))
        self.errors = errors


def _parse(model, payload):
    """422 with every field's error, ``loc: msg`` joined by ``; ``, as the
    JAX route formats pydantic's; a body that is not an object is
    ``Invalid request body``."""
    try:
        return model(**payload)
    except _Invalid as e:
        raise HTTPError(422, str(e)) from None
    except TypeError:
        raise HTTPError(422, "Invalid request body") from None


def register(app, ctx):
    settings, db, kv = ctx.settings, ctx.db, ctx.kv

    @app.post("/api/auth/register")
    async def register_user(req):
        body = _parse(Credentials, req.json())
        check_password_policy(body.password, settings.PASSWORD_MIN_LENGTH)
        existing = db.one("SELECT id FROM users WHERE email=?", (body.email,))
        if existing is not None:
            raise HTTPError(409, "Email already registered")
        uid = db.execute(
            "INSERT INTO users(email, password_hash, created_at)"
            " VALUES(?,?,?)",
            (body.email, hash_password(body.password), time.time()))
        log_json(20, "user_registered", email_hash=hash_email(body.email))
        return Response({"id": uid, "email": body.email}, status=201)

    @app.post("/api/auth/login")
    async def login(req):
        body = _parse(Credentials, req.json())
        # per-email login rate limit (reference: routes/auth.py:45-59)
        ctx.limiter.check(f"login:{hash_email(body.email)}",
                          settings.RATE_LIMIT_LOGIN_PER_MIN,
                          detail="Too many login attempts")
        row = db.one("SELECT * FROM users WHERE email=?", (body.email,))
        if row is None or not verify_password(body.password,
                                              row["password_hash"]):
            raise HTTPError(401, "Invalid credentials")
        if not row["is_active"]:
            raise HTTPError(401, "Account disabled")
        token = issue_token(row["id"], settings)
        return Response({"access_token": token, "token_type": "bearer"})

    @app.post("/api/auth/dev-token")
    async def dev_token(req):
        # gated hard off production (reference: routes/auth.py:61-84)
        if not settings.DEV_LOGIN_ENABLED or settings.is_production:
            raise HTTPError(404, "Not Found")
        email = "dev@example.com"
        row = db.one("SELECT id FROM users WHERE email=?", (email,))
        if row is None:
            uid = db.execute(
                "INSERT INTO users(email, password_hash, role, created_at)"
                " VALUES(?,?,?,?)",
                (email, hash_password("dev-password-123"), "admin",
                 time.time()))
        else:
            uid = row["id"]
        return Response({"access_token": issue_token(uid, settings),
                         "token_type": "bearer"})

    @app.post("/api/auth/logout")
    async def logout(req):
        user = get_current_user(req, db, kv, settings)
        try:
            revoke_token(kv, user.jti, settings.JWT_TTL_S)
        except KVError:
            raise HTTPError(503, "Auth backend unavailable") from None
        return Response({"status": "logged_out"})
