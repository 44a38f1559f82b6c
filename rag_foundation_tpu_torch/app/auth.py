"""Auth: scrypt password hashing, HS256 JWT, revocation, user resolution.

Reference parity (backend/app/auth.py): password policy,
tokens carrying sub/iss/aud/iat/exp/jti and no PII, decode verifying
aud+iss, ``jti`` revocation through the KV store with **fail-closed 503**
on KV errors (auth.py:157-168,199-212), ``get_current_user`` and
``require_admin`` guards. bcrypt/passlib are unavailable here; stdlib
``hashlib.scrypt`` is the (stronger) replacement.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import secrets
import time
from dataclasses import dataclass

from rag_foundation_tpu_torch.runtime.http import HTTPError, Request
from rag_foundation_tpu_torch.runtime.kv import KVError

_SCRYPT_N, _SCRYPT_R, _SCRYPT_P = 2 ** 14, 8, 1


# -- passwords --------------------------------------------------------------

def hash_password(password: str) -> str:
    if not isinstance(password, str) or not password:
        raise ValueError("empty password")
    pw = password.encode()[:1024]  # bound input (reference 72-byte bcrypt cap)
    salt = secrets.token_bytes(16)
    digest = hashlib.scrypt(pw, salt=salt, n=_SCRYPT_N, r=_SCRYPT_R,
                            p=_SCRYPT_P, dklen=32)
    return (f"scrypt${_SCRYPT_N}${_SCRYPT_R}${_SCRYPT_P}"
            f"${base64.b64encode(salt).decode()}"
            f"${base64.b64encode(digest).decode()}")


def verify_password(password: str, stored: str) -> bool:
    try:
        scheme, n, r, p, salt_b64, digest_b64 = stored.split("$")
        if scheme != "scrypt":
            return False
        digest = hashlib.scrypt(
            password.encode()[:1024], salt=base64.b64decode(salt_b64),
            n=int(n), r=int(r), p=int(p), dklen=32)
        return hmac.compare_digest(digest, base64.b64decode(digest_b64))
    except (ValueError, TypeError):
        return False


def check_password_policy(password: str, min_length: int = 10) -> None:
    """Raise 422 on weak passwords (reference: auth.py:97-117)."""
    problems = []
    if len(password) < min_length:
        problems.append(f"at least {min_length} characters")
    if not any(c.isdigit() for c in password):
        problems.append("a digit")
    if not any(c.isalpha() for c in password):
        problems.append("a letter")
    if problems:
        raise HTTPError(422, "Password must contain " + ", ".join(problems))


# -- JWT (HS256, stdlib) ----------------------------------------------------

def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def encode_jwt(claims: dict, secret: str) -> str:
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps(claims).encode())
    signing = f"{header}.{payload}".encode()
    sig = hmac.new(secret.encode(), signing, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64url(sig)}"


class TokenError(Exception):
    pass


def decode_jwt(token: str, secret: str, *, issuer: str, audience: str) -> dict:
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
    except ValueError:
        raise TokenError("malformed token") from None
    signing = f"{header_b64}.{payload_b64}".encode()
    expected = hmac.new(secret.encode(), signing, hashlib.sha256).digest()
    try:
        sig = _b64url_decode(sig_b64)
    except ValueError:  # binascii.Error included — garbage base64 in a
        raise TokenError("malformed signature") from None  # 500'd before
    if not hmac.compare_digest(expected, sig):
        raise TokenError("bad signature")
    try:
        header = json.loads(_b64url_decode(header_b64))
        claims = json.loads(_b64url_decode(payload_b64))
    except ValueError:
        raise TokenError("malformed token body") from None
    if header.get("alg") != "HS256":
        raise TokenError("unsupported alg")
    now = time.time()
    if claims.get("exp") is None or claims["exp"] < now:
        raise TokenError("token expired")
    if claims.get("iss") != issuer:
        raise TokenError("bad issuer")
    if claims.get("aud") != audience:
        raise TokenError("bad audience")
    return claims


def issue_token(user_id: int, settings) -> str:
    """Claims carry ids only — no email/PII (reference: auth.py:135-154)."""
    now = int(time.time())
    return encode_jwt({
        "sub": str(user_id),
        "iss": settings.JWT_ISSUER,
        "aud": settings.JWT_AUDIENCE,
        "iat": now,
        "exp": now + settings.JWT_TTL_S,
        "jti": secrets.token_hex(16),
    }, settings.JWT_SECRET)


def peek_token_sub(token: str, settings) -> str | None:
    """Signature-verified ``sub`` for rate-limit keying.

    Verifies HMAC + exp/iss/aud (cheap, no KV or DB) so a client cannot
    spray forged subs to mint fresh rate buckets; skips revocation —
    auth proper (get_current_user) re-checks before any privileged action.
    """
    try:
        claims = decode_jwt(token, settings.JWT_SECRET,
                            issuer=settings.JWT_ISSUER,
                            audience=settings.JWT_AUDIENCE)
    except TokenError:
        return None
    sub = claims.get("sub")
    return str(sub)[:64] if sub is not None else None


# -- request guards ---------------------------------------------------------

@dataclass(frozen=True)
class CurrentUser:
    id: int
    email: str
    role: str
    jti: str


def revoke_token(kv, jti: str, ttl_s: float) -> None:
    kv.setex(f"revoked:{jti}", ttl_s, "1")


def get_current_user(request: Request, db, kv, settings) -> CurrentUser:
    """Resolve the bearer token to a live, unrevoked user.

    KV failures fail CLOSED with 503 — a down revocation store must not
    silently re-admit revoked tokens (reference: auth.py:199-212).
    """
    authz = request.headers.get("authorization", "")
    if not authz.startswith("Bearer "):
        raise HTTPError(401, "Not authenticated",
                        headers={"www-authenticate": "Bearer"})
    try:
        claims = decode_jwt(authz[len("Bearer "):], settings.JWT_SECRET,
                            issuer=settings.JWT_ISSUER,
                            audience=settings.JWT_AUDIENCE)
    except TokenError as e:
        raise HTTPError(401, f"Invalid token: {e}") from None
    jti = claims.get("jti", "")
    try:
        if jti and kv.exists(f"revoked:{jti}"):
            raise HTTPError(401, "Token revoked")
    except KVError:
        raise HTTPError(503, "Auth backend unavailable") from None
    row = db.one("SELECT id, email, role, is_active FROM users WHERE id=?",
                 (int(claims["sub"]),))
    if row is None or not row["is_active"]:
        raise HTTPError(401, "Unknown or inactive user")
    user = CurrentUser(id=row["id"], email=row["email"], role=row["role"],
                       jti=jti)
    request.state["user"] = user
    return user


def require_admin(user: CurrentUser) -> CurrentUser:
    if user.role != "admin":
        raise HTTPError(403, "Admin privileges required")
    return user
