"""The port app's auth routes against the JAX app's: the request sequences
of ``tests/test_app_auth.py`` give the same statuses and bodies (tokens
and timestamps masked), and the pydantic-free ``Credentials`` parser
gives the 422 texts the JAX route formats from pydantic's errors."""

import pytest

from rag_foundation_tpu_torch.app.auth import (TokenError, decode_jwt,
                                               hash_password, issue_token,
                                               verify_password)
from tests.test_torch_app_helpers import PASSWORD, build, mod, run_both


def test_register_login_and_token_flow(tmp_path):
    def scenario(app):
        h = app.signup()
        app.see(app.client.get("/api/stores", headers=h), "stores")
        app.see(app.client.post("/api/auth/register", json_body={
            "email": "user@example.com", "password": PASSWORD}), "dup")
        app.see(app.client.post("/api/auth/login", json_body={
            "email": "user@example.com", "password": "WrongPass-123"}),
            "bad password")
        app.see(app.client.post("/api/auth/login", json_body={
            "email": "nobody@example.com", "password": PASSWORD}),
            "unknown user")
        for bad in ("short1", "alllettersbutlong", "123456789012"):
            app.see(app.client.post("/api/auth/register", json_body={
                "email": "x@example.com", "password": bad}), bad)
        app.see(app.client.get("/api/stores"), "no token")
        app.see(app.client.post("/api/chat", json_body={}), "chat no token")
        app.see(app.client.get("/api/stores", headers={
            "authorization": "Bearer garbage.token.here"}), "garbage")
        app.see(app.client.post("/api/auth/logout", headers=h), "logout")
        app.see(app.client.get("/api/stores", headers=h), "revoked")
        app.see(app.client.post("/api/auth/dev-token"), "dev token")

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    statuses = [s for _, s, _ in port]
    assert statuses == [201, 200, 200, 409, 401, 401, 422, 422, 422, 401,
                        401, 401, 200, 401, 200]
    assert "revoked" in port[13][2]["detail"].lower()


@pytest.mark.parametrize("body", [
    {},
    {"email": "user@example.com"},
    {"password": PASSWORD},
    {"email": 5, "password": PASSWORD},
    {"email": "user@example.com", "password": 12345678901},
    {"email": None, "password": None},
    {"email": "not-an-email", "password": PASSWORD},
    {"email": "a@nodot", "password": PASSWORD},
    {"email": "x" * 250 + "@example.com", "password": PASSWORD},
    {"email": ["user@example.com"], "password": [PASSWORD]},
    {"email": "  MiXed@Example.COM ", "password": PASSWORD, "extra": 1},
    [1, 2],
    "user@example.com",
    None,
], ids=lambda b: repr(b)[:40])
def test_credentials_parse_like_pydantic(tmp_path, body):
    def scenario(app):
        app.see(app.client.post("/api/auth/register", json_body=body))
        app.see(app.client.post("/api/auth/login", json_body=body))

    jax, port = run_both(tmp_path, scenario)
    assert port == jax


def test_dev_token_gated_and_kv_down_fails_closed(tmp_path):
    for pkg in ("jax", "port"):
        client, _ = build(pkg, tmp_path / pkg / "off",
                          DEV_LOGIN_ENABLED=False)
        assert client.post("/api/auth/dev-token").status_code == 404

    class SwitchableKV:
        def __init__(self, kv_mod):
            self._ok, self._bad = kv_mod.MemoryKV(), kv_mod.FailingKV()
            self.broken = False

        def __getattr__(self, name):
            return getattr(self._bad if self.broken else self._ok, name)

    kvs = {}

    def scenario(app):
        h = app.signup()
        app.see(app.client.get("/api/stores", headers=h))
        kvs[app.pkg].broken = True
        app.see(app.client.get("/api/stores", headers=h), "kv down")

    def kv_factory(pkg):
        kvs[pkg] = SwitchableKV(mod(pkg, "runtime.kv"))
        return kvs[pkg]

    jax, port = run_both(tmp_path, scenario, kv_factory=kv_factory)
    assert port == jax and port[-1][1] == 503


def test_jwt_claims_cross_both_packages(tmp_path):
    """The port's tokens carry ids only and verify under the JAX app's
    decoder (and the other way round): the same HS256 format."""
    settings = mod("port", "app.config").Settings(
        JWT_SECRET="s" * 40)
    token = issue_token(3, settings)
    claims = decode_jwt(token, settings.JWT_SECRET,
                        issuer=settings.JWT_ISSUER,
                        audience=settings.JWT_AUDIENCE)
    assert set(claims) >= {"sub", "iss", "aud", "iat", "exp", "jti"}
    assert claims["sub"] == "3" and "@" not in str(claims.values())
    jax_auth = mod("jax", "app.auth")
    assert jax_auth.decode_jwt(token, settings.JWT_SECRET,
                               issuer=settings.JWT_ISSUER,
                               audience=settings.JWT_AUDIENCE) == claims
    jax_token = jax_auth.issue_token(4, settings)
    assert decode_jwt(jax_token, settings.JWT_SECRET,
                      issuer=settings.JWT_ISSUER,
                      audience=settings.JWT_AUDIENCE)["sub"] == "4"
    with pytest.raises(TokenError):
        decode_jwt(token, settings.JWT_SECRET, issuer="wrong",
                   audience=settings.JWT_AUDIENCE)
    with pytest.raises(TokenError):
        decode_jwt(token, "x" * 40, issuer=settings.JWT_ISSUER,
                   audience=settings.JWT_AUDIENCE)
    h = hash_password("S3cret-password")
    assert verify_password("S3cret-password", h)
    assert jax_auth.verify_password("S3cret-password", h)
    assert not verify_password("S3cret-password", h[:-4] + "AAAA")
    assert not verify_password("S3cret-password", "not-a-hash")
