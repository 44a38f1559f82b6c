"""Both apps, the JAX one and the port's, from the same settings, and what
a request sequence saw through each.

``build("jax" | "port", tmp_path, **overrides)`` makes an app from the
values of ``tests/app_helpers.make_settings`` (the port's engine on the
CPU, through ``RAGTPU_ENGINE_PLATFORM=cpu`` as its entry point reads
it); ``run_both`` runs one scenario through each app's ``TestClient``
and returns the two records, which the parity tests compare. A record
holds statuses and JSON bodies or SSE frames with the values that differ
run to run masked: timestamps, tokens, the store key's random suffix and
the SSE message and text ids.
"""

from __future__ import annotations

import importlib
import json
import os
import re

PACKAGES = {"jax": "rag_foundation_tpu", "port": "rag_foundation_tpu_torch"}

# tests/app_helpers.make_settings
SETTINGS = dict(
    ENVIRONMENT="test", DEV_LOGIN_ENABLED=True, MOCK_MODE=False,
    ENGINE_DIM=128, ENGINE_CHUNK_TOKENS=40, ENGINE_CHUNK_OVERLAP=8,
    RATE_LIMIT_GLOBAL_PER_MIN=10_000, RATE_LIMIT_CHAT_PER_MIN=1_000,
    RATE_LIMIT_UPLOAD_PER_MIN=1_000, RATE_LIMIT_LOGIN_PER_MIN=1_000,
    STREAM_KEEPALIVE_S=5.0, WORKER_RETRY_BACKOFF_S=0.0)

PASSWORD = "Passw0rd-123"


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PACKAGES[pkg]}.{name}")


def settings_for(pkg: str, tmp_path, **overrides):
    cfg = mod(pkg, "app.config")
    values = dict(SETTINGS, DATA_DIR=str(tmp_path / "data"),
                  DATABASE_PATH=str(tmp_path / "app.db"))
    values.update(overrides)
    return cfg.Settings(**values)


def build(pkg: str, tmp_path, *, kv=None, with_worker: bool = True,
          **overrides):
    """(client, ctx) of one app, its worker built but not started."""
    main = mod(pkg, "app.main")
    http = mod(pkg, "runtime.http")
    settings = settings_for(pkg, tmp_path, **overrides)
    old = os.environ.get("RAGTPU_ENGINE_PLATFORM")
    os.environ["RAGTPU_ENGINE_PLATFORM"] = "cpu"
    try:
        ctx = main.build_context(settings, kv=kv, with_worker=with_worker)
    finally:
        if old is None:
            os.environ.pop("RAGTPU_ENGINE_PLATFORM", None)
        else:
            os.environ["RAGTPU_ENGINE_PLATFORM"] = old
    return http.TestClient(main.create_app(ctx, start_worker=False)), ctx


class App:
    """One app under a scenario: its client and context, the request
    helpers of ``tests/app_helpers`` and ``see``, which records what a
    response showed."""

    def __init__(self, pkg: str, client, ctx):
        self.pkg, self.client, self.ctx = pkg, client, ctx
        self.record: list = []

    def see(self, resp, note: str = ""):
        """Append (note, status, masked body or SSE frames) and return the
        response."""
        ctype = resp.headers.get("content-type", "")
        if ctype.startswith("text/event-stream"):
            body = [p if p == "[DONE]" else json.loads(p)
                    for p in resp.iter_sse()]
        elif ctype.startswith("application/json"):
            body = resp.json()
        else:
            body = resp.text
        self.record.append((note, resp.status_code, mask(body)))
        return resp

    def signup(self, email="user@example.com", password=PASSWORD) -> dict:
        self.see(self.client.post(
            "/api/auth/register",
            json_body={"email": email, "password": password}), "register")
        r = self.see(self.client.post(
            "/api/auth/login",
            json_body={"email": email, "password": password}), "login")
        return {"authorization": f"Bearer {r.json()['access_token']}"}

    def create_store(self, headers, name="My Store") -> dict:
        return self.see(self.client.post(
            "/api/stores", json_body={"name": name}, headers=headers),
            "create_store").json()

    def upload_text(self, headers, store_id, text, filename="doc.txt"):
        return self.see(self.client.post(
            "/api/upload", headers=headers,
            data={"store_id": str(store_id)},
            files={"file": (filename, text.encode(), "text/plain")}),
            f"upload {filename}")

    def drain(self) -> None:
        while self.ctx.worker.run_once():
            pass

    def make_admin(self, email="user@example.com") -> None:
        self.ctx.db.execute("UPDATE users SET role='admin' WHERE email=?",
                            (email,))


_RANDOM_ID = re.compile(r"^(msg|txt)-[0-9a-f]{12}$")
_TIMES = {"created_at", "updated_at", "access_token", "messageId"}


def mask(x):
    """The record's values with what differs run to run masked."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k in _TIMES:
                out[k] = "<masked>"
            elif k == "engine_key" and isinstance(v, str):
                out[k] = re.sub(r"-[0-9a-f]{8}$", "-<hex>", v)
            else:
                out[k] = mask(v)
        return out
    if isinstance(x, list):
        return [mask(v) for v in x]
    if isinstance(x, str) and _RANDOM_ID.match(x):
        return "<id>"
    return x


def run_both(tmp_path, scenario, *, kv_factory=None, with_worker=True,
             **overrides) -> tuple[list, list]:
    """``scenario(app)`` through the JAX app and the port's; returns
    their records (``app.record`` plus whatever the scenario returns)."""
    records = []
    for pkg in ("jax", "port"):
        kv = kv_factory(pkg) if kv_factory else None
        client, ctx = build(pkg, tmp_path / pkg, kv=kv,
                            with_worker=with_worker, **overrides)
        app = App(pkg, client, ctx)
        extra = scenario(app)
        records.append(app.record + ([("returned", extra)]
                                     if extra is not None else []))
    return records[0], records[1]


def test_mask_hides_what_differs_run_to_run():
    body = {"engine_key": "stores/1-my-store-0a1b2c3d", "created_at": 1.5,
            "frames": [{"type": "start", "messageId": "msg-0123456789ab"},
                       {"type": "text-start", "id": "txt-0123456789ab"}],
            "id": 7}
    assert mask(body) == {
        "engine_key": "stores/1-my-store-<hex>", "created_at": "<masked>",
        "frames": [{"type": "start", "messageId": "<masked>"},
                   {"type": "text-start", "id": "<id>"}], "id": 7}


def test_both_apps_build_from_the_same_settings(tmp_path):
    for pkg in ("jax", "port"):
        client, ctx = build(pkg, tmp_path / pkg)
        assert ctx.settings.ENGINE_DIM == 128
        assert client.get("/live").json() == {"status": "live"}
    assert str(ctx.rag.engine.device) == "cpu"
