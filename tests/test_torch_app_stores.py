"""The port app's store routes against the JAX app's: the request sequences
of ``tests/test_app_stores.py`` (over the routes the port serves) give the
same statuses and bodies, ids the same, store keys' random suffix and
timestamps masked; the pydantic-free ``StoreCreate`` parser gives the
same names and 422 texts, the XSS-sanitising validator included."""

import pytest

from tests.test_torch_app_helpers import run_both

DOC = ("Quarterly revenue grew twelve percent driven by cloud "
       "subscriptions and enterprise contracts. " * 8)


def test_store_crud_cap_and_listing(tmp_path):
    def scenario(app):
        h = app.signup()
        app.create_store(h, "A")
        app.create_store(h, "B")
        app.see(app.client.post("/api/stores", json_body={"name": "C"},
                                headers=h), "over the cap")
        app.see(app.client.get("/api/stores", headers=h), "list")

    jax, port = run_both(tmp_path, scenario, MAX_STORES_PER_USER=2)
    assert port == jax
    assert [s for _, s, _ in port][2:] == [201, 201, 409, 200]
    assert port[2][2]["engine_key"].startswith("stores/1-a-")


@pytest.mark.parametrize("body", [
    {"name": ""}, {"name": "   "}, {"name": "x" * 100}, {"name": "x" * 101},
    {"name": "x" * 200}, {"name": "<script>alert(1)</script>ok"},
    {"name": "&" * 20}, {"name": "&" * 21}, {"name": "  Tab\tName  "},
    {"name": 5}, {"name": None}, {"name": ["a"]}, {"name": True}, {},
    {"name": "ok", "extra": [1]}, [1, 2], "hi",
], ids=lambda b: repr(b)[:40])
def test_store_create_body_parses_like_pydantic(tmp_path, body):
    def scenario(app):
        h = app.signup()
        app.see(app.client.post("/api/stores", json_body=body, headers=h))

    jax, port = run_both(tmp_path, scenario)
    assert port == jax


def test_tenant_isolation_is_404_not_403(tmp_path):
    def scenario(app):
        h1 = app.signup("a@example.com")
        h2 = app.signup("b@example.com")
        sid = app.create_store(h1, "Private")["id"]
        app.see(app.client.delete(f"/api/stores/{sid}", headers=h2))
        app.see(app.client.post("/api/chat", headers=h2, json_body={
            "question": "hi", "store_ids": [sid]}))
        app.see(app.client.get(f"/api/upload/op-status/doc-{sid}",
                               headers=h2))
        app.see(app.client.get("/api/stores", headers=h1))

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    assert [s for _, s, _ in port][-4:] == [404, 404, 404, 200]


def test_soft_delete_cascade_and_admin_restore(tmp_path):
    def scenario(app):
        h = app.signup()
        app.make_admin()
        sid = app.create_store(h)["id"]
        app.upload_text(h, sid, DOC)
        app.drain()
        app.see(app.client.delete(f"/api/stores/{sid}", headers=h))
        app.see(app.client.get("/api/stores", headers=h))
        deleted = app.ctx.db.one("SELECT deleted_at FROM documents")
        app.see(app.client.post(f"/api/admin/stores/{sid}/restore",
                                headers=h))
        app.see(app.client.post(f"/api/admin/stores/{sid + 5}/restore",
                                headers=h))
        app.see(app.client.post("/api/chat", headers=h, json_body={
            "question": "How did revenue grow?", "store_ids": [sid]}))
        return deleted["deleted_at"] is not None

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    assert port[-1] == ("returned", True)
    assert "revenue" in str(port[-2][2]).lower()


def test_non_numeric_path_params_and_non_object_bodies(tmp_path):
    def scenario(app):
        h = app.signup("pp@example.com")
        for method, path in [("DELETE", "/api/stores/abc"),
                             ("DELETE", "/api/chat/sessions/nope"),
                             ("GET", "/api/chat/sessions/x/messages"),
                             ("GET", "/api/upload/op-status/doc-x"),
                             ("GET", "/api/upload/op-status/nope")]:
            app.see(app.client.request(method, path, headers=h), path)
        app.see(app.client.post("/api/stores", headers=h,
                                json_body=[1, 2]))
        app.see(app.client.post("/api/chat", headers=h, json_body="hi"))

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    assert [s for _, s, _ in port][2:] == [404] * 5 + [422, 422]
