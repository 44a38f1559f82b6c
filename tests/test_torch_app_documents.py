"""The port app's document routes against the JAX app's: listing, soft
delete and the admin restore run through both apps from the same
settings and give the same statuses, bodies and SSE frames (timestamps
and random ids masked). A delete drops the document from the engine at
once, so the next chat no longer cites it and the engine's search
returns none of its chunks; a restore re-ingests it through the worker
and it is cited again; without its payload the restore flips it to
ERROR."""

import re

from tests.test_torch_app_helpers import run_both

REVENUE = ("The quarterly revenue grew twelve percent driven by cloud "
           "subscriptions and enterprise contracts. " * 6)
GLACIER = ("The glacier research station sits at four thousand meters and "
           "houses nine scientists through the winter season. " * 6)
QUESTION = "How did the quarterly revenue grow?"


def _listed(app, h, sid, note=""):
    """List the store's documents; their status times and the times in
    their operation names differ run to run, so the record holds them
    masked."""
    r = app.see(app.client.get(f"/api/stores/{sid}/documents", headers=h),
                note)
    if r.status_code == 200:
        app.record[-1] = app.record[-1][:2] + ({"documents": [
            dict(d, status_updated_at="<masked>",
                 op_name=re.sub(r"-\d+$", "-<ms>", d["op_name"] or ""))
            for d in app.record[-1][2]["documents"]]},)
    return r


def _cited(app, h, sid) -> list[str]:
    """The titles a chat on the revenue question cites, in order."""
    r = app.see(app.client.post("/api/chat", headers=h, json_body={
        "question": QUESTION, "store_ids": [sid]}), "chat")
    return [f["title"] for f in app.record[-1][2]
            if isinstance(f, dict) and f.get("type") == "source-document"
            ] if r.status_code == 200 else []


def _searched(app) -> set[str]:
    """The documents the engine's own search returns for the question."""
    engine = app.ctx.rag.engine
    key = app.ctx.db.one("SELECT engine_key FROM stores")["engine_key"]
    return {hit.doc_id for hit in engine.search([key], QUESTION, k=8)}


def test_list_delete_restore_and_tenancy(tmp_path):
    def scenario(app):
        h = app.signup()
        h2 = app.signup("other@example.com")
        app.make_admin()
        sid = app.create_store(h)["id"]
        app.upload_text(h, sid, REVENUE, "finance.txt")
        app.upload_text(h, sid, GLACIER, "glacier.txt")
        app.drain()
        _listed(app, h, sid)
        # another user's view of it is 404, never 403
        _listed(app, h2, sid, "foreign list")
        app.see(app.client.delete("/api/documents/1", headers=h2),
                "foreign delete")
        app.see(app.client.post("/api/admin/documents/1/restore",
                                headers=h2), "restore as user")
        app.see(app.client.delete("/api/documents/99", headers=h),
                "no document")
        app.see(app.client.post("/api/admin/documents/99/restore",
                                headers=h), "restore none")
        engine_doc = app.ctx.db.one(
            "SELECT engine_doc_id FROM documents WHERE id=1")[0]
        before = (_cited(app, h, sid), engine_doc in _searched(app))

        app.see(app.client.delete("/api/documents/1", headers=h), "delete")
        app.see(app.client.delete("/api/documents/1", headers=h),
                "delete again")
        _listed(app, h, sid)
        deleted = (_cited(app, h, sid), engine_doc in _searched(app))

        app.see(app.client.post("/api/admin/documents/1/restore",
                                headers=h), "restore")
        app.see(app.client.get("/api/upload/op-status/doc-1", headers=h),
                "restored status")
        app.drain()
        _listed(app, h, sid)
        engine_doc = app.ctx.db.one(
            "SELECT engine_doc_id FROM documents WHERE id=1")[0]
        restored = (_cited(app, h, sid), engine_doc in _searched(app))
        audit = app.see(app.client.get("/api/admin/audit",
                                       headers=h)).json()["audit"]
        return before, deleted, restored, [a["action"] for a in audit]

    jax, port = run_both(tmp_path, scenario, ARCHIVE_UPLOADS=True)
    assert port == jax
    by_note = {r[0]: r[1:] for r in port if len(r) == 3}
    assert [by_note[n][0] for n in ("foreign list", "foreign delete",
                                    "restore as user", "no document",
                                    "restore none")] == [
        404, 404, 403, 404, 404]
    assert by_note["delete"] == (200, {"status": "deleted", "id": 1})
    assert by_note["delete again"][0] == 404
    assert by_note["restore"] == (200, {"status": "restored", "id": 1,
                                        "reingest": True})
    assert by_note["restored status"][1]["status"] == "PENDING"
    before, deleted, restored, actions = port[-1][1]
    assert before[0][0] == "finance.txt" and before[1]
    assert "finance.txt" not in deleted[0] and not deleted[1]
    assert restored[0][0] == "finance.txt" and restored[1]
    assert actions[0] == "document_restore"


def test_restore_without_a_payload_flips_to_error(tmp_path):
    def scenario(app):
        h = app.signup()
        app.make_admin()
        sid = app.create_store(h)["id"]
        app.upload_text(h, sid, REVENUE, "finance.txt")
        app.drain()
        app.see(app.client.delete("/api/documents/1", headers=h))
        app.see(app.client.post("/api/admin/documents/1/restore",
                                headers=h), "restore")
        app.see(app.client.get("/api/upload/op-status/doc-1", headers=h))
        _listed(app, h, sid)
        return app.ctx.queue.stats()

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    assert port[-4][2] == {"status": "restored", "id": 1,
                           "reingest": False}
    listed = port[-2][2]["documents"][0]
    assert listed["status"] == "ERROR"
    assert listed["last_error"] == "payload gone; re-upload required"


def test_delete_before_ingestion_and_restore_of_a_pending_document(tmp_path):
    """A document deleted while its job is queued never reaches the
    engine; its restore finds the payload still in place."""
    def scenario(app):
        h = app.signup()
        app.make_admin()
        sid = app.create_store(h)["id"]
        app.upload_text(h, sid, REVENUE, "finance.txt")
        app.see(app.client.delete("/api/documents/1", headers=h))
        app.drain()
        app.see(app.client.get("/api/upload/op-status/doc-1", headers=h))
        app.see(app.client.post("/api/admin/documents/1/restore",
                                headers=h), "restore")
        app.drain()
        _listed(app, h, sid)
        return _cited(app, h, sid)

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    assert port[-1][1][:1] == ["finance.txt"]
