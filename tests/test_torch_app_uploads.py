"""The port app's upload route and ingestion worker against the JAX app's:
the request sequences of ``tests/test_app_uploads.py`` (over the routes
the port serves) give the same statuses, bodies and document rows."""

import time

from rag_foundation_tpu_torch.app import dbschema
from rag_foundation_tpu_torch.app.routes.uploads import sanitize_name
from rag_foundation_tpu_torch.app.services.ingestion import (
    _sanitize_error, reset_stuck_documents)
from tests.test_torch_app_helpers import build, mod, run_both

DOC = ("Machine learning on tensor processing units requires careful "
       "attention to memory bandwidth and matrix unit utilization. " * 10)


def _doc_row(ctx, doc_id):
    row = ctx.db.one("SELECT filename, content_type, size_bytes, status,"
                     " last_error, chunks, est_tokens, engine_doc_id,"
                     " deleted_at IS NOT NULL AS deleted FROM documents"
                     " WHERE id=?", (doc_id,))
    return dict(row) if row is not None else None


def test_upload_ingest_flow_and_ledger(tmp_path):
    def scenario(app):
        h = app.signup()
        sid = app.create_store(h)["id"]
        op = app.upload_text(h, sid, DOC).json()["op_id"]
        app.see(app.client.get(f"/api/upload/op-status/{op}", headers=h))
        app.drain()
        app.see(app.client.get(f"/api/upload/op-status/{op}", headers=h))
        ledger = app.ctx.db.one(
            "SELECT model, prompt_tokens, cost_usd FROM query_log"
            " WHERE model='INDEX'")
        # the same document re-enqueued: DONE rows are skipped
        app.ctx.queue.enqueue("ingest_document", {"document_id": 1})
        app.drain()
        stats = app.ctx.rag.engine.store_stats(
            app.ctx.db.one("SELECT engine_key FROM stores")["engine_key"])
        return dict(ledger), _doc_row(app.ctx, 1), stats

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    ledger, row, stats = port[-1][1]
    assert row["status"] == "DONE" and row["chunks"] > 0
    assert ledger["prompt_tokens"] > 0 and stats["documents"] == 1


def test_upload_validation_errors(tmp_path):
    def scenario(app):
        h = app.signup()
        sid = str(app.create_store(h)["id"])
        post = app.client.post
        for files, data in [
                ({"file": ("x.bin", b"\x00\x01", "application/octet-stream")},
                 {"store_id": sid}),
                ({"file": ("x.pdf", b"not a pdf", "application/pdf")},
                 {"store_id": sid}),
                ({"file": ("big.txt", b"a" * (2 * 1024 * 1024),
                           "text/plain")}, {"store_id": sid}),
                ({"file": ("e.txt", b"", "text/plain")}, {"store_id": sid}),
                ({"file": ("a.txt", b"hello", "text/plain")},
                 {"store_id": "99999"}),
                ({"file": ("a.txt", b"hello", "text/plain")},
                 {"store_id": "abc"}),
                ({"file": ("a.txt", b"hello", "text/plain")}, {}),
                ({"other": ("a.txt", b"hello", "text/plain")},
                 {"store_id": sid})]:
            app.see(post("/api/upload", headers=h, data=data, files=files),
                    str(sorted(files)))
        app.see(post("/api/upload", headers=h, json_body={"x": 1}),
                "not multipart")

    jax, port = run_both(tmp_path, scenario, MAX_UPLOAD_MB=1)
    assert port == jax
    assert [s for _, s, _ in port][3:] == [415, 415, 413, 422, 404, 422,
                                           422, 422, 415]


def test_pdf_under_the_office_profile(tmp_path):
    def scenario(app):
        h = app.signup()
        sid = app.create_store(h)["id"]
        app.upload_text(h, sid, "", filename="a.pdf")
        pdf = b"%PDF-1.4 " + b"revenue growth cloud subscriptions " * 50
        app.see(app.client.post("/api/upload", headers=h,
                                data={"store_id": str(sid)},
                                files={"file": ("a.pdf", pdf,
                                                "application/pdf")}))
        app.drain()
        return _doc_row(app.ctx, 1)

    jax, port = run_both(tmp_path, scenario, UPLOAD_PROFILE="office")
    assert port == jax and port[-1][1]["status"] == "DONE"


def test_watchdog_failure_and_deleted_store(tmp_path):
    def scenario(app):
        h = app.signup()
        sid = app.create_store(h)["id"]
        app.upload_text(h, sid, DOC)
        app.ctx.db.execute(
            "UPDATE documents SET status=?, status_updated_at=? WHERE id=?",
            (dbschema.DOC_RUNNING, time.time() - 100, 1))
        ingestion = mod(app.pkg, "app.services.ingestion")
        n = ingestion.reset_stuck_documents(app.ctx.db, app.ctx.settings)
        stuck = _doc_row(app.ctx, 1)
        # a store soft-deleted before the worker runs: the cascade marks
        # the document deleted and the worker skips it
        sid2 = app.create_store(h, "Second")["id"]
        app.upload_text(h, sid2, DOC)
        app.see(app.client.delete(f"/api/stores/{sid2}", headers=h))
        app.drain()
        return n, stuck, _doc_row(app.ctx, 2)

    jax, port = run_both(tmp_path, scenario, WATCHDOG_STALE_S=0.01)
    assert port == jax
    n, stuck, deleted = port[-1][1]
    assert n == 1 and stuck["status"] == "ERROR"
    assert "watchdog" in stuck["last_error"] and deleted["deleted"]


def test_ingestion_failure_in_mock_mode_marks_error(tmp_path):
    def scenario(app):
        h = app.signup()
        sid = app.create_store(h)["id"]
        app.ctx.rag.ingest_should_fail = True
        app.upload_text(h, sid, DOC)
        app.drain()
        return _doc_row(app.ctx, 1)

    jax, port = run_both(tmp_path, scenario, MOCK_MODE=True)
    assert port == jax
    assert "mock ingestion failure" in port[-1][1]["last_error"]


def test_upload_503_without_a_queue(tmp_path):
    def scenario(app):
        h = app.signup()
        sid = app.create_store(h)["id"]
        app.upload_text(h, sid, DOC)
        return _doc_row(app.ctx, 1)

    jax, port = run_both(tmp_path, scenario, with_worker=False)
    assert port == jax
    assert port[-2][1] == 503 and "queue" in port[-1][1]["last_error"]


def test_filenames_sanitized_and_archived(tmp_path):
    assert sanitize_name("../../etc/passwd") == "passwd"
    assert sanitize_name("..\\..\\boot.ini") == "boot.ini"
    assert sanitize_name("we ird$$name!.pdf") == "we ird_name_.pdf"
    assert sanitize_name("...") == sanitize_name("") == "upload"

    def scenario(app):
        h = app.signup()
        sid = app.create_store(h)["id"]
        app.upload_text(h, sid, DOC, filename="../../../../tmp/evil.txt")
        app.drain()
        app.see(app.client.get("/api/upload/op-status/doc-1", headers=h))
        path = app.ctx.db.one("SELECT archive_path FROM documents")[0]
        return _doc_row(app.ctx, 1), path.endswith("doc-1-evil.txt")

    jax, port = run_both(tmp_path, scenario, ARCHIVE_UPLOADS=True)
    assert port == jax
    assert port[-1][1][0]["filename"] == "evil.txt" and port[-1][1][1]


def test_ingestion_errors_sanitized_like_jax():
    jax_ing = mod("jax", "app.services.ingestion")
    for e in (ValueError("bad thing at /srv/app/secret.py"),
              RuntimeError("engine exploded"), KeyError("k"),
              MemoryError()):
        assert _sanitize_error(e) == jax_ing._sanitize_error(e)
    assert "secret" not in _sanitize_error(ValueError("at /a/secret.py"))


def test_reset_stuck_only_ids(tmp_path):
    client, ctx = build("port", tmp_path, WATCHDOG_STALE_S=0.01)
    assert reset_stuck_documents(ctx.db, ctx.settings, only_ids=[]) == 0
