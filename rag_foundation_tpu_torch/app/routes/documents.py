"""Document listing, soft-delete, admin restore.

Counterpart of ``rag_foundation_tpu/app/routes/documents.py``: a delete
drops the document from the port's engine at once, a restore re-ingests
it through the job queue.

Reference parity: backend/app/routes/documents.py:19-93.
"""

from __future__ import annotations

import asyncio
import os
import shutil
import time

from rag_foundation_tpu_torch.app import dbschema
from rag_foundation_tpu_torch.app.auth import get_current_user, require_admin
from rag_foundation_tpu_torch.app.routes._params import int_param
from rag_foundation_tpu_torch.app.services.audit import record_admin_action
from rag_foundation_tpu_torch.app.services.cleanup import cleanup_document
from rag_foundation_tpu_torch.app.services.ingestion import upload_path
from rag_foundation_tpu_torch.app.tenant import (
    require_document_owned_by_user, require_store_owned_by_user)
from rag_foundation_tpu_torch.runtime.http import HTTPError, Response


def _doc_dto(row) -> dict:
    return {
        "id": row["id"], "store_id": row["store_id"],
        "filename": row["filename"], "content_type": row["content_type"],
        "size_bytes": row["size_bytes"], "status": row["status"],
        "status_updated_at": row["status_updated_at"],
        "chunks": row["chunks"], "est_tokens": row["est_tokens"],
        "last_error": row["last_error"], "created_at": row["created_at"],
        "op_name": row["op_name"],
    }


def register(app, ctx):
    settings, db = ctx.settings, ctx.db

    @app.get("/api/stores/{store_id}/documents")
    async def list_documents(req):
        user = get_current_user(req, db, ctx.kv, settings)
        store = require_store_owned_by_user(
            db, int_param(req, "store_id"), user.id)
        rows = db.query(
            "SELECT * FROM documents WHERE store_id=? AND deleted_at IS NULL"
            " ORDER BY id", (store["id"],))
        return Response({"documents": [_doc_dto(r) for r in rows]})

    @app.delete("/api/documents/{document_id}")
    async def delete_document(req):
        user = get_current_user(req, db, ctx.kv, settings)
        doc = require_document_owned_by_user(
            db, int_param(req, "document_id"), user.id)
        with db.tx() as conn:
            conn.execute("UPDATE documents SET deleted_at=? WHERE id=?",
                         (time.time(), doc["id"]))
        store = db.one("SELECT engine_key FROM stores WHERE id=?",
                       (doc["store_id"],))
        if store is not None and doc["engine_doc_id"]:
            await asyncio.to_thread(
                cleanup_document, ctx.rag, store["engine_key"],
                doc["engine_doc_id"])
        return Response({"status": "deleted", "id": doc["id"]})

    @app.post("/api/admin/documents/{document_id}/restore")
    async def restore_document(req):
        user = require_admin(get_current_user(req, db, ctx.kv, settings))
        did = int_param(req, "document_id")
        row = db.one("SELECT * FROM documents WHERE id=?", (did,))
        if row is None:
            raise HTTPError(404, "Document not found")
        # the engine copy was removed at delete time (privacy: deleted
        # content must stop being served immediately), so a restore
        # must RE-INGEST — flip to PENDING and enqueue; the payload (or
        # archive copy) must still exist for the worker to read
        payload = upload_path(settings, did)
        has_payload = payload.exists() or bool(
            row["archive_path"] and os.path.exists(row["archive_path"]))
        if row["archive_path"] and not payload.exists() and has_payload:
            shutil.copyfile(row["archive_path"], payload)
        with db.tx() as conn:
            conn.execute(
                "UPDATE documents SET deleted_at=NULL, status=?,"
                " status_updated_at=?, last_error=? WHERE id=?",
                (dbschema.DOC_PENDING if has_payload
                 else dbschema.DOC_ERROR, time.time(),
                 None if has_payload
                 else "payload gone; re-upload required", did))
        if has_payload and ctx.has_ingestion_queue():
            ctx.queue.enqueue("ingest_document", {"document_id": did})
        record_admin_action(db, admin_user_id=user.id,
                            action="document_restore", target=str(did))
        return Response({"status": "restored", "id": did,
                         "reingest": bool(has_payload)})
