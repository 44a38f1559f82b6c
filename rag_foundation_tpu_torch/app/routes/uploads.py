"""Upload route: validation, budget gate, document row, worker enqueue.

Reference parity: backend/app/routes/uploads.py — early
401, per-user upload rate limit, MIME allowlist by profile, size cap,
magic-number validation, token/cost estimate + budget check, Document
PENDING row, optional archive copy (GCS analog -> local archive dir),
enqueue-or-503, and the ``op-status`` polling endpoint.
"""

from __future__ import annotations

import asyncio
import os
import re
import shutil
import time
from pathlib import Path

from rag_foundation_tpu_torch.app import dbschema
from rag_foundation_tpu_torch.app.auth import get_current_user
from rag_foundation_tpu_torch.app.costs import (calc_index_cost,
                                                check_budget_or_402,
                                                estimate_tokens_from_bytes,
                                                require_pricing_configured)
from rag_foundation_tpu_torch.app.file_types import (allowed_types,
                                                     validate_magic)
from rag_foundation_tpu_torch.app.services.ingestion import upload_path
from rag_foundation_tpu_torch.app.tenant import require_store_owned_by_user
from rag_foundation_tpu_torch.runtime.http import HTTPError, Response


_SAFE_NAME = re.compile(r"[^A-Za-z0-9._\- ]+")


def sanitize_name(filename: str) -> str:
    """basename + character allowlist (reference: uploads.py:37-38,158) —
    a client-supplied name must never influence the archive path."""
    name = os.path.basename(filename.replace("\\", "/"))
    name = _SAFE_NAME.sub("_", name).strip(". ") or "upload"
    return name[:255]


def register(app, ctx):
    settings, db = ctx.settings, ctx.db

    @app.post("/api/upload")
    async def upload(req):
        user = get_current_user(req, db, ctx.kv, settings)  # early 401:
        # auth/rate/pricing gates run BEFORE a single body byte is read
        require_pricing_configured(settings, "INDEX")
        ctx.limiter.check(f"user:{user.id}:upload",
                          settings.RATE_LIMIT_UPLOAD_PER_MIN)
        max_bytes = settings.MAX_UPLOAD_MB * 1024 * 1024
        spool_dir = str(Path(settings.DATA_DIR) / "uploads" / "tmp")
        # streamed parse: 1 MiB chunks to a 0600 tempfile, 413 the moment
        # the cap is crossed, 415 at part HEADERS for disallowed types —
        # the body is never buffered in RAM (reference uploads.py:157-193)
        fields, files = await req.stream_multipart(
            max_file_bytes=max_bytes, spool_dir=spool_dir,
            allowed_file_types=allowed_types(settings.UPLOAD_PROFILE))
        try:
            if "file" not in files:
                raise HTTPError(422, "Missing file field")
            try:
                store_id = int(fields.get("store_id", ""))
            except ValueError:
                raise HTTPError(422,
                                "Missing or invalid store_id") from None
            store = require_store_owned_by_user(db, store_id, user.id)

            f = files["file"]
            if not f.size:
                raise HTTPError(422, "Empty file")
            if not validate_magic(f.content_type, f.head[:16]):
                raise HTTPError(
                    415, "File content does not match declared type")

            est_tokens = estimate_tokens_from_bytes(f.size,
                                                    f.content_type)
            est_cost = calc_index_cost(settings, est_tokens)
            check_budget_or_402(db, user.id, settings, hold=est_cost)

            safe_name = sanitize_name(f.filename)
            doc_id = db.execute(
                "INSERT INTO documents(store_id, user_id, filename,"
                " content_type, size_bytes, status, status_updated_at,"
                " est_tokens, created_at) VALUES(?,?,?,?,?,?,?,?,?)",
                (store["id"], user.id, safe_name, f.content_type,
                 f.size, dbschema.DOC_PENDING, time.time(), est_tokens,
                 time.time()))
            path = upload_path(settings, doc_id)
            # same-fs atomic move, no copy; f.path is the parser's own
            # spool tempfile name, not client data
            os.replace(f.path, path)  # taint-ok
        except BaseException:
            for part in files.values():
                part.cleanup()
            raise
        # any EXTRA file parts a client sent were spooled too — clean
        # them on success as well, or repeat uploads fill the tmp dir
        for name, part in files.items():
            if name != "file":
                part.cleanup()

        if settings.ARCHIVE_UPLOADS:
            try:
                archive = (Path(settings.DATA_DIR) / "archive"
                           / store["engine_key"].replace("/", "_"))
                archive.mkdir(parents=True, exist_ok=True)
                dst = archive / f"doc-{doc_id}-{safe_name[:100]}"
                # off the event loop: the copy is up to MAX_UPLOAD_MB
                await asyncio.to_thread(shutil.copyfile, path, dst)
                db.execute(
                    "UPDATE documents SET archive_path=? WHERE id=?",
                    (str(dst), doc_id))
            except BaseException:
                # the document row already exists as PENDING; a raw 500
                # here would strand it PENDING forever with no job —
                # mark it ERROR so the state machine stays truthful
                db.execute(
                    "UPDATE documents SET status=?, status_updated_at=?,"
                    " last_error=? WHERE id=?",
                    (dbschema.DOC_ERROR, time.time(),
                     "archive copy failed", doc_id))
                raise

        if not ctx.has_ingestion_queue():
            # queue down => 503, do not lose the job silently (reference:
            # uploads.py:263-293)
            db.execute(
                "UPDATE documents SET status=?, status_updated_at=?,"
                " last_error=? WHERE id=?",
                (dbschema.DOC_ERROR, time.time(), "ingestion queue"
                 " unavailable", doc_id))
            raise HTTPError(503, "Ingestion queue unavailable")
        ctx.queue.enqueue("ingest_document", {"document_id": doc_id},
                          max_attempts=settings.WORKER_MAX_ATTEMPTS)
        return Response({
            "document_id": doc_id,
            "op_id": f"doc-{doc_id}",
            "status": dbschema.DOC_PENDING,
            "estimated_tokens": est_tokens,
            "estimated_cost_usd": str(est_cost),
        }, status=201)

    @app.get("/api/upload/op-status/{op_id}")
    async def op_status(req):
        user = get_current_user(req, db, ctx.kv, settings)
        op_id = req.path_params["op_id"]
        if not op_id.startswith("doc-"):
            raise HTTPError(404, "Unknown operation")
        try:
            doc_id = int(op_id[len("doc-"):])
        except ValueError:
            raise HTTPError(404, "Unknown operation") from None
        row = db.one(
            "SELECT * FROM documents WHERE id=? AND user_id=?",
            (doc_id, user.id))
        if row is None:
            raise HTTPError(404, "Unknown operation")
        return Response({
            "op_id": op_id,
            "document_id": row["id"],
            "status": row["status"],
            "done": row["status"] in (dbschema.DOC_DONE, dbschema.DOC_ERROR),
            "error": row["last_error"],
            "chunks": row["chunks"],
        })
