"""Durable ingestion: the worker job behind document uploads.

Reference parity: backend/app/services/ingestion.py —
row-locked claim, idempotency gates (skip DONE/RUNNING), RUNNING->DONE/
ERROR transitions with ``status_updated_at``, sanitized ``last_error``,
index-cost QueryLog rows, rollback of the engine-side document on
unhandled errors, and temp-file cleanup. The network boundary (HTTPS to
Gemini) becomes a host->device boundary: chunk+embed+insert on the TPU
engine (SURVEY.md §3.1).
"""

from __future__ import annotations

import logging
import re
import time
from pathlib import Path

from rag_foundation_tpu_torch.app import dbschema
from rag_foundation_tpu_torch.app.costs import (calc_index_cost,
                                                record_query_cost)
from rag_foundation_tpu_torch.app.file_types import extract_text
from rag_foundation_tpu_torch.app.telemetry import log_json


def _sanitize_error(e: Exception) -> str:
    """Bounded, path-scrubbed message safe to surface via op-status
    (reference: ingestion.py:64 keeps full detail in logs only)."""
    msg = str(e)[:200]
    # scrub anything that looks like a filesystem path or engine internals
    msg = re.sub(r"(/[\w.\-]+)+", "<path>", msg)
    generic = {
        "ValueError": "document could not be processed",
        "KeyError": "document could not be processed",
        "MemoryError": "document too large for the engine",
    }
    label = generic.get(type(e).__name__, "ingestion failed")
    return f"{label}: {msg}" if msg and "<path>" not in msg else label


def upload_path(settings, document_id: int) -> Path:
    p = Path(settings.DATA_DIR) / "uploads"
    p.mkdir(parents=True, exist_ok=True)
    return p / f"doc-{document_id}"


def _set_status(db, document_id: int, status: str,
                *, error: str | None = None, chunks: int | None = None,
                op_name: str | None = None, engine_doc_id: str | None = None):
    sets = ["status=?", "status_updated_at=?"]
    params: list = [status, time.time()]
    if status == dbschema.DOC_DONE and error is None:
        # a retry that succeeds must clear the previous attempt's error
        # (op-status surfaces last_error; a stale message made a DONE
        # document look failed in the UI)
        sets.append("last_error=NULL")
    if error is not None:
        sets.append("last_error=?")
        params.append(error[:500])
    if chunks is not None:
        sets.append("chunks=?")
        params.append(chunks)
    if op_name is not None:
        sets.append("op_name=?")
        params.append(op_name)
    if engine_doc_id is not None:
        sets.append("engine_doc_id=?")
        params.append(engine_doc_id)
    params.append(document_id)
    db.execute(f"UPDATE documents SET {', '.join(sets)} WHERE id=?",  # sql-ok: literal fragments, values bound
               tuple(params))


def run_ingestion_sync(db, rag, settings, document_id: int) -> str:
    """Process one document end to end. Returns the final status.

    Safe to call concurrently / repeatedly: the claim transaction flips
    PENDING->RUNNING atomically and DONE/RUNNING rows are skipped
    (reference: ingestion.py:163-208).
    """
    # -- claim (row-lock analog: single sqlite write transaction) ----------
    with db.tx() as conn:
        row = conn.execute("SELECT * FROM documents WHERE id=?",
                           (document_id,)).fetchone()
        if row is None:
            return "missing"
        if row["deleted_at"] is not None:
            return "deleted"
        if row["status"] == dbschema.DOC_DONE:
            return dbschema.DOC_DONE  # idempotent skip
        if row["status"] == dbschema.DOC_RUNNING:
            age = time.time() - row["status_updated_at"]
            if age < settings.INGESTION_TIMEOUT_S:
                return dbschema.DOC_RUNNING  # another worker owns it
        op_name = f"ops/doc-{document_id}-{int(time.time() * 1000)}"
        conn.execute(
            "UPDATE documents SET status=?, status_updated_at=?, op_name=?"
            " WHERE id=?",
            (dbschema.DOC_RUNNING, time.time(), op_name, document_id))
    doc = dict(row)

    store = db.one("SELECT * FROM stores WHERE id=?", (doc["store_id"],))
    if store is None or store["deleted_at"] is not None:
        _set_status(db, document_id, dbschema.DOC_ERROR,
                    error="store deleted before ingestion")
        return dbschema.DOC_ERROR

    path = upload_path(settings, document_id)
    engine_doc_id = f"doc-{document_id}"
    try:
        data = path.read_bytes()
        text = extract_text(data, doc["content_type"])
        stats = rag.ingest_document(store["engine_key"], engine_doc_id,
                                    doc["filename"], text)
        # re-check AFTER the engine insert: a user deleting the document
        # mid-ingestion found engine_doc_id still NULL (it is only
        # written at DONE) and skipped engine cleanup — the deleted
        # content stayed retrievable in chat forever
        fresh = db.one("SELECT deleted_at FROM documents WHERE id=?",
                       (document_id,))
        if fresh is not None and fresh["deleted_at"] is not None:
            rag.delete_document(store["engine_key"], engine_doc_id)
            _set_status(db, document_id, dbschema.DOC_ERROR,
                        error="deleted during ingestion",
                        engine_doc_id=None)
            log_json(logging.INFO, "ingestion_aborted_deleted",
                     document_id=document_id)
            return dbschema.DOC_ERROR
        _set_status(db, document_id, dbschema.DOC_DONE,
                    chunks=stats["chunks"], engine_doc_id=engine_doc_id)
        # Index-cost ledger row, model="INDEX" (reference:
        # ingestion.py:73-103).
        tokens = doc["est_tokens"] or 0
        record_query_cost(
            db, user_id=doc["user_id"], store_id=doc["store_id"],
            model="INDEX", prompt_tokens=tokens, completion_tokens=0,
            cost_usd=calc_index_cost(settings, tokens))
        log_json(logging.INFO, "ingestion_done", document_id=document_id,
                 chunks=stats["chunks"])
        # Payload removed only on success so retries can re-read it
        # (archived copies persist independently when ARCHIVE_UPLOADS).
        if not settings.ARCHIVE_UPLOADS:
            try:
                path.unlink()
            except FileNotFoundError:
                pass
        return dbschema.DOC_DONE
    except FileNotFoundError:
        _set_status(db, document_id, dbschema.DOC_ERROR,
                    error="upload payload missing")
        return dbschema.DOC_ERROR
    except Exception as e:  # noqa: BLE001 — worker job boundary
        # Roll back the engine-side document so a retry starts clean
        # (reference: ingestion.py:320-335).
        try:
            rag.delete_document(store["engine_key"], engine_doc_id)
        except Exception:  # noqa: BLE001 — best-effort rollback
            pass
        _set_status(db, document_id, dbschema.DOC_ERROR,
                    error=_sanitize_error(e))
        log_json(logging.ERROR, "ingestion_failed", document_id=document_id,
                 error=f"{type(e).__name__}: {str(e)[:500]}")
        raise


def reset_stuck_documents(db, settings, *,
                          to_status: str = dbschema.DOC_ERROR,
                          only_ids: list[int] | None = None) -> int:
    """Watchdog: flip stale RUNNING docs (reference: worker.py:83-114 flips
    to ERROR; the admin endpoint flips to PENDING for re-ingestion,
    admin.py:176-228)."""
    cutoff = time.time() - settings.WATCHDOG_STALE_S
    id_guard, id_args = "", ()
    if only_ids is not None:
        # the admin path resets exactly the rows it is about to
        # re-enqueue (a doc crossing staleness between its snapshot and
        # this update would otherwise be reset but never enqueued)
        if not only_ids:
            return 0
        id_guard = f" AND id IN ({','.join('?' * len(only_ids))})"
        id_args = tuple(only_ids)
    with db.tx() as conn:
        cur = conn.execute(  # sql-ok: literal fragments, values bound
            "UPDATE documents SET status=?, status_updated_at=?,"
            " last_error=CASE WHEN ? = 'ERROR' THEN 'watchdog: stale RUNNING'"
            " ELSE last_error END"
            " WHERE status=? AND status_updated_at<?" + id_guard,
            (to_status, time.time(), to_status, dbschema.DOC_RUNNING,
             cutoff) + id_args)
        n = cur.rowcount
    if n:
        log_json(logging.WARNING, "watchdog_reset_stuck", count=n,
                 to_status=to_status)
    return n
