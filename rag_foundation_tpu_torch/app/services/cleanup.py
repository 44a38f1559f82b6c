"""Background engine-side cleanup for soft-deleted stores/documents.

Reference parity: backend/app/services/cleanup.py —
best-effort remote deletes plus a janitor that reaps stores soft-deleted
longer than a grace period (batch-capped, skipping stores with active
ingestions).
"""

from __future__ import annotations

import logging
import time

from rag_foundation_tpu_torch.app import dbschema
from rag_foundation_tpu_torch.app.telemetry import log_json


def cleanup_store(rag, engine_key: str) -> None:
    try:
        rag.delete_store(engine_key)
    except Exception:  # noqa: BLE001 — best-effort remote cleanup
        log_json(logging.WARNING, "cleanup_store_failed",
                 engine_key=engine_key)


def cleanup_document(rag, engine_key: str, engine_doc_id: str) -> None:
    try:
        rag.delete_document(engine_key, engine_doc_id)
    except Exception:  # noqa: BLE001
        log_json(logging.WARNING, "cleanup_document_failed",
                 engine_key=engine_key, doc=engine_doc_id)


def cleanup_stale_stores(db, rag, *, grace_s: float = 24 * 3600,
                         batch: int = 20) -> int:
    """Reap stores soft-deleted > grace_s ago, skipping active ingestion
    (reference: cleanup.py:92-133)."""
    cutoff = time.time() - grace_s
    rows = db.query(
        "SELECT s.id, s.engine_key FROM stores s WHERE s.deleted_at IS NOT "
        "NULL AND s.deleted_at<? AND s.engine_key!='' AND NOT EXISTS"
        " (SELECT 1 FROM documents d"
        " WHERE d.store_id=s.id AND d.status=?)"
        " ORDER BY s.deleted_at LIMIT ?",
        (cutoff, dbschema.DOC_RUNNING, batch))
    for r in rows:
        cleanup_store(rag, r["engine_key"])
        # mark reaped (engine_key='') or the un-ordered batch re-reaps
        # the same rows every tick and stores past the batch size are
        # never reached
        db.execute("UPDATE stores SET engine_key='' WHERE id=?",
                   (r["id"],))
    if rows:
        log_json(logging.INFO, "cleanup_stale_stores", count=len(rows))
    return len(rows)
