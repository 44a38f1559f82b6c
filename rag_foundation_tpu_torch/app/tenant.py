"""Tenant isolation guards — ownership checks that 404 (never 403).

Reference parity: backend/app/security/tenant.py:12-65 —
filters by ``user_id`` and ``deleted_at IS NULL`` and raises 404 for
missing AND foreign resources alike, so tenancy is never leaked through
status codes.
"""

from __future__ import annotations

import sqlite3

from rag_foundation_tpu_torch.runtime.http import HTTPError


def require_store_owned_by_user(db, store_id: int, user_id: int) -> sqlite3.Row:
    row = db.one(
        "SELECT * FROM stores WHERE id=? AND user_id=? AND deleted_at IS NULL",
        (store_id, user_id))
    if row is None:
        raise HTTPError(404, "Store not found")
    return row


def require_stores_owned_by_user(db, store_ids: list[int],
                                 user_id: int) -> list[sqlite3.Row]:
    if not store_ids:
        raise HTTPError(422, "At least one store id required")
    rows = [require_store_owned_by_user(db, sid, user_id)
            for sid in store_ids]
    return rows


def require_document_owned_by_user(db, document_id: int,
                                   user_id: int) -> sqlite3.Row:
    row = db.one(
        "SELECT * FROM documents WHERE id=? AND user_id=?"
        " AND deleted_at IS NULL", (document_id, user_id))
    if row is None:
        raise HTTPError(404, "Document not found")
    return row
