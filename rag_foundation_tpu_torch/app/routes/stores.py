"""Store CRUD: list/create/soft-delete + admin restore.

Reference parity: backend/app/routes/stores.py — per-user
store cap, engine-key format check, duplicate 409, cascade soft-delete of
documents, background engine cleanup, 404-not-403 tenancy.
"""

from __future__ import annotations

import asyncio
import sqlite3

import html
import re
import time

from rag_foundation_tpu_torch.app import validation as v
from rag_foundation_tpu_torch.app.routes._params import (
    int_param, json_object)
from rag_foundation_tpu_torch.app.auth import get_current_user, require_admin
from rag_foundation_tpu_torch.app.services.audit import record_admin_action
from rag_foundation_tpu_torch.app.services.cleanup import cleanup_store
from rag_foundation_tpu_torch.app.tenant import require_store_owned_by_user
from rag_foundation_tpu_torch.runtime.http import HTTPError, Response

_ENGINE_KEY_RE = re.compile(r"^stores/[A-Za-z0-9._-]+$")


def _store_name(value, loc: tuple) -> str:
    # XSS-sanitizing validator (reference: schemas.py:9-32)
    s = html.escape(v.to_str(value, loc).strip())
    if not 1 <= len(s) <= 100:
        raise v.FieldError(loc, "Value error, name must be 1-100 characters")
    return s


def parse_store_create(payload: dict) -> str:
    """The sanitized store name of a create body (the JAX route's
    ``StoreCreate``); 422 with the first error's message."""
    values, errors = v.parse_fields(payload,
                                    {"name": (_store_name, v.MISSING)})
    if errors:
        raise HTTPError(422, errors[0].msg)
    return values["name"]


def _store_dto(row) -> dict:
    return {"id": row["id"], "name": row["name"],
            "engine_key": row["engine_key"],
            "created_at": row["created_at"]}


def register(app, ctx):
    settings, db = ctx.settings, ctx.db

    @app.get("/api/stores")
    async def list_stores(req):
        user = get_current_user(req, db, ctx.kv, settings)
        rows = db.query(
            "SELECT * FROM stores WHERE user_id=? AND deleted_at IS NULL"
            " ORDER BY id", (user.id,))
        return Response({"stores": [_store_dto(r) for r in rows]})

    @app.post("/api/stores")
    async def create_store(req):
        user = get_current_user(req, db, ctx.kv, settings)
        name = parse_store_create(json_object(req))
        count = db.one(
            "SELECT COUNT(*) AS n FROM stores WHERE user_id=? AND"
            " deleted_at IS NULL", (user.id,))["n"]
        if count >= settings.MAX_STORES_PER_USER:
            raise HTTPError(409, "Store limit reached")
        # off the event loop: a first engine op can pay a remote TPU
        # compile (minutes) — inline it would freeze every request
        engine_key = await asyncio.to_thread(ctx.rag.create_store,
                                             name, user.id)
        if not _ENGINE_KEY_RE.match(engine_key):
            # format check analog (reference: stores.py:46-50)
            await asyncio.to_thread(cleanup_store, ctx.rag, engine_key)
            raise HTTPError(502, "Engine returned malformed store key")
        try:
            sid = db.execute(
                "INSERT INTO stores(user_id, name, engine_key, created_at)"
                " VALUES(?,?,?,?)",
                (user.id, name, engine_key, time.time()))
        except sqlite3.IntegrityError:
            await asyncio.to_thread(cleanup_store, ctx.rag, engine_key)
            raise HTTPError(409, "Store already exists") from None
        except Exception:
            # a real db failure is a 500, not a misleading 409
            await asyncio.to_thread(cleanup_store, ctx.rag, engine_key)
            raise
        row = db.one("SELECT * FROM stores WHERE id=?", (sid,))
        return Response(_store_dto(row), status=201)

    @app.delete("/api/stores/{store_id}")
    async def delete_store(req):
        user = get_current_user(req, db, ctx.kv, settings)
        store = require_store_owned_by_user(
            db, int_param(req, "store_id"), user.id)
        now = time.time()
        with db.tx() as conn:
            conn.execute("UPDATE stores SET deleted_at=? WHERE id=?",
                         (now, store["id"]))
            # cascade soft-delete documents (reference: stores.py:75-80)
            conn.execute(
                "UPDATE documents SET deleted_at=? WHERE store_id=? AND"
                " deleted_at IS NULL", (now, store["id"]))
        # engine-side cleanup is DEFERRED to the stale-store janitor
        # (24 h grace): immediate cleanup made the admin restore
        # endpoint a lie — the row came back but the vectors were gone
        return Response({"status": "deleted", "id": store["id"]})

    @app.post("/api/admin/stores/{store_id}/restore")
    async def restore_store(req):
        user = require_admin(get_current_user(req, db, ctx.kv, settings))
        sid = int_param(req, "store_id")
        row = db.one("SELECT * FROM stores WHERE id=?", (sid,))
        if row is None:
            raise HTTPError(404, "Store not found")
        if row["engine_key"] == "":
            # the janitor already reaped the engine data (24 h grace
            # elapsed) — a row-only restore would be an empty shell
            raise HTTPError(409, "Store already reaped; engine data is "
                                 "gone and cannot be restored")
        with db.tx() as conn:
            conn.execute("UPDATE stores SET deleted_at=NULL WHERE id=?",
                         (sid,))
            if row["deleted_at"] is not None:
                # un-cascade the documents soft-deleted with the store
                conn.execute(
                    "UPDATE documents SET deleted_at=NULL WHERE"
                    " store_id=? AND deleted_at=?",
                    (sid, row["deleted_at"]))
        record_admin_action(db, admin_user_id=user.id,
                            action="store_restore", target=str(sid))
        return Response({"status": "restored", "id": sid})
