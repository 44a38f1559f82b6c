"""Admin console: users, budgets, audit, system counts, watchdog.

Counterpart of ``rag_foundation_tpu/app/routes/admin.py`` on the port's
engine: the recall probe runs ``Engine.recall_probe`` (or its RPC over
the engine socket in connect mode) off the event loop.

Reference parity: backend/app/routes/admin.py:30-253 —
user list/role toggle with self-demotion ban, budget upsert, audit list,
system counts, reset-stuck RUNNING->PENDING, deletion audit; every action
rate-limited and written to the audit log.
"""

from __future__ import annotations

import asyncio

import time
from decimal import Decimal, InvalidOperation

from rag_foundation_tpu_torch.app import dbschema
from rag_foundation_tpu_torch.app.routes._params import (
    int_param, json_object)
from rag_foundation_tpu_torch.app.auth import get_current_user, require_admin
from rag_foundation_tpu_torch.app.services.audit import record_admin_action
from rag_foundation_tpu_torch.app.services.ingestion import (
    reset_stuck_documents)
from rag_foundation_tpu_torch.runtime.http import HTTPError, Response


def register(app, ctx):
    settings, db = ctx.settings, ctx.db

    def _admin(req):
        user = require_admin(get_current_user(req, db, ctx.kv, settings))
        ctx.limiter.check(f"user:{user.id}:admin", 60)
        return user

    @app.get("/api/admin/users")
    async def list_users(req):
        _admin(req)
        # budget joined in so the manage-user modal can prefill it
        # (reference admin.py:51-52 returns admin_notes +
        # monthly_limit_usd with each user row)
        rows = db.query(
            "SELECT u.id, u.email, u.role, u.is_active, u.created_at,"
            " u.admin_notes, b.monthly_usd"
            " FROM users u LEFT JOIN budgets b ON b.user_id = u.id"
            " ORDER BY u.id LIMIT 500")
        return Response({"users": [dict(r) for r in rows]})

    @app.patch("/api/admin/users/{user_id}")
    async def update_user(req):
        admin = _admin(req)
        uid = int_param(req, "user_id")
        body = req.json()
        target = db.one("SELECT * FROM users WHERE id=?", (uid,))
        if target is None:
            raise HTTPError(404, "User not found")
        sets, params, changes = [], [], []
        if "role" in body:
            role = body["role"]
            if role not in ("user", "admin"):
                raise HTTPError(422, "role must be user|admin")
            if uid == admin.id and role != "admin":
                # self-demotion ban (reference: admin.py:71-75)
                raise HTTPError(409, "Admins cannot demote themselves")
            sets.append("role=?")
            params.append(role)
            changes.append(f"role={role}")
        if "is_active" in body:
            active = 1 if body["is_active"] else 0
            if uid == admin.id and not active:
                raise HTTPError(409, "Admins cannot deactivate themselves")
            sets.append("is_active=?")
            params.append(active)
            changes.append(f"is_active={active}")
        if "admin_notes" in body:
            # free-form operator notes (reference admin.py:78); null or
            # empty clears; capped so the audit detail stays bounded
            notes = body["admin_notes"]
            if notes is not None and not isinstance(notes, str):
                raise HTTPError(422, "admin_notes must be a string")
            if notes is not None and len(notes) > 2000:
                raise HTTPError(422, "admin_notes too long (max 2000)")
            sets.append("admin_notes=?")
            params.append(notes or None)
            changes.append("admin_notes")
        if not sets:
            raise HTTPError(422, "Nothing to update")
        params.append(uid)
        db.execute(f"UPDATE users SET {', '.join(sets)} WHERE id=?",  # sql-ok: sets are literal fragments, values bound
                   tuple(params))
        record_admin_action(db, admin_user_id=admin.id, action="user_update",
                            target=str(uid), detail=";".join(changes))
        return Response({"status": "updated", "id": uid})

    @app.put("/api/admin/budgets/{user_id}")
    async def upsert_budget(req):
        admin = _admin(req)
        uid = int_param(req, "user_id")
        if db.one("SELECT id FROM users WHERE id=?", (uid,)) is None:
            raise HTTPError(404, "User not found")
        try:
            amount = Decimal(str(req.json().get("monthly_usd")))
            if amount < 0:
                raise InvalidOperation
        except (InvalidOperation, TypeError, ValueError):
            raise HTTPError(422, "monthly_usd must be a non-negative"
                            " number") from None
        db.execute(
            "INSERT INTO budgets(user_id, monthly_usd, updated_at)"
            " VALUES(?,?,?) ON CONFLICT(user_id) DO UPDATE SET"
            " monthly_usd=excluded.monthly_usd,"
            " updated_at=excluded.updated_at",
            (uid, str(amount), time.time()))
        record_admin_action(db, admin_user_id=admin.id, action="budget_set",
                            target=str(uid), detail=str(amount))
        return Response({"status": "updated", "user_id": uid,
                         "monthly_usd": str(amount)})

    @app.get("/api/admin/audit")
    async def list_audit(req):
        _admin(req)
        rows = db.query(
            "SELECT * FROM admin_audit_log ORDER BY id DESC LIMIT 200")
        return Response({"audit": [dict(r) for r in rows]})

    @app.get("/api/admin/system")
    async def system_counts(req):
        _admin(req)
        counts = {}
        for table in ("users", "stores", "documents", "query_log",
                      "chat_sessions"):
            counts[table] = db.one(  # sql-ok: table from a literal tuple
                f"SELECT COUNT(*) AS n FROM {table}")["n"]
        counts["documents_by_status"] = {
            r["status"]: r["n"] for r in db.query(
                "SELECT status, COUNT(*) AS n FROM documents WHERE"
                " deleted_at IS NULL GROUP BY status")}
        if ctx.queue is not None:
            counts["jobs"] = ctx.queue.stats()
        return Response(counts)

    @app.post("/api/admin/watchdog/reset-stuck")
    async def watchdog_reset(req):
        admin = _admin(req)
        if ctx.queue is None:
            # flipping to PENDING without a queue would STRAND the
            # documents (nothing ever re-processes PENDING rows)
            raise HTTPError(503, "Ingestion queue unavailable")
        # admin path re-queues: RUNNING->PENDING (reference:
        # admin.py:176-228); snapshot then reset the SAME rows so a doc
        # crossing staleness between the two steps isn't reset-but-
        # never-enqueued
        cutoff = time.time() - settings.WATCHDOG_STALE_S
        stuck = db.query(
            "SELECT id FROM documents WHERE status=? AND status_updated_at<?",
            (dbschema.DOC_RUNNING, cutoff))
        ids = [r["id"] for r in stuck]
        n = reset_stuck_documents(db, settings,
                                  to_status=dbschema.DOC_PENDING,
                                  only_ids=ids)
        for did in ids:
            ctx.queue.enqueue("ingest_document", {"document_id": did})
        record_admin_action(db, admin_user_id=admin.id,
                            action="watchdog_reset", detail=f"count={n}")
        return Response({"reset": n})

    @app.post("/api/admin/engine/recall-probe")
    async def recall_probe(req):
        """Sampled recall-vs-exact audit for one store (SURVEY.md §5
        recall gauge); records engine_recall_at_k + HBM occupancy."""
        admin = _admin(req)
        body = json_object(req)
        store_id = body.get("store_id")
        if not isinstance(store_id, int):
            raise HTTPError(422, "store_id (int) required")
        store = db.one("SELECT * FROM stores WHERE id=? AND"
                       " deleted_at IS NULL", (store_id,))
        if store is None:
            raise HTTPError(404, "Store not found")
        engine = getattr(ctx.rag, "engine", None)
        if engine is None:
            raise HTTPError(501, "recall probe unavailable in mock mode")
        k = int(body.get("k", 10))
        if not 1 <= k <= 100:
            raise HTTPError(422, "k must be between 1 and 100")
        # off the event loop: the probe runs sampled searches + an
        # exact on-device scan (and possibly a fresh remote compile) —
        # inline it froze every stream and health check for the duration
        result = await asyncio.to_thread(
            engine.recall_probe, store["engine_key"], k=k,
            sample=min(int(body.get("sample", 32)), 256))
        record_admin_action(
            db, admin_user_id=admin.id, action="recall_probe",
            detail=f"store={store_id} recall={result['recall']}")
        return Response(result)

    @app.get("/api/admin/deletions")
    async def deletion_audit(req):
        _admin(req)
        stores = db.query(
            "SELECT id, name, user_id, deleted_at FROM stores WHERE"
            " deleted_at IS NOT NULL ORDER BY deleted_at DESC LIMIT 100")
        docs = db.query(
            "SELECT id, filename, user_id, deleted_at FROM documents WHERE"
            " deleted_at IS NOT NULL ORDER BY deleted_at DESC LIMIT 100")
        return Response({"stores": [dict(r) for r in stores],
                         "documents": [dict(r) for r in docs]})
