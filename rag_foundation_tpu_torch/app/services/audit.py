"""Admin audit trail (reference: backend/app/services/audit.py:14-41)."""

from __future__ import annotations

import logging
import time

from rag_foundation_tpu_torch.app.telemetry import log_json


def record_admin_action(db, *, admin_user_id: int, action: str,
                        target: str = "", detail: str = "") -> None:
    db.execute(
        "INSERT INTO admin_audit_log(admin_user_id, action, target, detail,"
        " created_at) VALUES(?,?,?,?,?)",
        (admin_user_id, action, target, detail[:1000], time.time()))
    log_json(logging.INFO, "admin_action", action=action, target=target,
             admin_user_id=admin_user_id)
