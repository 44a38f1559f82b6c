"""DB-backed branding settings: public read, admin-only write.

Counterpart of ``rag_foundation_tpu/app/routes/settings_routes.py``.

Reference parity: backend/app/routes/settings.py:29-87 —
validated key/value pairs (app name/icon/theme/colors/prompts), audited
writes.
"""

from __future__ import annotations

import re
import time

from rag_foundation_tpu_torch.app.auth import get_current_user, require_admin
from rag_foundation_tpu_torch.app.file_types import allowed_types
from rag_foundation_tpu_torch.app.services.audit import record_admin_action
from rag_foundation_tpu_torch.runtime.http import HTTPError, Response

ALLOWED_KEYS = {
    "app_name", "app_icon", "theme", "primary_color", "accent_color",
    "favicon_url", "welcome_message", "welcome_prompts", "footer_text",
}
_COLOR_RE = re.compile(r"^#[0-9a-fA-F]{3,8}$")


def _validate(key: str, value: str) -> None:
    if key not in ALLOWED_KEYS:
        raise HTTPError(422, f"Unknown setting {key!r}")
    if len(value) > 2000:
        raise HTTPError(422, "Value too long")
    if key.endswith("_color") and value and not _COLOR_RE.match(value):
        raise HTTPError(422, f"{key} must be a hex color")
    if key == "theme" and value not in (
            "", "light", "dark", "system", "ocean", "forest", "contrast"):
        raise HTTPError(
            422, "theme must be light|dark|system|ocean|forest|contrast")


def register(app, ctx):
    settings, db = ctx.settings, ctx.db

    @app.get("/api/settings")
    async def get_settings(req):
        rows = db.query("SELECT key, value FROM app_settings")
        return Response({
            "settings": {r["key"]: r["value"] for r in rows},
            # model metadata for the chat toolbar (reference model
            # picker, frontend ChatContext.tsx)
            "models": list(settings.ALLOWED_MODELS),
            "default_model": settings.DEFAULT_MODEL,
            # upload limits for the composer-attachment UI (reference
            # utils/uploadLimits.ts reads these from build-time env;
            # server-driven here so the SPA always matches the API)
            "upload": {
                "max_mb": settings.MAX_UPLOAD_MB,
                "profile": settings.UPLOAD_PROFILE,
                "mime_count": len(allowed_types(settings.UPLOAD_PROFILE)),
            },
        })

    @app.put("/api/settings")
    async def put_settings(req):
        user = require_admin(get_current_user(req, db, ctx.kv, settings))
        body = req.json()
        if not isinstance(body, dict):
            raise HTTPError(422, "Expected an object of settings")
        for key, value in body.items():
            _validate(key, str(value))
        now = time.time()
        with db.tx() as conn:
            for key, value in body.items():
                conn.execute(
                    "INSERT INTO app_settings(key, value, updated_at)"
                    " VALUES(?,?,?) ON CONFLICT(key) DO UPDATE SET"
                    " value=excluded.value, updated_at=excluded.updated_at",
                    (key, str(value), now))
        record_admin_action(db, admin_user_id=user.id,
                            action="settings_update",
                            detail=",".join(sorted(body)))
        return Response({"status": "updated", "keys": sorted(body)})
