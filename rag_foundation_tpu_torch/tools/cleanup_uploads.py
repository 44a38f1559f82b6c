"""Operator tool: delete stale upload payloads (reference:
backend/scripts/cleanup_tmp.py).

Payloads live at ``DATA_DIR/uploads/doc-{id}`` and are normally removed
when ingestion succeeds (unless ARCHIVE_UPLOADS keeps them). Documents
that end in ERROR, get soft-deleted before ingestion, or lose their DB
row entirely leave payloads behind; this janitor removes any payload
older than ``--max-age-hours`` whose document is NOT pending/running.

    python -m rag_foundation_tpu_torch.tools.cleanup_uploads \
        [--max-age-hours 24] [--dry-run]

Counterpart of ``scripts/cleanup_uploads.py`` on the port's config,
without pydantic: the same flags, output and ``RAGTPU_*`` variables.
"""

from __future__ import annotations

import argparse
import time

from rag_foundation_tpu_torch.app import dbschema
from rag_foundation_tpu_torch.app.config import load_settings
from rag_foundation_tpu_torch.app.dbschema import MIGRATIONS
from rag_foundation_tpu_torch.app.services.ingestion import upload_path
from rag_foundation_tpu_torch.runtime.db import Database

ACTIVE = (dbschema.DOC_PENDING, dbschema.DOC_RUNNING)


def cleanup_uploads(settings, db, *, max_age_hours: float = 24.0,
                    dry_run: bool = False) -> int:
    """Remove stale payloads; returns how many files were removed."""
    # derive the dir from the SAME helper ingestion uses (a layout change
    # must not silently strand this janitor on an old path)
    uploads = upload_path(settings, 0).parent
    if max_age_hours <= 0 or not uploads.exists():
        return 0
    cutoff = time.time() - max_age_hours * 3600
    removed = 0
    for entry in uploads.iterdir():
        if not entry.is_file() or not entry.name.startswith("doc-"):
            continue
        try:
            if entry.stat().st_mtime >= cutoff:
                continue
        except FileNotFoundError:
            continue
        try:
            doc_id = int(entry.name[len("doc-"):])
        except ValueError:
            continue
        rows = db.query(
            "SELECT status FROM documents WHERE id=?", (doc_id,))
        row = rows[0] if rows else None
        if row is not None and row["status"] in ACTIVE:
            continue  # ingestion may still need to (re-)read it
        if not dry_run:
            entry.unlink(missing_ok=True)
        removed += 1
        print(f"{'would remove' if dry_run else 'removed'} {entry}"
              f" (status={row['status'] if row else 'no document row'})")
    return removed


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-age-hours", type=float, default=24.0)
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args()
    settings = load_settings()
    db = Database(settings.DATABASE_PATH)
    db.migrate(MIGRATIONS)
    n = cleanup_uploads(settings, db, max_age_hours=args.max_age_hours,
                        dry_run=args.dry_run)
    print(f"{'would remove' if args.dry_run else 'removed'} {n} payloads")


if __name__ == "__main__":
    main()
