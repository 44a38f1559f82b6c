"""Bootstrap the first admin user (reference:
backend/scripts/create_first_admin.py).

    python -m rag_foundation_tpu_torch.tools.create_first_admin \
        --email a@b.co --password ...

Counterpart of ``scripts/create_first_admin.py`` on the port's config,
without pydantic: the same flags, the same exit codes and output, the
same ``RAGTPU_*`` variables for the database location.
"""

from __future__ import annotations

import argparse
import time

from rag_foundation_tpu_torch.app.auth import (check_password_policy,
                                               hash_password)
from rag_foundation_tpu_torch.app.config import load_settings
from rag_foundation_tpu_torch.app.dbschema import MIGRATIONS
from rag_foundation_tpu_torch.runtime.db import Database


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--email", required=True)
    ap.add_argument("--password", required=True)
    args = ap.parse_args()
    settings = load_settings()
    try:
        check_password_policy(args.password, settings.PASSWORD_MIN_LENGTH)
    except Exception as e:  # HTTPError is a web-layer type; speak CLI
        raise SystemExit(f"password rejected: {getattr(e, 'detail', e)}")
    db = Database(settings.DATABASE_PATH, migrations=MIGRATIONS)
    email = args.email.strip().lower()
    row = db.one("SELECT id FROM users WHERE email=?", (email,))
    if row is not None:
        # the operator supplied a password — honor it (silently keeping
        # a lost/unknown old hash locked admins out)
        db.execute(
            "UPDATE users SET role='admin', password_hash=?,"
            " is_active=1 WHERE id=?",
            (hash_password(args.password), row["id"]))
        print(f"promoted existing user {email} (id={row['id']}) to "
              f"admin and reset the password")
        return
    uid = db.execute(
        "INSERT INTO users(email, password_hash, role, created_at)"
        " VALUES(?,?,?,?)",
        (email, hash_password(args.password), "admin", time.time()))
    print(f"created admin {email} (id={uid})")


if __name__ == "__main__":
    main()
