"""Operator tool: flip stale RUNNING documents to ERROR (reference:
backend/scripts/mark_stuck_documents_error.py).

    python -m rag_foundation_tpu_torch.tools.mark_stuck_documents_error \
        [--stale-s 600]

Counterpart of ``scripts/mark_stuck_documents_error.py`` on the port's
config, without pydantic: the same flag, output and ``RAGTPU_*``
variables.
"""

from __future__ import annotations

import argparse

from rag_foundation_tpu_torch.app.config import load_settings
from rag_foundation_tpu_torch.app.dbschema import MIGRATIONS
from rag_foundation_tpu_torch.app.services.ingestion import (
    reset_stuck_documents)
from rag_foundation_tpu_torch.runtime.db import Database


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stale-s", type=float, default=None)
    args = ap.parse_args()
    overrides = {} if args.stale_s is None else {
        "WATCHDOG_STALE_S": args.stale_s}
    settings = load_settings(**overrides)
    db = Database(settings.DATABASE_PATH, migrations=MIGRATIONS)
    n = reset_stuck_documents(db, settings)
    print(f"reset {n} stuck document(s) to ERROR")


if __name__ == "__main__":
    main()
