"""Standalone ingestion worker process.

    python -m rag_foundation_tpu_torch.app.worker_main

Counterpart of ``rag_foundation_tpu/app/worker_main.py`` over the port's
engine. Reference parity: the separate ARQ worker process
(backend/app/worker.py, ``arq app.worker.WorkerSettings``).
Coordinates with any number of API processes through the sqlite-backed
job queue (leases make crashed-worker jobs reclaimable); runs the
watchdog and stale-store janitor crons, and the recall audit when
``RAGTPU_ENGINE_RECALL_AUDIT_S`` > 0.

The engine is decided as the port app's ``main()`` decides it: in
process on the card, on the CPU with ``RAGTPU_ENGINE_PLATFORM=cpu``, or
the port ``engine_main``'s over its socket with
``RAGTPU_ENGINE_RPC_MODE=connect`` (the split topology: this process
then holds no device). Without a card, and in neither of the other
modes, it exits non-zero; there is no CPU fallback.
"""

from __future__ import annotations

import logging
import signal

from rag_foundation_tpu_torch.app.config import load_settings
from rag_foundation_tpu_torch.app.dbschema import MIGRATIONS
from rag_foundation_tpu_torch.app.services.cleanup import cleanup_stale_stores
from rag_foundation_tpu_torch.app.services.ingestion import (
    reset_stuck_documents, run_ingestion_sync)
from rag_foundation_tpu_torch.app.services.rag import make_rag_client
from rag_foundation_tpu_torch.app.telemetry import (configure_logging,
                                                    log_json)
from rag_foundation_tpu_torch.runtime.db import Database
from rag_foundation_tpu_torch.runtime.jobqueue import JobQueue, Worker


def main() -> None:
    configure_logging()
    settings = load_settings()
    db = Database(settings.DATABASE_PATH, migrations=MIGRATIONS)
    try:
        rag = make_rag_client(settings)
    except RuntimeError as e:
        raise SystemExit(
            f"engine unavailable at startup: {e}\nRefusing to work "
            "without the engine's device — set "
            "RAGTPU_ENGINE_PLATFORM=cpu, RAGTPU_ENGINE_RPC_MODE=connect "
            "or RAGTPU_MOCK_MODE=1") from e
    engine = getattr(rag, "engine", None)
    device = getattr(engine, "device", None)
    if getattr(device, "type", None) == "cuda":
        # the claim threads find CUDA initialised (as in app.main)
        import torch
        torch.cuda.set_device(device)
    queue = JobQueue(db, lease_s=settings.WORKER_JOB_TIMEOUT_S,
                     retry_backoff_s=settings.WORKER_RETRY_BACKOFF_S)
    worker = Worker(queue, concurrency=settings.WORKER_CONCURRENCY)
    worker.register(
        "ingest_document",
        lambda payload: run_ingestion_sync(db, rag, settings,
                                           payload["document_id"]))
    worker.cron(settings.WATCHDOG_CRON_S,
                lambda: reset_stuck_documents(db, settings))
    worker.cron(settings.WATCHDOG_CRON_S * 4,
                lambda: cleanup_stale_stores(db, rag))
    if settings.ENGINE_RECALL_AUDIT_S > 0:
        # the split topology (staging/prod default) runs crons HERE —
        # without this the audit knob silently did nothing off the
        # in-process-worker path
        def recall_audit():
            if engine is None:
                return
            for key in engine.list_stores():
                try:
                    out = engine.recall_probe(key, k=10)
                    log_json(logging.INFO, "recall_audit", store=key,
                             **out)
                except Exception as e:  # noqa: BLE001 — cron isolation
                    log_json(logging.WARNING, "recall_audit_failed",
                             store=key, error=str(e)[:200])
        worker.cron(settings.ENGINE_RECALL_AUDIT_S, recall_audit)
    log_json(logging.INFO, "worker_started",
             database=settings.DATABASE_PATH,
             device=str(device) if device is not None
             else ("none" if engine is None else "remote"))

    signal.signal(signal.SIGTERM, lambda *_: worker.stop())
    signal.signal(signal.SIGINT, lambda *_: worker.stop())
    worker.run_forever()
    log_json(logging.INFO, "worker_stopped")


if __name__ == "__main__":
    main()
