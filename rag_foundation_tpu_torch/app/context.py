"""Application context: every shared dependency in one injectable object.

The reference wired dependencies through FastAPI ``Depends`` and module
globals patched in tests (backend/tests/conftest.py:164-198).
Here the wiring is explicit: routes close over an ``AppContext`` so tests
can build one with fakes (same spirit, no globals to patch).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any

from rag_foundation_tpu_torch.app.config import Settings
from rag_foundation_tpu_torch.app.rate_limit import RateLimiter
from rag_foundation_tpu_torch.runtime.db import Database
from rag_foundation_tpu_torch.runtime.jobqueue import JobQueue, Worker


@dataclass
class AppContext:
    settings: Settings
    db: Database
    kv: Any
    rag: Any
    limiter: RateLimiter
    queue: JobQueue | None = None
    worker: Worker | None = None
    stream_semaphore: asyncio.Semaphore | None = None
    extra: dict[str, Any] = field(default_factory=dict)

    def has_ingestion_queue(self) -> bool:
        return self.queue is not None
