"""Host runtime: HTTP/SSE server, sqlite persistence, durable job queue, KV.

A copy of ``rag_foundation_tpu.runtime`` (stdlib only, imports rewritten)
so that the port's app runs where the JAX package is not installed.

The reference outsourced this layer to FastAPI/Starlette + SQLAlchemy +
Redis/ARQ (SURVEY.md §1 L2-L6). None of those are available here, and a
framework should own its runtime anyway — so these are first-party:

- ``http``   asyncio HTTP/1.1 server with routing, middleware, SSE
             streaming, multipart parsing, and an in-process TestClient.
- ``db``     sqlite3 engine with WAL, migrations, thread-local conns.
- ``kv``     TTL key-value store (rate limits, JWT revocation) — the
             Redis analog, memory-backed with a sqlite shared mode.
- ``jobqueue`` durable job queue over sqlite + worker loop — the ARQ
             analog (reference: backend/app/worker.py).
"""
