"""App factory: middleware chain, routes, health/metrics, worker wiring.

Counterpart of ``rag_foundation_tpu/app/main.py`` over the port's engine::

    python -m rag_foundation_tpu_torch.app.main --port 8000

serves the same HTTP/SSE API as the JAX app: every route of
``docs/api_spec.json`` and the static SPA at ``/``. The engine is the
port's ``Engine`` in process, on the card (``RAGTPU_ENGINE_PLATFORM=cpu``
puts it on the CPU; without a card and without that variable it exits
with an error, there is no CPU fallback), or a port ``engine_main`` over
its socket with ``RAGTPU_ENGINE_RPC_MODE=connect``. The in-process
worker drains uploads, or, with ``RAGTPU_WORKER_IN_PROCESS=0``,
``app.worker_main`` processes do (the split topology).

Reference parity: backend/app/main.py:42-425 — CSRF header
check, CORS, HTTP metrics, security headers, JSON body cap, correlation-id
logging, global rate limit, exception handler, loopback-gated /metrics,
and /live /ready /health probes; lifespan runs the security gate.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from rag_foundation_tpu_torch.app import metrics
from rag_foundation_tpu_torch.app.config import Settings, load_settings
from rag_foundation_tpu_torch.app.context import AppContext
from rag_foundation_tpu_torch.app.dbschema import MIGRATIONS
from rag_foundation_tpu_torch.app.rate_limit import (RateLimiter,
                                                     global_rate_key)
from rag_foundation_tpu_torch.app.routes import (admin, auth_routes, chat,
                                                 costs_routes, documents,
                                                 settings_routes, stores,
                                                 uploads)
from rag_foundation_tpu_torch.app.security_gate import run_security_gate
from rag_foundation_tpu_torch.app.services.cleanup import cleanup_stale_stores
from rag_foundation_tpu_torch.app.services.ingestion import (
    reset_stuck_documents, run_ingestion_sync)
from rag_foundation_tpu_torch.app.services.rag import make_rag_client
from rag_foundation_tpu_torch.app.telemetry import (bind_request,
                                                    clear_request,
                                                    configure_logging,
                                                    log_json)
from rag_foundation_tpu_torch.runtime.db import Database
from rag_foundation_tpu_torch.runtime.http import (App, HTTPError, Request,
                                                   Response)
from rag_foundation_tpu_torch.runtime.jobqueue import JobQueue, Worker
from rag_foundation_tpu_torch.runtime.kv import MemoryKV, SqliteKV

_CORR_ID_OK = __import__("re").compile(r"^[A-Za-z0-9-]{8,64}$")
_MUTATING = {"POST", "PUT", "PATCH", "DELETE"}


def build_context(settings: Settings | None = None, *, db=None, kv=None,
                  rag=None, with_worker: bool = True) -> AppContext:
    settings = settings or load_settings()
    db = db or Database(settings.DATABASE_PATH, migrations=MIGRATIONS)
    if db.ping():
        db.migrate(MIGRATIONS)
    if kv is None:
        kv = (SqliteKV(settings.kv_path) if settings.KV_BACKEND == "sqlite"
              else MemoryKV())
    rag = rag or make_rag_client(settings)
    engine = getattr(rag, "engine", None)
    device = getattr(engine, "device", None)
    if getattr(device, "type", None) == "cuda":
        # one card a process, made current here, in the thread that
        # built the engine: the chat threads (asyncio.to_thread) and the
        # worker's threads then find CUDA initialised
        import torch
        torch.cuda.set_device(device)
    ctx = AppContext(settings=settings, db=db, kv=kv, rag=rag,
                     limiter=RateLimiter(kv))

    def engine_probe() -> bool:
        # cheap engine liveness roundtrip (reference cached its external
        # Gemini probe, main.py:352-423; ours is in process, or one RPC
        # to the engine process in connect mode)
        engine = getattr(ctx.rag, "engine", None)
        if engine is None:
            return True  # mock mode
        engine.list_stores()
        return True

    ctx.extra["engine_probe"] = engine_probe
    # ENGINE_RPC_MODE=serve: host the engine for sibling API processes
    # (engine/rpc.py scale-out topology — one card owner, N servers)
    if getattr(settings, "ENGINE_RPC_MODE", "") == "serve" \
            and getattr(ctx.rag, "engine", None) is not None:
        from rag_foundation_tpu_torch.engine.rpc import EngineRpcServer
        ctx.extra["engine_rpc"] = EngineRpcServer(
            ctx.rag.engine, settings.engine_rpc_socket).start()
    # production topology (deploy/docker-compose.yml): API processes set
    # WORKER_IN_PROCESS=0 and dedicated worker_main processes drain the
    # shared sqlite queue — ingestion (encode + IVF rebuilds) then never
    # contends with the serving path in-process
    if with_worker and not settings.WORKER_IN_PROCESS:
        ctx.queue = JobQueue(db, lease_s=settings.WORKER_JOB_TIMEOUT_S,
                             retry_backoff_s=settings.WORKER_RETRY_BACKOFF_S)
        with_worker = False
    if with_worker:
        queue = JobQueue(db, lease_s=settings.WORKER_JOB_TIMEOUT_S,
                 retry_backoff_s=settings.WORKER_RETRY_BACKOFF_S)
        worker = Worker(queue, concurrency=settings.WORKER_CONCURRENCY)
        worker.register(
            "ingest_document",
            lambda payload: run_ingestion_sync(
                db, ctx.rag, settings, payload["document_id"]))
        worker.cron(settings.WATCHDOG_CRON_S,
                    lambda: reset_stuck_documents(db, settings))
        worker.cron(settings.WATCHDOG_CRON_S * 4,
                    lambda: cleanup_stale_stores(db, ctx.rag))
        if settings.ENGINE_RECALL_AUDIT_S > 0:
            def recall_audit():
                engine = getattr(ctx.rag, "engine", None)
                if engine is None:
                    return
                for key in engine.list_stores():
                    try:
                        out = engine.recall_probe(key, k=10)
                        log_json(logging.INFO, "recall_audit",
                                 store=key, **out)
                    except Exception as e:  # noqa: BLE001 — cron isolation
                        log_json(logging.WARNING, "recall_audit_failed",
                                 store=key, error=str(e)[:200])
            worker.cron(settings.ENGINE_RECALL_AUDIT_S, recall_audit)
        ctx.queue = queue
        ctx.worker = worker
    return ctx


def create_app(ctx: AppContext | None = None, *,
               settings: Settings | None = None,
               start_worker: bool = True) -> App:
    configure_logging()
    ctx = ctx or build_context(settings)
    settings = ctx.settings
    app = App()
    app.state["ctx"] = ctx

    # -- middleware (outermost first) --------------------------------------
    @app.middleware
    async def correlation_and_logging(req: Request, call_next):
        rid = req.headers.get("x-request-id", "")
        if not _CORR_ID_OK.match(rid):
            rid = uuid.uuid4().hex
        bind_request(request_id=rid)
        t0 = time.perf_counter()
        try:
            resp = await call_next(req)
        finally:
            clear_request()
        resp.headers["x-request-id"] = rid
        dur = time.perf_counter() - t0
        if req.path.startswith("/api/"):
            # collapse resource IDs at EVERY depth or the label set
            # grows with each store/document ever touched
            route = "/".join(
                "{id}" if seg.isdigit() else seg
                for seg in req.path.split("/")[:5])
        else:
            route = req.path
        metrics.http_requests_total.labels(
            req.method, route, str(resp.status)).inc()
        metrics.http_request_duration_seconds.labels(
            req.method, route).observe(dur)
        log_json(logging.INFO, "request_complete", method=req.method,
                 path=req.path, status=resp.status,
                 dur_ms=int(dur * 1000))
        return resp

    @app.middleware
    async def security_headers(req: Request, call_next):
        resp = await call_next(req)
        resp.headers.setdefault("x-content-type-options", "nosniff")
        resp.headers.setdefault("x-frame-options", "DENY")
        resp.headers.setdefault("referrer-policy", "no-referrer")
        resp.headers.setdefault(
            "content-security-policy",
            "default-src 'self'; frame-ancestors 'none'")
        return resp

    @app.middleware
    async def cors(req: Request, call_next):
        origin = req.headers.get("origin", "")
        if req.method == "OPTIONS":
            if origin in settings.CORS_ORIGINS:
                return Response(b"", status=204, headers={
                    "access-control-allow-origin": origin,
                    "access-control-allow-methods":
                        "GET, POST, PUT, PATCH, DELETE, OPTIONS",
                    "access-control-allow-headers":
                        "authorization, content-type, x-request-id,"
                        " x-requested-with",
                    "access-control-max-age": "600",
                })
            return Response(b"", status=204)
        try:
            resp = await call_next(req)
        except HTTPError as e:
            # convert HERE (inside security_headers + correlation):
            # error responses must still carry CORS + security headers,
            # count in metrics, and get an x-request-id — letting the
            # exception ride to the framework boundary bypassed every
            # outer middleware (a browser SPA saw opaque fetch failures
            # on any 401/422/429)
            resp = Response({"detail": e.detail}, status=e.status,
                            headers=e.headers)
        if origin in settings.CORS_ORIGINS:
            resp.headers["access-control-allow-origin"] = origin
            resp.headers["vary"] = "Origin"
        return resp

    @app.middleware
    async def csrf_guard(req: Request, call_next):
        # Header-based CSRF check for browser-origin mutations (reference:
        # main.py:76-86): EVERY mutating request that carries an Origin
        # header (i.e. comes from a browser) must also carry a custom
        # header (bearer token or x-requested-with) — cross-site forms
        # can send neither. Allowlisted origins are not exempt: a same-
        # origin form post is still a CSRF vector for cookie-ish clients.
        if settings.CSRF_ENABLED and req.method in _MUTATING \
                and req.path.startswith("/api/") \
                and req.headers.get("origin"):
            if "authorization" not in req.headers and \
                    req.headers.get("x-requested-with") != "XMLHttpRequest":
                raise HTTPError(403, "CSRF check failed")
        return await call_next(req)

    @app.middleware
    async def body_limit(req: Request, call_next):
        # uploads stream their own body via stream_multipart (reference
        # exempts uploads from the JSON cap, main.py:176); every other
        # route buffers here under the cap — bodies are read lazily off
        # the socket, so an oversized JSON body aborts at the cap, not
        # after full buffering
        if req.path != "/api/upload":
            # the cap must NOT key off the client-controlled
            # content-type: handlers parse req.json() regardless, so a
            # text/plain 99 MB body would buffer in full
            cap = settings.MAX_JSON_BODY_MB * 1024 * 1024
            try:
                await req.read_body(cap)
            except HTTPError as e:
                if e.status == 413:
                    raise HTTPError(413, "JSON body too large") from None
                raise
        return await call_next(req)

    @app.middleware
    async def global_rate_limit(req: Request, call_next):
        if req.path.startswith("/api/"):
            key = global_rate_key(req, settings)
            ctx.limiter.check(f"global:{key}",
                              settings.RATE_LIMIT_GLOBAL_PER_MIN)
        return await call_next(req)

    @app.exception_handler
    def on_exception(req: Request, exc: Exception) -> Response:
        log_json(logging.ERROR, "unhandled_exception",
                 exc_type=type(exc).__name__, path=req.path)
        return Response({"detail": "Internal Server Error"}, status=500)

    # -- probes (reference: main.py:308-423) -------------------------------
    @app.get("/live")
    async def live(req):
        return Response({"status": "live"})

    @app.get("/ready")
    async def ready(req):
        ok = ctx.db.ping()
        return Response({"status": "ready" if ok else "degraded",
                         "db": ok}, status=200 if ok else 503)

    @app.get("/health")
    async def health(req):
        db_ok = ctx.db.ping()
        kv_ok = ctx.kv.ping()
        engine_ok = True
        try:
            probe = ctx.extra.get("engine_probe")
            if probe is not None:
                engine_ok = bool(probe())
        except Exception:  # noqa: BLE001
            engine_ok = False
        ok = db_ok and kv_ok and engine_ok
        return Response({
            "status": "healthy" if ok else "degraded",
            "db": db_ok, "kv": kv_ok, "engine": engine_ok,
            "queue_pending": ctx.queue.pending() if ctx.queue else None,
        }, status=200 if ok else 503)

    @app.get("/metrics")
    async def metrics_endpoint(req):
        # loopback-gated unless METRICS_ALLOW_ALL (reference: main.py:308-322)
        peer = req.client[0]
        if not settings.METRICS_ALLOW_ALL and \
                peer not in ("127.0.0.1", "::1", ""):
            raise HTTPError(403, "Metrics restricted to loopback")
        return Response(metrics.render(getattr(ctx.rag, "engine", None)),
                        content_type="text/plain; version=0.0.4")

    # -- frontend (static SPA; reference served React via Vite/nginx) ------
    static_dir = Path(__file__).resolve().parent / "static"
    _TYPES = {".html": "text/html; charset=utf-8",
              ".js": "application/javascript", ".css": "text/css",
              ".svg": "image/svg+xml", ".ico": "image/x-icon"}

    @app.get("/")
    async def index(req):
        return Response((static_dir / "index.html").read_bytes(),
                        content_type=_TYPES[".html"])

    @app.get("/static/{name}")
    async def static_file(req):
        name = req.path_params["name"]
        target = (static_dir / name).resolve()
        if target.parent != static_dir or not target.is_file():
            raise HTTPError(404, "Not Found")
        return Response(target.read_bytes(),
                        content_type=_TYPES.get(target.suffix,
                                                "application/octet-stream"))

    # -- routers -----------------------------------------------------------
    for module in (auth_routes, stores, documents, uploads, chat,
                   costs_routes, settings_routes, admin):
        module.register(app, ctx)

    # -- lifespan ----------------------------------------------------------
    async def _startup():
        run_security_gate(settings, ctx.kv)
        ctx.stream_semaphore = asyncio.Semaphore(
            settings.MAX_CONCURRENT_STREAMS)
        # a thread for each admitted stream (its engine call, then its
        # queue reads, go through asyncio.to_thread) on top of the
        # default pool's min(32, cores + 4): with the default alone, a
        # few streams' engine calls run at a time and the rest queue
        asyncio.get_running_loop().set_default_executor(ThreadPoolExecutor(
            max_workers=settings.MAX_CONCURRENT_STREAMS
            + min(32, (os.cpu_count() or 1) + 4),
            thread_name_prefix="ragtpu-app"))
        if start_worker and ctx.worker is not None:
            ctx.worker.start()
        engine = getattr(ctx.rag, "engine", None)
        device = getattr(engine, "device", None)
        log_json(logging.INFO, "app_started",
                 environment=settings.ENVIRONMENT,
                 mock_mode=settings.MOCK_MODE,
                 device=str(device) if device is not None
                 else ("none" if engine is None else "remote"),
                 engine_rpc_mode=settings.ENGINE_RPC_MODE)

    async def _shutdown():
        if ctx.worker is not None:
            ctx.worker.stop()

    app.on_startup.append(_startup)
    app.on_shutdown.append(_shutdown)
    return app


def main():  # pragma: no cover — production entrypoint
    import argparse

    parser = argparse.ArgumentParser(description="ragtpu API server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--workers", type=int, default=1,
                        help="forked API processes sharing the port via"
                        " SO_REUSEPORT (gunicorn-workers analog;"
                        " requires sqlite KV + a persistent DB path)")
    args = parser.parse_args()
    from rag_foundation_tpu_torch.runtime.http import serve
    if args.workers <= 1:
        # fail fast instead of serving as a zombie: an in-process engine
        # on the card (the default) needs one
        try:
            app = create_app()
        except RuntimeError as e:
            raise SystemExit(
                f"engine unavailable at startup: {e}\nRefusing to serve "
                "without the engine's device — set "
                "RAGTPU_ENGINE_PLATFORM=cpu, RAGTPU_ENGINE_RPC_MODE=connect "
                "or RAGTPU_MOCK_MODE=1") from e
        asyncio.run(serve(app, args.host, args.port))
        return
    import signal as _signal
    settings = load_settings()
    if settings.DATABASE_PATH == ":memory:" or \
            settings.KV_BACKEND != "sqlite":
        raise SystemExit("--workers > 1 requires RAGTPU_DATABASE_PATH to "
                         "be a file and RAGTPU_KV_BACKEND=sqlite so "
                         "processes share state")
    children = []
    for _ in range(args.workers):
        pid = os.fork()
        if pid == 0:
            # each worker builds its own app (own engine/event loop) over
            # the shared sqlite DB/KV/queue; kernel balances accepts
            asyncio.run(serve(create_app(), args.host, args.port,
                              reuse_port=True))
            os._exit(0)
        children.append(pid)

    def _reap(*_a):
        for pid in children:
            os.kill(pid, _signal.SIGTERM)
    _signal.signal(_signal.SIGTERM, _reap)
    _signal.signal(_signal.SIGINT, _reap)
    for pid in children:
        os.waitpid(pid, 0)


if __name__ == "__main__":  # pragma: no cover
    main()
