"""The port's runtime layer (``rag_foundation_tpu_torch.runtime``, a copy
of ``rag_foundation_tpu.runtime`` the port's app runs on): the cases of
``tests/test_runtime.py`` on the port's modules — HTTP framework and
middleware, multipart, chunked SSE over a real socket, sqlite migrations
and transactions, KV TTL and eviction, job-queue leases, reclaim, retry
backoff and the worker, on the port's own ``FakeClock``."""

import asyncio
import threading
import time

import pytest

from rag_foundation_tpu_torch.runtime.db import Database
from rag_foundation_tpu_torch.runtime.http import (
    App, HTTPError, Request, Response, StreamingResponse, TestClient,
    serve, sse_frame)
from rag_foundation_tpu_torch.runtime.jobqueue import JobQueue, Worker
from rag_foundation_tpu_torch.runtime.kv import (FailingKV, KVError, MemoryKV,
                                                 SqliteKV)


# -- HTTP framework ---------------------------------------------------------

def _make_app():
    app = App()

    @app.get("/hello/{name}")
    async def hello(req):
        return Response({"hi": req.path_params["name"],
                         "q": req.query.get("x")})

    @app.post("/echo")
    async def echo(req):
        return Response(req.json(), status=201)

    @app.post("/upload")
    async def upload(req):
        fields, files = req.multipart()
        f = files["file"]
        return Response({"fields": fields, "filename": f.filename,
                         "size": len(f.data), "ctype": f.content_type})

    @app.get("/boom")
    async def boom(req):
        raise HTTPError(418, "teapot")

    @app.get("/crash")
    async def crash(req):
        raise RuntimeError("secret internal detail")

    @app.get("/stream")
    async def stream(req):
        async def gen():
            yield sse_frame({"n": 1})
            yield sse_frame("keepalive", comment=True)
            yield sse_frame({"n": 2})
            yield sse_frame("[DONE]")
        return StreamingResponse(gen())

    @app.middleware
    async def add_header(req, call_next):
        resp = await call_next(req)
        resp.headers["x-framework"] = "ragtpu"
        return resp

    return app


def test_routing_and_json():
    with TestClient(_make_app()) as c:
        r = c.get("/hello/world?x=1")
        assert r.status_code == 200 and r.json() == {"hi": "world", "q": "1"}
        assert r.headers["x-framework"] == "ragtpu"
        r = c.post("/echo", json_body={"a": [1, 2]})
        assert r.status_code == 201 and r.json() == {"a": [1, 2]}
        assert c.get("/nope").status_code == 404
        r = c.post("/hello/x")
        assert r.status_code == 405 and "GET" in r.headers["allow"]
        assert c.get("/boom").json() == {"detail": "teapot"}


def test_unhandled_exception_hides_detail():
    r = TestClient(_make_app()).get("/crash")
    assert r.status_code == 500
    assert "secret" not in r.text


def test_multipart_upload():
    with TestClient(_make_app()) as c:
        r = c.post("/upload", data={"store": "s1"},
                   files={"file": ("doc.txt", b"hello world", "text/plain")})
        assert r.status_code == 200
        out = r.json()
        assert out["fields"] == {"store": "s1"}
        assert out["filename"] == "doc.txt"
        assert out["size"] == 11


def test_sse_stream_collection():
    with TestClient(_make_app()) as c:
        r = c.get("/stream")
        frames = list(r.iter_sse())
        assert frames == ['{"n": 1}', '{"n": 2}', "[DONE]"]
        assert "text/event-stream" in r.headers["content-type"]
        assert ": keepalive" in r.text


def test_real_socket_server_roundtrip():
    """End-to-end over a real socket including chunked SSE."""
    import http.client

    app = _make_app()
    ready = threading.Event()
    stop_holder = {}

    def run():
        async def main():
            stop = asyncio.Event()
            stop_holder["stop"] = stop
            stop_holder["loop"] = asyncio.get_running_loop()
            aready = asyncio.Event()

            async def flag():
                await aready.wait()
                ready.set()
            t = asyncio.create_task(flag())
            await serve(app, "127.0.0.1", 8765, ready=aready, stop=stop)
            t.cancel()
        asyncio.run(main())

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(10)
    conn = http.client.HTTPConnection("127.0.0.1", 8765, timeout=10)
    conn.request("GET", "/hello/sock?x=2")
    resp = conn.getresponse()
    assert resp.status == 200
    assert b'"hi": "sock"' in resp.read()
    conn.request("GET", "/stream")
    resp = conn.getresponse()
    body = resp.read().decode()
    assert '{"n": 2}' in body and "data: [DONE]" in body
    conn.close()
    stop_holder["loop"].call_soon_threadsafe(stop_holder["stop"].set)
    th.join(5)


# -- Database ---------------------------------------------------------------

def test_db_migrations_and_tx(tmp_path):
    m1 = "CREATE TABLE t(a INTEGER);"
    m2 = "ALTER TABLE t ADD COLUMN b TEXT;"
    db = Database(tmp_path / "x.db", migrations=[m1])
    db.execute("INSERT INTO t(a) VALUES (1)")
    db.migrate([m1, m2])  # idempotent: only applies m2
    db.execute("INSERT INTO t(a,b) VALUES (2,'x')")
    rows = db.query("SELECT * FROM t ORDER BY a")
    assert [tuple(r) for r in rows] == [(1, None), (2, "x")]
    with pytest.raises(RuntimeError):
        with db.tx() as conn:
            conn.execute("INSERT INTO t(a) VALUES (3)")
            raise RuntimeError("rollback me")
    assert len(db.query("SELECT * FROM t")) == 2
    assert db.ping()


def test_db_concurrent_process_migration(tmp_path):
    """N processes booting one fresh DB must not race the migrations
    (the SO_REUSEPORT scale-out topology starts every API process at
    once against a shared DATABASE_PATH)."""
    import multiprocessing as mp

    path = str(tmp_path / "race.db")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    ps = [ctx.Process(target=_migrate_boot, args=(path, q))
          for _ in range(6)]
    for p in ps:
        p.start()
    for p in ps:
        p.join(60)
    results = [q.get(timeout=5) for _ in ps]
    assert results == ["ok"] * len(ps), results


def _migrate_boot(path, q):  # top-level: must be picklable for spawn
    try:
        from rag_foundation_tpu_torch.app.dbschema import MIGRATIONS
        from rag_foundation_tpu_torch.runtime.db import Database
        from rag_foundation_tpu_torch.runtime.jobqueue import JobQueue
        db = Database(path, migrations=MIGRATIONS)
        JobQueue(db)   # ad-hoc ALTER migration must not race either
        q.put("ok")
    except Exception as e:  # pragma: no cover - failure detail for CI
        q.put(f"fail: {type(e).__name__}: {e}")


def test_db_memory_shared_across_threads():
    db = Database(":memory:", migrations=["CREATE TABLE t(a INTEGER);"])
    db.execute("INSERT INTO t VALUES (42)")
    out = {}

    def reader():
        out["rows"] = db.query("SELECT a FROM t")
    th = threading.Thread(target=reader)
    th.start()
    th.join()
    assert out["rows"][0]["a"] == 42


# -- KV ---------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda tmp, c: MemoryKV(clock=c),
    lambda tmp, c: SqliteKV(tmp / "kv.db", clock=c),
])
def test_kv_basics(make, tmp_path):
    from rag_foundation_tpu_torch.utils.clock import FakeClock
    clock = FakeClock()
    kv = make(tmp_path, clock)
    assert kv.get("a") is None
    kv.set("a", "1")
    assert kv.get("a") == "1" and kv.exists("a")
    kv.setex("b", 5.0, "x")
    assert kv.get("b") == "x"
    clock.advance(5.1)  # TTL expiry without sleeping (FakeClock)
    assert kv.get("b") is None
    assert kv.incr("ctr") == 1
    assert kv.incr("ctr") == 2
    kv.delete("a")
    assert not kv.exists("a")
    assert kv.ping()


def test_failing_kv_raises():
    kv = FailingKV()
    with pytest.raises(KVError):
        kv.get("x")
    assert not kv.ping()


# -- Job queue --------------------------------------------------------------

def test_jobqueue_lifecycle(tmp_path):
    db = Database(tmp_path / "q.db")
    q = JobQueue(db, retry_backoff_s=0.0)
    w = Worker(q)
    done = []
    w.register("ok", lambda p: done.append(p["v"]))
    fails = {"n": 0}

    def flaky(p):
        fails["n"] += 1
        if fails["n"] < 2:
            raise ValueError("transient")
    w.register("flaky", flaky)

    q.enqueue("ok", {"v": 1})
    q.enqueue("flaky", {})
    q.enqueue("missing_handler", {}, max_attempts=1)
    while w.run_once():
        pass
    assert done == [1]
    s = q.stats()
    # flaky failed once then requeued; run again to finish it
    while w.run_once():
        pass
    s = q.stats()
    assert s.get("done") == 2 and s.get("error") == 1
    assert fails["n"] == 2


def test_jobqueue_lease_recovery(tmp_path):
    from rag_foundation_tpu_torch.utils.clock import FakeClock
    clock = FakeClock()
    db = Database(tmp_path / "q.db")
    q = JobQueue(db, lease_s=30.0, clock=clock)
    q.enqueue("x", {}, max_attempts=5)
    job = q.claim()
    assert job is not None
    assert q.claim() is None  # leased, not claimable
    clock.advance(31.0)  # lease expiry without sleeping
    job2 = q.claim()  # lease expired -> reclaim
    assert job2 is not None and job2["id"] == job["id"]
    assert job2["attempts"] == 2


def test_worker_cron_ticks(tmp_path):
    from rag_foundation_tpu_torch.utils.clock import FakeClock
    mono = FakeClock()
    q = JobQueue(Database(tmp_path / "q.db"))
    w = Worker(q, poll_interval=0.01, mono=mono)
    hits = []
    w.cron(30.0, lambda: hits.append(1))
    w._tick_crons()
    assert hits == []          # not due yet
    mono.advance(31.0)
    w._tick_crons()
    mono.advance(31.0)
    w._tick_crons()
    assert len(hits) == 2      # exactly one tick per elapsed period


def test_worker_concurrent_claims(tmp_path):
    """concurrency>1 processes jobs in parallel without double-claiming."""
    db = Database(tmp_path / "qc.db")
    q = JobQueue(db)
    w = Worker(q, poll_interval=0.01, concurrency=4)
    seen = []
    gate = threading.Barrier(4, timeout=10)

    for i in range(8):
        q.enqueue("j", {"v": i})
    all_done = threading.Event()

    def _watch(p):
        gate.wait()  # forces 4 jobs to be in flight simultaneously
        seen.append(p["v"])
        if len(seen) >= 8:
            all_done.set()

    w.register("j", _watch)  # replaces handler: adds completion signal
    w.start()
    assert all_done.wait(15)
    w.stop()
    assert sorted(seen) == list(range(8))  # each exactly once
    assert q.stats().get("done") == 8


def test_reuse_port_two_servers():
    """Two event loops share one port via SO_REUSEPORT (multi-worker)."""
    import http.client

    apps = [_make_app(), _make_app()]
    readies = [threading.Event(), threading.Event()]
    holders = [{}, {}]

    def run(i):
        async def main():
            stop = asyncio.Event()
            holders[i]["stop"], holders[i]["loop"] = \
                stop, asyncio.get_running_loop()
            aready = asyncio.Event()

            async def flag():
                await aready.wait()
                readies[i].set()
            task = asyncio.create_task(flag())
            await serve(apps[i], "127.0.0.1", 8821, ready=aready,
                        stop=stop, reuse_port=True)
            task.cancel()
        asyncio.run(main())

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    assert all(r.wait(10) for r in readies)
    try:
        for _ in range(6):
            conn = http.client.HTTPConnection("127.0.0.1", 8821, timeout=10)
            conn.request("GET", "/hello/w?x=1")
            assert conn.getresponse().status == 200
            conn.close()
    finally:
        for h, t in zip(holders, threads):
            h["loop"].call_soon_threadsafe(h["stop"].set)
            t.join(5)


def test_job_retry_backoff(tmp_path):
    """Failed jobs requeue with a jittered exponential not_before delay
    (reference: ingestion poll backoff / ARQ defer); claim honors it."""
    import time as _time

    from rag_foundation_tpu_torch.runtime.db import Database
    from rag_foundation_tpu_torch.runtime.jobqueue import JobQueue

    db = Database(str(tmp_path / "q.db"))
    q = JobQueue(db)
    q.enqueue("j", {}, max_attempts=3)
    job = q.claim()
    q.finish(job["id"], error="boom")
    row = db.query("SELECT status, not_before FROM jobs")[0]
    assert row["status"] == "queued"
    assert row["not_before"] > _time.time()  # delayed, not hot-looped
    assert q.claim() is None                 # not claimable yet
    db.execute("UPDATE jobs SET not_before=0")
    job = q.claim()
    assert job is not None                   # claimable after the delay
    q.finish(job["id"], error="boom")
    db.execute("UPDATE jobs SET not_before=0")
    q.finish(q.claim()["id"], error="boom")  # third attempt -> terminal
    assert db.query("SELECT status FROM jobs")[0]["status"] == "error"


def test_finish_requires_matching_claim_token(tmp_path):
    """A worker that overran its lease must not clobber the state of
    the worker that re-claimed the job (round-2 review finding)."""
    from rag_foundation_tpu_torch.runtime.db import Database
    from rag_foundation_tpu_torch.runtime.jobqueue import JobQueue

    t = [1000.0]
    db = Database(str(tmp_path / "q.db"))
    q = JobQueue(db, lease_s=10, clock=lambda: t[0])
    q.enqueue("ingest", {"x": 1})
    j1 = q.claim()
    t[0] += 20  # lease expires
    j2 = q.claim()  # second worker takes over
    assert j2["id"] == j1["id"]
    assert j2["claim_token"] != j1["claim_token"]
    # the original's finish is a NO-OP now
    q.finish(j1["id"], claim_token=j1["claim_token"])
    row = db.one("SELECT status FROM jobs WHERE id=?", (j1["id"],))
    assert row["status"] == "running"
    # the current owner's finish lands
    q.finish(j2["id"], claim_token=j2["claim_token"])
    row = db.one("SELECT status FROM jobs WHERE id=?", (j2["id"],))
    assert row["status"] == "done"


def test_worker_survives_queue_level_errors(tmp_path):
    """A transient db error in claim() must not kill the loop
    (round-2 review finding)."""
    from rag_foundation_tpu_torch.runtime.db import Database
    from rag_foundation_tpu_torch.runtime.jobqueue import JobQueue, Worker

    db = Database(str(tmp_path / "q2.db"))
    q = JobQueue(db, retry_backoff_s=0)
    w = Worker(q, poll_interval=0.01)
    boom = [2]
    real_claim = q.claim

    def flaky_claim():
        if boom[0] > 0:
            boom[0] -= 1
            raise RuntimeError("transient db hiccup")
        return real_claim()
    q.claim = flaky_claim
    done = []
    w.register("j", lambda p: done.append(p))
    q.enqueue("j", {"ok": 1})
    assert w._run_once_guarded() is False   # first hiccup survived
    assert w._run_once_guarded() is False   # second hiccup survived
    assert w._run_once_guarded() is True    # then the job runs
    assert done == [{"ok": 1}]


def test_memorykv_incr_eviction_and_revoked_protection():
    """Rate-limit keys must evict (incr path) and live revocation
    markers must never be evicted by a key flood (fail-closed;
    round-2 review findings)."""
    from rag_foundation_tpu_torch.runtime.kv import MemoryKV

    kv = MemoryKV(max_keys=50)
    kv.setex("revoked:token-a", 3600, "1")
    for i in range(300):
        kv.incr(f"rl:client-{i}:w1")
        kv.expire(f"rl:client-{i}:w1", 60)
    assert len(kv._data) <= 51
    assert kv.exists("revoked:token-a")  # survived the flood
