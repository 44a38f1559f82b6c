"""Engine RPC: one device-owning engine process, many API processes.

Counterpart of ``rag_foundation_tpu/engine/rpc.py`` (same protocol, same
ops), serving the port's ``Engine``. The device engine lives in exactly
ONE process; API processes reach it over a unix socket with a
length-prefixed JSON protocol exposing the Engine surface the app uses
(search / ingest / store lifecycle / recall probe). Every search from
every API process funnels into the one engine, so its QueryBatcher
coalesces concurrent searches into batched device calls.

Protocol: 4-byte big-endian length + UTF-8 JSON, request
``{"op": str, ...kwargs}``, response ``{"ok": true, "result": ...}`` or
``{"ok": false, "kind": ExcClassName, "error": str}``. Connections are
persistent; clients keep a small pool.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import socketserver
import struct
import threading

import numpy as np

_LEN = struct.Struct(">I")
_MAX_MSG = 256 << 20      # a full document upload fits; garbage doesn't


def _send(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj, separators=(",", ":")).encode()
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv(sock: socket.socket) -> dict | None:
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = _LEN.unpack(hdr)
    if n > _MAX_MSG:
        raise ValueError(f"oversized rpc frame ({n} bytes)")
    data = _recv_exact(sock, n)
    if data is None:
        return None
    return json.loads(data)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            return None
        buf += part
    return bytes(buf)


# ---------------------------------------------------------------------------
# server

_OPS = ("ping", "list_stores", "create_store", "delete_store",
        "has_store", "store_stats", "ingest_document", "delete_document",
        "search", "search_batch", "recall_probe", "metrics_text",
        "pad_store",
        "prewarm", "prewarm_generator")
# "generate" is NOT in _OPS: it is the one streaming op and is
# special-cased in the connection loop (multi-frame response).


class EngineRpcServer:
    """Threaded unix-socket server wrapping a live Engine."""

    def __init__(self, engine, path: str, *, allow_pad: bool = False):
        self.engine = engine
        self.path = path
        self.allow_pad = allow_pad     # bench/dev only; never in prod
        if os.path.exists(path):
            os.unlink(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        req = _recv(self.request)
                    except (ConnectionError, ValueError, OSError):
                        return
                    if req is None:
                        return
                    if req.get("op") == "generate":
                        # STREAMING op: many delta frames then a done
                        # frame (SSE-shaped; reference analog is the
                        # provider's streaming generate_content,
                        # gemini_rag.py:517-551)
                        try:
                            outer._stream_generate(self.request, req)
                        except (ConnectionError, OSError):
                            return   # client went away mid-stream
                        continue
                    _send(self.request, outer._dispatch(req))

        class Server(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True
            # listen backlog: socketserver's default of 5 refuses
            # (EAGAIN) the connects of a burst of concurrent clients
            request_queue_size = 256

        self._server = Server(path, Handler)
        os.chmod(path, 0o600)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="engine-rpc", daemon=True)

    def start(self) -> "EngineRpcServer":
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    # -- dispatch ---------------------------------------------------------
    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        if op not in _OPS:
            return {"ok": False, "kind": "ValueError",
                    "error": f"unknown op {op!r}"}
        try:
            result = getattr(self, f"_op_{op}")(req)
            return {"ok": True, "result": result}
        except Exception as e:  # noqa: BLE001 — protocol boundary
            return {"ok": False, "kind": type(e).__name__,
                    "error": str(e)}

    def _op_ping(self, req):
        return "pong"

    def _op_list_stores(self, req):
        return self.engine.list_stores()

    def _op_create_store(self, req):
        self.engine.create_store(req["key"])
        return True

    def _op_delete_store(self, req):
        self.engine.delete_store(req["key"])
        return True

    def _op_has_store(self, req):
        return self.engine.has_store(req["key"])

    def _op_store_stats(self, req):
        return self.engine.store_stats(req["key"])

    def _op_ingest_document(self, req):
        return self.engine.ingest_document(
            req["key"], req["doc_id"], req["filename"], req["text"])

    def _op_delete_document(self, req):
        self.engine.delete_document(req["key"], req["doc_id"])
        return True

    def _op_search(self, req):
        doc_filter = set(req["doc_filter"]) if req.get("doc_filter") \
            else None
        hits = self.engine.search(
            req["keys"], req["query"], k=req.get("k", 5),
            doc_filter=doc_filter, meta_filter=req.get("meta_filter"))
        return [dataclasses.asdict(h) for h in hits]

    def _op_search_batch(self, req):
        """Raw batched search (Engine.search_batch): one encode + one
        device scan for all queries; chunk ids and scores per query."""
        scores, ids = self.engine.search_batch(
            req["key"], list(req["queries"]), k=int(req.get("k", 10)))
        return {"scores": np.asarray(scores, np.float64).tolist(),
                "ids": np.asarray(ids, np.int64).tolist()}

    def _op_recall_probe(self, req):
        return self.engine.recall_probe(
            req["key"], k=req.get("k", 10), sample=req.get("sample", 32))

    def _op_pad_store(self, req):
        """Bench/dev: pad a store's index with synthetic metadata-less
        vectors so serving runs scan a production-scale corpus
        (Engine.pad_store). Refused unless the server was started with
        allow_pad (engine_main enables it outside production)."""
        if not self.allow_pad:
            raise PermissionError("pad_store disabled on this server")
        return self.engine.pad_store(req["key"], int(req["n"]),
                                     seed=int(req.get("seed", 0)))

    def _op_prewarm(self, req):
        """Compile batched-search signatures for pow2 query buckets
        (Engine.prewarm) — run after bulk loads so production traffic
        never pays a first-compile live."""
        return self.engine.prewarm(req["key"], k=int(req.get("k", 5)),
                                   max_bucket=int(req.get(
                                       "max_bucket", 64)))

    def _stream_generate(self, sock: socket.socket, req: dict) -> None:
        """Serve one generate stream: delta frames, then ``done`` (or a
        single error frame — the connection stays usable either way)."""
        try:
            for delta in self.engine.generate_stream(
                    req["question"], req.get("evidences") or [],
                    max_tokens=req.get("max_tokens")):
                _send(sock, {"ok": True, "delta": delta})
            _send(sock, {"ok": True, "done": True})
        except (ConnectionError, OSError):
            raise
        except Exception as e:  # noqa: BLE001 — protocol boundary
            _send(sock, {"ok": False, "kind": type(e).__name__,
                         "error": str(e)})

    def _op_prewarm_generator(self, req):
        return self.engine.prewarm_generator()

    def _op_metrics_text(self, req):
        """The port keeps no Prometheus registry yet: the per-stage
        search profile, one ``stage seconds calls`` line each."""
        from rag_foundation_tpu_torch.engine.profile import search_profile
        return "".join(f"{name} {v['s']} {v['n']}\n" for name, v in
                       sorted(search_profile.snapshot().items()))


# ---------------------------------------------------------------------------
# client

class EngineRpcError(RuntimeError):
    pass


class RemoteEngine:
    """Engine facade over the RPC socket — same surface the app layer
    uses on the in-process Engine (services/rag.py, routes/admin.py,
    app/main.py health probe)."""

    def __init__(self, path: str, *, timeout: float = 600.0,
                 pool_size: int = 8):
        self.path = path
        self.timeout = timeout
        self._pool: list[socket.socket] = []
        self._lock = threading.Lock()
        self._pool_size = pool_size

    # -- plumbing ---------------------------------------------------------
    def _connect(self) -> socket.socket:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        s.connect(self.path)
        return s

    def _call(self, op: str, **kwargs):
        with self._lock:
            sock = self._pool.pop() if self._pool else None
        if sock is None:
            sock = self._connect()
        try:
            _send(sock, {"op": op, **kwargs})
            resp = _recv(sock)
        except (ConnectionError, OSError):
            # one reconnect: the server may have restarted
            sock.close()
            sock = self._connect()
            _send(sock, {"op": op, **kwargs})
            resp = _recv(sock)
        if resp is None:
            sock.close()
            raise EngineRpcError("engine rpc connection closed")
        with self._lock:
            if len(self._pool) < self._pool_size:
                self._pool.append(sock)
            else:
                sock.close()
        if resp["ok"]:
            return resp["result"]
        kind, err = resp.get("kind", ""), resp.get("error", "")
        if kind == "StoreNotFound":
            from rag_foundation_tpu_torch.engine.api import StoreNotFound
            raise StoreNotFound(err)
        if kind == "ValueError":
            raise ValueError(err)
        raise EngineRpcError(f"{kind}: {err}")

    # -- engine surface ---------------------------------------------------
    def ping(self) -> bool:
        return self._call("ping") == "pong"

    def list_stores(self) -> list[str]:
        return self._call("list_stores")

    def create_store(self, key: str) -> None:
        self._call("create_store", key=key)

    def delete_store(self, key: str) -> None:
        self._call("delete_store", key=key)

    def has_store(self, key: str) -> bool:
        return self._call("has_store", key=key)

    def store_stats(self, key: str) -> dict:
        return self._call("store_stats", key=key)

    def ingest_document(self, key: str, doc_id: str, filename: str,
                        text: str) -> dict:
        return self._call("ingest_document", key=key, doc_id=doc_id,
                          filename=filename, text=text)

    def delete_document(self, key: str, doc_id: str) -> None:
        self._call("delete_document", key=key, doc_id=doc_id)

    def search(self, keys: list[str], query: str, k: int = 5,
               doc_filter=None, meta_filter=None):
        from rag_foundation_tpu_torch.engine.api import SearchHit
        rows = self._call(
            "search", keys=list(keys), query=query, k=k,
            doc_filter=sorted(doc_filter) if doc_filter else None,
            meta_filter=meta_filter)
        return [SearchHit(**r) for r in rows]

    def search_batch(self, key: str, queries: list[str], k: int = 10
                     ) -> tuple[np.ndarray, np.ndarray]:
        r = self._call("search_batch", key=key, queries=list(queries), k=k)
        return (np.asarray(r["scores"], np.float32),
                np.asarray(r["ids"], np.int64))

    def recall_probe(self, key: str, *, k: int = 10, sample: int = 32
                     ) -> dict:
        return self._call("recall_probe", key=key, k=k, sample=sample)

    def metrics_text(self) -> str:
        return self._call("metrics_text")

    def generate_stream(self, question: str, evidences: list[str],
                        *, max_tokens: int | None = None):
        """Client half of the streaming generate op. The socket carries
        in-flight frames, so it only returns to the pool after the done
        frame; an abandoned or errored stream closes it instead."""
        with self._lock:
            sock = self._pool.pop() if self._pool else None
        if sock is None:
            sock = self._connect()
        req = {"op": "generate", "question": question,
               "evidences": list(evidences), "max_tokens": max_tokens}
        try:
            try:
                _send(sock, req)
                first = _recv(sock)
            except (ConnectionError, OSError):
                sock.close()
                sock = self._connect()   # one reconnect (server restart)
                _send(sock, req)
                first = _recv(sock)
            resp = first
            while True:
                if resp is None:
                    raise EngineRpcError("engine rpc connection closed "
                                         "mid-generation")
                if not resp.get("ok"):
                    # single error frame; connection stays usable
                    kind = resp.get("kind", "")
                    err = resp.get("error", "")
                    with self._lock:
                        if len(self._pool) < self._pool_size:
                            self._pool.append(sock)
                            sock = None
                    raise EngineRpcError(f"{kind}: {err}")
                if resp.get("done"):
                    with self._lock:
                        if len(self._pool) < self._pool_size:
                            self._pool.append(sock)
                            sock = None
                    return
                yield resp["delta"]
                resp = _recv(sock)
        finally:
            if sock is not None:
                sock.close()

    def prewarm_generator(self) -> dict:
        return self._call("prewarm_generator")

    def pad_store(self, key: str, n: int, *, seed: int = 0) -> dict:
        return self._call("pad_store", key=key, n=n, seed=seed)

    def prewarm(self, key: str, *, k: int = 5, max_bucket: int = 64
                ) -> dict:
        return self._call("prewarm", key=key, k=k, max_bucket=max_bucket)
