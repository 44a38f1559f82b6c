"""First-party asyncio HTTP/1.1 framework: routing, middleware, SSE, multipart.

Replaces the reference's FastAPI/Starlette/uvicorn stack (reference app
factory: backend/app/main.py:42-425) with a self-contained
implementation:

- ``App``: router (``{param}`` path patterns), middleware chain, exception
  mapping, lifespan hooks.
- ``Request`` / ``Response`` / ``StreamingResponse``: SSE rides chunked
  transfer encoding; JSON bodies are size-capped by middleware in the app
  layer.
- ``serve()``: asyncio socket server, keep-alive, graceful shutdown.
- ``TestClient``: drives the app in-process (no sockets) exactly like the
  reference's Starlette TestClient-based tests.
"""

from __future__ import annotations

import asyncio
import email.parser
import email.policy
import json
import re
import threading
import time
import traceback
import urllib.parse
from collections.abc import AsyncIterator, Awaitable, Callable
from typing import Any

MAX_HEADER_BYTES = 64 * 1024
DEFAULT_MAX_BODY = 100 * 1024 * 1024  # absolute transport cap; app caps lower

STATUS_PHRASES = {
    200: "OK", 201: "Created", 204: "No Content", 301: "Moved Permanently",
    302: "Found", 304: "Not Modified", 307: "Temporary Redirect",
    400: "Bad Request", 401: "Unauthorized", 402: "Payment Required",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    409: "Conflict", 413: "Payload Too Large", 415: "Unsupported Media Type",
    422: "Unprocessable Entity", 429: "Too Many Requests",
    500: "Internal Server Error", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
}


class HTTPError(Exception):
    """Raise anywhere in a handler to produce a JSON error response."""

    def __init__(self, status: int, detail: str = "",
                 headers: dict[str, str] | None = None):
        super().__init__(detail or STATUS_PHRASES.get(status, str(status)))
        self.status = status
        self.detail = detail or STATUS_PHRASES.get(status, str(status))
        self.headers = headers or {}


class Disconnected(Exception):
    """Client went away mid-stream."""


class UploadedFile:
    __slots__ = ("filename", "content_type", "data")

    def __init__(self, filename: str, content_type: str, data: bytes):
        self.filename = filename
        self.content_type = content_type
        self.data = data


class SpooledFile:
    """A multipart file part streamed to a 0600 tempfile (never fully
    buffered in RAM) — reference parity: the reference streams 1 MiB
    chunks to a 0600 temp file with an in-flight cap
    (backend/app/routes/uploads.py:157-193)."""

    __slots__ = ("filename", "content_type", "path", "size", "head")

    def __init__(self, filename: str, content_type: str, path: str,
                 size: int, head: bytes):
        self.filename = filename
        self.content_type = content_type
        self.path = path
        self.size = size
        self.head = head  # first bytes, for magic-number validation

    def cleanup(self):
        import os as _os
        try:
            _os.unlink(self.path)
        except OSError:
            pass


STREAM_CHUNK = 1024 * 1024  # 1 MiB read granularity (reference parity)


class Request:
    def __init__(self, method: str, target: str, headers: dict[str, str],
                 body: bytes | None = b"",
                 client: tuple[str, int] = ("", 0),
                 reader: asyncio.StreamReader | None = None):
        self.method = method.upper()
        parsed = urllib.parse.urlsplit(target)
        self.path = urllib.parse.unquote(parsed.path) or "/"
        self.query = {k: v[-1] for k, v in
                      urllib.parse.parse_qs(parsed.query).items()}
        self.headers = {k.lower(): v for k, v in headers.items()}
        self.body = body if reader is None else None
        self.client = client
        self.path_params: dict[str, str] = {}
        self.state: dict[str, Any] = {}
        # streaming-body machinery: when constructed by the socket server
        # the body has NOT been read yet; handlers/middleware pull it via
        # read_body() (bounded buffering) or iter_raw() (streaming)
        self._reader = reader
        self._consumed = reader is None
        self._started = False
        cl = self.headers.get("content-length")
        self.content_length = int(cl) if cl and cl.isdigit() else None
        self._chunked = (self.headers.get("transfer-encoding", "")
                         .lower() == "chunked")

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "").split(";")[0].strip().lower()

    @property
    def body_consumed(self) -> bool:
        """True iff the socket holds no unread body bytes (keep-alive
        safe). False for both never-started and abandoned-midway."""
        return self._consumed

    async def iter_raw(self) -> AsyncIterator[bytes]:
        """Yield raw body chunks exactly once (streaming routes)."""
        if self._reader is None:
            self._consumed = True
            if self.body:
                yield self.body
            return
        if self._consumed or self._started:
            if self.body is not None:
                yield self.body
            return
        self._started = True
        if self._chunked:
            while True:
                size_line = await self._reader.readline()
                if not size_line:
                    # EOF mid-body is a DISCONNECT, not the terminal
                    # chunk: treating it as size 0 would accept a
                    # truncated body as complete
                    raise Disconnected()
                # strip RFC 7230 chunk extensions ("5;name=val")
                token = size_line.strip().split(b";", 1)[0]
                try:
                    size = int(token or b"0", 16)
                except ValueError:
                    raise HTTPError(400, "Malformed chunk size") \
                        from None
                if size == 0:
                    # consume optional trailer fields up to the blank
                    # line so keep-alive connections stay in sync
                    while True:
                        line = await self._reader.readline()
                        if line in (b"\r\n", b"\n", b""):
                            break
                    break
                remaining = size
                while remaining:
                    piece = await self._reader.read(
                        min(remaining, STREAM_CHUNK))
                    if not piece:
                        raise Disconnected()
                    remaining -= len(piece)
                    yield piece
                await self._reader.readexactly(2)
        elif self.content_length:
            remaining = self.content_length
            while remaining:
                piece = await self._reader.read(min(remaining,
                                                    STREAM_CHUNK))
                if not piece:
                    raise Disconnected()
                remaining -= len(piece)
                yield piece
        self._consumed = True  # reached only when fully drained

    async def read_body(self, limit: int | None = None) -> bytes:
        """Buffer the whole body (once), 413ing past ``limit``."""
        if self.body is not None:
            if limit is not None and len(self.body) > limit:
                raise HTTPError(413, "Payload Too Large")
            return self.body
        if limit is not None and self.content_length is not None \
                and self.content_length > limit:
            raise HTTPError(413, "Payload Too Large")
        chunks, total = [], 0
        async for piece in self.iter_raw():
            total += len(piece)
            if limit is not None and total > limit:
                raise HTTPError(413, "Payload Too Large")
            chunks.append(piece)
        self.body = b"".join(chunks)
        return self.body

    def json(self) -> Any:
        if self.body is None:
            raise HTTPError(400, "Request body not loaded")
        if not self.body:
            raise HTTPError(400, "Empty request body")
        try:
            return json.loads(self.body)
        except (ValueError, UnicodeDecodeError):
            raise HTTPError(400, "Invalid JSON body") from None

    async def stream_multipart(
        self, *,
        max_file_bytes: int,
        spool_dir: str,
        allowed_file_types: set[str] | None = None,
        max_field_bytes: int = 64 * 1024,
        head_bytes: int = 64,
    ) -> tuple[dict[str, str], dict[str, SpooledFile]]:
        """Incrementally parse multipart/form-data from the socket.

        File parts stream to 0600 tempfiles in ``spool_dir`` in ~1 MiB
        chunks with an in-flight size cap (413 raised the moment the cap
        is crossed — the remaining body is never read); field parts are
        size-capped in RAM. ``allowed_file_types`` rejects a part at its
        HEADERS (415) before any payload is spooled. Mirrors the
        reference's streaming upload loop
        (backend/app/routes/uploads.py:157-193).

        Callers own cleanup of the returned SpooledFiles (``.cleanup()``
        or move the path into place).
        """
        import os as _os
        import tempfile as _tempfile

        ctype = self.headers.get("content-type", "")
        if "multipart/form-data" not in ctype:
            raise HTTPError(415, "Expected multipart/form-data")
        m = re.search(r'boundary="?([^";,]+)"?', ctype)
        if not m:
            raise HTTPError(400, "Missing multipart boundary")
        delim = b"--" + m.group(1).encode("latin-1")
        # a content-length beyond any plausible total aborts before the
        # first byte is read
        overhead = 64 * 1024 + max_field_bytes * 8
        if self.content_length is not None and \
                self.content_length > max_file_bytes + overhead:
            raise HTTPError(413, "File exceeds upload size limit")

        fields: dict[str, str] = {}
        files: dict[str, SpooledFile] = {}
        spooled_paths: list[str] = []  # every tempfile ever created
        ait = self.iter_raw()
        buf = b""
        eof = False
        consumed = 0
        # TOTAL body cap enforced on bytes actually read: chunked
        # bodies carry no content-length, and per-part caps alone would
        # let a crafted stream of many small parts grow RAM/disk
        # without bound
        max_total = max_file_bytes + overhead

        async def fill() -> bool:
            nonlocal buf, eof, consumed
            if eof:
                return False
            try:
                piece = await ait.__anext__()
            except StopAsyncIteration:
                eof = True
                return False
            consumed += len(piece)
            if consumed > max_total:
                raise HTTPError(413, "File exceeds upload size limit")
            buf += piece
            return True

        async def require(n: int):
            while len(buf) < n:
                if not await fill():
                    raise HTTPError(400, "Truncated multipart body")

        try:
            # preamble: scan to the first delimiter
            while True:
                i = buf.find(delim)
                if i >= 0:
                    buf = buf[i + len(delim):]
                    break
                buf = buf[-(len(delim) - 1):] if len(buf) >= len(delim) \
                    else buf
                if not await fill():
                    raise HTTPError(400, "Malformed multipart body")

            while True:
                await require(2)
                if buf[:2] == b"--":          # closing delimiter
                    break
                if buf[:2] != b"\r\n":
                    raise HTTPError(400, "Malformed multipart body")
                buf = buf[2:]
                # part headers
                while b"\r\n\r\n" not in buf:
                    if len(buf) > MAX_HEADER_BYTES:
                        raise HTTPError(431, "Part headers too large")
                    if not await fill():
                        raise HTTPError(400, "Truncated multipart body")
                head, buf = buf.split(b"\r\n\r\n", 1)
                hdrs: dict[str, str] = {}
                for line in head.decode("latin-1").split("\r\n"):
                    k, _, v = line.partition(":")
                    hdrs[k.strip().lower()] = v.strip()
                disp = hdrs.get("content-disposition", "")
                name_m = re.search(r'name="([^"]*)"', disp)
                file_m = re.search(r'filename="([^"]*)"', disp)
                name = name_m.group(1) if name_m else ""
                part_type = hdrs.get("content-type",
                                     "application/octet-stream")
                part_type = part_type.split(";")[0].strip().lower()

                marker = b"\r\n" + delim
                is_file = file_m is not None
                if is_file and allowed_file_types is not None and \
                        part_type not in allowed_file_types:
                    raise HTTPError(
                        415, f"Content type {part_type!r} not allowed")
                sink_fd = None
                sink_path = ""
                size = 0
                head_acc = b""
                field_acc = b""
                if is_file and name:
                    _os.makedirs(spool_dir, exist_ok=True)
                    sink_fd, sink_path = _tempfile.mkstemp(
                        dir=spool_dir, prefix="part-")
                    _os.fchmod(sink_fd, 0o600)
                    spooled_paths.append(sink_path)

                def emit(data: bytes):
                    nonlocal size, head_acc, field_acc
                    if not data:
                        return
                    size += len(data)
                    if is_file:
                        if size > max_file_bytes:
                            raise HTTPError(
                                413, "File exceeds upload size limit")
                        if len(head_acc) < head_bytes:
                            head_acc += data[:head_bytes - len(head_acc)]
                        if sink_fd is not None:
                            _os.write(sink_fd, data)
                    else:
                        if size > max_field_bytes:
                            raise HTTPError(413, "Form field too large")
                        field_acc += data

                try:
                    while True:
                        i = buf.find(marker)
                        if i >= 0:
                            emit(buf[:i])
                            buf = buf[i + len(marker):]
                            break
                        keep = len(marker) - 1
                        if len(buf) > keep:
                            emit(buf[:-keep])
                            buf = buf[-keep:]
                        if not await fill():
                            raise HTTPError(400,
                                            "Truncated multipart body")
                finally:
                    if sink_fd is not None:
                        _os.close(sink_fd)
                if is_file and name:
                    if name in files:  # duplicate form name: the first
                        files[name].cleanup()  # spool would leak
                    files[name] = SpooledFile(
                        filename=file_m.group(1), content_type=part_type,
                        path=sink_path, size=size, head=head_acc)
                elif name:
                    fields[name] = field_acc.decode("utf-8", "replace")
            return fields, files
        except BaseException:
            for p in spooled_paths:
                try:
                    _os.unlink(p)
                except OSError:
                    pass
            raise

    def multipart(self) -> tuple[dict[str, str], dict[str, UploadedFile]]:
        """Parse multipart/form-data into (fields, files)."""
        if self.body is None:
            raise HTTPError(400, "Request body not loaded")
        ctype = self.headers.get("content-type", "")
        if "multipart/form-data" not in ctype:
            raise HTTPError(415, "Expected multipart/form-data")
        header = f"Content-Type: {ctype}\r\n\r\n".encode()
        msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
            header + self.body)
        fields: dict[str, str] = {}
        files: dict[str, UploadedFile] = {}
        if not msg.is_multipart():
            raise HTTPError(400, "Malformed multipart body")
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            if not name:
                continue
            filename = part.get_filename()
            payload = part.get_payload(decode=True) or b""
            if filename is not None:
                files[name] = UploadedFile(
                    filename=filename,
                    content_type=part.get_content_type(),
                    data=payload)
            else:
                fields[name] = payload.decode("utf-8", "replace")
        return fields, files


class Response:
    def __init__(self, body: Any = b"", status: int = 200,
                 headers: dict[str, str] | None = None,
                 content_type: str | None = None):
        self.status = status
        self.headers = dict(headers or {})
        if isinstance(body, (dict, list)):
            self.body = json.dumps(body).encode()
            content_type = content_type or "application/json"
        elif isinstance(body, str):
            self.body = body.encode()
            content_type = content_type or "text/plain; charset=utf-8"
        elif body is None:
            self.body = b""
        else:
            self.body = bytes(body)
        if content_type:
            self.headers.setdefault("content-type", content_type)

    def json(self) -> Any:
        return json.loads(self.body)

    @property
    def text(self) -> str:
        return self.body.decode("utf-8", "replace")


class StreamingResponse(Response):
    """Response whose body is an async byte iterator (used for SSE).

    ``stats_hook``: optional callable receiving, after the stream ends,
    ``{"gen_wait_s", "client_write_s", "chunks", "bytes"}`` — the
    server-side decomposition of a stream's wall time into waiting on
    the generator (engine/pump) vs writing+draining to the client
    socket (flow control). The runtime stays app-agnostic; the chat
    route plugs its metrics in here.
    """

    def __init__(self, iterator: AsyncIterator[bytes], status: int = 200,
                 headers: dict[str, str] | None = None,
                 content_type: str = "text/event-stream",
                 stats_hook=None):
        super().__init__(b"", status=status, headers=headers,
                         content_type=content_type)
        self.iterator = iterator
        self.stats_hook = stats_hook
        self.headers.setdefault("cache-control", "no-cache")


def sse_frame(event: dict | str, *, comment: bool = False) -> bytes:
    """Encode one SSE frame (``data: {...}\\n\\n`` or ``: keepalive``)."""
    if comment:
        return f": {event}\n\n".encode()
    data = event if isinstance(event, str) else json.dumps(event)
    return f"data: {data}\n\n".encode()


Handler = Callable[[Request], Awaitable[Response]]
Middleware = Callable[[Request, Handler], Awaitable[Response]]

_PARAM_RE = re.compile(r"{([a-zA-Z_][a-zA-Z0-9_]*)}")


def _compile_pattern(path: str) -> re.Pattern:
    pattern = _PARAM_RE.sub(lambda m: f"(?P<{m.group(1)}>[^/]+)", path)
    return re.compile(f"^{pattern}$")


class App:
    def __init__(self):
        self._routes: list[tuple[str, re.Pattern, str, Handler]] = []
        self._middleware: list[Middleware] = []
        self._exception_handler: Callable[[Request, Exception], Response] | None = None
        self.on_startup: list[Callable[[], Any]] = []
        self.on_shutdown: list[Callable[[], Any]] = []
        self.state: dict[str, Any] = {}

    # -- registration ------------------------------------------------------
    def route(self, method: str, path: str):
        def deco(fn: Handler) -> Handler:
            self._routes.append((method.upper(), _compile_pattern(path), path, fn))
            return fn
        return deco

    def get(self, path: str):
        return self.route("GET", path)

    def post(self, path: str):
        return self.route("POST", path)

    def delete(self, path: str):
        return self.route("DELETE", path)

    def patch(self, path: str):
        return self.route("PATCH", path)

    def put(self, path: str):
        return self.route("PUT", path)

    def middleware(self, fn: Middleware) -> Middleware:
        self._middleware.append(fn)
        return fn

    def exception_handler(self, fn):
        self._exception_handler = fn
        return fn

    # -- dispatch ----------------------------------------------------------
    def _match(self, method: str, path: str) -> tuple[Handler, dict[str, str]]:
        allowed: set[str] = set()
        for m, pat, _raw, fn in self._routes:
            match = pat.match(path)
            if match:
                if m == method:
                    return fn, match.groupdict()
                allowed.add(m)
        if allowed:
            raise HTTPError(405, "Method Not Allowed",
                            headers={"allow": ", ".join(sorted(allowed))})
        raise HTTPError(404, "Not Found")

    async def handle(self, request: Request) -> Response:
        async def terminal(req: Request) -> Response:
            fn, params = self._match(req.method, req.path)
            req.path_params = params
            return await fn(req)

        handler = terminal
        for mw in reversed(self._middleware):
            handler = (lambda mw, nxt: lambda req: mw(req, nxt))(mw, handler)
        try:
            return await handler(request)
        except HTTPError as e:
            return Response({"detail": e.detail}, status=e.status,
                            headers=e.headers)
        except Disconnected:
            raise
        except Exception as e:  # noqa: BLE001 — global exception boundary
            if self._exception_handler is not None:
                return self._exception_handler(request, e)
            traceback.print_exc()
            return Response({"detail": "Internal Server Error"}, status=500)

    async def startup(self):
        for fn in self.on_startup:
            r = fn()
            if asyncio.iscoroutine(r):
                await r

    async def shutdown(self):
        for fn in self.on_shutdown:
            r = fn()
            if asyncio.iscoroutine(r):
                await r


# ---------------------------------------------------------------------------
# Socket server
# ---------------------------------------------------------------------------

async def _read_request(reader: asyncio.StreamReader,
                        client: tuple[str, int],
                        max_body: int) -> Request | None:
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    except asyncio.LimitOverrunError:
        raise HTTPError(431, "Headers too large") from None
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, target, _version = lines[0].split(" ", 2)
    except ValueError:
        raise HTTPError(400, "Malformed request line") from None
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    if "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError:
            raise HTTPError(400, "Bad Content-Length") from None
        if n > max_body:
            raise HTTPError(413, "Payload Too Large")
    # body is NOT read here: handlers/middleware pull it lazily via
    # Request.read_body()/iter_raw()/stream_multipart() so upload routes
    # never buffer large payloads in RAM (reference streams 1 MiB chunks,
    # reference uploads.py:157-193)
    has_body = "content-length" in headers and int(
        headers["content-length"]) > 0
    has_body = has_body or headers.get("transfer-encoding",
                                       "").lower() == "chunked"
    return Request(method, target, headers,
                   body=None if has_body else b"",
                   client=client, reader=reader if has_body else None)


def _response_head(resp: Response, *, chunked: bool) -> bytes:
    phrase = STATUS_PHRASES.get(resp.status, "Unknown")
    lines = [f"HTTP/1.1 {resp.status} {phrase}"]
    headers = dict(resp.headers)
    if chunked:
        headers["transfer-encoding"] = "chunked"
    else:
        headers["content-length"] = str(len(resp.body))
    headers.setdefault("date", time.strftime(
        "%a, %d %b %Y %H:%M:%S GMT", time.gmtime()))
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


async def _connection(app: App, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter, max_body: int):
    peer = writer.get_extra_info("peername") or ("", 0)
    client = (peer[0], peer[1]) if isinstance(peer, tuple) and len(peer) >= 2 \
        else ("", 0)
    try:
        while True:
            try:
                request = await _read_request(reader, client, max_body)
            except HTTPError as e:
                err = Response({"detail": e.detail}, status=e.status)
                writer.write(_response_head(err, chunked=False) + err.body)
                await writer.drain()
                return
            if request is None:
                return
            resp = await app.handle(request)
            keep_alive = request.headers.get("connection", "").lower() != "close"
            if not request.body_consumed:
                # the handler never drained the body (e.g. an early 4xx
                # on a streaming upload): the socket is mid-payload, so
                # the connection cannot be reused
                keep_alive = False
            if isinstance(resp, StreamingResponse):
                writer.write(_response_head(resp, chunked=True))
                await writer.drain()
                t_gen = t_write = 0.0
                n_chunks = n_bytes = 0
                try:
                    ait = resp.iterator.__aiter__()
                    while True:
                        t0 = time.perf_counter()
                        try:
                            chunk = await ait.__anext__()
                        except StopAsyncIteration:
                            t_gen += time.perf_counter() - t0
                            break
                        t_gen += time.perf_counter() - t0
                        if not chunk:
                            continue
                        t0 = time.perf_counter()
                        writer.write(f"{len(chunk):x}\r\n".encode()
                                     + chunk + b"\r\n")
                        await writer.drain()
                        t_write += time.perf_counter() - t0
                        n_chunks += 1
                        n_bytes += len(chunk)
                    writer.write(b"0\r\n\r\n")
                    await writer.drain()
                    if resp.stats_hook is not None:
                        try:
                            resp.stats_hook({
                                "gen_wait_s": t_gen,
                                "client_write_s": t_write,
                                "chunks": n_chunks, "bytes": n_bytes})
                        except Exception:  # noqa: BLE001 — observability
                            pass
                except (ConnectionResetError, BrokenPipeError):
                    # client went away mid-stream: close the generator so
                    # its finally-block finalizers run (cost ledger,
                    # message persistence — reference logs failed streams,
                    # chat.py:653-788)
                    aclose = getattr(resp.iterator, "aclose", None)
                    if aclose is not None:
                        try:
                            await aclose()
                        except Exception:  # noqa: BLE001 — teardown
                            pass
                    return
            else:
                writer.write(_response_head(resp, chunked=False) + resp.body)
                await writer.drain()
            if not keep_alive:
                return
    except (ConnectionResetError, BrokenPipeError,
            asyncio.IncompleteReadError, Disconnected):
        pass
    finally:
        try:
            writer.close()
            await writer.wait_closed()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass


async def serve(app: App, host: str = "127.0.0.1", port: int = 8000,
                *, max_body: int = DEFAULT_MAX_BODY,
                ready: asyncio.Event | None = None,
                stop: asyncio.Event | None = None,
                reuse_port: bool = False):
    await app.startup()
    server = await asyncio.start_server(
        lambda r, w: _connection(app, r, w, max_body), host, port,
        limit=MAX_HEADER_BYTES, reuse_port=reuse_port or None)
    if ready is not None:
        ready.set()
    try:
        if stop is None:
            async with server:
                await server.serve_forever()
        else:
            async with server:
                await stop.wait()
    finally:
        await app.shutdown()


# ---------------------------------------------------------------------------
# In-process test client
# ---------------------------------------------------------------------------

class ClientResponse:
    def __init__(self, status: int, headers: dict[str, str], body: bytes):
        self.status_code = status
        self.headers = headers
        self.body = body

    def json(self) -> Any:
        return json.loads(self.body)

    @property
    def text(self) -> str:
        return self.body.decode("utf-8", "replace")

    def iter_sse(self):
        """Yield decoded SSE data payloads (skips comments/keepalives)."""
        for raw in self.text.split("\n\n"):
            for line in raw.split("\n"):
                if line.startswith("data: "):
                    yield line[len("data: "):]


class TestClient:
    """Synchronous in-process client driving ``App.handle`` directly.

    Runs a private event loop on a background thread so sync test code can
    exercise async handlers, mirroring Starlette's TestClient ergonomics
    (used throughout the reference's tests,
    backend/tests/conftest.py:164-198).
    """

    __test__ = False  # not a pytest test class

    def __init__(self, app: App, base_headers: dict[str, str] | None = None):
        self.app = app
        self.base_headers = base_headers or {}
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, daemon=True)
        self._thread.start()
        self._run(app.startup())

    def close(self):
        self._run(self.app.shutdown())
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(120)

    def request(self, method: str, path: str, *, json_body: Any = None,
                data: dict[str, str] | None = None,
                files: dict[str, tuple[str, bytes, str]] | None = None,
                headers: dict[str, str] | None = None,
                body: bytes | None = None) -> ClientResponse:
        hdrs = {**self.base_headers, **(headers or {})}
        payload = b""
        if json_body is not None:
            payload = json.dumps(json_body).encode()
            hdrs.setdefault("content-type", "application/json")
        elif files is not None or data is not None:
            boundary = "ragtpuboundary1234567890"
            parts = []
            for k, v in (data or {}).items():
                parts.append(
                    f"--{boundary}\r\nContent-Disposition: form-data; "
                    f"name=\"{k}\"\r\n\r\n{v}\r\n".encode())
            for k, (fname, blob, ctype) in (files or {}).items():
                parts.append(
                    f"--{boundary}\r\nContent-Disposition: form-data; "
                    f"name=\"{k}\"; filename=\"{fname}\"\r\n"
                    f"Content-Type: {ctype}\r\n\r\n".encode() + blob + b"\r\n")
            parts.append(f"--{boundary}--\r\n".encode())
            payload = b"".join(parts)
            hdrs["content-type"] = f"multipart/form-data; boundary={boundary}"
        elif body is not None:
            payload = body
        hdrs.setdefault("host", "testserver")
        req = Request(method, path, hdrs, payload, client=("127.0.0.1", 0))
        resp = self._run(self._collect(req))
        return resp

    async def _collect(self, req: Request) -> ClientResponse:
        resp = await self.app.handle(req)
        body = resp.body
        if isinstance(resp, StreamingResponse):
            out = []
            async for chunk in resp.iterator:
                out.append(chunk)
            body = b"".join(out)
        return ClientResponse(resp.status, dict(resp.headers), body)

    def get(self, path, **kw):
        return self.request("GET", path, **kw)

    def post(self, path, **kw):
        return self.request("POST", path, **kw)

    def delete(self, path, **kw):
        return self.request("DELETE", path, **kw)

    def patch(self, path, **kw):
        return self.request("PATCH", path, **kw)

    def put(self, path, **kw):
        return self.request("PUT", path, **kw)
