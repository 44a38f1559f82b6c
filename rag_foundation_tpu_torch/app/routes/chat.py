"""Chat SSE route — the read/hot path.

Reference parity: backend/app/routes/chat.py (1270 lines).
The SSE wire contract is preserved verbatim as the product surface
(SURVEY.md §3.2): ``start -> text-start -> text-delta* -> text-end ->
source-document* -> finish -> [DONE]`` with ``error``/``budget_exceeded``
frames and ``: keepalive`` comments, under the
``x-vercel-ai-ui-message-stream: v1`` header. Internals are rebuilt: the
"provider" is the port's engine (in process or over its RPC socket); the
sync engine iterator is
pumped by a daemon thread through a bounded queue (backpressure surfaces
as an explicit error frame, reference chat.py:486-520), with retry-on-
transient suppressed after the first delta (chat.py:1076-1128) and a
mid-stream budget cut-off (chat.py:1036-1049).
"""

from __future__ import annotations

import asyncio
import functools
import logging
import queue as queue_mod
import threading
import time
import uuid
from decimal import Decimal

from rag_foundation_tpu_torch.app import metrics
from rag_foundation_tpu_torch.app import validation as v
from rag_foundation_tpu_torch.app.routes._params import (
    int_param, json_object)
from rag_foundation_tpu_torch.app.auth import get_current_user
from rag_foundation_tpu_torch.app.costs import (calc_query_cost,
                                                check_budget_or_402,
                                                record_query_cost,
                                                remaining_budget,
                                                require_pricing_configured)
from rag_foundation_tpu_torch.app.services.rag import RagError
from rag_foundation_tpu_torch.app.telemetry import log_json
from rag_foundation_tpu_torch.app.tenant import require_stores_owned_by_user
from rag_foundation_tpu_torch.runtime.http import (HTTPError, Response,
                                                   StreamingResponse, sse_frame)


_INT_LIST = v.optional(v.list_of(v.to_int))
_ANY = (lambda value, loc: value, None)


class ChatRequest:
    """Accepts snake_case and camelCase aliases (reference:
    chat.py:65-108). The JAX route's pydantic model as a plain parser:
    the same fields, coerced as pydantic's lax mode does, other keys
    ignored; a rejected field raises ``FieldError`` (the route answers
    422 with its message, as with pydantic's first error)."""

    FIELDS = {
        "question": (v.optional(v.to_str), None),
        "messages": (v.optional(v.list_of(
            lambda value, loc: v.to_dict(value, loc))), None),
        "store_ids": (_INT_LIST, None),
        "storeIds": (_INT_LIST, None),
        "model": (v.optional(v.to_str), None),
        "session_id": (v.optional(v.to_int), None),
        "sessionId": (v.optional(v.to_int), None),
        "document_ids": (_INT_LIST, None),
        "documentIds": (_INT_LIST, None),
        "top_k": (v.optional(v.to_int), None),
        "topK": (v.optional(v.to_int), None),
        # validated by sanitize_tags / validate_metadata_filter (400s
        # with reference-parity messages, not 422s)
        "tags": _ANY,
        "metadata_filter": _ANY,
        "metadataFilter": _ANY,
    }

    def __init__(self, /, **payload):
        values, errors = v.parse_fields(payload, self.FIELDS)
        if errors:
            raise errors[0]
        self.__dict__.update(values)

    @property
    def resolved_store_ids(self) -> list[int]:
        return self.store_ids if self.store_ids is not None \
            else (self.storeIds or [])

    @property
    def resolved_session_id(self) -> int | None:
        return self.session_id if self.session_id is not None \
            else self.sessionId

    @property
    def resolved_document_ids(self) -> list[int] | None:
        return self.document_ids if self.document_ids is not None \
            else self.documentIds

    @property
    def resolved_top_k(self) -> int | None:
        return self.top_k if self.top_k is not None else self.topK

    @property
    def resolved_metadata_filter(self) -> dict | None:
        return self.metadata_filter if self.metadata_filter is not None \
            else self.metadataFilter


_SAFE_META_VALUES = (str, int, float, bool)


def sanitize_tags(raw) -> dict[str, str] | None:
    """Request tags for the cost ledger: <=5 entries, keys <=32 chars,
    scalar values stringified <=128 (reference: chat.py:251-265)."""
    if raw is None:
        return None
    if not isinstance(raw, dict):
        raise HTTPError(400, "tags must be an object")
    cleaned: dict[str, str] = {}
    for key, value in raw.items():
        if len(cleaned) >= 5:
            break
        if not isinstance(key, str) or not key.strip():
            continue
        if isinstance(value, _SAFE_META_VALUES):
            cleaned[key.strip()[:32]] = str(value)[:128]
    return cleaned or None


def _coerce_meta_value(key: str, value):
    if isinstance(value, _SAFE_META_VALUES):
        return [value[:256] if isinstance(value, str) else value]
    if isinstance(value, list):
        out = []
        for item in value:
            if not isinstance(item, _SAFE_META_VALUES):
                raise HTTPError(400, "metadataFilter values must be"
                                " strings, numbers, booleans, or lists"
                                " of those")
            out.append(item[:256] if isinstance(item, str) else item)
        if not out:
            raise HTTPError(400, "metadataFilter lists must include at"
                            " least one value")
        return out
    raise HTTPError(400, f"Invalid metadataFilter value for {key!r}")


def validate_metadata_filter(raw, settings) -> dict | None:
    """Allowlist-enforced metadata filter (reference: chat.py:296-335):
    only simple scalar/list values, only configured keys, only when the
    deployment opted in. Values normalize to OR-lists per key; keys AND."""
    if raw is None:
        return None
    if not settings.ALLOW_METADATA_FILTERS:
        raise HTTPError(400,
                        "Metadata filters are disabled on this deployment.")
    if not isinstance(raw, dict):
        raise HTTPError(400, "metadataFilter must be an object")
    allowed = settings.METADATA_FILTER_ALLOWED_KEYS or []
    if not allowed:
        raise HTTPError(400, "Metadata filters require"
                        " METADATA_FILTER_ALLOWED_KEYS to be configured.")
    cleaned: dict = {}
    for key, value in raw.items():
        if not isinstance(key, str) or not key.strip():
            raise HTTPError(400,
                            "metadataFilter keys must be non-empty strings")
        nkey = key.strip()
        if nkey not in allowed:
            raise HTTPError(400,
                            f"metadataFilter key {nkey!r} is not allowed")
        cleaned[nkey] = _coerce_meta_value(nkey, value)
    if not cleaned:
        raise HTTPError(400,
                        "metadataFilter must include at least one"
                        " allowed key")
    return cleaned


class _Backpressure(RuntimeError):
    pass


def _extract_question(body: ChatRequest, max_len: int) -> str:
    """Last user message text from AssistantUI messages, or ``question``
    (reference: chat.py:120-172)."""
    text = ""
    if body.messages:
        for msg in reversed(body.messages):
            if msg.get("role") != "user":
                continue
            content = msg.get("content")
            if isinstance(content, str):
                text = content
            elif isinstance(content, list):
                text = " ".join(
                    p.get("text", "") for p in content
                    if isinstance(p, dict) and p.get("type") == "text")
            break
    if not text and body.question:
        text = body.question
    text = (text or "").strip()
    if not text:
        raise HTTPError(422, "No question provided")
    if len(text) > max_len:
        raise HTTPError(422, f"Question exceeds {max_len} characters")
    return text


def _history_from_messages(body: ChatRequest, settings) -> list[dict]:
    """Prior turns, newest-kept, char-budget trimmed (reference:
    chat.py:182-223): cap turns, drop oldest past the char budget, and
    truncate the oldest included message rather than losing the newest."""
    msgs = []
    for msg in (body.messages or [])[:-1]:
        role = msg.get("role")
        if role not in ("user", "assistant"):
            continue
        content = msg.get("content")
        if isinstance(content, list):
            content = " ".join(p.get("text", "") for p in content
                               if isinstance(p, dict)
                               and p.get("type") == "text")
        if isinstance(content, str) and content:
            msgs.append({"role": role, "content": content})
    msgs = msgs[-settings.HISTORY_MAX_TURNS:]
    budget = settings.HISTORY_CHAR_BUDGET
    kept: list[dict] = []
    used = 0
    for msg in reversed(msgs):
        n = len(msg["content"])
        if used + n > budget:
            room = budget - used
            if room > 50:
                kept.append({"role": msg["role"],
                             "content": msg["content"][-room:]})
            break
        kept.append(msg)
        used += n
    return list(reversed(kept))


def _sse_error(code: str, message: str, status: int | None = None) -> bytes:
    payload = {"type": "error", "code": code, "message": message,
               "errorText": message}
    if status is not None:
        payload["status"] = status
    return sse_frame(payload)


def _finish_frame(prompt_tokens: int, completion_tokens: int,
                  model: str) -> bytes:
    return sse_frame({
        "type": "finish", "finishReason": "stop",
        "promptTokens": prompt_tokens,
        "completionTokens": completion_tokens,
        "usage": {"prompt_tokens": prompt_tokens,
                  "completion_tokens": completion_tokens, "model": model},
    })


def _citation_frames(citations: list[dict]) -> list[bytes]:
    return [sse_frame({
        "type": "source-document",
        "sourceId": f"cit-{c['index']}",
        "mediaType": "file",
        "title": c.get("title") or c.get("uri") or "Source",
        "snippet": c.get("snippet"),
    }) for c in citations]


def _ensure_session(db, user_id: int, store_id: int | None,
                    session_id: int | None, question: str) -> int:
    now = time.time()
    if session_id is not None:
        row = db.one(
            "SELECT id FROM chat_sessions WHERE id=? AND user_id=?",
            (session_id, user_id))
        if row is None:
            raise HTTPError(404, "Session not found")
        db.execute("UPDATE chat_sessions SET updated_at=? WHERE id=?",
                   (now, session_id))
        return session_id
    title = question[:80]
    return db.execute(
        "INSERT INTO chat_sessions(user_id, store_id, title, created_at,"
        " updated_at) VALUES(?,?,?,?,?)",
        (user_id, store_id, title, now, now))


def _persist_message(db, session_id: int, user_id: int, role: str,
                     content: str) -> None:
    db.execute(
        "INSERT INTO chat_history(session_id, user_id, role, content,"
        " created_at) VALUES(?,?,?,?,?)",
        (session_id, user_id, role, content, time.time()))


def _pump(delta_iter, out_q: queue_mod.Queue, stop: threading.Event,
          queue_timeout_s: float = 5.0):
    """Producer thread: drain the sync engine iterator into the bounded
    queue; a full queue means the consumer stalled -> backpressure error
    (reference: chat.py:486-520)."""
    def put_terminal(item):
        # terminal markers must ALWAYS land: drop buffered chunks under
        # the queue mutex (a bare deque.clear() raced the consumer's
        # popleft into an IndexError) and never block forever (a
        # disconnected consumer would leak this thread)
        for _ in range(2):
            try:
                out_q.put(item, timeout=queue_timeout_s)
                return
            except queue_mod.Full:
                with out_q.mutex:
                    out_q.queue.clear()
        # consumer gone and queue wedged: give up quietly

    try:
        for delta in delta_iter:
            if stop.is_set():
                return
            try:
                out_q.put(("chunk", delta), timeout=queue_timeout_s)
            except queue_mod.Full:
                put_terminal(
                    ("error", _Backpressure("stream backpressure")))
                return
        put_terminal(("end", None))
    except Exception as e:  # noqa: BLE001 — cross-thread error channel
        put_terminal(("error", e))


def register(app, ctx):
    settings, db = ctx.settings, ctx.db

    @app.post("/api/chat")
    async def chat_stream(req):
        t_pre = time.perf_counter()
        user = get_current_user(req, db, ctx.kv, settings)
        try:
            body = ChatRequest(**json_object(req))
        except v.FieldError as e:
            raise HTTPError(422, e.msg) from None
        store_ids = body.resolved_store_ids
        stores = require_stores_owned_by_user(db, store_ids, user.id)
        question = _extract_question(body, settings.MAX_QUESTION_LENGTH)
        history = _history_from_messages(body, settings)
        ctx.limiter.check(f"user:{user.id}:chat",
                          settings.RATE_LIMIT_CHAT_PER_MIN)
        model = body.model or settings.DEFAULT_MODEL
        if model not in settings.ALLOWED_MODELS:
            raise HTTPError(422, f"Model {model!r} not allowed")
        top_k = body.resolved_top_k
        if top_k is not None and not 1 <= top_k <= 20:
            raise HTTPError(422, "top_k must be between 1 and 20")
        require_pricing_configured(settings, model)
        # budget pre-check with hold (reference: chat.py:916-935)
        remaining = check_budget_or_402(db, user.id, settings)

        # document filter: allowlist-validated against the selected
        # stores (metadata-filter sanitization analog, reference
        # chat.py:250-335)
        doc_filter = None
        doc_ids = body.resolved_document_ids
        if doc_ids is not None:
            if not doc_ids or len(doc_ids) > 50:
                raise HTTPError(422, "document_ids must list 1-50 ids")
            allowed_store_ids = {s["id"] for s in stores}
            doc_filter = set()
            for did in doc_ids:
                row = db.one(
                    "SELECT id, store_id, engine_doc_id FROM documents"
                    " WHERE id=? AND user_id=? AND deleted_at IS NULL",
                    (int(did), user.id))
                if row is None or row["store_id"] not in allowed_store_ids:
                    raise HTTPError(404, "Document not found")
                doc_filter.add(row["engine_doc_id"] or f"doc-{row['id']}")

        tags = sanitize_tags(body.tags)
        meta_filter = validate_metadata_filter(
            body.resolved_metadata_filter, settings)

        metrics.chat_stage_seconds.labels("preamble").observe(
            time.perf_counter() - t_pre)
        t_sess = time.perf_counter()
        session_id = _ensure_session(
            db, user.id, stores[0]["id"], body.resolved_session_id, question)
        _persist_message(db, session_id, user.id, "user", question)
        metrics.chat_stage_seconds.labels("session").observe(
            time.perf_counter() - t_sess)
        engine_keys = [s["engine_key"] for s in stores]
        message_id = f"msg-{uuid.uuid4().hex[:12]}"
        text_id = f"txt-{uuid.uuid4().hex[:12]}"

        async def generator():
            sem = ctx.stream_semaphore
            acquired = False
            if sem is not None:
                try:
                    await asyncio.wait_for(
                        sem.acquire(),
                        timeout=settings.STREAM_SEMAPHORE_TIMEOUT_S)
                    acquired = True
                except asyncio.TimeoutError:
                    yield _sse_error("capacity", "Server is at capacity,"
                                     " try again shortly", 503)
                    yield sse_frame("[DONE]")
                    return
            t_start = time.perf_counter()
            answer_parts: list[str] = []
            prompt_tokens = 0
            completion_tokens = 0
            citations: list[dict] = []
            status = "ok"
            try:
                yield sse_frame({"type": "start", "messageId": message_id})
                yield sse_frame({"type": "text-start", "id": text_id})
                emitted = False
                attempts = max(1, settings.STREAM_RETRY_ATTEMPTS)
                for attempt in range(attempts):
                    t_eng = time.perf_counter()
                    try:
                        deltas, result = await asyncio.to_thread(
                            functools.partial(
                                ctx.rag.ask_stream, question, engine_keys,
                                model=model, history=history,
                                top_k=top_k, doc_filter=doc_filter,
                                metadata_filter=meta_filter))
                        metrics.chat_stage_seconds.labels(
                            "engine").observe(time.perf_counter() - t_eng)
                    except RagError as e:
                        if attempt + 1 < attempts:
                            continue  # retry-on-transient
                        # scrubbed client message; detail stays in logs
                        # (reference: redact_llm_error, genai.py:109-122)
                        log_json(logging.ERROR, "stream_engine_error",
                                 error=type(e).__name__)
                        yield _sse_error("upstream",
                                         "Retrieval engine error", 502)
                        yield sse_frame("[DONE]")
                        status = "error"
                        return
                    # available as soon as the search ran: every early
                    # return below (budget cut, backpressure, error,
                    # disconnect) must still bill the prompt cost —
                    # leaving this 0 until success under-recorded the
                    # ledger on exactly the cut-off paths
                    prompt_tokens = result.prompt_tokens
                    # tests inject a queue factory to drive keepalive /
                    # backpressure paths deterministically (the reference
                    # freezes time instead; conftest.py:246-313)
                    make_q = ctx.extra.get("stream_queue_factory")
                    out_q: queue_mod.Queue = (
                        make_q(settings.STREAM_QUEUE_MAX) if make_q
                        else queue_mod.Queue(
                            maxsize=settings.STREAM_QUEUE_MAX))
                    stop = threading.Event()
                    producer = threading.Thread(
                        target=_pump, args=(deltas, out_q, stop), daemon=True)
                    producer.start()
                    failed_mid = False
                    try:
                        while True:
                            try:
                                kind, payload = await asyncio.to_thread(
                                    out_q.get, True,
                                    settings.STREAM_KEEPALIVE_S)
                            except queue_mod.Empty:
                                yield sse_frame(
                                    f"keepalive {int(time.time())}",
                                    comment=True)
                                continue
                            if kind == "end":
                                break
                            if kind == "error":
                                if isinstance(payload, _Backpressure):
                                    yield _sse_error(
                                        "backpressure",
                                        "Client not consuming stream", 429)
                                    status = "error"
                                    yield sse_frame("[DONE]")
                                    return
                                if isinstance(payload, RagError) \
                                        and not emitted \
                                        and attempt + 1 < attempts:
                                    failed_mid = True
                                    break
                                yield _sse_error(
                                    "upstream", "Stream failed", 502)
                                status = "error"
                                yield sse_frame("[DONE]")
                                return
                            delta = payload
                            emitted = True
                            answer_parts.append(delta)
                            completion_tokens += max(1, len(delta) // 4)
                            # mid-stream budget cut-off (chat.py:1036-1049)
                            if remaining is not None:
                                cost = calc_query_cost(
                                    settings, model,
                                    result.prompt_tokens,
                                    completion_tokens).total_cost_usd
                                if cost > remaining:
                                    yield sse_frame(
                                        {"type": "budget_exceeded",
                                         "message": "Monthly budget"
                                         " exhausted mid-stream"})
                                    status = "over_budget"
                                    stop.set()
                                    yield sse_frame("[DONE]")
                                    return
                            yield sse_frame({"type": "text-delta",
                                             "id": text_id, "delta": delta})
                    finally:
                        stop.set()
                    if not failed_mid:
                        prompt_tokens = result.prompt_tokens
                        citations = result.citations
                        break
                yield sse_frame({"type": "text-end", "id": text_id})
                for frame in _citation_frames(citations):
                    yield frame
                yield _finish_frame(prompt_tokens, completion_tokens, model)
                yield sse_frame("[DONE]")
                metrics.chat_stage_seconds.labels("stream").observe(
                    time.perf_counter() - t_start)
            finally:
                if acquired and sem is not None:
                    sem.release()
                t_fin = time.perf_counter()
                # finalize: usage + cost ledger + assistant persist
                # (reference: chat.py:653-788)
                try:
                    cost = calc_query_cost(settings, model, prompt_tokens,
                                           completion_tokens)
                    final_status = status
                    if status == "ok" and remaining is not None:
                        post = remaining_budget(db, user.id, settings)
                        if post is not None and \
                                post - cost.total_cost_usd < Decimal(0):
                            final_status = "over_budget"
                    # failed streams carry an error_code tag (reference:
                    # chat.py:613-636)
                    row_tags = dict(tags or {})
                    if final_status != "ok":
                        row_tags["error_code"] = final_status
                    record_query_cost(
                        db, user_id=user.id, store_id=stores[0]["id"],
                        model=model, prompt_tokens=prompt_tokens,
                        completion_tokens=completion_tokens,
                        cost_usd=cost.total_cost_usd, status=final_status,
                        tags=row_tags or None)
                    metrics.llm_tokens_total.labels(
                        "prompt", model).inc(prompt_tokens)
                    metrics.llm_tokens_total.labels(
                        "completion", model).inc(completion_tokens)
                    if answer_parts:
                        _persist_message(db, session_id, user.id,
                                         "assistant", "".join(answer_parts))
                    metrics.chat_stage_seconds.labels(
                        "finalize").observe(time.perf_counter() - t_fin)
                    log_json(logging.INFO, "chat_complete",
                             dur_ms=int((time.perf_counter() - t_start)
                                        * 1000),
                             status=status, model=model,
                             completion_tokens=completion_tokens)
                except Exception:  # noqa: BLE001 — never break the stream
                    log_json(logging.ERROR, "chat_finalize_failed")

        def stream_stats(st: dict) -> None:
            # decomposition of the "stream" stage (VERDICT r3 item 6):
            # generator wait (engine + pump) vs client write+drain
            # (socket flow control) — separable only at the writer loop
            metrics.chat_stage_seconds.labels("stream_gen_wait").observe(
                st["gen_wait_s"])
            metrics.chat_stage_seconds.labels(
                "stream_client_write").observe(st["client_write_s"])

        return StreamingResponse(generator(), headers={
            "x-vercel-ai-ui-message-stream": "v1",
            "x-session-id": str(session_id),
        }, stats_hook=stream_stats)

    # -- session listing (reference: chat.py:1230-1270) --------------------
    @app.get("/api/chat/sessions")
    async def list_sessions(req):
        user = get_current_user(req, db, ctx.kv, settings)
        rows = db.query(
            "SELECT id, store_id, title, created_at, updated_at FROM"
            " chat_sessions WHERE user_id=? ORDER BY updated_at DESC"
            " LIMIT 100", (user.id,))
        return Response({"sessions": [dict(r) for r in rows]})

    @app.delete("/api/chat/sessions/{session_id}")
    async def delete_session(req):
        """Delete a chat session + its history (reference thread
        persistence exposes thread deletion —
        frontend/src/hooks/useThreadPersistence.ts)."""
        user = get_current_user(req, db, ctx.kv, settings)
        sid = int_param(req, "session_id")
        if db.one("SELECT id FROM chat_sessions WHERE id=? AND user_id=?",
                  (sid, user.id)) is None:
            raise HTTPError(404, "Session not found")
        db.execute("DELETE FROM chat_history WHERE session_id=?", (sid,))
        db.execute("DELETE FROM chat_sessions WHERE id=?", (sid,))
        return Response({"deleted": sid})

    @app.get("/api/chat/sessions/{session_id}/messages")
    async def session_messages(req):
        user = get_current_user(req, db, ctx.kv, settings)
        sid = int_param(req, "session_id")
        if db.one("SELECT id FROM chat_sessions WHERE id=? AND user_id=?",
                  (sid, user.id)) is None:
            raise HTTPError(404, "Session not found")
        # newest window, returned oldest-first; unbounded sessions must
        # not grow the response without limit (VERDICT r1 weak #7)
        rows = db.query(
            "SELECT id, role, content, created_at FROM ("
            "  SELECT id, role, content, created_at FROM chat_history"
            "  WHERE session_id=? ORDER BY id DESC LIMIT 500"
            ") ORDER BY id", (sid,))
        return Response({"messages": [dict(r) for r in rows]})
