"""The port app's chat route against the JAX app's: the request sequences
of ``tests/test_app_chat.py`` and ``tests/test_sse_contract.py`` give the
same statuses, the same SSE frame sequences (answers, citations, token
counts; the message and text ids masked), the same sessions, messages
and ledger rows; the pydantic-free ``ChatRequest`` gives the 422 texts
pydantic gives the JAX route, for the bodies below."""

import json
import pathlib
import re

import pytest

from rag_foundation_tpu_torch.app.routes.chat import (ChatRequest,
                                                      _history_from_messages)
from rag_foundation_tpu_torch.app.validation import FieldError
from tests.test_torch_app_helpers import (App, build, mod, run_both,
                                         settings_for)

DOC_FIN = ("The quarterly revenue grew twelve percent driven by cloud "
           "subscriptions. Operating margin expanded to thirty percent "
           "while churn declined. " * 6)
DOC_PENG = ("Penguins are flightless seabirds living almost exclusively "
            "in the southern hemisphere, especially Antarctica. " * 6)


def _corpus(app):
    h = app.signup()
    sid = app.create_store(h)["id"]
    app.upload_text(h, sid, DOC_FIN, "finance.txt")
    app.upload_text(h, sid, DOC_PENG, "penguins.txt")
    app.drain()
    return h, sid


def _chat(app, h, body, note=""):
    r = app.see(app.client.post("/api/chat", headers=h, json_body=body),
                note)
    app.record.append(("headers", r.headers.get(
        "x-vercel-ai-ui-message-stream"), r.headers.get("x-session-id")))
    return r


def test_chat_streams_sessions_and_ledger(tmp_path):
    def scenario(app):
        h, sid = _corpus(app)
        for body in (
                {"question": "How did revenue grow?", "storeIds": [sid]},
                {"question": "Where do penguins live?", "store_ids": [sid]},
                {"question": "Where do penguins live?", "store_ids": [sid]},
                {"storeIds": [sid], "messages": [
                    {"role": "user", "content": [
                        {"type": "text", "text": "old question"}]},
                    {"role": "assistant", "content": "old answer"},
                    {"role": "user", "content": [
                        {"type": "text",
                         "text": "Where do penguins live?"}]}]},
                {"question": "Where do penguins live?", "store_ids": [sid],
                 "top_k": 1},
                {"question": "Where do penguins live?", "storeIds": [sid],
                 "topK": 4},
                {"question": "Where do penguins live?", "store_ids": [sid],
                 "documentIds": [1]},
                {"question": "hi", "store_ids": [sid],
                 "document_ids": [99999]},
                {"question": "What is the melting point of glass?",
                 "store_ids": [sid]},
                {"store_ids": [sid]},
                {"question": "x" * 40_000, "store_ids": [sid]},
                {"question": "hi", "store_ids": []},
                {"question": "hi", "store_ids": [sid],
                 "model": "not-a-model"},
                {"question": "hi", "store_ids": [sid], "top_k": 0},
                {"question": "hi", "store_ids": [sid], "tags": "x"},
                {"question": "hi", "store_ids": [sid],
                 "metadataFilter": {"doc_name": "a"}}):
            _chat(app, h, body, json.dumps(body)[:60])
        app.see(app.client.get("/api/chat/sessions", headers=h))
        app.see(app.client.get("/api/chat/sessions/1/messages", headers=h))
        _chat(app, h, {"question": "and revenue?", "store_ids": [sid],
                       "sessionId": 1})
        app.see(app.client.get("/api/chat/sessions/1/messages", headers=h))
        h2 = app.signup("other@example.com")
        app.see(app.client.get("/api/chat/sessions/1/messages", headers=h2))
        app.see(app.client.delete("/api/chat/sessions/1", headers=h2))
        app.see(app.client.delete("/api/chat/sessions/1", headers=h))
        app.see(app.client.get("/api/chat/sessions/1/messages", headers=h))
        ledger = [dict(r) for r in app.ctx.db.query(
            "SELECT model, prompt_tokens, completion_tokens, cost_usd,"
            " status, tags FROM query_log ORDER BY id")]
        uid = app.ctx.db.one("SELECT id FROM users WHERE email=?",
                             ("user@example.com",))["id"]
        app.ctx.db.execute(
            "INSERT INTO budgets(user_id, monthly_usd, updated_at)"
            " VALUES(?, '0.0000001', 0)", (uid,))
        _chat(app, h, {"question": "Where do penguins live?",
                       "store_ids": [sid]}, "budget spent")
        return ledger

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    streams = [e[2] for e in port
               if len(e) == 3 and e[0] != "headers" and e[1] == 200
               and isinstance(e[2], list) and e[2]
               and isinstance(e[2][0], dict) and "type" in e[2][0]]
    assert len(streams) >= 8
    for frames in streams:
        types = [f if f == "[DONE]" else f["type"] for f in frames]
        assert types[:2] == ["start", "text-start"]
        assert types[-2:] == ["finish", "[DONE]"]
    first = [f for f in streams[0] if f != "[DONE]"]
    assert first[-2]["type"] == "source-document"
    assert first[-2 - sum(f["type"] == "source-document"
                          for f in first) + 1]["title"] == "finance.txt"
    assert port[-3] == ("budget spent", 402, {
        "detail": "Monthly budget exhausted"})


def test_mock_mode_retry_and_mid_stream_budget_cut(tmp_path):
    pricing = {"ragtpu-retrieval-v1": {"input": "0", "output": "2000"},
               "INDEX": {"input": "0", "output": "0"}}

    def scenario(app):
        h = app.signup()
        sid = app.create_store(h)["id"]
        _chat(app, h, {"question": "hello there", "store_ids": [sid]})
        app.ctx.rag.stream_should_fail = True
        _chat(app, h, {"question": "hi", "store_ids": [sid]}, "fails")
        app.ctx.rag.stream_should_fail = False
        uid = app.ctx.db.one("SELECT id FROM users")["id"]
        app.ctx.db.execute("INSERT INTO budgets(user_id, monthly_usd,"
                           " updated_at) VALUES(?, '0.02', 0)", (uid,))
        StreamResult = mod(app.pkg, "app.services.rag").StreamResult

        def long_ask_stream(question, keys, **kw):
            def gen():
                for i in range(5000):
                    yield f"word{i} "
            return gen(), StreamResult(prompt_tokens=1)

        app.ctx.rag.ask_stream = long_ask_stream
        _chat(app, h, {"question": "hi", "store_ids": [sid]}, "cut")
        return [dict(r) for r in app.ctx.db.query(
            "SELECT prompt_tokens, completion_tokens, status, tags FROM"
            " query_log WHERE model != 'INDEX' ORDER BY id")]

    jax, port = run_both(tmp_path, scenario, MOCK_MODE=True,
                         STREAM_RETRY_ATTEMPTS=2, BUDGET_HOLD_USD="0",
                         MODEL_PRICING=pricing)
    assert port == jax
    mock_text = "".join(f.get("delta", "") for f in port[3][2]
                        if isinstance(f, dict))
    assert mock_text == "[mock-mode] hello there"
    assert [r["status"] for r in port[-1][1]] == ["ok", "error",
                                                  "over_budget"]


BODIES = [
    {}, {"question": 5}, {"question": None, "store_ids": [1]},
    {"question": "hi", "store_ids": "1"}, {"question": "hi",
                                           "store_ids": ["1"]},
    {"question": "hi", "store_ids": [1.0]}, {"question": "hi",
                                             "store_ids": [1.5]},
    {"question": "hi", "store_ids": ["a"]}, {"question": "hi",
                                             "store_ids": [None]},
    {"question": "hi", "store_ids": [True]}, {"question": "hi",
                                              "storeIds": {"a": 1}},
    {"question": "hi", "store_ids": [1], "top_k": "3"},
    {"question": "hi", "store_ids": [1], "topK": "x"},
    {"question": "hi", "store_ids": [1], "top_k": 2.5},
    {"question": "hi", "store_ids": [1], "top_k": 30},
    {"question": "hi", "store_ids": [1], "session_id": "abc"},
    {"question": "hi", "store_ids": [1], "sessionId": 77},
    {"question": "hi", "store_ids": [1], "model": 3},
    {"question": "hi", "store_ids": [1], "messages": "x"},
    {"question": "hi", "store_ids": [1], "messages": ["x"]},
    {"question": "hi", "store_ids": [1], "messages": [{"role": "user"}]},
    {"question": "hi", "store_ids": [1], "document_ids": []},
    {"question": "hi", "store_ids": [1], "documentIds": ["z"]},
    {"question": "hi", "store_ids": [1], "tags": [1]},
    {"question": "hi", "store_ids": [1], "metadata_filter": {"k": 1}},
    {"question": 5, "store_ids": "x", "top_k": "y"},
    {"question": "   ", "store_ids": [1]},
    {"question": "hi", "storeIds": [1], "unknown": {"x": 1}},
]


@pytest.mark.parametrize("body", BODIES, ids=lambda b: json.dumps(b)[:48])
def test_chat_body_parses_like_pydantic(tmp_path, body):
    def scenario(app):
        h = app.signup()
        app.create_store(h)
        _chat(app, h, body)

    jax, port = run_both(tmp_path, scenario, MOCK_MODE=True)
    assert port == jax


def test_chat_request_coerces_like_the_jax_model():
    jax_model = mod("jax", "app.routes.chat").ChatRequest
    body = {"question": "q", "store_ids": ["1", 2.0, True], "topK": "3",
            "sessionId": " 4 ", "messages": [{"role": "user"}],
            "tags": {"a": 1}, "metadataFilter": [1]}
    ours, theirs = ChatRequest(**body), jax_model(**body)
    for name in ("resolved_store_ids", "resolved_session_id",
                 "resolved_document_ids", "resolved_top_k",
                 "resolved_metadata_filter"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert (ours.messages, ours.tags) == (theirs.messages, theirs.tags)
    with pytest.raises(FieldError) as e:
        ChatRequest(question="q", top_k=[1])
    assert e.value.msg == "Input should be a valid integer"


def test_history_trimming_matches_the_jax_route(tmp_path):
    jax_chat = mod("jax", "app.routes.chat")
    msgs = [{"role": "user", "content": f"turn {i} " + "x" * 50}
            for i in range(10)] + [
        {"role": "assistant", "content": [{"type": "text", "text": "a"}]},
        {"role": "system", "content": "ignored"},
        {"role": "user", "content": "current"}]
    for turns, budget in ((4, 120), (24, 6000), (3, 40)):
        kw = dict(HISTORY_MAX_TURNS=turns, HISTORY_CHAR_BUDGET=budget)
        ours = _history_from_messages(
            ChatRequest(messages=msgs),
            settings_for("port", pathlib.Path(tmp_path), **kw))
        theirs = jax_chat._history_from_messages(
            jax_chat.ChatRequest(messages=msgs),
            settings_for("jax", pathlib.Path(tmp_path), **kw))
        assert ours == theirs
        assert sum(len(m["content"]) for m in ours) <= budget


def test_raw_sse_bytes_equal_modulo_ids(tmp_path):
    """The chunked SSE body of one chat, byte for byte, with the two
    generated ids masked (the live recorded stream of
    ``tests/test_sse_contract.py``)."""
    def scenario(app):
        h, sid = _corpus(app)
        r = app.client.post("/api/chat", headers=h, json_body={
            "question": "How did revenue grow?", "storeIds": [sid]})
        return re.sub(r"(msg|txt)-[0-9a-f]{12}", "ID", r.text)

    jax, port = run_both(tmp_path, scenario)
    assert port[-1] == jax[-1]
    assert port[-1][1].endswith("data: [DONE]\n\n")
    assert "revenue" in port[-1][1].lower()


def test_every_admitted_stream_gets_a_thread(tmp_path):
    """The port's app sizes asyncio's default executor to its stream limit
    (plus the default pool): 40 admitted streams whose engine calls all
    wait for one another complete together. With the default pool alone
    (min(32, cores + 4) threads) the calls past it would queue behind the
    waiting ones."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    n = 40
    client, ctx = build("port", tmp_path, MOCK_MODE=True,
                        MAX_CONCURRENT_STREAMS=n,
                        STREAM_SEMAPHORE_TIMEOUT_S=30.0)
    app = App("port", client, ctx)
    h = app.signup()
    sid = app.create_store(h)["id"]
    barrier = threading.Barrier(n, timeout=20)
    ask = ctx.rag.ask_stream

    def ask_together(*a, **kw):
        barrier.wait()
        return ask(*a, **kw)

    ctx.rag.ask_stream = ask_together
    with ThreadPoolExecutor(n) as pool:
        outs = list(pool.map(lambda i: client.post(
            "/api/chat", headers=h, json_body={
                "question": f"q{i}", "store_ids": [sid]}).text, range(n)))
    assert not barrier.broken
    assert all("[mock-mode] q" in o and o.endswith("data: [DONE]\n\n")
               for o in outs)
