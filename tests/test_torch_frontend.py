"""The port app's static SPA and the twins of its JavaScript.

``GET /`` and ``/static/*`` serve the same bytes with the same content
types as the JAX app (the port keeps its own copy of the nine files),
block traversal and carry the same CSP. The port's ``utils/sse``,
``utils/chatview`` and ``utils/uploadview`` give what the JAX package's
twins give on the recorded streams of ``tests/test_sse_contract.py`` and
on the port app's own live SSE bytes, and the scenarios of
``tests/test_frontend_behavior.py`` run through them against the port
app."""

from pathlib import Path

import pytest

from rag_foundation_tpu.utils import chatview as jax_chatview
from rag_foundation_tpu.utils import sse as jax_sse
from rag_foundation_tpu.utils import uploadview as jax_uploadview
from rag_foundation_tpu_torch.utils import chatview, sse, uploadview
from tests.test_sse_contract import FULL_STREAM, _wire
from tests.test_torch_app_helpers import App, build, run_both

ROOT = Path(__file__).resolve().parents[1]
STATIC = ROOT / "rag_foundation_tpu_torch" / "app" / "static"
FILES = sorted(p.name for p in (ROOT / "rag_foundation_tpu" / "app"
                                / "static").iterdir())
DOC = ("The quarterly revenue grew twelve percent driven by cloud "
       "subscriptions. Operating margin expanded to thirty percent "
       "while churn declined. " * 6)


def test_the_port_keeps_a_byte_equal_copy_of_the_static_files():
    assert len(FILES) == 9
    assert sorted(p.name for p in STATIC.iterdir()) == FILES
    for name in FILES:
        assert (STATIC / name).read_bytes() == (
            ROOT / "rag_foundation_tpu" / "app" / "static" / name
        ).read_bytes(), name


def test_index_and_static_files_served_as_the_jax_app_serves_them(tmp_path):
    paths = ["/"] + [f"/static/{n}" for n in FILES] + [
        "/static/..%2Fmain.py", "/static/../main.py", "/static/nope.js",
        "/static/", "/static/%2e%2e%2fconfig.py", "/static/.",
        "/static/index.html/"]
    seen = {}
    for pkg in ("jax", "port"):
        client, _ = build(pkg, tmp_path / pkg, MOCK_MODE=True)
        seen[pkg] = [(p, r.status_code, r.headers.get("content-type"),
                      r.headers.get("content-security-policy"),
                      r.headers.get("x-frame-options"), r.body)
                     for p in paths for r in [client.get(p)]]
    assert seen["port"] == seen["jax"]
    by_path = {p: rest for p, *rest in seen["port"]}
    assert by_path["/"][0] == 200
    assert by_path["/"][1] == "text/html; charset=utf-8"
    assert by_path["/"][4] == (STATIC / "index.html").read_bytes()
    assert by_path["/static/app.js"][1] == "application/javascript"
    assert by_path["/static/style.css"][1] == "text/css"
    assert "default-src 'self'" in by_path["/"][2]
    for bad in ("/static/..%2Fmain.py", "/static/nope.js"):
        assert by_path[bad][0] == 404


# -- the twins ----------------------------------------------------------------

STREAMS = {
    "full": FULL_STREAM,
    "crlf": FULL_STREAM.replace("\n", "\r\n"),
    "keepalive": _wire(": keepalive", ": keepalive",
                       'data: {"type": "text-delta", "delta": "x"}',
                       ": keepalive", "data: [DONE]"),
    "budget": _wire('data: {"type": "text-delta", "delta": "partial"}',
                    'data: {"type": "budget_exceeded", '
                    '"message": "monthly budget exhausted"}',
                    'data: {"type": "finish", "finishReason": "length"}',
                    "data: [DONE]"),
    "error": _wire('data: {"type": "error", "message": "engine failed"}',
                   "data: [DONE]"),
    "malformed": _wire("data: {not json}", "data: [DONE]"),
    "fields": _wire("event: message\nid: 7\ndata: "
                    '{"type": "text-delta", "delta": "y"}', "data: [DONE]"),
    "after_done": _wire("data: [DONE]", 'data: {"type": "text-delta"}'),
    "unterminated": _wire('data: {"type": "start"}') + "data: {",
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_sse_twin_equals_the_jax_twin_at_every_split(name):
    wire = STREAMS[name]
    want = jax_sse.parse_stream([wire])
    assert sse.parse_stream([wire]) == want
    for cut in range(1, len(wire)):
        parts = [wire[:cut], wire[cut:]]
        got = sse.parse_stream(parts)
        assert got == jax_sse.parse_stream(parts), cut
        assert got == want, cut
    p, q = sse.SseParser(), jax_sse.SseParser()
    for i in range(0, len(wire), 5):
        assert p.push(wire[i:i + 5]) == q.push(wire[i:i + 5])
        assert (p.buffer, p.done) == (q.buffer, q.done)


@pytest.mark.parametrize("text", [
    "a **b** c", "x *it* y", "use `code` here", "- one\n- two", "l1\nl2",
    '<img src=x onerror=alert(1)>', "**a** and *b*", "• dot\n  - deep",
    "*a **b** c*", "`<b>`", "", "&amp; \"q\" 'a'"])
def test_md_lite_equals_the_jax_twin(text):
    assert chatview.md_lite(text) == jax_chatview.md_lite(text)
    assert chatview.esc(text) == jax_chatview.esc(text)


def _view_state(view) -> dict:
    return {"session": view.session_id, "last": view.last_question,
            "streaming": view.streaming, "error": view.error_text,
            "retry": view.retry_visible, "status": view.status,
            "messages": [vars(m) for m in view.messages]}


def _drive(mod_chat, mod_sse, frames_wire: str, sid: str | None):
    view = mod_chat.ChatView()
    view.begin_question("q?")
    view.accept_session_header(sid)
    parser = mod_sse.SseParser()
    for i in range(0, len(frames_wire), 7):
        for f in parser.push(frames_wire[i:i + 7]):
            view.handle_frame(f)
    view.finish_stream(aborted=not parser.done)
    if view.messages[-1].chips:
        view.click_chip(1, 0)
    return _view_state(view)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_chat_view_twin_equals_the_jax_twin(name):
    assert _drive(chatview, sse, STREAMS[name], "4") == \
        _drive(jax_chatview, jax_sse, STREAMS[name], "4")


def _upload_steps(mod):
    tracker = mod.UploadTracker()
    a, b, c = (tracker.start(n) for n in ("a.txt", "b.txt", "c.exe"))
    out = []
    tracker.upload_failed(c, "Unsupported file type")
    out.append(tracker.poll(a, {"status": "PENDING", "done": False}, 1))
    out.append(tracker.poll(a, {"status": "RUNNING", "done": False}, 2))
    out.append(tracker.poll(b, {"status": "ERROR", "done": True,
                                "error": "ingestion failed"}, 2))
    out.append(tracker.poll(a, {"status": "DONE", "done": True,
                                "chunks": 7}, 3))
    d = tracker.start("d.txt")
    out.append(tracker.poll_failed(d, "network"))
    with pytest.raises(RuntimeError):
        tracker.poll(a, {"done": True}, 4)
    return out, tracker.active, tracker.refreshes, [
        vars(i) for i in tracker.items]


def test_upload_tracker_twin_equals_the_jax_twin():
    assert _upload_steps(uploadview) == _upload_steps(jax_uploadview)


# -- the port app's live bytes through the twins ------------------------------

def test_live_chat_and_upload_through_both_twins(tmp_path):
    """The reference's Playwright chat scenario (upload, poll, send,
    stream, citations, chips) on each app's live responses, fed to the
    port's twins and to the JAX package's alike: on the port app both
    end in the same states, and those equal what the JAX app's own bytes
    drive the twins to."""
    twins = ((chatview, sse, uploadview),
             (jax_chatview, jax_sse, jax_uploadview))

    def scenario(app):
        h = app.signup()
        sid = app.create_store(h, "E2E Store")["id"]
        trackers = [up.UploadTracker() for _, _, up in twins]
        items = [t.start("finance.txt") for t in trackers]
        op = app.upload_text(h, sid, DOC, "finance.txt").json()["op_id"]
        for secs in (1, 3):
            st = app.client.get(f"/api/upload/op-status/{op}",
                                headers=h).json()
            for t, item in zip(trackers, items):
                t.poll(item, st, secs=secs)
            app.drain()
        resp = app.client.post("/api/chat", headers=h, json_body={
            "question": "How did revenue grow?", "store_ids": [sid]})
        raw = resp.text
        states = []
        for (chat_mod, sse_mod, _), t, item in zip(twins, trackers, items):
            view = chat_mod.ChatView()
            view.begin_question("How did revenue grow?")
            view.accept_session_header(resp.headers.get("x-session-id"))
            parser = sse_mod.SseParser()
            for i in range(0, len(raw), 7):
                for f in parser.push(raw[i:i + 7]):
                    view.handle_frame(f)
            assert parser.done
            view.finish_stream()
            view.click_chip(1, 0)
            states.append((vars(item), t.active, t.refreshes,
                           _view_state(view)))
        return states

    jax, port = run_both(tmp_path, scenario)
    assert port == jax
    port_twin, jax_twin = port[-1][1]
    assert port_twin == jax_twin
    item, active, refreshes, view = port_twin
    assert item["phase"].startswith("done (") and item["removed"]
    assert (active, refreshes) == (0, 1)
    answer = view["messages"][1]
    assert "revenue" in answer["raw"].lower()
    assert answer["html"] == chatview.md_lite(answer["raw"])
    assert answer["chips"] == len(answer["citations"]) > 0
    assert answer["citations"][0]["title"] == "finance.txt"
    assert answer["panel_open"] and answer["highlighted"] == 0
    assert view["session"] == 1 and view["status"] == "Ready"


def test_stream_error_retry_through_the_port_twins(tmp_path):
    """chat.spec.ts error scenario on the port app (mock mode): the error
    frame shows the retry, the retry resubmits and succeeds."""
    client, ctx = build("port", tmp_path, MOCK_MODE=True,
                        STREAM_RETRY_ATTEMPTS=1)
    app = App("port", client, ctx)
    h = app.signup()
    sid = app.create_store(h)["id"]
    ctx.rag.stream_should_fail = True
    view = chatview.ChatView()
    view.begin_question("What failed?")
    resp = client.post("/api/chat", headers=h, json_body={
        "question": "What failed?", "store_ids": [sid]})
    parser = sse.SseParser()
    for f in parser.push(resp.text):
        view.handle_frame(f)
    view.finish_stream()
    assert view.error_text and view.retry_visible
    ctx.rag.stream_should_fail = False
    q = view.retry_question()
    target = view.begin_question(q)
    resp = client.post("/api/chat", headers=h, json_body={
        "question": q, "store_ids": [sid]})
    for f in sse.SseParser().push(resp.text):
        view.handle_frame(f)
    view.finish_stream()
    assert target.raw.startswith("[mock-mode]")
    assert not view.retry_visible and view.error_text == ""
