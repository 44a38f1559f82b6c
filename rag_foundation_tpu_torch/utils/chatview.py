"""Chat view state machine — the executable spec for static/chat.js.

No JS runtime exists in this image, so the chat view's *behavioral*
logic (frame handling, message accumulation, markdown-lite rendering,
citation panel + chips, streaming status, retry availability, session
switching) is kept as a transliteration pair: this module is the
testable twin, and ``app/static/chat.js`` mirrors it for the browser
(``handleFrame`` / ``mdLite`` / ``submitQuestion`` / ``loadSession`` /
``addCitationChips``). Any behavior change MUST land in both. The same
pattern as utils/sse.py ↔ static/sse.js.

tests/test_torch_frontend.py replays the reference's Playwright
scenarios (frontend/tests/e2e/chat.spec.ts:1-76 — send, stream,
citations, error, session switch) against this twin, fed by the port
app's live SSE bytes, and holds it to the JAX package's twin.
"""

from __future__ import annotations

import html
import re
from dataclasses import dataclass, field


def esc(text: str) -> str:
    """api.js ``esc``: HTML-escape before any interpolation."""
    return html.escape(str(text), quote=True)


_BOLD = re.compile(r"\*\*([^*\n]+)\*\*")
_ITAL = re.compile(r"(^|[^*])\*([^*\n]+)\*")
_CODE = re.compile(r"`([^`\n]+)`")
_BULLET = re.compile(r"^\s*[-•]\s+")


def md_lite(text: str) -> str:
    """chat.js ``mdLite``: escape FIRST, then allow bold / italic /
    inline code / bullet lines. No raw HTML ever."""
    out = esc(text)
    out = _BOLD.sub(r"<b>\1</b>", out)
    out = _ITAL.sub(r"\1<i>\2</i>", out)
    out = _CODE.sub(r"<code>\1</code>", out)
    lines = [f"<li>{_BULLET.sub('', ln)}</li>" if _BULLET.match(ln) else ln
             for ln in out.split("\n")]
    return "<br>".join(lines).replace("</li><br>", "</li>")


@dataclass
class Message:
    role: str
    raw: str = ""            # accumulated text (target._raw)
    html: str = ""           # rendered content (textContent / innerHTML)
    streaming_dot: bool = False
    citations: list[dict] = field(default_factory=list)
    panel_open: bool = False
    highlighted: int | None = None
    chips: int = 0

    @property
    def panel_summary(self) -> str:
        return f"Sources ({len(self.citations)})"


class ChatView:
    """State machine behind the chat pane (chat.js submitQuestion +
    handleFrame + session handlers)."""

    def __init__(self) -> None:
        self.messages: list[Message] = []
        self.session_id: int | None = None
        self.last_question: str | None = None
        self.streaming = False
        self.error_text = ""
        self.retry_visible = False
        self.status = "Ready"          # toolbar: Ready / Generating…

    # -- submit lifecycle (chat.js submitQuestion) -----------------------
    def begin_question(self, question: str) -> Message:
        if self.streaming:
            raise RuntimeError("submit while streaming is a no-op in js")
        self.last_question = question
        self.error_text = ""
        self.retry_visible = False
        self.messages.append(Message("user", raw=question, html=question))
        target = Message("assistant")
        self.messages.append(target)
        self.streaming = True
        self.status = "Generating…"
        return target

    def accept_session_header(self, sid: str | None) -> None:
        if sid:
            self.session_id = int(sid)

    def handle_frame(self, frame: dict) -> None:
        """chat.js handleFrame — applied to the in-flight assistant
        message."""
        target = self.messages[-1]
        kind = frame.get("type")
        if kind == "text-delta":
            target.raw += frame["delta"]
            target.html = target.raw     # textContent while streaming
            target.streaming_dot = True
        elif kind == "text-end":
            target.html = md_lite(target.raw)
        elif kind == "source-document":
            target.citations.append({
                "title": esc(frame.get("title", "")),
                "snippet": esc(frame.get("snippet") or "")})
        elif kind in ("error", "budget_exceeded"):
            self.set_error(frame.get("message")
                           or frame.get("errorText") or "", retry=True)
        # start / text-start / finish: no view change

    def finish_stream(self, aborted: bool = False) -> None:
        """chat.js finally block: the dot goes, partial text stays,
        chips attach when the panel has entries."""
        target = self.messages[-1]
        target.streaming_dot = False
        if target.citations and not aborted:
            target.chips = len(target.citations)
        if target.raw and not target.chips:
            target.html = md_lite(target.raw)
        self.streaming = False
        self.status = "Ready"

    def set_error(self, msg: str, retry: bool = False) -> None:
        self.error_text = msg
        self.retry_visible = bool(retry and self.last_question)

    # -- citations (chat.js addCitationChips click handler) --------------
    def click_chip(self, msg_index: int, chip: int) -> None:
        m = self.messages[msg_index]
        if not 0 <= chip < m.chips:
            raise IndexError(chip)
        m.panel_open = True
        m.highlighted = chip

    # -- sessions (chat.js loadSession / new-session / delete) -----------
    def load_session(self, session_id: int, messages: list[dict]) -> None:
        self.session_id = session_id
        self.messages = [Message(m["role"], raw=m["content"],
                                 html=m["content"]) for m in messages]

    def new_session(self) -> None:
        self.session_id = None
        self.messages = []

    def on_session_deleted(self, session_id: int) -> None:
        if self.session_id == session_id:
            self.new_session()

    # -- retry (chat.js #retry handler) -----------------------------------
    def retry_question(self) -> str:
        if not self.retry_visible or self.streaming:
            raise RuntimeError("retry not available")
        assert self.last_question is not None
        return self.last_question
