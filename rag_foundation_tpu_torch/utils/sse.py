"""SSE frame parser — the executable spec for the frontend's sse.js.

The image has no JS runtime, so the frontend's stream-parsing logic is
kept as a line-for-line transliteration pair: this module is the
testable twin (tests/test_torch_frontend.py replays the recorded
reference-contract streams of tests/test_sse_contract.py — keepalives,
error frames, budget cut-off, frames split across reads — and the port
app's live SSE bytes against it and against the JAX package's twin), and
``app/static/sse.js`` mirrors it for the browser. Any wire-contract
change MUST land in both. This module and ``app/static`` are the port's
own copies of the JAX package's ``utils/sse.py`` and static files.

Contract (reference frontend useSseRuntime.ts:114-313):
- events separated by a blank line; CRLF tolerated
- only ``data: `` lines carry payloads; ``: keepalive`` comments and
  other fields are skipped
- ``data: [DONE]`` terminates the stream
- payloads are JSON frames: start / text-start / text-delta / text-end
  / source-document / error / finish
"""

from __future__ import annotations

import json
import re

_SEP = re.compile(r"\r?\n\r?\n")
_LINE = re.compile(r"\r?\n")


class SseParser:
    """Incremental parser: feed decoded text chunks, receive frames."""

    def __init__(self) -> None:
        self.buffer = ""
        self.done = False

    def push(self, chunk: str) -> list[dict]:
        if self.done:
            return []
        self.buffer += chunk
        frames: list[dict] = []
        while True:
            m = _SEP.search(self.buffer)
            if m is None:
                break
            raw = self.buffer[: m.start()]
            self.buffer = self.buffer[m.end():]
            for line in _LINE.split(raw):
                if not line.startswith("data: "):
                    continue  # comments (": keepalive") / other fields
                payload = line[6:]
                if payload == "[DONE]":
                    self.done = True
                    return frames
                try:
                    frames.append(json.loads(payload))
                except ValueError:
                    frames.append({"type": "error",
                                   "message": f"malformed frame: "
                                              f"{payload}"})
        return frames


def parse_stream(chunks) -> tuple[list[dict], bool]:
    """Parse an iterable of text chunks; returns (frames, saw_done)."""
    p = SseParser()
    frames: list[dict] = []
    for c in chunks:
        frames.extend(p.push(c))
        if p.done:
            break
    return frames, p.done
