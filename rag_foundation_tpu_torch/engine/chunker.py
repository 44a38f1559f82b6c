"""Host-side document chunking.

The system this project replaces passed a ``chunking_config`` straight
through to Gemini and never chunked locally. Here chunking is ours:
whitespace-token windows with overlap, carrying byte offsets so
citations can point back into the source document.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_TOKEN_RE = re.compile(r"\S+")


@dataclass(frozen=True)
class Chunk:
    text: str
    start: int       # byte/char offset into the source text
    end: int
    ordinal: int     # chunk index within the document


def chunk_text(
    text: str,
    *,
    max_tokens: int = 200,
    overlap_tokens: int = 40,
) -> list[Chunk]:
    """Split ``text`` into overlapping whitespace-token windows.

    Deterministic, offset-preserving; empty/whitespace-only input yields
    no chunks. ``overlap_tokens`` must be < ``max_tokens``.
    """
    if overlap_tokens >= max_tokens:
        raise ValueError("overlap_tokens must be < max_tokens")
    spans = [(m.start(), m.end()) for m in _TOKEN_RE.finditer(text)]
    if not spans:
        return []
    stride = max_tokens - overlap_tokens
    chunks: list[Chunk] = []
    i = 0
    ordinal = 0
    while i < len(spans):
        window = spans[i : i + max_tokens]
        start, end = window[0][0], window[-1][1]
        chunks.append(Chunk(text=text[start:end], start=start, end=end,
                            ordinal=ordinal))
        ordinal += 1
        if i + max_tokens >= len(spans):
            break
        i += stride
    return chunks
