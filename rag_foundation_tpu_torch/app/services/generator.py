"""Pluggable answer generators — the composition slot of ``ask_stream``.

Counterpart of ``rag_foundation_tpu/app/services/generator.py``, copied
apart from imports; the generative tier streams from the port engine's
decoder (``Engine.generate_stream``, trained by
``tools/train_decoder``).

The reference streams an LLM-composed answer over the retrieved context
(backend/app/services/gemini_rag.py:517-551). This repo
owns retrieval end-to-end, so answer composition is a first-class,
swappable stage: ``AnswerGenerator.stream(question, hits)`` yields text
deltas that ride the exact same SSE pump/backpressure/budget machinery
regardless of implementation (SURVEY.md §3.2 "pluggable generator").

Implementations:

- ``SpanReaderGenerator`` (default, ``ENGINE_GENERATOR=span_reader``):
  the extractive head — span-reader answer composed eagerly, streamed as
  word deltas. Behavior-identical to the pre-protocol hard-wired path.
- ``MockGenerativeGenerator`` (``ENGINE_GENERATOR=mock_generative``):
  a lazily-streamed "LLM-shaped" generator that narrates the retrieved
  evidence turn by turn. It exists to prove the slot: deltas are
  produced incrementally (never precomputed into one string), so a real
  token-streaming LLM backend drops in with the same contract — and the
  full chat SSE suite passes over it unchanged.
- ``GenerativeGenerator`` (``ENGINE_GENERATOR=generative``): the REAL
  device-resident decoder (models/decoder.py, trained by
  tools/train_decoder.py). Tokens are greedy-decoded on the device in
  blocks (one dispatch each) and streamed through the same SSE pump.
  Every emission passes a GROUNDING GATE — content stems must appear in
  the retrieved evidence or the question — and any violation, model
  self-refusal on non-empty hits, or engine failure falls back to the
  extractive span reader: the product never streams a citation-free
  claim (the "no citation-free claims" invariant; reference analog:
  Gemini's grounding_metadata, gemini_rag.py:554-595).
"""

from __future__ import annotations

from collections.abc import Iterator, Sequence
from typing import Protocol, runtime_checkable


@runtime_checkable
class AnswerGenerator(Protocol):
    """Composes the streamed answer text from retrieval hits.

    ``stream`` yields text deltas (concatenation = the full answer).
    Implementations must handle ``hits == []`` (the refusal case) and
    must be safe to call from a worker thread (the chat route pumps the
    iterator from a daemon thread, reference chat.py:486-520).
    """

    name: str

    def stream(self, question: str, hits: Sequence,
               *, history: list[dict] | None = None) -> Iterator[str]:
        ...


def _word_deltas(text: str, words_per_delta: int = 6) -> Iterator[str]:
    words = text.split(" ")
    for i in range(0, len(words), words_per_delta):
        chunk = " ".join(words[i: i + words_per_delta])
        if i:
            chunk = " " + chunk
        yield chunk


REFUSAL_TEXT = ("I could not find relevant information in the selected "
                "stores to answer this question.")


class SpanReaderGenerator:
    """Default extractive generator: span reader over ranked sentences,
    sentence fallback, top-passage quote fallback (ENGINE_ANSWER_MODE
    span|sentences), streamed as word deltas."""

    name = "span_reader"

    def __init__(self, settings):
        self.settings = settings

    def stream(self, question: str, hits: Sequence,
               *, history: list[dict] | None = None) -> Iterator[str]:
        # deferred import: rag.py owns the composition helpers and
        # imports this module for make_generator
        from rag_foundation_tpu_torch.app.services import rag
        yield from _word_deltas(
            rag.compose_answer(self.settings, question, hits))


class MockGenerativeGenerator:
    """Streaming mock of a generative backend.

    Unlike the extractive path, nothing is precomputed: each delta is
    generated as the iterator advances, the way an LLM token stream
    arrives. The narration is deterministic (same question + hits =>
    same text) so tests can assert on it, and it grounds itself in the
    retrieved text so citations stay meaningful.
    """

    name = "mock_generative"

    def __init__(self, settings):
        self.settings = settings

    def stream(self, question: str, hits: Sequence,
               *, history: list[dict] | None = None) -> Iterator[str]:
        if not hits:
            yield from _word_deltas(REFUSAL_TEXT)
            return
        from rag_foundation_tpu_torch.app.services import rag
        docs: list[str] = []
        for h in hits:
            if h.doc_name not in docs:
                docs.append(h.doc_name)
        n_src = min(len(hits), 3)
        yield f"[generated] Drawing on {n_src} retrieved "
        yield "passage" + ("s" if n_src != 1 else "")
        yield f" from {docs[0]}"
        if len(docs) > 1:
            yield f" and {len(docs) - 1} other document"
            yield "s" if len(docs) > 2 else ""
        yield ": "
        core = rag.compose_answer(self.settings, question, hits)
        yield from _word_deltas(core)


def prep_evidence(question: str, hits: Sequence, *, limit: int = 8
                  ) -> list[str]:
    """Evidence segments for the decoder prompt: the top question-
    relevant SENTENCES across the hits (rag._ranked_sentences — the
    same pool the span reader mines), falling back to raw chunk texts
    when nothing ranks. Dense sentences beat raw chunks in a fixed
    prompt budget, and scripts/train_decoder.py builds its training
    prompts through THIS function so serve time matches training."""
    from rag_foundation_tpu_torch.app.services import rag
    ranked = rag._ranked_sentences(question, hits, limit=limit)
    if ranked:
        return [s for s, _ in ranked]
    return [h.text for h in hits[:3]]


class GenerativeGenerator:
    """Device decoder generation with a grounding gate + extractive
    fallback. Emission policy:

    - deltas buffer to word boundaries (a block can split a word);
    - nothing is emitted until the accumulated text contains >= 1
      content stem matched in evidence/question ("armed");
    - >= 2 unmatched content stems abort generation — fall back to the
      span reader if nothing was emitted yet, else stop cleanly;
    - a model self-refusal while hits exist falls back (the refusal
      decision belongs to the upstream retrieval gates, rag.py);
    - engine errors fall back (degraded beats 500 mid-stream).
    """

    name = "generative"

    def __init__(self, settings, engine=None):
        if engine is None:
            raise ValueError("ENGINE_GENERATOR=generative needs a live "
                             "engine (the decoder runs device-side)")
        self.settings = settings
        self.engine = engine

    def stream(self, question: str, hits: Sequence,
               *, history: list[dict] | None = None) -> Iterator[str]:
        if not hits:
            yield from _word_deltas(REFUSAL_TEXT)
            return
        from rag_foundation_tpu_torch.app import metrics
        from rag_foundation_tpu_torch.app.services import rag, textnorm
        evidences = prep_evidence(question, hits)
        allowed: set[str] = set()
        for src in [question] + evidences:
            allowed |= set(textnorm.content_stems(src))

        def unmatched(text: str) -> int:
            return sum(1 for t in textnorm.content_stems(text)
                       if not any(textnorm.stems_match(t, a)
                                  for a in allowed))

        refusal_head = " ".join(REFUSAL_TEXT.lower().split()[:4])
        acc, emitted, armed, failed = "", "", False, None
        try:
            for delta in self.engine.generate_stream(question, evidences):
                acc += delta
                if acc.lower().startswith(refusal_head[: len(acc)]):
                    if acc.lower().startswith(refusal_head):
                        failed = "self_refusal"
                        break
                    continue   # could still be the refusal prefix
                cut = acc.rfind(" ")   # hold back the unfinished word
                ready = acc[:cut] if cut > 0 else ""
                if unmatched(ready) >= 2:
                    failed = "ungrounded"
                    break
                if not armed and ready:
                    stems = textnorm.content_stems(ready)
                    armed = any(any(textnorm.stems_match(t, a)
                                    for a in allowed) for t in stems)
                if armed and len(ready) > len(emitted):
                    yield ready[len(emitted):]
                    emitted = ready
            else:
                # stream done: gate + flush the tail
                if unmatched(acc) >= 2:
                    failed = "ungrounded"
                elif not armed:
                    stems = textnorm.content_stems(acc)
                    armed = any(any(textnorm.stems_match(t, a)
                                    for a in allowed) for t in stems)
                    failed = None if armed else "unanchored"
                if not failed and armed and len(acc) > len(emitted):
                    yield acc[len(emitted):]
                    emitted = acc
        except Exception:  # noqa: BLE001 — availability over the tier
            failed = "engine_error"
        if failed and not emitted:
            metrics.engine_calls_total.labels(
                "generate", f"fallback_{failed}").inc()
            yield from _word_deltas(
                rag.compose_answer(self.settings, question, hits))
            return
        if failed:   # violation after partial emission: stop cleanly
            metrics.engine_calls_total.labels(
                "generate", f"truncated_{failed}").inc()
            return
        metrics.engine_calls_total.labels("generate", "ok").inc()


GENERATORS: dict[str, type] = {
    "span_reader": SpanReaderGenerator,
    "mock_generative": MockGenerativeGenerator,
    "generative": GenerativeGenerator,
}


def make_generator(settings, engine=None) -> AnswerGenerator:
    """Resolve ENGINE_GENERATOR to an implementation (default
    span_reader — config validates membership at startup). ``engine``
    is the live engine handle; only the generative tier needs it."""
    name = getattr(settings, "ENGINE_GENERATOR", "span_reader")
    cls = GENERATORS.get(name)
    if cls is None:
        raise ValueError(f"unknown ENGINE_GENERATOR {name!r} "
                         f"(have: {sorted(GENERATORS)})")
    if cls is GenerativeGenerator:
        return cls(settings, engine)
    return cls(settings)
