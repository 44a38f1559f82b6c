"""The extractive answer text of the JAX app's ``services/rag.py``: the
sentence ranking, the span-reader cascade and its fallbacks, copied
verbatim apart from imports.

``compose_answer`` labels the generative decoder's training examples
(``tools/train_decoder.build_triples``) and ``_ranked_sentences`` picks
their evidence (``generator.prep_evidence``); the rest of the JAX module
(the engine adapter, the chat stream, the refusal gates) serves the app,
which stays in the JAX package.
"""

from __future__ import annotations

from rag_foundation_tpu_torch.app.services import reader, textnorm

# sentence split shared with ingest-time stem pinning (textnorm)
_SENT_SPLIT = textnorm.SENT_SPLIT
# corpus-derived texts (hit chunks + their sentences) pin permanently:
# they recur for every question that retrieves them and are
# precomputed at ingest (textnorm.pin_chunk)
_hit_tokens = textnorm.pin_stems


def _ranked_sentences(question: str, hits, *, limit: int = 8
                      ) -> list[tuple[str, float]]:
    """Sentences across the top hits ranked by IDF-weighted
    question-token overlap (document frequency taken over the candidate
    sentences themselves — no global state needed). Returns
    (sentence, score) descending; empty when nothing overlaps."""
    q_tokens = textnorm.StemSet.from_text(question)
    if not q_tokens:
        return []
    cands: list[tuple[int, int, str, set[str]]] = []   # (hit, pos, s, toks)
    seen: set[str] = set()   # chunk overlap duplicates sentences
    for hi, h in enumerate(hits[:12]):
        for pos, s in enumerate(_SENT_SPLIT.split(h.text.strip())):
            s = s.strip()
            if s.startswith("#"):
                # markdown heading glued to the chunk's first sentence
                # — headings and their boilerplate lead-ins ("This
                # chapter of the ... handbook") are structure, not facts
                continue
            if not 12 <= len(s) <= 600 or s in seen:
                continue
            seen.add(s)
            toks = _hit_tokens(s)
            if toks:
                cands.append((hi, pos, s, toks))
    if not cands:
        return []
    import math
    df: dict[str, int] = {}
    for _, _, _, toks in cands:
        for t in toks:
            df[t] = df.get(t, 0) + 1
    n_c = len(cands)
    overlap_cache: dict[int, set[str]] = {}

    def score(item):
        hi, _pos, _s, toks = item
        key = id(item)
        overlap = overlap_cache.get(key)
        if overlap is None:
            overlap = q_tokens.matched_in(toks)
            overlap_cache[key] = overlap
        if not overlap:
            return 0.0
        idf = sum(math.log(1 + n_c / df.get(t, 0.5)) for t in overlap)
        return idf / math.sqrt(len(toks)) * (1.0 - 0.05 * hi)

    ranked = sorted(cands, key=score, reverse=True)
    out: list[tuple[str, float]] = []
    for item in ranked[:limit]:
        sc = score(item)
        if sc <= 0.0:
            break
        out.append((item[2], sc))
    return out


def _extract_sentences(question: str, hits, *, max_sentences: int = 2,
                       max_chars: int = 400) -> str:
    """Best-matching sentences joined, bounded by count and chars."""
    ranked = _ranked_sentences(question, hits, limit=max_sentences)
    out: list[str] = []
    used = 0
    for s, _sc in ranked:
        if used + len(s) > max_chars:
            break
        out.append(s)
        used += len(s)
    return " ".join(out)


def compose_answer(settings, question: str, hits) -> str:
    """Extractive answer text. The reference outsources composition to a
    generative model (gemini_rag.py:463-551); owning retrieval
    end-to-end means the extractive head is ours. Two modes
    (ENGINE_ANSWER_MODE): "span" (default) runs the span-extraction
    reader over the best-matching sentences and answers with the
    short span — the span is the exact-match unit on the quality
    benchmark; "sentences" streams the top sentences verbatim.

    This is the composition core behind ``SpanReaderGenerator`` (and the
    grounding text of the mock generative impl); swap the whole stage
    via ENGINE_GENERATOR (services/generator.py)."""
    from rag_foundation_tpu_torch.app.services.generator import REFUSAL_TEXT
    if not hits:
        return REFUSAL_TEXT
    mode = getattr(settings, "ENGINE_ANSWER_MODE", "span")
    ranked = _ranked_sentences(question, hits, limit=8)
    if mode == "span" and ranked:
        res = reader.extract_answer_span(question, ranked)
        if res is not None and res.score > 0.0:
            return res.span
    lead = _extract_sentences(question, hits, max_sentences=2)
    if lead:
        return lead
    # no sentence matched the question tokens: quote the top passage
    # (supporting evidence still arrives as source-document frames)
    snippet = hits[0].text.strip()
    if len(snippet) > 300:
        snippet = snippet[:300].rsplit(" ", 1)[0] + "…"
    return f"From {hits[0].doc_name}: {snippet}"
