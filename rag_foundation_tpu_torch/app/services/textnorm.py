"""Shared lexical normalization for the extractive QA path.

One stemmer + fuzzy matcher used by BOTH the refusal gates / sentence
ranking (services/rag.py) and the span reader (services/reader.py), so
"photometric" in a question finds "photometry" in a passage and
"rotation schedule" finds "staff rotate". A mismatch between the two
layers' tokenization was the round-2 source of false refusals.

No external NLP dependencies — a Porter-lite suffix stripper plus a
shared-prefix fallback (>=5 chars agree => same concept). Hyphenated
corpus tokens ("warm-up", "first-aid") match their parts.
"""

from __future__ import annotations

import functools
import re
import threading

_WORD_RE = re.compile(r"[a-z0-9]+(?:[-'][a-z0-9]+)*")

STOPWORDS = frozenset(
    "a an the is are was were be been being do does did to of in on at by "
    "for with from as and or but not no what which who whom whose when "
    "where why how this that these those it its if then than there here "
    "can could should would may might will shall has have had also very "
    "into onto upon".split())

_SUFFIXES = ("ization", "ational", "ation", "ingly", "fully", "ness",
             "ment", "ions", "ical", "ibly", "ably", "ies", "ion", "ing",
             "ed", "ly", "es", "al", "ic", "s", "y", "e")


# The chat serving plane is host-CPU-bound (ENGINE.md "Serving at
# scale": the engine answers in single-digit ms; the reader/refusal
# path dominated the per-request budget). All three hot functions are
# pure and their inputs recur heavily across requests — the same chunk
# sentences are re-ranked for every question that retrieves them — so
# memoization cuts most of the per-request stemming/matching work
# (profiled: ~55k stem() + ~213k stems_match() calls per 60 requests
# before caching; caches turn repeat traffic into dict hits).
@functools.lru_cache(maxsize=65536)
def stem(token: str) -> str:
    """Porter-lite: strip one long suffix, keep a >=4-char stem."""
    t = token.lower()
    for suf in _SUFFIXES:
        if t.endswith(suf) and len(t) - len(suf) >= 4:
            return t[: len(t) - len(suf)]
    return t


@functools.lru_cache(maxsize=1 << 18)
def stems_match(a: str, b: str) -> bool:
    """Same concept? Exact stem match, a shared >=5-char prefix, or a
    hyphen part of one matching the other."""
    if a == b:
        return True
    m = min(len(a), len(b))
    if m >= 5 and a[:m] == b[:m]:
        return True
    if "-" in a and any(stems_match(stem(p), b)
                        for p in a.split("-") if p):
        return True
    if "-" in b and any(stems_match(a, stem(p))
                        for p in b.split("-") if p):
        return True
    return False


def words(text: str) -> list[str]:
    return _WORD_RE.findall(text.lower())


# Corpus-derived texts (chunk bodies and their sentences) recur for
# EVERY question that retrieves them, and at a few thousand chunks x
# ~5 sentences they overflow an LRU and thrash (VERDICT r3 item 6:
# "precompute chunk sentence stems at ingest time instead of memoizing
# at first query"). They are pinned here — computed once at ingest /
# store-restore / first hit assembly; query-derived texts stay in the
# bounded LRU. Memory: one frozenset of short strings per distinct
# chunk sentence. Pins from ingest are REFCOUNTED (the same sentence
# can live in several chunks/stores) and evicted by unpin_chunk on the
# document/store delete paths, so upload/delete churn does not leak
# (ADVICE r4). Pins taken at hit assembly (pin_stems, the RPC-app
# process which never ingests) carry no refcount; they are bounded by
# a soft cap that evicts the oldest zero-ref entries.
_PINNED: dict[str, frozenset] = {}
_PIN_REFS: dict[str, int] = {}
_ZERO_REF_CAP = 200_000
_PIN_LOCK = threading.Lock()

# sentence split shared by the reader path and ingest-time pinning (the
# keys must match exactly); doesn't break on honorific abbreviations
# ("chaired by Dr. Amara Chen" is one sentence)
SENT_SPLIT = re.compile(
    r"(?<=[.!?])(?<!\bDr\.)(?<!\bMr\.)(?<!\bMs\.)(?<!\bSt\.)"
    r"(?<!\bNo\.)(?<!Mrs\.)(?<!rof\.)\s+")


@functools.lru_cache(maxsize=16384)
def _content_stems_lru(text: str) -> frozenset[str]:
    return frozenset(stem(w) for w in words(text) if w not in STOPWORDS)


def content_stems(text: str) -> frozenset[str]:
    """Frozen (it is cached and shared) stem set of the content words."""
    hit = _PINNED.get(text)
    if hit is not None:
        return hit
    return _content_stems_lru(text)


def pin_stems(text: str) -> frozenset[str]:
    """content_stems with pinned residency (corpus-derived texts).

    Zero-ref pins (taken at hit assembly rather than ingest) are
    bounded: past _ZERO_REF_CAP entries the oldest unreferenced pins
    are evicted, so a long-lived RPC-app process cannot grow without
    bound."""
    hit = _PINNED.get(text)
    if hit is not None:
        return hit
    stems = _content_stems_lru(text)
    with _PIN_LOCK:
        if len(_PINNED) >= _ZERO_REF_CAP:
            # evict oldest zero-ref pins (insertion-ordered dict scan)
            dead = [k for k in _PINNED
                    if _PIN_REFS.get(k, 0) <= 0][: _ZERO_REF_CAP // 4]
            for k in dead:
                _PINNED.pop(k, None)
        _PINNED[text] = stems
    return stems


def _chunk_keys(text: str):
    yield text
    for s in SENT_SPLIT.split(text.strip()):
        s = s.strip()
        if s:
            yield s


def pin_chunk(text: str) -> None:
    """Precompute the stem sets the reader will ask for when a hit
    carries this chunk: the full text (coverage gates) and each split
    sentence (sentence ranking). Called at ingest and store restore so
    the first query pays nothing. Refcounted: pair with unpin_chunk on
    the delete path."""
    with _PIN_LOCK:
        for key in _chunk_keys(text):
            _PIN_REFS[key] = _PIN_REFS.get(key, 0) + 1
            if key not in _PINNED:
                _PINNED[key] = _content_stems_lru(key)


def unpin_chunk(text: str) -> None:
    """Release one pin_chunk reference; evicts stem sets whose last
    referencing chunk was deleted (document delete / store delete), so
    upload/delete churn does not leak pinned memory (ADVICE r4)."""
    with _PIN_LOCK:
        for key in _chunk_keys(text):
            refs = _PIN_REFS.get(key, 0) - 1
            if refs <= 0:
                _PIN_REFS.pop(key, None)
                _PINNED.pop(key, None)
            else:
                _PIN_REFS[key] = refs


class StemSet:
    """Set of stems with fuzzy membership (`in` uses stems_match)."""

    def __init__(self, stems: set[str]):
        self._stems = stems

    @classmethod
    def from_text(cls, text: str) -> "StemSet":
        return cls(content_stems(text))

    def __contains__(self, item: str) -> bool:
        if item in self._stems:           # exact: one hash probe
            return True
        return any(stems_match(item, s) for s in self._stems)

    def __iter__(self):
        return iter(self._stems)

    def __len__(self) -> int:
        return len(self._stems)

    def __bool__(self) -> bool:
        return bool(self._stems)

    def matched_in(self, other_stems: set[str] | list[str]) -> set[str]:
        """Subset of THIS set's stems that fuzzy-match any of
        ``other_stems`` (used for coverage fractions). Exact matches
        resolve by set intersection; only the remainder pays the
        O(|self|x|other|) fuzzy scan."""
        others = (other_stems if isinstance(other_stems, (set, frozenset))
                  else set(other_stems))
        out = set(self._stems & others)
        for s in self._stems:
            if s not in out and any(stems_match(s, o) for o in others):
                out.add(s)
        return out
