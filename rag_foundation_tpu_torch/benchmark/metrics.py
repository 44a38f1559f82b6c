"""Answer-quality metrics: alias-aware EM/F1, refusal detection, citation
hit rate, latency stats.

Reference parity: scripts/benchmark/metrics.py:22-108 —
the same metric definitions so results stay comparable, extended with
retrieval-native metrics (recall@k against a labeled set).
"""

from __future__ import annotations

import re
import string

_REFUSAL_RE = re.compile(
    r"(i\s+(could|can)\s*not\s+find|no\s+(relevant\s+)?information"
    r"|not\s+(found|available)\s+in\s+the\s+(provided|selected)"
    r"|unable\s+to\s+(find|answer)|don'?t\s+know)", re.IGNORECASE)


def normalize(text: str) -> str:
    """Lowercase, strip punctuation/articles, squash whitespace."""
    text = text.lower()
    text = "".join(c for c in text if c not in string.punctuation)
    text = re.sub(r"\b(a|an|the)\b", " ", text)
    return " ".join(text.split())


def exact_match(prediction: str, answers: list[str]) -> float:
    norm = normalize(prediction)
    return float(any(normalize(a) == norm for a in answers if a))


def f1_score(prediction: str, answers: list[str]) -> float:
    """Token-level F1, max over answer aliases."""
    pred_tokens = normalize(prediction).split()
    best = 0.0
    for ans in answers:
        if not ans:  # empty aliases score nothing (match exact_match)
            continue
        gold = normalize(ans).split()
        if not gold or not pred_tokens:
            best = max(best, float(gold == pred_tokens))
            continue
        common: dict[str, int] = {}
        for t in pred_tokens:
            common[t] = common.get(t, 0) + 1
        overlap = 0
        for t in gold:
            if common.get(t, 0) > 0:
                overlap += 1
                common[t] -= 1
        if overlap == 0:
            continue
        precision = overlap / len(pred_tokens)
        recall = overlap / len(gold)
        best = max(best, 2 * precision * recall / (precision + recall))
    return best


def contains_match(prediction: str, answers: list[str]) -> float:
    """Soft EM: any alias appears as a substring of the normalized
    prediction (useful for extractive answers)."""
    norm = normalize(prediction)
    return float(any(normalize(a) in norm for a in answers if a))


def is_refusal(prediction: str) -> bool:
    return bool(_REFUSAL_RE.search(prediction or ""))


def refusal_ok(prediction: str, answerable: bool) -> float:
    """1.0 when the model refused iff the question was unanswerable."""
    refused = is_refusal(prediction)
    return float(refused != answerable)


def citation_hit(citations: list[dict], expected_sources: list[str]) -> float:
    """1.0 if any expected source name appears in any citation
    title/uri/snippet (reference: metrics.py:73-92)."""
    if not expected_sources:
        return 1.0
    hay = " ".join(
        f"{c.get('title', '')} {c.get('uri', '')} {c.get('snippet', '')}"
        for c in citations).lower()
    return float(any(src.lower() in hay for src in expected_sources))


def recall_at_k(retrieved_ids: list, expected_ids: list, k: int) -> float:
    if not expected_ids:
        return 1.0
    got = set(retrieved_ids[:k])
    return len(got & set(expected_ids)) / min(len(expected_ids), k)


def mean(xs: list[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def p95(xs: list[float]) -> float:
    if not xs:
        return 0.0
    ordered = sorted(xs)
    idx = min(len(ordered) - 1, max(0, round(0.95 * len(ordered)) - 1))
    return ordered[idx]
