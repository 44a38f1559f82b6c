"""The generative tier's prompt text from the JAX app's
``services/generator.py``: ``REFUSAL_TEXT`` and ``prep_evidence``,
copied verbatim apart from imports. The generators themselves (span
reader, mock, the decoder behind the grounding gate) serve the app,
which stays in the JAX package.
"""

from __future__ import annotations

from collections.abc import Sequence

REFUSAL_TEXT = ("I could not find relevant information in the selected "
                "stores to answer this question.")


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
