"""The port's copies of the JAX app's answer text (``app/services``:
``textnorm``, ``reader``, the ``rag`` and ``generator`` functions the
decoder's trainer needs) against the JAX package's, on the CPU.

Every one of the 120 questions of ``benchmarks/quality/questions.jsonl``
is answered over hits made from the paragraphs of
``benchmarks/quality/docs`` (ranked by shared content stems, the top 8):
once with every document, once with the question's own sources left out
(the unanswerable shape, which reaches the reader's fallbacks), in the
"span" and the "sentences" answer modes. ``compose_answer`` and
``prep_evidence`` must give equal strings, and the trainer's
``token_f1`` and ``grounded`` equal values on those answers: the copies
are exact, so there is no tolerance.
"""

import importlib.util
import inspect
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from rag_foundation_tpu.app.services import generator as jgen
from rag_foundation_tpu.app.services import rag as jrag
from rag_foundation_tpu.app.services import reader as jreader
from rag_foundation_tpu.app.services import textnorm as jtextnorm
from rag_foundation_tpu_torch.app.services import generator as tgen
from rag_foundation_tpu_torch.app.services import rag as trag
from rag_foundation_tpu_torch.app.services import reader as treader
from rag_foundation_tpu_torch.app.services import textnorm as ttextnorm
from rag_foundation_tpu_torch.tools import train_decoder as ttd

ROOT = Path(__file__).resolve().parents[1]
QUALITY = ROOT / "benchmarks" / "quality"
QUESTIONS = [json.loads(line) for line in
             (QUALITY / "questions.jsonl").read_text().splitlines()
             if line.strip()]
PARAGRAPHS = [(doc.name, para.strip())
              for doc in sorted((QUALITY / "docs").glob("*.md"))
              for para in doc.read_text().split("\n\n") if para.strip()]
MODES = ("span", "sentences")


def _script():
    """``scripts/train_decoder.py`` as a module (it imports JAX only
    inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        "train_decoder_script", ROOT / "scripts" / "train_decoder.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = _script()


def _hits(question: str, leave_out=()) -> list:
    """The 8 paragraphs sharing the most content stems with the question
    (ties by document order), as the app's hits."""
    q = jtextnorm.content_stems(question)
    ranked = sorted(
        (-len(q & jtextnorm.content_stems(text)), i)
        for i, (name, text) in enumerate(PARAGRAPHS) if name not in leave_out)
    return [SimpleNamespace(text=PARAGRAPHS[i][1], doc_name=PARAGRAPHS[i][0])
            for _, i in ranked[:8]]


def _cases(item):
    q = item["question"]
    yield "all documents", _hits(q)
    yield "sources left out", _hits(q, set(item["expected_sources"]))


def test_the_quality_set_is_whole():
    assert len(QUESTIONS) == 120 and len(PARAGRAPHS) >= 30


@pytest.mark.parametrize("n", range(len(QUESTIONS)))
def test_answer_text_equals_jax(n):
    item = QUESTIONS[n]
    q = item["question"]
    for what, hits in _cases(item):
        evs = tgen.prep_evidence(q, hits)
        assert evs == jgen.prep_evidence(q, hits), what
        for mode in MODES:
            settings = SimpleNamespace(ENGINE_ANSWER_MODE=mode)
            ans = trag.compose_answer(settings, q, hits)
            assert ans == jrag.compose_answer(settings, q, hits), \
                (what, mode)
            for gold in item["answers"]:
                assert ttd.token_f1(ans, gold) == \
                    SCRIPT.token_f1(ans, gold), (what, mode, gold)
            assert ttd.grounded(ans, evs, q) == \
                SCRIPT.grounded(ans, evs, q), (what, mode)


def test_the_questions_reach_every_branch_of_the_cascade():
    """Over the 120 questions the cases above take the span reader (span
    mode), the sentence answer (sentences mode; no question here sends
    the span mode to it) and the quote fallback, so each branch is
    compared."""
    seen = {"span": 0, "sentences": 0, "quote": 0}
    for item in QUESTIONS:
        q = item["question"]
        for _, hits in _cases(item):
            lead = trag._extract_sentences(q, hits, max_sentences=2)
            for mode in MODES:
                ans = trag.compose_answer(
                    SimpleNamespace(ENGINE_ANSWER_MODE=mode), q, hits)
                if ans.startswith("From "):
                    seen["quote"] += 1
                elif ans == lead:
                    seen["sentences"] += 1
                else:
                    seen[mode] += 1
    assert min(seen.values()) > 0, seen


def test_no_hits_is_the_refusal():
    settings = SimpleNamespace(ENGINE_ANSWER_MODE="span")
    assert trag.compose_answer(settings, "anything?", []) == \
        jrag.compose_answer(settings, "anything?", []) == tgen.REFUSAL_TEXT
    assert tgen.REFUSAL_TEXT == jgen.REFUSAL_TEXT
    assert tgen.prep_evidence("anything?", []) == []


def _code(fn) -> str:
    """A function's source without its module's import paths."""
    return inspect.getsource(fn).replace("rag_foundation_tpu_torch.",
                                         "rag_foundation_tpu.")


def _body(mod) -> str:
    """A module's source after its docstring (the port's reader names
    the reference's files without their machine path)."""
    return inspect.getsource(mod).split('"""', 2)[2]


def test_the_copies_are_verbatim_apart_from_imports():
    for jmod, tmod in ((jtextnorm, ttextnorm), (jreader, treader)):
        assert _body(tmod).replace("rag_foundation_tpu_torch.",
                                   "rag_foundation_tpu.") == _body(jmod), \
            tmod.__name__
    for name in ("_ranked_sentences", "_extract_sentences",
                 "compose_answer"):
        assert _code(getattr(trag, name)) == \
            inspect.getsource(getattr(jrag, name)), name
    assert _code(tgen.prep_evidence) == inspect.getsource(jgen.prep_evidence)
    assert trag._SENT_SPLIT.pattern == jrag._SENT_SPLIT.pattern
    # the trainer's host functions against the script's, whose imports
    # of the JAX app sit inside them (one line each in these)
    for name in ("cloze_question", "token_f1", "_norm_tokens", "grounded",
                 "run_eval", "smoke_corpus"):
        want = "".join(
            line for line in inspect.getsourcelines(getattr(SCRIPT, name))[0]
            if not line.lstrip().startswith("from rag_foundation_tpu."))
        assert inspect.getsource(getattr(ttd, name)) == want, name
