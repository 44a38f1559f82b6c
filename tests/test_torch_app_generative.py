"""The port app's generative tier (``ENGINE_GENERATOR=generative``)
against the JAX app's, on the CPU.

- The grounding gate: each scripted decoder stream of
  ``tests/test_decoder.py`` (and an engine that fails after its first
  words) goes through both packages' ``GenerativeGenerator``; the
  streamed text and the ``engine_calls_total{op="generate"}`` outcome it
  counts are equal: ok, ``fallback_unanchored``, ``fallback_ungrounded``,
  ``fallback_self_refusal``, ``fallback_engine_error``,
  ``truncated_ungrounded`` and ``truncated_engine_error``.
- Both apps at the configuration of
  ``benchmarks/results/quality/ab_summary.json`` (hash encoder, ``exact``,
  coverage 0.35, chunks of 120 tokens, ``top_k`` 5) over the small
  ``checkpoints/decoder_smoke.npz``, run in f32 by both packages (a
  checkpoint stores no dtype; the engines' default is bf16): all 120
  questions of ``benchmarks/quality/questions.jsonl`` over SSE give equal
  answers, citations and gate outcomes, question by question. Those
  questions reach every outcome the smoke decoder gives: ok,
  ``fallback_unanchored`` and ``fallback_self_refusal``, and the
  retrieval gates' refusals, which never reach the decoder.
"""

import json
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
from prometheus_client import generate_latest

from tests.test_torch_app_helpers import App, build, mod

ROOT = Path(__file__).resolve().parents[1]
QUALITY = ROOT / "benchmarks" / "quality"
DOCS = sorted((QUALITY / "docs").glob("*.md"))
QUESTIONS = [json.loads(line) for line in
             (QUALITY / "questions.jsonl").read_text().splitlines()
             if line.strip()]
OUTCOME = re.compile(
    r'^engine_calls_total\{op="generate",outcome="([a-z_]+)"\} (\S+)$', re.M)


def _hit(text, doc_name="doc.txt"):
    return SimpleNamespace(text=text, doc_name=doc_name, doc_id="d1",
                           store_key="stores/x", ordinal=0, score=0.9)


HITS = [_hit("The mount slews at 4.5 degrees per second. "
             "It is painted white.")]
SETTINGS = SimpleNamespace(ENGINE_ANSWER_MODE="span")
QUESTION = "How fast does the mount slew?"


class ScriptedEngine:
    """Engine stub: ``generate_stream`` yields a script, then raises
    ``error`` if one is given."""

    def __init__(self, deltas=(), error=None):
        self.deltas, self.error, self.calls = list(deltas), error, 0

    def generate_stream(self, question, evidences, *, max_tokens=None):
        self.calls += 1
        yield from self.deltas
        if self.error:
            raise self.error


def _outcomes(pkg: str) -> dict:
    """{outcome: count} of ``engine_calls_total{op="generate"}`` in the
    package's app registry."""
    metrics = mod(pkg, "app.metrics")
    text = (generate_latest(metrics.registry) if pkg == "jax"
            else metrics.render()).decode()
    return {k: float(v) for k, v in OUTCOME.findall(text)}


def _moved(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def _gated(pkg: str, engine, question=QUESTION, hits=HITS):
    """(streamed text, outcomes counted) of one stream through the
    package's ``GenerativeGenerator``."""
    gen = mod(pkg, "app.services.generator").GenerativeGenerator(
        SETTINGS, engine)
    before = _outcomes(pkg)
    text = "".join(gen.stream(question, hits))
    return text, _moved(before, _outcomes(pkg))


REFUSAL = mod("port", "app.services.generator").REFUSAL_TEXT
SCRIPTS = {
    "ok": (["4.5 degrees ", "per second."], None, "ok"),
    "word_split_at_a_block_edge": (["4.5 degr", "ees per second."], None,
                                   "ok"),
    "unanchored": (["It is what it is."], None, "fallback_unanchored"),
    "ungrounded": (["the reactor exploded yesterday morning "], None,
                   "fallback_ungrounded"),
    "self_refusal": ([REFUSAL[:20], REFUSAL[20:]], None,
                     "fallback_self_refusal"),
    "engine_error": ([], RuntimeError("device wedged"),
                     "fallback_engine_error"),
    "truncated": (["4.5 degrees per second ",
                   "zebra quasar nonsense words "], None,
                  "truncated_ungrounded"),
    "truncated_engine_error": (["4.5 degrees per second "],
                               RuntimeError("device lost"),
                               "truncated_engine_error"),
}


@pytest.mark.parametrize("case", list(SCRIPTS))
def test_gate_streams_and_outcomes_equal_the_jax_tier(case):
    deltas, error, outcome = SCRIPTS[case]
    got = {pkg: _gated(pkg, ScriptedEngine(deltas, error))
           for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    text, moved = got["port"]
    assert moved == {outcome: 1.0}
    compose = mod("port", "app.services.rag").compose_answer
    if outcome.startswith("fallback_"):
        assert text == compose(SETTINGS, QUESTION, HITS)
    elif outcome == "ok":
        assert text == "4.5 degrees per second."
    else:                       # stopped after the grounded words
        assert text == "4.5 degrees per second"


def test_gate_refuses_on_empty_hits_without_the_engine():
    for pkg in ("jax", "port"):
        engine = ScriptedEngine(["should never run"])
        assert _gated(pkg, engine, hits=[]) == (REFUSAL, {})
        assert engine.calls == 0


def test_gate_requires_an_engine():
    for pkg in ("jax", "port"):
        gen = mod(pkg, "app.services.generator")
        with pytest.raises(ValueError, match="live engine"):
            gen.GenerativeGenerator(SETTINGS, None)


# -- both apps over the smoke decoder ------------------------------------------

AB_CONFIG = dict(
    ENGINE_GENERATOR="generative",
    ENGINE_GENERATOR_CKPT=str(ROOT / "checkpoints" / "decoder_smoke.npz"),
    ENGINE_ENCODER="hash", ENGINE_DIM=384, ENGINE_INDEX_MODE="exact",
    ENGINE_MIN_COVERAGE=0.35, ENGINE_CHUNK_TOKENS=120,
    ENGINE_CHUNK_OVERLAP=24, ENGINE_TOP_K=5)
SMOKE_OUTCOMES = {"ok", "fallback_unanchored", "fallback_self_refusal"}


def _f32_decoders(monkeypatch):
    """Both packages load decoder checkpoints in f32."""
    for pkg in ("jax", "port"):
        new = mod(pkg, "models.decoder").DecoderConfig.__new__
        monkeypatch.setattr(new, "__defaults__",
                            new.__defaults__[:-1] + ("float32",))


def _asked(app: App) -> list:
    """(answer, [(title, snippet)], outcomes) of each question."""
    h = app.signup()
    sid = app.create_store(h, "quality")["id"]
    for path in DOCS:
        r = app.client.post("/api/upload", headers=h,
                            data={"store_id": str(sid)},
                            files={"file": (path.name, path.read_bytes(),
                                            "text/markdown")})
        assert r.status_code == 201, r.text
    app.drain()
    out = []
    for q in QUESTIONS:
        before = dict(OUTCOME.findall(app.client.get("/metrics").text))
        r = app.client.post("/api/chat", headers=h, json_body={
            "question": q["question"], "store_ids": [sid]})
        assert r.status_code == 200, r.text
        frames = [json.loads(p) for p in r.iter_sse() if p != "[DONE]"]
        after = dict(OUTCOME.findall(app.client.get("/metrics").text))
        out.append((
            "".join(f.get("delta", "") for f in frames
                    if f["type"] == "text-delta"),
            [(f["title"], f["snippet"]) for f in frames
             if f["type"] == "source-document"],
            sorted(k for k, v in after.items()
                   if float(v) != float(before.get(k, 0)))))
    return out


def test_generative_apps_equal_on_the_quality_questions(tmp_path,
                                                        monkeypatch):
    _f32_decoders(monkeypatch)
    got = {}
    for pkg in ("jax", "port"):
        client, ctx = build(pkg, tmp_path / pkg, **AB_CONFIG)
        got[pkg] = _asked(App(pkg, client, ctx))
        assert ctx.rag.engine._text_generator().cfg.dtype == "float32"
    assert ctx.rag.engine._text_generator().device.type == "cpu"
    assert len(got["port"]) == len(QUESTIONS) == 120
    diffs = [(q["question"], a, b) for q, a, b in
             zip(QUESTIONS, got["port"], got["jax"]) if a != b]
    assert not diffs, diffs[:3]
    counts = {}
    for _, _, outcomes in got["port"]:
        assert len(outcomes) <= 1, outcomes
        for o in outcomes or ["refused_before_the_decoder"]:
            counts[o] = counts.get(o, 0) + 1
    assert set(counts) == SMOKE_OUTCOMES | {"refused_before_the_decoder"}, \
        counts
    print(f"gate outcomes over 120 questions: {counts}")
