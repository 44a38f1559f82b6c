"""The port's app at the quality benchmark's production configuration,
against the JAX app, on the CPU.

That configuration (``benchmarks/README.md``, the "Production default
config" of ``benchmarks/results/quality/summary_hybrid.json``):
``ENGINE_ENCODER=hybrid ENGINE_DIM=768
ENGINE_ENCODER_CKPT=checkpoints/minilm_ict.npz ENGINE_MIN_COVERAGE=0.35``,
chunks of 120 tokens overlapping 24, ``exact``, ``top_k`` 5. The hybrid
encoder gives the MiniLM half 384 of the 768 dimensions (the checkpoint's
hidden width) and the native hash channel the other 384; the port's
MiniLM runs the flash-attention forward's plain version here.

Both apps are built from the same settings, the ten documents of
``benchmarks/quality/docs`` go in through ``/api/upload``, and all 120
questions of ``quality`` and all 24 follow-ups of ``quality_multiturn``
(their prior turns sent as the AssistantUI ``messages`` array, so
``rag.reformulate_query`` rewrites them) are asked over SSE. The streamed
answers and the cited titles and snippets are equal, in order, question
by question, apart from a counted set of near-ties.

The near-tie bound: both engines run MiniLM in bf16 (a checkpoint stores
no dtype), so a hit's score differs between the packages by bf16
rounding, within ``HYBRID_TIE`` (``ENC_TOL`` of
``tests/test_torch_engine.py``), and two hits whose scores lie that
close may swap. Every cited score agrees within the bound, and where a
question's answer or citations differ, the two engines' own searches for
its (reformulated) query must first differ at a rank whose two scores
lie within it.
"""

import json
from pathlib import Path

import pytest

from tests.test_torch_app_helpers import App, build, mod

ROOT = Path(__file__).resolve().parents[1]
QUALITY = ROOT / "benchmarks" / "quality"
DOCS = sorted((QUALITY / "docs").glob("*.md"))
BENCHES = {name: [json.loads(line) for line in
                  (QUALITY / f"{name}.jsonl").read_text().splitlines()
                  if line.strip()]
           for name in ("questions", "questions_multiturn")}
PRODUCTION = dict(
    ENGINE_ENCODER="hybrid", ENGINE_DIM=768,
    ENGINE_ENCODER_CKPT=str(ROOT / "checkpoints" / "minilm_ict.npz"),
    ENGINE_MIN_COVERAGE=0.35, ENGINE_CHUNK_TOKENS=120,
    ENGINE_CHUNK_OVERLAP=24, ENGINE_INDEX_MODE="exact", ENGINE_TOP_K=5)
HYBRID_TIE = 5e-3        # ENC_TOL: bf16 MiniLM scores, port vs JAX
MAX_NEAR_TIES = 6        # a bench (observed on a CPU: 4 of 120, 1 of 24)
SEARCH_K = 128           # the app's deepest search (ENGINE_LEXICAL_RERANK)


def _chat(app: App, h, sid, q) -> tuple[str, list]:
    """(answer, [(title, snippet)]) of one question over SSE, its prior
    turns sent as the AssistantUI ``messages`` array."""
    if q.get("history"):
        body = {"messages": q["history"] + [
            {"role": "user", "content": q["question"]}]}
    else:
        body = {"question": q["question"]}
    r = app.client.post("/api/chat", headers=h,
                        json_body=dict(body, store_ids=[sid]))
    assert r.status_code == 200, r.text
    frames = [p if p == "[DONE]" else json.loads(p) for p in r.iter_sse()]
    types = [f if f == "[DONE]" else f["type"] for f in frames]
    assert types[:2] == ["start", "text-start"], types
    assert types[-3:] == ["source-document", "finish", "[DONE]"] \
        or types[-3:] == ["text-end", "finish", "[DONE]"], types
    return ("".join(f.get("delta", "") for f in frames
                    if isinstance(f, dict) and f["type"] == "text-delta"),
            [(f["title"], f["snippet"]) for f in frames
             if isinstance(f, dict) and f["type"] == "source-document"])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Each app's answers to both benches, and its engine and store key."""
    out = {}
    for pkg in ("jax", "port"):
        tmp = tmp_path_factory.mktemp(pkg)
        client, ctx = build(pkg, tmp, **PRODUCTION)
        app = App(pkg, client, ctx)
        h = app.signup()
        sid = app.create_store(h, "quality-meridian")["id"]
        for path in DOCS:
            r = client.post("/api/upload", headers=h,
                            data={"store_id": str(sid)},
                            files={"file": (path.name, path.read_bytes(),
                                            "text/markdown")})
            assert r.status_code == 201, r.text
        app.drain()
        key = ctx.db.one("SELECT engine_key FROM stores WHERE id=?",
                         (sid,))["engine_key"]
        out[pkg] = {"engine": ctx.rag.engine, "key": key,
                    "answers": {name: [_chat(app, h, sid, q) for q in qs]
                                for name, qs in BENCHES.items()}}
    return out


def test_production_settings_build_the_hybrid_engine(served):
    port, jax_e = served["port"]["engine"], served["jax"]["engine"]
    assert port.encoder_fingerprint() == jax_e.encoder_fingerprint() == \
        "hybrid-hash-minilm:dim768:minilm_ict.npz:w0.35"
    assert port.encoder.mini.cfg.hidden == 384 and port.encoder.hash_enc.dim \
        == 384 and port.encoder.hash_enc._lib is not None
    assert port.device.type == "cpu"
    stats = port.store_stats(served["port"]["key"])
    assert stats == jax_e.store_stats(served["jax"]["key"])
    assert stats["documents"] == 10 and stats["chunks"] > 10


def _searches(served, q) -> dict:
    """Each engine's hits for the question as the app searches it."""
    rq = mod("port", "app.services.rag").reformulate_query(
        q["question"], q.get("history"))
    return {pkg: s["engine"].search([s["key"]], rq, k=SEARCH_K)
            for pkg, s in served.items()}


@pytest.mark.parametrize("bench", list(BENCHES))
def test_answers_and_citations_equal_the_jax_app(served, bench):
    qs = BENCHES[bench]
    got, want = (served[pkg]["answers"][bench] for pkg in ("port", "jax"))
    assert len(got) == len(want) == len(qs) == \
        {"questions": 120, "questions_multiturn": 24}[bench]
    ties = []
    for q, ours, theirs in zip(qs, got, want):
        hits = _searches(served, q)
        pairs = list(zip(hits["port"], hits["jax"]))
        first = next((rank for rank, (a, b) in enumerate(pairs)
                      if (a.doc_id, a.ordinal) != (b.doc_id, b.ordinal)),
                     None)
        # rank by rank, the same hits score alike; the first swap is a
        # near-tie
        for a, b in pairs[:first]:
            assert abs(a.score - b.score) <= HYBRID_TIE, (q, a, b)
        if first is not None:
            diff = abs(pairs[first][0].score - pairs[first][1].score)
            assert diff <= HYBRID_TIE, (q["question"], first, diff)
        if ours != theirs:
            assert first is not None, (q["question"], "the answers differ, "
                                       "the engines' hits do not")
            ties.append((q["question"], first, diff))
    assert len(ties) <= MAX_NEAR_TIES, ties
    # the answers are the system's, not refusals across the board
    cited = sum(1 for q, (_, cites) in zip(qs, got)
                if any(t in q.get("expected_sources", []) for t, _ in cites))
    assert cited >= len(qs) // 2
    print(f"{bench}: {len(qs) - len(ties)} of {len(qs)} equal, near-ties "
          f"{ties}")
