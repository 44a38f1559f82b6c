"""The JAX app's chat over the port's engine process, against the same
app over the in-process JAX engine.

``EngineRag.ask_stream`` (the app's real composition: search at the
reader depth, the lexical re-rank's over-fetch, the refusal gates, the
span reader, the citations) runs twice with the same settings
(``tests/app_helpers.make_settings``, the app's ``ENGINE_TOP_K`` 5,
``ENGINE_READER_K`` 12 and ``ENGINE_LEXICAL_RERANK`` 128, so the engine
is asked for k=12, or k=128 when a question has selector terms):

- over ``RemoteEngine`` (``ENGINE_RPC_MODE=connect``) to
  ``python -m rag_foundation_tpu_torch.engine_main`` in its own process
  on the CPU, given the same settings as ``RAGTPU_*`` variables;
- over an in-process JAX ``Engine``.

Both embed with their package's native hasher (the default; the two
libraries compute the same bits). Corpus: the ten documents of
``benchmarks/quality/docs`` through ``EngineRag.ingest_document``;
questions: all 120 of ``benchmarks/quality/questions.jsonl``. Per
question the streamed answer text and each citation's ``title`` and
``uri`` must be identical, in order; the citation ``score``
(``round(score, 6)``) within ``SCORE_TOL``: the two engines sum the same
f32 dot products in another order, and a last-place difference of the
rounded score is float-order noise.

Modes: ``exact`` (both engines ingest on their own), and ``ivf_flat_int8``
and ``ivf_pq`` with the host re-rank, where the port's ``engine_main``
serves a copy of the ``data_dir`` the JAX engine wrote: the packages'
k-means draws differ on purpose, so both must serve the same body. The
build threshold (48 of the corpus's 60 chunks) and ``nlist`` 8 (nprobe
4) make the ten documents build a body that holds most chunks beside a
streaming tail.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from rag_foundation_tpu.app.services import rag as rag_mod
from rag_foundation_tpu.engine.rpc import RemoteEngine as JaxRemote
from rag_foundation_tpu_torch import engine_main
from tests.app_helpers import make_settings

ROOT = Path(__file__).resolve().parents[1]
QUALITY = ROOT / "benchmarks" / "quality"
DOCS = sorted((QUALITY / "docs").glob("*.md"))
QUESTIONS = [json.loads(line)["question"] for line in
             (QUALITY / "questions.jsonl").read_text().splitlines()
             if line.strip()]
SCORE_TOL = 2e-6
IVF = dict(ENGINE_NLIST=8, ENGINE_NPROBE=4, ENGINE_BUILD_THRESHOLD=48)
MODES = {
    "exact": {},
    "ivf_flat_int8": dict(IVF, ENGINE_INDEX_MODE="ivf_flat_int8"),
    "ivf_pq": dict(IVF, ENGINE_INDEX_MODE="ivf_pq", ENGINE_PQ_M=32,
                   ENGINE_PQ_REFINE="host"),
}


def _engine_env(settings, sock: str) -> dict:
    """The app's engine settings as the ``RAGTPU_*`` variables the port's
    ``engine_main`` reads: every field it reads, from the same object."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(PYTHONPATH=str(ROOT), RAGTPU_ENVIRONMENT="test",
               RAGTPU_ENGINE_PLATFORM="cpu",
               RAGTPU_DATA_DIR=str(settings.DATA_DIR),
               RAGTPU_ENGINE_RPC_SOCKET=sock,
               RAGTPU_ENGINE_BATCH_WINDOW_MS=str(
                   settings.ENGINE_BATCH_WINDOW_MS))
    for _, name, typ, _ in engine_main._FIELDS:
        value = getattr(settings, name)
        env["RAGTPU_" + name] = str(value).lower() if typ is bool \
            else str(value)
    return env


def _spawn(settings, sock):
    return subprocess.Popen(
        [sys.executable, "-m", "rag_foundation_tpu_torch.engine_main"],
        cwd=str(settings.DATA_DIR), env=_engine_env(settings, sock),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _wait_ping(proc, sock, timeout=60.0):
    remote = JaxRemote(sock, timeout=60.0)
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"engine_main exited {proc.returncode}: "
                               f"{proc.stderr.read()}")
        try:
            if remote.ping():
                return
        except OSError:
            time.sleep(0.15)   # conftest bans sleeps > 0.2 s
    raise TimeoutError("engine_main never served")


def _ingest(rag, key):
    for i, doc in enumerate(DOCS):
        rag.ingest_document(key, f"doc-{i}", doc.name, doc.read_text())


def _ask_all(rag, key):
    out = []
    for q in QUESTIONS:
        deltas, result = rag.ask_stream(q, [key], model="test")
        text = "".join(deltas)
        assert result.finished
        out.append((text, [(c["title"], c["uri"]) for c in result.citations],
                    [c["score"] for c in result.citations]))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_app_chat_over_port_engine_matches_jax_engine(mode, tmp_path,
                                                      monkeypatch):
    # the app names a store stores/{user}-{slug}-{hex8}: one hex for both
    monkeypatch.setattr(rag_mod.secrets, "token_hex",
                        lambda n: "5eed" * (n // 2))
    jax_settings = make_settings(tmp_path / "jax", **MODES[mode])
    jax_rag = rag_mod.EngineRag(jax_settings)
    key = jax_rag.create_store("Quality Docs", 1)
    assert key == "stores/1-quality-docs-5eed5eed"
    _ingest(jax_rag, key)
    if mode != "exact":
        seg = jax_rag.engine._store(key).segment
        assert len(seg.body_chunk_ids) >= 0.75 * seg.count > 0
        assert seg.tail.count > 0

    sock = str(tmp_path / "engine.sock")
    port_settings = make_settings(tmp_path / "port", **MODES[mode],
                                  ENGINE_RPC_MODE="connect",
                                  ENGINE_RPC_SOCKET=sock)
    if mode != "exact":
        # the port serves what the JAX engine wrote, body.npz included
        shutil.copytree(tmp_path / "jax" / "data",
                        tmp_path / "port" / "data")
        with np.load(next((tmp_path / "port" / "data").rglob(
                "body.npz"))) as body:
            assert (body["body_chunk_ids"] >= 0).sum() == \
                len(seg.body_chunk_ids)
    (tmp_path / "port" / "data").mkdir(parents=True, exist_ok=True)
    proc = _spawn(port_settings, sock)
    try:
        _wait_ping(proc, sock)
        port_rag = rag_mod.EngineRag(port_settings)
        assert isinstance(port_rag.engine, JaxRemote)
        if mode == "exact":
            assert port_rag.create_store("Quality Docs", 1) == key
            _ingest(port_rag, key)
        assert port_rag.engine.store_stats(key) == \
            jax_rag.engine.store_stats(key)
        got = _ask_all(port_rag, key)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
            log = proc.stderr.read()
        finally:
            proc.stderr.close()
    assert proc.returncode == 0, log
    started = json.loads(next(line for line in log.splitlines()
                              if "engine_rpc_started" in line))
    assert started["native_shim"] is True and started["device"] == "cpu"
    want = _ask_all(jax_rag, key)

    # both k=12 and k=128 searches were asked
    selectors = sum(bool(rag_mod._selector_terms(q)) for q in QUESTIONS)
    assert 0 < selectors < len(QUESTIONS)
    answered = 0
    for q, (gt, gc, gs), (wt, wc, ws) in zip(QUESTIONS, got, want):
        assert gt == wt, q
        assert gc == wc, q
        assert np.abs(np.subtract(gs, ws)).max(initial=0.0) <= SCORE_TOL, \
            (q, gs, ws)
        answered += bool(gc)
    assert answered >= 0.9 * len(QUESTIONS)
