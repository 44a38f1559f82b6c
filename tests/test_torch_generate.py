"""The port engine's generative tier on the CPU: ``Engine.generate_stream``
and ``prewarm_generator``, the RPC ``generate`` stream on the port's
server (``tests/test_decoder.py``'s RPC cases against a real decoder),
and the JAX app's ``GenerativeGenerator`` streaming through the JAX
``RemoteEngine`` from the port's ``engine_main`` in its own process."""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from rag_foundation_tpu_torch.engine.api import Engine, EngineConfig
from rag_foundation_tpu_torch.engine.rpc import (EngineRpcError,
                                                 EngineRpcServer,
                                                 RemoteEngine)
from rag_foundation_tpu_torch.models.decoder import TextGenerator

ROOT = Path(__file__).resolve().parents[1]
SMOKE = str(ROOT / "checkpoints" / "decoder_smoke.npz")
QUESTION = "how long does maintenance of the optics unit take?"
EVIDENCE = ["Maintenance of the optics unit takes 12 hours on average.",
            "Operators must check the cooling panel every 30 minutes."]
# a prompt the smoke checkpoint answers with words of its evidence, which
# the app's grounding gate passes through as they are
APP_QUESTION = "check watts must"
APP_CHUNK = ("Maintenance of the storage unit takes 79 seconds on average. "
             "The sensor budget is capped at 2 watts per quarter. Operators "
             "must check the network panel every 24 percent. Maintenance of "
             "the power unit takes 69 liters on average.")


@pytest.fixture(scope="module")
def engine():
    return Engine(EngineConfig(dim=32, device="cpu", generator_ckpt=SMOKE,
                               gen_block=8))


def test_generate_stream_and_prewarm(engine):
    info = engine.prewarm_generator()
    assert set(info) == {"ckpt", "compile_s"}
    assert info["ckpt"] == SMOKE and info["compile_s"] >= 0
    deltas = list(engine.generate_stream(QUESTION, EVIDENCE))
    assert len(deltas) >= 2 and all(deltas)
    gen = TextGenerator(SMOKE, block=8, device="cpu")
    assert "".join(deltas) == "".join(gen.stream(QUESTION, EVIDENCE))
    # one block a delta after the prefill's token: max_tokens caps blocks
    assert len(list(engine.generate_stream(QUESTION, EVIDENCE,
                                           max_tokens=9))) <= 2
    assert engine._text_generator() is engine._text_generator()
    assert engine._text_generator().device.type == "cpu"


def test_first_concurrent_streams_build_one_generator():
    """The decoder is built at first use; streams racing to it share one."""
    import sys
    eng = Engine(EngineConfig(dim=32, device="cpu", generator_ckpt=SMOKE,
                              gen_block=8))
    want = "".join(TextGenerator(SMOKE, block=8, device="cpu").stream(
        QUESTION, EVIDENCE))
    got, built = [None] * 8, [None] * 8

    def run(i):
        got[i] = "".join(eng.generate_stream(QUESTION, EVIDENCE))
        built[i] = id(eng._text_generator())

    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert got == [want] * 8 and len(set(built)) == 1


def test_engine_without_ckpt_raises_jax_message():
    eng = Engine(EngineConfig(dim=32, device="cpu"))
    with pytest.raises(ValueError, match="no generative decoder configured"):
        list(eng.generate_stream("q", ["ev"]))
    with pytest.raises(ValueError, match="ENGINE_GENERATOR_CKPT"):
        eng.prewarm_generator()


def test_generator_settings_defaults_and_checks():
    from rag_foundation_tpu.engine.api import EngineConfig as JaxConfig
    cfg, jcfg = EngineConfig(), JaxConfig()
    assert (cfg.generator_ckpt, cfg.gen_block, cfg.gen_constrained) == (
        jcfg.generator_ckpt, jcfg.gen_block, jcfg.gen_constrained)
    with pytest.raises(ValueError, match="gen_block"):
        EngineConfig(gen_block=0)


@pytest.fixture()
def served(tmp_path, engine):
    path = str(tmp_path / "rpc.sock")
    server = EngineRpcServer(engine, path).start()
    remote = RemoteEngine(path, timeout=60.0)
    yield remote
    remote.close()
    server.shutdown()


def test_rpc_generate_stream_roundtrip(served, engine):
    want = list(engine.generate_stream(QUESTION, EVIDENCE))
    assert list(served.generate_stream(QUESTION, EVIDENCE)) == want
    # the connection is reusable for normal ops and another stream
    assert served.ping()
    assert list(served.generate_stream(QUESTION, EVIDENCE)) == want
    assert set(served.prewarm_generator()) == {"ckpt", "compile_s"}


def test_rpc_generate_stream_propagates_errors(tmp_path):
    path = str(tmp_path / "rpc.sock")
    server = EngineRpcServer(Engine(EngineConfig(dim=32, device="cpu")),
                             path).start()
    try:
        remote = RemoteEngine(path, timeout=60.0)
        with pytest.raises(EngineRpcError, match="no generative decoder"):
            list(remote.generate_stream("q", ["ev"]))
        assert remote.ping()      # the error frame left the socket usable
        # a plain op re-raises the engine's ValueError, as JAX's client does
        with pytest.raises(ValueError, match="no generative decoder"):
            remote.prewarm_generator()
    finally:
        server.shutdown()


def test_rpc_abandoned_stream_does_not_poison_pool(served, engine):
    want = list(engine.generate_stream(QUESTION, EVIDENCE))
    it = served.generate_stream(QUESTION, EVIDENCE)
    assert next(it) == want[0]
    it.close()         # abandoned mid-stream: the socket is discarded
    assert served.ping()
    assert list(served.generate_stream(QUESTION, EVIDENCE)) == want


def test_rpc_concurrent_streams(served, engine):
    questions = [f"how long does maintenance of the {w} unit take?"
                 for w in ("optics", "power", "cooling", "sensor")]
    want = ["".join(engine.generate_stream(q, EVIDENCE)) for q in questions]
    got = [None] * len(questions)

    def run(i):
        got[i] = "".join(served.generate_stream(questions[i], EVIDENCE))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(questions))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert got == want


# -- the JAX app over the port's engine process --------------------------------

def _spawn_port_engine_main(tmp_path, sock):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(PYTHONPATH=str(ROOT), RAGTPU_ENVIRONMENT="test",
               RAGTPU_ENGINE_PLATFORM="cpu",
               RAGTPU_DATA_DIR=str(tmp_path / "data"),
               RAGTPU_ENGINE_RPC_SOCKET=sock, RAGTPU_ENGINE_DIM="64",
               RAGTPU_ENGINE_GENERATOR_CKPT=SMOKE,
               RAGTPU_ENGINE_GEN_BLOCK="8")
    return subprocess.Popen(
        [sys.executable, "-m", "rag_foundation_tpu_torch.engine_main"],
        cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)


def _wait_ping(remote, proc, timeout=60.0):
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


def test_jax_app_generative_tier_streams_the_port_engine(tmp_path):
    """``GenerativeGenerator`` (the app's tier) through the JAX
    ``RemoteEngine`` streams the port engine's own answer: it would fall
    back to the span reader on an engine error, so the text must equal
    the engine's ``generate_stream`` for the same evidences, and the
    app's counter must record ``ok``, not a fallback."""
    from rag_foundation_tpu.app import metrics
    from rag_foundation_tpu.app.services.generator import (
        GenerativeGenerator, prep_evidence)
    from rag_foundation_tpu.app.services.rag import compose_answer
    from rag_foundation_tpu.engine.rpc import RemoteEngine as JaxRemote

    settings = SimpleNamespace(ENGINE_ANSWER_MODE="span")
    hits = [SimpleNamespace(text=APP_CHUNK, doc_name="ops.txt",
                            doc_id="d1", store_key="stores/x", ordinal=0,
                            score=0.9)]
    evidences = prep_evidence(APP_QUESTION, hits)
    own = Engine(EngineConfig(dim=64, device="cpu", generator_ckpt=SMOKE,
                              gen_block=8))
    want = "".join(own.generate_stream(APP_QUESTION, evidences))
    fallback = compose_answer(settings, APP_QUESTION, hits)
    assert want and want != fallback

    sock = str(tmp_path / "engine.sock")
    proc = _spawn_port_engine_main(tmp_path, sock)
    try:
        remote = JaxRemote(sock, timeout=60.0)
        _wait_ping(remote, proc)
        assert set(remote.prewarm_generator()) == {"ckpt", "compile_s"}
        ok = metrics.engine_calls_total.labels("generate", "ok")
        n0 = ok._value.get()
        got = "".join(GenerativeGenerator(settings, remote).stream(
            APP_QUESTION, hits))
        assert ok._value.get() == n0 + 1
        assert got == want
        assert "".join(remote.generate_stream(APP_QUESTION, evidences)) \
            == want
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        finally:
            proc.stderr.close()
    assert proc.returncode == 0
