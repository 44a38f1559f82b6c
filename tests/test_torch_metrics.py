"""The port's engine faults against the JAX engine: ``VectorSegment``'s
``compact()`` and ``live_count``, the engine's Prometheus text over RPC,
and ``engine_main``'s generator settings.

The JAX registry (``rag_foundation_tpu.app.metrics``) is module-global,
so its series are compared as deltas over the searches of one test; the
port keeps one registry an ``Engine``. ``prometheus_client``'s parser is
a test-only import: the port renders the text itself.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from rag_foundation_tpu.engine.api import Engine as JaxEngine
from rag_foundation_tpu.engine.api import EngineConfig as JaxConfig
from rag_foundation_tpu.engine.rpc import EngineRpcServer as JaxRpcServer
from rag_foundation_tpu.engine.rpc import RemoteEngine as JaxRemote
from rag_foundation_tpu.engine.segments import \
    VectorSegment as JaxVectorSegment
from rag_foundation_tpu.models.hash_encoder import \
    HashingEncoder as JaxHashingEncoder
from rag_foundation_tpu_torch import engine_main
from rag_foundation_tpu_torch.engine import Engine, EngineConfig
from rag_foundation_tpu_torch.engine.metrics import (EngineMetrics, Gauge,
                                                     Histogram)
from rag_foundation_tpu_torch.engine.rpc import EngineRpcServer, RemoteEngine
from rag_foundation_tpu_torch.engine.segments import VectorSegment
from rag_foundation_tpu_torch.models.hash_encoder import HashingEncoder

ROOT = Path(__file__).resolve().parents[1]
DIM = 64


# -- fault 1: VectorSegment.compact() and live_count ---------------------------

@pytest.mark.parametrize("n,dead_share,seed", [
    (300, 0.3, 0), (2500, 0.1, 1), (1030, 0.9, 2), (50, 1.0, 3)])
def test_segment_compact_and_live_count_match_jax(n, dead_share, seed):
    """Same rows and deletes into both segments; count and live_count
    agree before and after compact(), and so do the searches (ids
    exactly, scores within 1e-6: f32 dots of unit rows)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, DIM)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    ids = rng.permutation(10 * n)[:n].astype(np.int32)
    jax_seg = JaxVectorSegment(DIM)
    port = VectorSegment(DIM, device="cpu")
    for lo in range(0, n, 700):          # several appends, growth included
        jax_seg.add(v[lo:lo + 700], ids[lo:lo + 700])
        port.add(v[lo:lo + 700], ids[lo:lo + 700])
    dead = set(int(i) for i in rng.choice(ids, int(n * dead_share),
                                          replace=False))
    jax_seg.delete_ids(dead)
    port.delete_ids(dead)
    q = rng.standard_normal((7, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    k = 10
    assert (port.count, port.live_count) == (jax_seg.count,
                                             jax_seg.live_count)
    assert port.live_count == n - len(dead)
    before = port.search(q, k)
    jax_seg.compact()
    port.compact()
    assert (port.count, port.live_count) == (jax_seg.count,
                                             jax_seg.live_count)
    assert port.count == port.live_count == n - len(dead)
    js, ji = jax_seg.search(q, k)
    ps, pi = port.search(q, k)
    np.testing.assert_array_equal(pi, np.asarray(ji))
    np.testing.assert_allclose(ps, np.asarray(js), rtol=0, atol=1e-6)
    # compaction changes no result of the port's own search
    np.testing.assert_array_equal(pi, before[1])
    assert not set(pi[pi >= 0].tolist()) & dead


# -- fault 2: the engine's Prometheus text -------------------------------------

def _families(text: str) -> dict:
    return {f.name: f for f in text_string_to_metric_families(text)}


def _hist(fams, name, **labels):
    """{le: cumulative count}, count and sum of one histogram child."""
    buckets, count, total = {}, 0.0, 0.0
    for s in fams[name].samples if name in fams else ():
        own = {k: v for k, v in s.labels.items() if k != "le"}
        if own != labels:
            continue
        if s.name == name + "_bucket":
            buckets[float(s.labels["le"])] = s.value
        elif s.name == name + "_count":
            count = s.value
        elif s.name == name + "_sum":
            total = s.value
    return buckets, count, total


def _stage_counts(fams) -> dict:
    return {s.labels["stage"]: s.value
            for s in fams["engine_query_stage_seconds"].samples
            if s.name == "engine_query_stage_seconds_count"}


def _gauge(fams, name, **labels):
    for s in fams[name].samples:
        if s.labels == labels:
            return s.value
    return None


def _doc(i: int) -> str:
    return (f"Project {i} report. The codename for project {i} is "
            f"ZEBRA{i * 7}. Its budget is {i * 13 % 997} thousand credits.")


def _drive(remote, store):
    """The same traffic for both engines: ingest, single searches,
    a recall audit."""
    remote.create_store(store)
    for i in range(40):
        remote.ingest_document(store, f"d{i}", f"{i}.txt", _doc(i))
    for i in range(5):
        remote.search([store], f"What is the codename for project {i}?",
                      k=3)
    return remote.recall_probe(store, k=5, sample=16)


def test_metrics_text_matches_jax_engine(tmp_path):
    """``metrics_text`` over the port's RPC parses as Prometheus text with
    the JAX engine's series: the batch-size histogram's buckets and
    counts, the stage labels and their counts, and the recall gauge, for
    the same searches (JAX's module-global registry as deltas)."""
    groups = [3, 1, 17, 130, 8]
    store = f"stores/metrics-{os.getpid()}"

    jax_engine = JaxEngine(JaxConfig(dim=DIM))
    jax_engine.encoder = JaxHashingEncoder(dim=DIM, use_native=False)
    jsock = str(tmp_path / "jax.sock")
    jserver = JaxRpcServer(jax_engine, jsock).start()
    try:
        jremote = JaxRemote(jsock)
        j0 = _families(jremote.metrics_text())
        jprobe = _drive(jremote, store)
        for n in groups:
            jax_engine._search_group([store], ["codename"] * n, 4)
        j1 = _families(jremote.metrics_text())
    finally:
        jserver.shutdown()

    engine = Engine(EngineConfig(dim=DIM, device="cpu"))
    engine.encoder = HashingEncoder(dim=DIM, use_native=False)
    sock = str(tmp_path / "port.sock")
    server = EngineRpcServer(engine, sock).start()
    try:
        remote = RemoteEngine(sock)
        p0 = _families(remote.metrics_text())
        pprobe = _drive(remote, store)
        for n in groups:
            engine._search_group([store], ["codename"] * n, 4)
        text = remote.metrics_text()
        p1 = _families(text)
        remote.close()
    finally:
        server.shutdown()

    assert pprobe == jprobe
    name = "engine_search_batch_size"
    jb0, jc0, js0 = _hist(j0, name)
    jb1, jc1, js1 = _hist(j1, name)
    pb0, pc0, ps0 = _hist(p0, name)
    pb1, pc1, ps1 = _hist(p1, name)
    assert (pc0, ps0) == (0, 0) and set(pb0.values()) == {0}
    assert sorted(pb1) == sorted(jb1) == [1, 2, 4, 8, 16, 32, 64, 128,
                                          float("inf")]
    assert {le: pb1[le] for le in pb1} == {le: jb1[le] - jb0.get(le, 0)
                                          for le in jb1}
    assert pc1 == jc1 - jc0 == 5 + len(groups)
    assert ps1 == js1 - js0 == 5 + sum(groups)
    assert pb1[8] == 5 + 3          # five singles, then 3, 1 and 8
    # stages: the same labels, each observed once a group
    jst0, jst1, pst = _stage_counts(j0), _stage_counts(j1), _stage_counts(p1)
    assert set(pst) == {"embed", "scan", "merge"}
    assert pst == {s: jst1[s] - jst0.get(s, 0) for s in jst1}
    _, _, stage_sum = _hist(p1, "engine_query_stage_seconds", stage="scan")
    assert stage_sum > 0
    # the recall audit's gauge, and device memory left unset on the CPU
    k = str(pprobe["k"])
    assert _gauge(p1, "engine_recall_at_k", store=store, k=k) == \
        _gauge(j1, "engine_recall_at_k", store=store, k=k) == \
        pprobe["recall"]
    assert _gauge(p1, "engine_device_bytes_in_use") == 0
    for fam in ("engine_search_batch_size", "engine_query_stage_seconds",
                "engine_recall_at_k", "engine_device_bytes_in_use"):
        assert p1[fam].type == j1[fam].type
        assert p1[fam].documentation == j1[fam].documentation
        assert f"# TYPE {fam} {p1[fam].type}" in text


def test_metrics_render_format():
    """The text exposition format by hand: cumulative buckets ending in
    +Inf, _count and _sum, escaped label values, a labelled gauge."""
    h = Histogram("t_seconds", "A latency", ["stage"], buckets=(0.1, 1.0))
    for v in (0.05, 0.1, 0.5, 3.0):
        h.labels("scan").observe(v)
    g = Gauge("t_gauge", "A gauge", ["store"])
    g.labels(store='a"b\\c').set(0.25)
    text = h.render() + g.render()
    assert text.splitlines()[:2] == ["# HELP t_seconds A latency",
                                     "# TYPE t_seconds histogram"]
    assert 't_seconds_bucket{stage="scan",le="0.1"} 2' in text
    assert 't_seconds_bucket{stage="scan",le="1.0"} 3' in text
    assert 't_seconds_bucket{stage="scan",le="+Inf"} 4' in text
    assert 't_seconds_count{stage="scan"} 4' in text
    fams = _families(text)
    sums = [s.value for s in fams["t_seconds"].samples
            if s.name == "t_seconds_sum"]
    assert sums == [pytest.approx(3.65)]
    assert [(s.labels, s.value) for s in fams["t_gauge"].samples] == \
        [({"store": 'a"b\\c'}, 0.25)]
    m = EngineMetrics()
    assert m.update_device_memory("cpu") is None
    assert _gauge(_families(m.render()), "engine_device_bytes_in_use") == 0


def test_port_runtime_does_not_import_prometheus_client():
    """The card machine has no prometheus_client: the port's engine, RPC
    and engine_main run without it."""
    code = ("import sys\n"
            "import rag_foundation_tpu_torch.engine_main\n"
            "from rag_foundation_tpu_torch.engine import Engine, EngineConfig\n"
            "from rag_foundation_tpu_torch.engine.rpc import EngineRpcServer\n"
            "e = Engine(EngineConfig(dim=32, device='cpu'))\n"
            "e.create_store('s'); e.ingest_document('s', 'd', 'd.txt', 'x y')\n"
            "e.search(['s'], 'x'); e.recall_probe('s', k=1, sample=1)\n"
            "e.metrics.render()\n"
            "assert 'prometheus_client' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})


# -- engine_main's generator settings (the refusal they replace is gone) ------

def test_engine_main_reads_the_generator_settings():
    from rag_foundation_tpu.app.config import Settings
    fields = Settings.model_fields
    cfg, _, _ = engine_main.config_from_env({"RAGTPU_ENGINE_PLATFORM": "cpu"})
    # unset: the JAX app's defaults (an empty checkpoint means none)
    assert (cfg.generator_ckpt or "", cfg.gen_block, cfg.gen_constrained) \
        == (fields["ENGINE_GENERATOR_CKPT"].default,
            fields["ENGINE_GEN_BLOCK"].default,
            fields["ENGINE_GEN_CONSTRAINED"].default) == ("", 16, True)
    assert cfg.generator_ckpt is None
    cfg, _, _ = engine_main.config_from_env({
        "RAGTPU_ENGINE_PLATFORM": "cpu",
        "RAGTPU_ENGINE_GENERATOR_CKPT": "checkpoints/decoder_smoke.npz",
        "RAGTPU_ENGINE_GEN_BLOCK": "4", "RAGTPU_ENGINE_GEN_CONSTRAINED": "0"})
    assert (cfg.generator_ckpt, cfg.gen_block, cfg.gen_constrained) == (
        "checkpoints/decoder_smoke.npz", 4, False)
    assert cfg.device == "cpu"


@pytest.mark.parametrize("block", ["sixteen", "0"])
def test_engine_main_exits_before_the_socket_on_a_bad_gen_block(
        tmp_path, monkeypatch, block):
    sock = tmp_path / "engine.sock"
    for name, value in (("ENGINE_PLATFORM", "cpu"),
                        ("DATA_DIR", str(tmp_path)),
                        ("ENGINE_RPC_SOCKET", str(sock)),
                        ("ENGINE_GENERATOR_CKPT", "decoder.npz"),
                        ("ENGINE_GEN_BLOCK", block)):
        monkeypatch.setenv("RAGTPU_" + name, value)
    with pytest.raises(SystemExit) as e:
        engine_main.main()
    assert e.value.code not in (0, None)
    assert "engine_main" in str(e.value.code)
    assert not sock.exists()


def test_engine_main_prewarms_and_serves_the_generator(tmp_path):
    """With a checkpoint set, ``main`` opens the socket, prewarms the
    decoder (``generator_prewarmed`` in its log) and serves
    ``prewarm_generator`` and the ``generate`` stream."""
    import time
    sock = str(tmp_path / "engine.sock")
    ckpt = str(ROOT / "checkpoints" / "decoder_smoke.npz")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(PYTHONPATH=str(ROOT), RAGTPU_ENGINE_PLATFORM="cpu",
               RAGTPU_DATA_DIR=str(tmp_path / "data"),
               RAGTPU_ENGINE_RPC_SOCKET=sock,
               RAGTPU_ENGINE_GENERATOR_CKPT=ckpt)
    proc = subprocess.Popen(
        [sys.executable, "-m", "rag_foundation_tpu_torch.engine_main"],
        cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        remote = RemoteEngine(sock, timeout=60.0)
        deadline = time.time() + 60
        while True:
            assert proc.poll() is None, proc.stderr.read()
            assert time.time() < deadline, "engine_main never served"
            try:
                if remote.ping():
                    break
            except OSError:
                time.sleep(0.15)
        info = remote.prewarm_generator()
        assert info["ckpt"] == ckpt and info["compile_s"] >= 0
        assert "".join(remote.generate_stream("how fast?", ["it is fast"]))
        remote.close()
    finally:
        proc.terminate()
        _, err = proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    assert '"event": "generator_prewarmed"' in err
