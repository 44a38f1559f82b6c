"""Port Engine (rag_foundation_tpu_torch/engine) against the JAX Engine.

Both engines serve the same documents from a shared ``data_dir`` (the
JAX engine writes it and the port loads it, and the reverse), so the
port scans the very body JAX trained. ``search`` must return the same
``SearchHit`` lists in the same order. Tolerances: ``ivf_flat_int8``
scores are bit-equal (exact int8 dots); ``exact`` and ``ivf_flat``
scores agree within 1e-5 relative (f32 matmul summation order). The
JAX engine is given the pure-Python hasher the port uses, so both embed
bit-identically.
"""

import shutil

import numpy as np
import pytest
import torch

from rag_foundation_tpu.engine.api import Engine as JaxEngine
from rag_foundation_tpu.engine.api import EngineConfig as JaxConfig
from rag_foundation_tpu.models.hash_encoder import \
    HashingEncoder as JaxHashingEncoder
from rag_foundation_tpu_torch.engine import Engine, EngineConfig, SearchHit
from rag_foundation_tpu_torch.engine.api import StoreNotFound
from rag_foundation_tpu_torch.engine.rpc import EngineRpcServer, RemoteEngine
from rag_foundation_tpu_torch.engine_main import config_from_env
from rag_foundation_tpu_torch.models.hash_encoder import HashingEncoder

STORE = "stores/parity"
DIM = 128


_SYL = ("ka", "lo", "mi", "ne", "ru", "ta", "vo", "zu", "pe", "shi", "dra",
        "gon", "bel", "tor", "qua", "xen", "fli", "mur", "sol", "yat")


def _name(i: int) -> str:
    """A made-up project name, unique per i < 8000: three base-20
    syllables of a permuted i, so neighbouring i share no syllable."""
    c = (i * 7919 + 13) % 8000
    return "".join(_SYL[(c // 20 ** j) % 20] for j in range(3)).capitalize()


def _doc(i: int) -> str:
    return (f"Project {_name(i)} report. The codename for project "
            f"{_name(i)} is ZEBRA{i * 7}. Its budget is {i * 13 % 997} "
            f"thousand credits and its lead office is in sector {i % 23} "
            f"of campus {'north' if i % 2 else 'south'}.")


QUERIES = [f"What is the codename for project {_name(i)}?"
           for i in (0, 3, 17, 42, 99, 150, 211)] + [
    "Which project has the codename ZEBRA294?",
    "Which project has its lead office in sector 5 of campus north?"]


def _cfg(mode: str, data_dir: str) -> dict:
    return dict(dim=DIM, chunk_tokens=30, chunk_overlap=5, index_mode=mode,
                nlist=64, nprobe=16, build_threshold=160, ivf_p=3,
                data_dir=data_dir)


def _jax_engine(mode, data_dir):
    e = JaxEngine(JaxConfig(**_cfg(mode, data_dir)))
    e.encoder = JaxHashingEncoder(dim=DIM, use_native=False)
    return e


def _port_engine(mode, data_dir):
    return Engine(EngineConfig(**_cfg(mode, data_dir), device="cpu"))


def _ingest(engine, lo, hi):
    for i in range(lo, hi):
        engine.ingest_document(STORE, f"doc-{i}", f"p{i}.txt", _doc(i))


def _int8_body_ids(engine):
    """Chunk ids scored by the int8 body scan (bit-exact); the rest come
    from the f32 tail scan."""
    seg = engine._store(STORE).segment
    if seg.mode != "ivf_flat_int8" or seg.body is None:
        return set()
    return set(seg.body_chunk_ids.tolist())


TOL = dict(rtol=1e-5, atol=1e-6)


def _key(h):
    return (h.doc_id, h.chunk_id, h.text, h.start, h.end, h.ordinal)


def _assert_same_hits(a, b, exact_ids=frozenset()):
    """Same hits in the same order. Hits scored by the int8 body scan
    (``exact_ids``) must match bit for bit; f32-scored hits within TOL,
    and two f32 hits whose scores lie within TOL of each other (a tie in
    real arithmetic) may come in either order."""
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert len(ha) == len(hb)
        np.testing.assert_allclose([h.score for h in ha],
                                   [h.score for h in hb], **TOL)
        for i, (x, y) in enumerate(zip(ha, hb)):
            if _key(x) == _key(y):
                if x.chunk_id in exact_ids:
                    assert np.float32(x.score) == np.float32(y.score)
                continue
            assert not ({x.chunk_id, y.chunk_id} <= set(exact_ids))
            near = [h for h in ha if h is not x and np.isclose(
                h.score, x.score, **TOL)]
            assert near or i == len(ha) - 1, (i, x, y)


def _search_all(engine):
    return [engine.search([STORE], q, k=5) for q in QUERIES]


def test_hash_encoder_bit_identical_to_jax_python_path():
    texts = [_doc(i) for i in range(20)] + QUERIES
    ours = HashingEncoder(dim=DIM)
    ref = JaxHashingEncoder(dim=DIM, use_native=False)
    np.testing.assert_array_equal(ours.encode(texts), ref.encode(texts))
    np.testing.assert_array_equal(ours.encode_queries(texts),
                                  ref.encode_queries(texts))


@pytest.mark.parametrize("mode", ["exact", "ivf_flat", "ivf_flat_int8"])
def test_port_serves_jax_data_dir_with_same_hits(mode, tmp_path):
    jdir = str(tmp_path / "jax")
    jax_e = _jax_engine(mode, jdir)
    jax_e.create_store(STORE)
    n_docs = 120 if mode == "exact" else 240   # JAX exact ingest is slow
    _ingest(jax_e, 0, n_docs)
    if mode != "exact":
        st = jax_e._store(STORE).segment
        assert st.body is not None and st.tail.count > 0
    # the port loads a copy, so the two engines mutate separate dirs
    pdir = str(tmp_path / "port")
    shutil.copytree(jdir, pdir)
    port = _port_engine(mode, pdir)
    assert port.has_store(STORE)
    _assert_same_hits(_search_all(port), _search_all(jax_e),
                      _int8_body_ids(port))
    # Q=1 with nprobe*8 > nlist goes through the list scan
    if mode != "exact":
        body = port._store(STORE).segment.body
        assert 1 * min(16, body.nlist) * 8 > body.nlist

    # tombstones in the body, then a streaming flush (tail -> body)
    for e in (jax_e, port):
        e.delete_document(STORE, "doc-17")
        e.delete_document(STORE, "doc-99")
    _assert_same_hits(_search_all(port), _search_all(jax_e),
                      _int8_body_ids(port))
    for e in (jax_e, port):
        _ingest(e, n_docs, n_docs + 50)
    if mode != "exact":
        # both engines flushed the tail into their bodies the same way
        # (flush size max(1024, threshold // 8) rows)
        for e in (jax_e, port):
            e._store(STORE).segment._flush_tail_to_body()
        np.testing.assert_array_equal(
            port._store(STORE).segment.body.row_ids.numpy(),
            np.asarray(jax_e._store(STORE).segment.body.row_ids))
    _assert_same_hits(_search_all(port), _search_all(jax_e),
                      _int8_body_ids(port))


@pytest.mark.parametrize("mode", ["exact", "ivf_flat_int8"])
def test_jax_serves_port_data_dir_with_same_hits(mode, tmp_path):
    pdir = str(tmp_path / "port")
    port = _port_engine(mode, pdir)
    port.create_store(STORE)
    _ingest(port, 0, 200)
    port.delete_document(STORE, "doc-3")
    _ingest(port, 200, 230)       # a streaming tail beside the body
    jax_e = _jax_engine(mode, pdir)
    assert jax_e.has_store(STORE)
    _assert_same_hits(_search_all(jax_e), _search_all(port),
                      _int8_body_ids(port))
    assert jax_e.store_stats(STORE) == port.store_stats(STORE)


def test_port_restart_reloads_body_verbatim(tmp_path):
    d = str(tmp_path / "port")
    a = _port_engine("ivf_flat_int8", d)
    a.create_store(STORE)
    _ingest(a, 0, 200)
    b = _port_engine("ivf_flat_int8", d)
    ba, bb = a._store(STORE).segment.body, b._store(STORE).segment.body
    assert torch.equal(ba.lists, bb.lists) and ba.scale == bb.scale
    _assert_same_hits(_search_all(b), _search_all(a), _int8_body_ids(a))


def test_rpc_round_trip(tmp_path):
    engine = Engine(EngineConfig(dim=DIM, device="cpu", batch_window_s=0.01))
    sock = str(tmp_path / "engine.sock")
    server = EngineRpcServer(engine, sock).start()
    try:
        remote = RemoteEngine(sock)
        assert remote.ping()
        remote.create_store(STORE)
        for i in range(30):
            remote.ingest_document(STORE, f"d{i}", f"{i}.txt", _doc(i))
        hits = remote.search([STORE], QUERIES[1], k=3)
        assert all(isinstance(h, SearchHit) for h in hits)
        assert hits[0].doc_id == "d3"
        assert hits == engine.search([STORE], QUERIES[1], k=3)
        scores, ids = remote.search_batch(STORE, QUERIES[:3], k=4)
        assert scores.shape == ids.shape == (3, 4)
        assert remote.store_stats(STORE)["documents"] == 30
        assert isinstance(remote.metrics_text(), str)
        with pytest.raises(StoreNotFound):
            remote.search(["stores/missing"], "q")
    finally:
        server.shutdown()


def test_pad_store_int8_recall_on_cpu(tmp_path):
    # the pads are the JAX engine's: noise of 0.35 per coordinate around
    # a unit center, nearly isotropic at this dim, so a pad row's ten
    # nearest rows lie in any list. Probing every list (nprobe = nlist)
    # leaves only the per-sub-block capture (ivf_p=8) between the served
    # path and the exact scan
    engine = Engine(EngineConfig(dim=DIM, index_mode="ivf_flat_int8",
                                 nlist=64, nprobe=64, ivf_p=8,
                                 device="cpu"))
    engine.create_store(STORE)
    for i in range(40):
        engine.ingest_document(STORE, f"d{i}", f"{i}.txt", _doc(i))
    out = engine.pad_store(STORE, 20_000)
    seg = engine._store(STORE).segment
    assert out["padded"] == 20_000 and seg.body is not None
    assert seg.count == 20_040 - int((seg.body_chunk_ids < 0).sum())
    hits = engine.search([STORE], QUERIES[1], k=3)
    assert hits and hits[0].doc_id == "d3"
    probe = engine.recall_probe(STORE, sample=32, k=10)
    assert probe["recall"] >= 0.95, probe


def test_pad_store_host_rows_match_jax():
    # modes other than ivf_flat_int8 pad with host rows from numpy's
    # generator: the same rows as the JAX engine's, bit for bit
    jax_e = _jax_engine("exact", None)
    port = _port_engine("exact", None)
    for e in (jax_e, port):
        e.create_store(STORE)
        e.pad_store(STORE, 3000, seed=3)
    js = jax_e._store(STORE).segment.state()
    ts = port._store(STORE).segment.state()
    np.testing.assert_array_equal(ts["ids"], js["ids"])
    np.testing.assert_array_equal(ts["vectors"], js["vectors"])


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA"):
        Engine(EngineConfig(dim=64))
    with pytest.raises(ValueError, match="not ported"):
        EngineConfig(index_mode="ivf_pq")
    with pytest.raises(ValueError, match="not ported"):
        EngineConfig(encoder="minilm")


def test_engine_main_config_from_env(tmp_path):
    cfg, sock, allow_pad = config_from_env({
        "RAGTPU_ENGINE_PLATFORM": "cpu", "RAGTPU_DATA_DIR": str(tmp_path),
        "RAGTPU_ENGINE_INDEX_MODE": "ivf_flat_int8",
        "RAGTPU_ENGINE_NLIST": "4096", "RAGTPU_ENGINE_NPROBE": "32",
        "RAGTPU_ENGINE_IVF_P": "3", "RAGTPU_ENGINE_DIM": "768",
        "RAGTPU_ENGINE_BATCH_WINDOW_MS": "2",
        "RAGTPU_ENVIRONMENT": "production"})
    assert (cfg.device, cfg.index_mode, cfg.nlist, cfg.nprobe, cfg.ivf_p,
            cfg.dim) == ("cpu", "ivf_flat_int8", 4096, 32, 3, 768)
    assert cfg.batch_window_s == pytest.approx(0.002)
    assert cfg.data_dir == str(tmp_path) + "/engine"
    assert sock == str(tmp_path / "engine.sock") and not allow_pad
    cfg, _, allow_pad = config_from_env({})
    assert cfg.device == "cuda" and cfg.index_mode == "exact" and allow_pad
