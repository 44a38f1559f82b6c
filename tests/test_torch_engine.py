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
        remote.close()                  # pooled connections go ...
        assert not remote._pool
        assert remote.ping()            # ... and a later call reconnects
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


def test_approx_routing_is_accepted_and_matches_jax(tmp_path):
    # the JAX engine with approx_routing=True (lax.approx_max_k, exact on
    # its CPU backend) and the port serving a copy of its data_dir with
    # the flag set give the same hits; the flag reaches ivf_search through
    # StoreIndex as in the JAX package
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_e = JaxEngine(JaxConfig(**_cfg("ivf_flat_int8", jdir),
                                approx_routing=True))
    jax_e.encoder = JaxHashingEncoder(dim=DIM, use_native=False)
    jax_e.create_store(STORE)
    _ingest(jax_e, 0, 240)
    shutil.copytree(jdir, pdir)
    port = Engine(EngineConfig(**_cfg("ivf_flat_int8", pdir), device="cpu",
                               approx_routing=True))
    for e in (jax_e, port):
        assert e._store(STORE).segment.approx_routing is True
    assert port._store(STORE).segment.body is not None
    _assert_same_hits(_search_all(port), _search_all(jax_e),
                      _int8_body_ids(port))
    # a batch of all the queries passes Q*nprobe*8 > nlist and routes
    # through build_dispatch(approx=True)
    qv = port.encoder.encode(QUERIES * 2)
    jv, ji = jax_e._store(STORE).segment.search(qv, 5)
    tv, ti = port._store(STORE).segment.search(qv, 5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, **TOL)


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA"):
        Engine(EngineConfig(dim=64))
    with pytest.raises(ValueError, match="must divide"):
        EngineConfig(index_mode="ivf_pq", dim=64, pq_m=48)
    with pytest.raises(ValueError, match="unknown encoder"):
        EngineConfig(encoder="bert")
    with pytest.raises(RuntimeError, match="no CUDA"):
        Engine(EngineConfig(encoder="minilm", dim=64))


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
    assert cfg.approx_routing is False
    cfg, _, _ = config_from_env({"RAGTPU_ENGINE_APPROX_ROUTING": "true"})
    assert cfg.approx_routing is True


# -- the ivf_pq store ----------------------------------------------------------

PQ_M = 32       # 4 dims a subquantizer, as m=192 at d=768


def _pq_cfg(data_dir, refine="device", packed=False):
    return dict(_cfg("ivf_pq", data_dir), pq_m=PQ_M, pq_refine=refine,
                pq_packed=packed)


def _pq_jax(data_dir, **kw):
    e = JaxEngine(JaxConfig(**_pq_cfg(data_dir, **kw)))
    e.encoder = JaxHashingEncoder(dim=DIM, use_native=False)
    return e


def _pq_port(data_dir, **kw):
    return Engine(EngineConfig(**_pq_cfg(data_dir, **kw), device="cpu"))


def _assert_pq_hits(a, b, body_ids, refine="device"):
    """``ivf_pq`` parity between the packages on the same body: the same
    top hit for every query, the same hit on at least 0.95 of (query,
    rank) positions (one ulp in an f32 LUT sum can move a candidate at
    the ADC cut), and where both return the same chunk its score is
    bit-equal when the device refine store scored it (``body_ids``: int8
    dots times two scales), within 1e-5 relative for the host rescore and
    the exact tail (f32 dots), within 1e-3 for raw ADC sums."""
    same = total = 0
    for ha, hb in zip(a, b):
        assert ha and hb and _key(ha[0]) == _key(hb[0])
        for x, y in zip(ha, hb):
            total += 1
            if _key(x) != _key(y):
                # two f32-scored hits within 1e-5 of each other (a tie
                # in real arithmetic) may come in either order
                same += bool(np.isclose(x.score, y.score, rtol=1e-5)
                             and not (refine == "device"
                                      and {x.chunk_id, y.chunk_id}
                                      <= body_ids))
                continue
            same += 1
            in_body = x.chunk_id in body_ids
            if refine == "device" and in_body:
                assert np.float32(x.score) == np.float32(y.score)
            else:
                np.testing.assert_allclose(
                    x.score, y.score, rtol=1e-5,
                    atol=1e-3 if refine == "none" and in_body else 1e-6)
    assert same >= 0.95 * total, (same, total)


@pytest.mark.parametrize("refine", ["device", "host", "none"])
def test_ivf_pq_port_serves_jax_data_dir(refine, tmp_path):
    jdir = str(tmp_path / "jax")
    jax_e = _pq_jax(jdir, refine=refine)
    jax_e.create_store(STORE)
    _ingest(jax_e, 0, 200)
    jseg = jax_e._store(STORE).segment
    assert type(jseg.body).__name__ == "IVFPQIndex" and jseg.tail.count > 0
    pdir = str(tmp_path / "port")
    shutil.copytree(jdir, pdir)
    port = _pq_port(pdir, refine=refine)
    seg = port._store(STORE).segment
    # the saved body (codes, ids, codebooks, refine) and archive reload
    # verbatim, refine padded to 8 rows as saved
    for name in ("codes", "row_ids", "centroids", "codebook_centroids",
                 "refine"):
        np.testing.assert_array_equal(getattr(seg.body, name).numpy(),
                                      np.asarray(getattr(jseg.body, name)))
    assert seg.body.refine.shape[0] == (
        0 if refine != "device" else -(-len(seg.body_chunk_ids) // 8) * 8)
    np.testing.assert_array_equal(
        seg._pq_archive.chunk_i8(0, seg._pq_archive.n),
        jseg._pq_archive.chunk_i8(0, jseg._pq_archive.n))
    _assert_pq_hits(_search_all(port), _search_all(jax_e),
                    set(seg.body_chunk_ids.tolist()), refine)
    assert port.store_stats(STORE) == jax_e.store_stats(STORE)


@pytest.mark.parametrize("refine,packed", [("device", False),
                                           ("host", True)])
def test_ivf_pq_jax_serves_port_data_dir(refine, packed, tmp_path):
    pdir = str(tmp_path / "port")
    port = _pq_port(pdir, refine=refine, packed=packed)
    port.create_store(STORE)
    _ingest(port, 0, 200)
    port.delete_document(STORE, "doc-3")
    _ingest(port, 200, 215)       # a streaming tail beside the body
    seg = port._store(STORE).segment
    assert seg.body.packed == packed and seg.tail.count > 0
    jax_e = _pq_jax(pdir, refine=refine, packed=packed)
    assert jax_e.has_store(STORE)
    _assert_pq_hits(_search_all(jax_e), _search_all(port),
                    set(seg.body_chunk_ids.tolist()), refine)
    assert jax_e.store_stats(STORE) == port.store_stats(STORE)
    # and back: a restart of the port reloads its own body verbatim
    again = _pq_port(pdir, refine=refine, packed=packed)
    assert torch.equal(again._store(STORE).segment.body.codes, seg.body.codes)
    assert _search_all(again) == _search_all(port)


@pytest.mark.parametrize("refine", ["device", "host", "none"])
def test_ivf_pq_store_lifecycle(refine):
    """Ingest past the build threshold, search, append without a rebuild,
    delete, rebuild (compacts the archive), audit."""
    port = _pq_port(None, refine=refine)
    port.create_store(STORE)
    _ingest(port, 0, 200)
    seg = port._store(STORE).segment
    body0 = seg.body
    assert type(body0).__name__ == "IVFPQIndex" and body0.m == PQ_M
    assert (body0.refine.shape[0] > 0) == (refine == "device")
    assert seg._pq_archive.n == len(seg.body_chunk_ids)
    # top hits against the exact engine over the same documents: the
    # re-ranked tiers lose at most the candidates the 4-bit ADC cut
    # drops, raw ADC ranking more
    exact_e = _port_engine("exact", None)
    exact_e.create_store(STORE)
    _ingest(exact_e, 0, 200)
    right = sum(a[0].doc_id == b[0].doc_id
                for a, b in zip(_search_all(port), _search_all(exact_e)))
    assert right >= (5 if refine == "none" else 7), right

    # streaming append: the tail goes into the existing body in place
    _ingest(port, 200, 230)
    n_tail = seg.tail.count
    assert n_tail > 0 and seg.body is body0
    rows_before = len(seg.body_chunk_ids)
    seg._flush_tail_to_body()
    assert seg.body.codes is body0.codes           # no retrain, no relayout
    assert seg.tail.count == 0
    assert len(seg.body_chunk_ids) == rows_before + n_tail
    assert seg._pq_archive.n == len(seg.body_chunk_ids)
    hits = port.search([STORE], f"What is the codename for project "
                                f"{_name(215)}?", k=3)
    assert hits[0].doc_id == "doc-215"

    # delete: tombstoned at once, compacted away by the rebuild
    port.delete_document(STORE, "doc-17")
    assert all(h.doc_id != "doc-17" for hs in _search_all(port) for h in hs)
    live = seg.count - len(seg._dead)
    old_arch = seg._pq_archive
    seg.rebuild()
    assert seg._pq_archive is not old_arch and not seg._dead
    assert seg._pq_archive.n == len(seg.body_chunk_ids) == live
    assert seg.count == live
    assert all(h.doc_id != "doc-17" for hs in _search_all(port) for h in hs)

    # search_many pipelines batches and equals search batch for batch
    qv = port.encoder.encode(QUERIES)
    many = seg.search_many([qv[:4], qv[4:5], qv[5:]], 5)
    for (v, i), q in zip(many, (qv[:4], qv[4:5], qv[5:])):
        v1, i1 = seg.search(q, 5)
        np.testing.assert_array_equal(i, i1)
        np.testing.assert_array_equal(v, v1)

    # the exact audit: refine store on the device, or the host archive
    exact = seg.exact_reference_search(qv, 5)
    served = seg.search(qv, 5)[1]
    assert exact.shape == (len(QUERIES), 5)
    assert np.mean(exact[:, 0] == served[:, 0]) >= (
        0.3 if refine == "none" else 0.85)    # raw ADC ranks coarsely
    probe = port.recall_probe(STORE, sample=32, k=5)
    assert probe["sample"] > 0, probe
    assert probe["recall"] >= (0.3 if refine == "none" else 0.7), probe


def test_ivf_pq_audit_needs_stored_rows():
    port = _pq_port(None, refine="none")
    port.create_store(STORE)
    _ingest(port, 0, 200)
    seg = port._store(STORE).segment
    seg._pq_archive = None          # as after loading an old checkpoint
    with pytest.raises(NotImplementedError, match="refine store"):
        seg.exact_reference_search(port.encoder.encode(QUERIES[:2]), 5)
    # rows are then reconstructed from the codes (lossy) for a rebuild
    vecs, ids = seg.sample_live_rows(16)
    assert vecs.shape == (16, DIM) and np.all(np.isfinite(vecs))
    seg.rebuild()
    assert seg._pq_archive is not None
    hits = port.search([STORE], QUERIES[1], k=3)
    assert hits and hits[0].doc_id == "doc-3"


def test_ivf_pq_restores_round1_checkpoint_without_refine_fields():
    port = _pq_port(None)
    port.create_store(STORE)
    _ingest(port, 0, 200)
    seg = port._store(STORE).segment
    state = seg.body_state()
    assert {"f_refine", "f_refine_scale", "archive_rows",
            "archive_scale"} <= set(state)
    old = {k: v for k, v in state.items()
           if k not in ("f_refine", "f_refine_scale", "archive_rows",
                        "archive_scale")}
    fresh = _pq_port(None)._new_index(STORE)
    fresh.restore_body(old)
    assert fresh.body.refine.shape == (0, 0)
    assert fresh.body.refine_scale == 1.0 and fresh._pq_archive is None
    qv = port.encoder.encode(QUERIES)
    vals, ids = fresh.search(qv, 5)              # pure ADC ranking
    assert np.all(np.isfinite(vals[:, 0]))
    assert np.mean(ids[:, 0] == seg.search(qv, 5)[1][:, 0]) >= 0.5
    # a rebuild sources the rows from the codes once
    fresh.rebuild()
    assert fresh._pq_archive is not None
    assert fresh.body.refine.shape[0] > 0


def test_ivf_pq_bulk_load_archive():
    from rag_foundation_tpu_torch.engine.archive import HostArchive
    from rag_foundation_tpu_torch.engine.index import StoreIndex
    rng = np.random.default_rng(0)
    c = rng.standard_normal((16, 64)).astype(np.float32)
    v = c[rng.integers(0, 16, 3000)] + 0.3 * rng.standard_normal(
        (3000, 64)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    arch = HostArchive(64)
    arch.reserve(3000)
    arch.append(v)
    ids = np.arange(100, 3100, dtype=np.int64)
    seg = StoreIndex(64, mode="ivf_pq", nlist=16, nprobe=8, pq_m=32,
                     device="cpu")
    seen = []
    seg.bulk_load_archive(arch, ids, progress=lambda a, b: seen.append(a))
    assert seen and seen[-1] == 3000 and seg._pq_archive is arch
    assert seg.count == 3000 and seg.body.nlist == 16
    _, got = seg.search(v[:32], 1)
    assert np.mean(got[:, 0] == ids[:32]) >= 0.9
    with pytest.raises(ValueError, match="chunk_ids length"):
        seg.bulk_load_archive(arch, ids[:-1])
    with pytest.raises(ValueError, match="requires mode"):
        StoreIndex(64, device="cpu").bulk_load_archive(arch, ids)
    with pytest.raises(ValueError, match="not divisible"):
        StoreIndex(64, mode="ivf_pq", pq_m=48, device="cpu")
    with pytest.raises(ValueError, match="unknown pq_refine"):
        StoreIndex(64, mode="ivf_pq", pq_m=16, pq_refine="disk",
                   device="cpu")


def test_engine_main_reads_pq_variables(tmp_path):
    cfg, _, _ = config_from_env({
        "RAGTPU_ENGINE_PLATFORM": "cpu", "RAGTPU_DATA_DIR": str(tmp_path),
        "RAGTPU_ENGINE_INDEX_MODE": "ivf_pq", "RAGTPU_ENGINE_DIM": "768",
        "RAGTPU_ENGINE_PQ_M": "192", "RAGTPU_ENGINE_PQ_PACKED": "true",
        "RAGTPU_ENGINE_PQ_REFINE": "host",
        "RAGTPU_ENGINE_PQ_CAP_SLACK": "1.1"})
    assert (cfg.index_mode, cfg.pq_m, cfg.pq_packed, cfg.pq_refine,
            cfg.pq_cap_slack) == ("ivf_pq", 192, True, "host", 1.1)
    cfg, _, _ = config_from_env({"RAGTPU_ENGINE_PLATFORM": "cpu"})
    assert (cfg.pq_m, cfg.pq_packed, cfg.pq_refine, cfg.pq_cap_slack) == (
        48, False, "device", 1.5)
    with pytest.raises(ValueError, match="pq_refine"):
        config_from_env({"RAGTPU_ENGINE_PQ_REFINE": "disk"})


@pytest.mark.parametrize("ivf_p,want", [(3, 4), (4, 4), (8, 8)])
def test_ivf_pq_capture_width_follows_ivf_p_from_four_up(ivf_p, want,
                                                         monkeypatch):
    # the JAX engine fixes the ADC scan's per-sub-block capture at 4; the
    # port takes a larger ivf_p (a deliberate difference), never less
    from rag_foundation_tpu_torch.engine import index as index_mod
    seen = []
    real = index_mod.ivfpq_search

    def spy(*a, **kw):
        seen.append(kw["p"])
        return real(*a, **kw)

    monkeypatch.setattr(index_mod, "ivfpq_search", spy)
    port = Engine(EngineConfig(**dict(_pq_cfg(None), ivf_p=ivf_p),
                               device="cpu"))
    port.create_store(STORE)
    _ingest(port, 0, 170)
    port.search([STORE], QUERIES[1], k=5)          # fetch 8
    port._store(STORE).segment.search(port.encoder.encode(QUERIES[:1]), 2)
    assert seen == [want, 2]


# -- the MiniLM and hybrid encoders --------------------------------------------

# a small MiniLM saved by the JAX package; the engines run it in bf16 (a
# checkpoint stores no dtype), so the two packages' embeddings differ at
# bf16 rounding level (tests/test_torch_encoder.py): scores agree within
# ENC_TOL (observed 1.3e-3), and two hits may swap only within it
MINI = dict(vocab_size=512, hidden=64, layers=2, heads=2, ffn=128,
            max_len=64)
ENC_TOL = 5e-3


@pytest.fixture(scope="module")
def minilm_ckpt(tmp_path_factory):
    import jax

    from rag_foundation_tpu.models import encoder as jenc
    cfg = jenc.EncoderConfig(**MINI)
    path = str(tmp_path_factory.mktemp("ckpt") / "mini.npz")
    jenc.save_params(jenc.init_params(jax.random.key(0), cfg), path, cfg)
    return path


def _enc_cfg(encoder, ckpt, data_dir=None, mode="exact"):
    # chunk_tokens 30 <= 0.6 * max_len: no window warning. An IVF body
    # probes all its lists: the two packages train other centroids
    return dict(dim=64 if encoder == "minilm" else 128, encoder=encoder,
                encoder_ckpt=ckpt, hybrid_w=0.35, chunk_tokens=30,
                chunk_overlap=5, index_mode=mode, nlist=16, nprobe=16,
                build_threshold=40, data_dir=data_dir)


def _enc_engines(encoder, ckpt, jdir=None, pdir=None, mode="exact"):
    jax_e = JaxEngine(JaxConfig(**_enc_cfg(encoder, ckpt, jdir, mode)))
    if encoder == "hybrid":     # the hash channel on the Python path
        jax_e.encoder.hash_enc = JaxHashingEncoder(dim=64, use_native=False)
    port = Engine(EngineConfig(**_enc_cfg(encoder, ckpt, pdir, mode),
                               device="cpu"))
    return jax_e, port


def _assert_near_hits(a, b, tol=ENC_TOL):
    """Scores rank by rank within ``tol``; a hit that beats the other
    list's last score by more than 2 tol is in the other list too."""
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert len(ha) == len(hb) > 0
        np.testing.assert_allclose([h.score for h in ha],
                                   [h.score for h in hb], rtol=0, atol=tol)
        for x, y in ((ha, hb), (hb, ha)):
            ids = {_key(h) for h in y}
            for h in x:
                if h.score > y[-1].score + 2 * tol:
                    assert _key(h) in ids, (h, y)


@pytest.mark.parametrize("encoder,mode", [("minilm", "exact"),
                                          ("minilm", "ivf_flat"),
                                          ("hybrid", "exact")])
def test_minilm_engines_ingest_and_search_alike(encoder, mode, minilm_ckpt):
    jax_e, port = _enc_engines(encoder, minilm_ckpt, mode=mode)
    assert port.encoder_fingerprint() == jax_e.encoder_fingerprint() == (
        "minilm-jax:dim64:mini.npz" if encoder == "minilm"
        else "hybrid-hash-minilm:dim128:mini.npz:w0.35")
    for e in (jax_e, port):
        e.create_store(STORE)
        _ingest(e, 0, 60)
    assert port.store_stats(STORE) == jax_e.store_stats(STORE)
    if mode == "ivf_flat":
        assert port._store(STORE).segment.body is not None
    # the stored vectors: the same chunks, embedded alike
    jv, ji = jax_e._store(STORE).segment.live_rows()
    pv, pi = port._store(STORE).segment.live_rows()
    jv, pv = np.asarray(jv)[np.argsort(ji)], np.asarray(pv)[np.argsort(pi)]
    assert np.array_equal(np.sort(ji), np.sort(pi))
    assert (jv * pv).sum(axis=1).min() >= 0.9995
    _assert_near_hits(_search_all(port), _search_all(jax_e))


def test_minilm_data_dirs_load_across_without_mismatch(minilm_ckpt,
                                                       tmp_path, caplog):
    import logging
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_e, port = _enc_engines("hybrid", minilm_ckpt, jdir, pdir)
    for e in (jax_e, port):
        e.create_store(STORE)
        _ingest(e, 0, 40)
    caplog.set_level(logging.WARNING)
    port_on_jax = Engine(EngineConfig(**_enc_cfg("hybrid", minilm_ckpt,
                                                 jdir), device="cpu"))
    jax_on_port, _ = _enc_engines("hybrid", minilm_ckpt, pdir)
    assert port_on_jax.has_store(STORE) and jax_on_port.has_store(STORE)
    assert not [r for r in caplog.records
                if "mismatch" in r.getMessage()
                or "embedded under" in r.getMessage()]
    _assert_near_hits(_search_all(port_on_jax), _search_all(jax_e))
    _assert_near_hits(_search_all(jax_on_port), _search_all(port))
    # another hybrid weight is another embedding space: the port says so
    caplog.clear()
    Engine(EngineConfig(**dict(_enc_cfg("hybrid", minilm_ckpt, jdir),
                               hybrid_w=0.5), device="cpu"))
    assert [r for r in caplog.records if "embedded under" in r.getMessage()]


def test_minilm_engine_checks_and_window_warning(minilm_ckpt, caplog):
    import logging
    with pytest.raises(ValueError, match="hidden=64"):
        Engine(EngineConfig(encoder="minilm", encoder_ckpt=minilm_ckpt,
                            dim=128, device="cpu"))
    with pytest.raises(ValueError, match="too small"):
        Engine(EngineConfig(encoder="hybrid", encoder_ckpt=minilm_ckpt,
                            dim=64, device="cpu"))
    caplog.set_level(logging.WARNING)
    Engine(EngineConfig(**_enc_cfg("minilm", minilm_ckpt), device="cpu"))
    assert "chunk_exceeds_encoder_window" not in caplog.text
    e = Engine(EngineConfig(encoder="minilm", encoder_ckpt=minilm_ckpt,
                            dim=64, chunk_tokens=200, device="cpu"))
    assert "chunk_exceeds_encoder_window" in caplog.text
    assert e.encoder.cfg.max_len == 64 and e.encoder.device.type == "cpu"
    # no checkpoint: a random MiniLM of the default architecture
    e = Engine(EngineConfig(encoder="minilm", dim=384, chunk_tokens=60,
                            device="cpu"))
    assert e.encoder.cfg.layers == 6 and e.encoder_fingerprint() == \
        "minilm-jax:dim384"


def test_engine_main_reads_encoder_variables(minilm_ckpt):
    cfg, _, _ = config_from_env({
        "RAGTPU_ENGINE_PLATFORM": "cpu", "RAGTPU_ENGINE_ENCODER": "hybrid",
        "RAGTPU_ENGINE_ENCODER_CKPT": minilm_ckpt,
        "RAGTPU_ENGINE_HYBRID_W": "0.5", "RAGTPU_ENGINE_DIM": "128"})
    assert (cfg.encoder, cfg.encoder_ckpt, cfg.hybrid_w, cfg.dim) == (
        "hybrid", minilm_ckpt, 0.5, 128)
    cfg, _, _ = config_from_env({"RAGTPU_ENGINE_PLATFORM": "cpu"})
    assert (cfg.encoder, cfg.encoder_ckpt, cfg.hybrid_w) == (
        "hash", None, 0.35)
