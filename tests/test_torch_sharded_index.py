"""Port sharded store and engine wiring (parallel/sharded_index.py,
engine/index.py and engine/api.py on a mesh) against the JAX package's
on the conftest's 8 virtual CPU devices; the port shards over
``[cpu] * 8``.

Tolerances: ids are equal; f32 scores agree within 1e-5 relative (the
two packages' matmuls sum in another order) and int8 body scores are
bit-identical; layouts after appends and saved states are compared
exactly. The JAX engine is given the pure-Python hasher the port uses.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rag_foundation_tpu.engine.api import Engine as JaxEngine
from rag_foundation_tpu.engine.api import EngineConfig as JaxConfig
from rag_foundation_tpu.engine.index import StoreIndex as JaxStoreIndex
from rag_foundation_tpu.models.hash_encoder import \
    HashingEncoder as JaxHashingEncoder
from rag_foundation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rag_foundation_tpu.parallel.sharded_index import \
    ShardedVectorStore as JaxShardedStore
from rag_foundation_tpu_torch.engine import Engine, EngineConfig
from rag_foundation_tpu_torch.engine.index import StoreIndex
from rag_foundation_tpu_torch.engine.segments import VectorSegment
from rag_foundation_tpu_torch.engine_main import config_from_env
from rag_foundation_tpu_torch.models.hash_encoder import HashingEncoder
from rag_foundation_tpu_torch.parallel.mesh import make_mesh
from rag_foundation_tpu_torch.parallel.sharded_index import \
    ShardedVectorStore
from rag_foundation_tpu_torch.parallel.sharded_ivf import ShardedBody
from tests.test_torch_engine import (STORE, _assert_same_hits, _cfg, _ingest,
                                     _int8_body_ids, _search_all)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-6)
D, NLIST = 64, 32


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax_make_mesh(8)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=[CPU] * 8)


def _vecs(n, d=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(n, seed=17):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((NLIST, D)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    v = c[rng.integers(0, NLIST, n)] + 0.25 * rng.standard_normal(
        (n, D)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


# -- ShardedVectorStore ------------------------------------------------------

def _assert_same_search(t, j, q, k):
    tv, ti = t.search(q, k)
    jv, ji = j.search(q, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, **TOL)
    assert ti.dtype == np.int64 and ti.shape == (len(q), k)
    return tv, ti


def test_sharded_store_matches_jax_through_add_delete_compact(jmesh, mesh):
    x = _vecs(3000)
    ids = np.arange(3000) * 7            # non-contiguous ids
    t = ShardedVectorStore(32, mesh, shard_capacity=256)
    j = JaxShardedStore(32, jmesh, shard_capacity=256)
    q = np.concatenate([x[[0, 5, 999, 2999]], _vecs(5, seed=1)])
    for lo, hi in ((0, 5), (5, 1000), (1000, 3000)):   # growth included
        t.add(x[lo:hi], ids[lo:hi])
        j.add(x[lo:hi], ids[lo:hi])
        np.testing.assert_array_equal(t._counts, j._counts)
        assert t._shard_cap == j._shard_cap and t.count == j.count
        _assert_same_search(t, j, q, 10)
    assert t._counts.max() - t._counts.min() <= 1     # water fill
    dead = {0, 35, 6993, 14, 20993}
    for s in (t, j):
        s.delete_ids(dead)
    assert t.live_count == 3000 - len(dead)
    _, ti = _assert_same_search(t, j, q, 10)
    assert not dead & set(ti.reshape(-1).tolist())
    _assert_same_search(t, j, q, 3000)               # fetch past the rows
    for s in (t, j):
        s.compact()
    np.testing.assert_array_equal(t._counts, j._counts)
    assert t.count == j.count == 3000 - len(dead)
    _assert_same_search(t, j, q, 10)
    ts, js = t.state(), j.state()
    np.testing.assert_array_equal(ts["ids"], js["ids"])
    np.testing.assert_array_equal(ts["vectors"], js["vectors"])


def test_sharded_store_matches_one_device_segment(mesh):
    x = _vecs(4000, seed=2)
    ids = np.arange(4000) * 3
    seg = VectorSegment(32, device="cpu")
    seg.add(x, ids)
    t = ShardedVectorStore(32, mesh)
    t.add(x, ids)
    q = _vecs(9, seed=3)
    sv, si = seg.search(q, 10)
    tv, ti = t.search(q, 10)
    np.testing.assert_array_equal(ti, si)
    np.testing.assert_allclose(tv, sv, **TOL)


def test_sharded_store_search_handle_keeps_its_snapshot(mesh):
    x = _vecs(500, seed=4)
    t = ShardedVectorStore(32, mesh)
    t.add(x[:300], np.arange(300))
    want = t.search(x[:3], 4)
    handle = t.search_dispatch(torch.as_tensor(x[:3]), 4)
    t.add(x[300:], np.arange(300, 500))
    t.delete_ids({0, 1})
    t.compact()
    got = t.search_finalize(handle)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    empty = ShardedVectorStore(32, mesh)
    v, i = empty.search(x[:2], 3)
    assert (i == -1).all() and np.isneginf(v).all()
    assert empty.state()["vectors"].shape == (0, 32)


# -- StoreIndex on a mesh ----------------------------------------------------

def _carry(jidx, mesh, **kw):
    """A port StoreIndex on ``mesh`` holding JAX's body and tail."""
    t = StoreIndex(D, mesh=mesh, device="cpu", **kw)
    t.restore_body(jidx.body_state())
    st = jidx.tail.state()
    if len(st["ids"]):
        t.tail.add(st["vectors"], st["ids"])
    return t


def _same_state(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


@pytest.mark.parametrize("mode", ["ivf_flat_int8", "ivf_flat"])
def test_mesh_store_flush_appends_like_jax(jmesh, mesh, mode):
    v = _clustered(5200)
    kw = dict(mode=mode, nlist=NLIST, nprobe=16, build_threshold=4000)
    j = JaxStoreIndex(D, mesh=jmesh, **kw)
    j.add(v[:4096], np.arange(4096))
    t = _carry(j, mesh, **kw)
    assert isinstance(t.body, ShardedBody) and t.body.nlist == NLIST
    assert isinstance(t.tail, ShardedVectorStore)
    q = v[100:164]
    tv, ti = t.search(q, 5)
    jv, ji = j.search(q, 5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, **TOL)
    cents = t.body.shards[0].centroids
    for s in (t, j):
        s.add(v[4096:4500], np.arange(4096, 4500))     # tail beside body
    _assert_idx_search(t, j, v[4090:4154], mode)
    for s in (t, j):
        s.add(v[4500:5200], np.arange(4500, 5200))     # > 1024: a flush
    assert t.tail.count == 0 and t.body_version == 2
    assert t.body.shards[0].centroids is cents        # appended, no retrain
    _same_state(t.body_state(), j.body_state())
    _assert_idx_search(t, j, v[4500:4564], mode)
    _, ids = t.search(v[4500:4503], 3)
    assert list(ids[:, 0]) == [4500, 4501, 4502]


def _assert_idx_search(t, j, q, mode):
    tv, ti = t.search(q, 5)
    jv, ji = j.search(q, 5)
    np.testing.assert_array_equal(ti, ji)
    if mode == "ivf_flat_int8":
        body = np.isin(ti, t.body_chunk_ids)
        np.testing.assert_array_equal(tv[body], jv[body])
    np.testing.assert_allclose(tv, jv, **TOL)


def test_mesh_store_saved_state_reloads_across_shard_counts(mesh):
    # probing every list, the hits do not depend on the shard count
    v = _clustered(4800, seed=5)
    kw = dict(mode="ivf_flat_int8", nlist=NLIST, nprobe=NLIST,
              build_threshold=4000)
    s8 = StoreIndex(D, mesh=mesh, device="cpu", **kw)
    s8.add(v[:4096], np.arange(4096))
    assert isinstance(s8.body, ShardedBody)
    s8.delete_ids({7, 8})
    q = v[:96]
    want = s8.search(q, 6)
    st8 = s8.body_state()
    one = StoreIndex(D, device="cpu", **kw)
    one.restore_body(st8)
    assert not isinstance(one.body, ShardedBody)
    _same_state(one.body_state(), st8)
    np.testing.assert_array_equal(one.search(q, 6)[1], want[1])
    back = StoreIndex(D, mesh=make_mesh(4, devices=[CPU] * 4), device="cpu",
                      **kw)
    back.restore_body(one.body_state())
    assert len(back.body.shards) == 4
    got = back.search(q, 6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    # the sharded audit over the lists equals the unsharded one
    np.testing.assert_array_equal(back.exact_reference_search(q, 6),
                                  one.exact_reference_search(q, 6))
    sv, si = back.sample_live_rows(16, seed=3)
    ov, oi = one.sample_live_rows(16, seed=3)
    np.testing.assert_array_equal(si, oi)
    np.testing.assert_array_equal(sv, ov)
    np.testing.assert_array_equal(back.live_rows()[1], one.live_rows()[1])


def test_only_a_restored_body_may_stay_whole_on_a_mesh(mesh):
    # nlist 12 does not split 8 ways: a body handed to the store raises,
    # a saved one is served whole by the one-device paths (JAX raises on
    # it: the next test)
    v = _clustered(2048, seed=3)
    kw = dict(mode="ivf_flat_int8", nlist=12, nprobe=12,
              build_threshold=4000)
    one = StoreIndex(D, device="cpu", **kw)
    one.add(v, np.arange(2048))
    one.rebuild()
    assert one.body.nlist == 12
    t = StoreIndex(D, mesh=mesh, device="cpu", **kw)
    with pytest.raises(ValueError, match="nlist 12 must divide by 8"):
        t.adopt_body(one.body, one.body_chunk_ids)
    assert t.body is None
    t.restore_body(one.body_state())
    assert not isinstance(t.body, ShardedBody)
    np.testing.assert_array_equal(t.search(v[:32], 5)[1],
                                  one.search(v[:32], 5)[1])
    # a rebuild sizes nlist for the shards and splits the body
    t.add(v[:8], np.arange(5000, 5008))
    t.rebuild()
    assert isinstance(t.body, ShardedBody) and t.body.nlist % 8 == 0


def test_restored_unsplittable_body_jax_raises_the_port_serves(jmesh,
                                                                mesh):
    """A saved body whose nlist (12) does not split over 8 shards. The JAX
    ``StoreIndex`` keeps it whole on restore but still takes its sharded
    search and flush paths, where ``shard_map`` raises; the port serves
    it whole, and its first streaming flush lands in it."""
    kw = dict(mode="ivf_flat_int8", nlist=12, nprobe=12,
              build_threshold=4000)
    v = _clustered(2048, seed=3)
    one = JaxStoreIndex(D, **kw)
    one.add(v, np.arange(2048))
    one.rebuild()
    assert one.body.nlist == 12
    state = one.body_state()
    j = JaxStoreIndex(D, mesh=jmesh, **kw)
    t = StoreIndex(D, mesh=mesh, device="cpu", **kw)
    j.restore_body(state)
    t.restore_body(state)
    assert not isinstance(t.body, ShardedBody)
    for q in (v[:1], v[:32]):
        with pytest.raises(ValueError, match="not evenly divisible"):
            j.search(q, 5)
        want = one.search(q, 5)
        got = t.search(q, 5)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])   # int8 dots
    new = _clustered(1100, seed=4)
    new_ids = np.arange(10_000, 11_100)
    with pytest.raises(ValueError, match="not evenly divisible"):
        j.add(new, new_ids)              # the tail passes 1024: a flush
    version = t.body_version
    t.add(new, new_ids)
    assert t.body_version > version and t.tail.count == 0
    assert not isinstance(t.body, ShardedBody) and t.body.nlist == 12
    assert (t.body_chunk_ids >= 10_000).sum() == 1100
    assert t.count == 2048 + 1100
    assert np.mean(t.search(new[:64], 1)[1][:, 0] == new_ids[:64]) >= 0.95


def test_mesh_ivfpq_host_refine_like_jax_and_across_shard_counts(jmesh,
                                                                 mesh):
    v = _clustered(4096, seed=9)
    kw = dict(mode="ivf_pq", nlist=NLIST, nprobe=NLIST, build_threshold=4000,
              pq_m=16, pq_packed=True, pq_refine="host")
    j = JaxStoreIndex(D, mesh=jmesh, **kw)
    j.add(v, np.arange(4096))
    t = _carry(j, mesh, **kw)
    assert isinstance(t.body, ShardedBody) and t._pq_archive is not None
    q = v[100:132]
    jv, ji = j.search(q, 5)
    tv, ti = t.search(q, 5)
    _assert_pq_close((tv, ti), (jv, ji))
    assert list(ti[:4, 0]) == [100, 101, 102, 103]
    # 8 -> 1 -> 8: the same saved state and the same hits
    st8 = t.body_state()
    _same_state(st8, j.body_state())
    one = StoreIndex(D, device="cpu", **kw)
    one.restore_body(st8)
    assert not isinstance(one.body, ShardedBody)
    _same_state(one.body_state(), st8)
    # one device takes the int8 query transport, the mesh bf16 (as in the
    # JAX engine): their ADC candidates may differ at the cut
    _assert_pq_close(one.search(q, 5), (tv, ti))
    back = StoreIndex(D, mesh=mesh, device="cpu", **kw)
    back.restore_body(one.body_state())
    assert isinstance(back.body, ShardedBody)
    bv, bi = back.search(q, 5)
    np.testing.assert_array_equal(bi, ti)
    np.testing.assert_array_equal(bv, tv)
    np.testing.assert_array_equal(back.exact_reference_search(q, 5),
                                  one.exact_reference_search(q, 5))


def _assert_pq_close(a, b):
    """test_torch_engine.py's ivf_pq parity: one ulp in an f32 LUT entry
    can move a candidate at the ADC cut, so the same top hit everywhere
    and the same row on 0.95 of the (query, rank) positions; where the
    rows agree, the host rescore's f32 scores within 1e-5."""
    (av, ai), (bv, bi) = a, b
    np.testing.assert_array_equal(ai[:, 0], bi[:, 0])
    same = ai == bi
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_allclose(av[same], bv[same], **TOL)


def test_mesh_ivfpq_refuses_the_device_refine_table(mesh):
    with pytest.raises(ValueError, match="pq_refine='host'"):
        StoreIndex(D, mode="ivf_pq", pq_m=16, pq_refine="device",
                   mesh=mesh, device="cpu")


# -- Engine and engine_main --------------------------------------------------

def test_engine_mesh_shards_serves_jax_data_dir_with_same_hits(tmp_path):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    cfg = _cfg("ivf_flat_int8", jdir)
    jax_e = JaxEngine(JaxConfig(**cfg, mesh_shards=8))
    jax_e.encoder = JaxHashingEncoder(dim=cfg["dim"], use_native=False)
    jax_e.create_store(STORE)
    _ingest(jax_e, 0, 240)
    shutil.copytree(jdir, pdir)
    port = Engine(EngineConfig(**_cfg("ivf_flat_int8", pdir),
                               mesh_shards=8, device="cpu"))
    port.encoder = HashingEncoder(dim=cfg["dim"], use_native=False)
    seg = port._store(STORE).segment
    assert isinstance(seg.body, ShardedBody) and len(seg.body.shards) == 8
    assert isinstance(seg.tail, ShardedVectorStore) and seg.tail.count > 0
    _assert_same_hits(_search_all(port), _search_all(jax_e),
                      _int8_body_ids(port))
    for e in (jax_e, port):
        e.delete_document(STORE, "doc-17")
        _ingest(e, 240, 290)
        e._store(STORE).segment._flush_tail_to_body()
    _same_state(port._store(STORE).segment.body_state(),
                jax_e._store(STORE).segment.body_state())
    _assert_same_hits(_search_all(port), _search_all(jax_e),
                      _int8_body_ids(port))
    # the mesh engine's save reloads on one device with the same body
    port.save()
    single = Engine(EngineConfig(**_cfg("ivf_flat_int8", pdir),
                                 device="cpu"))
    _same_state(single._store(STORE).segment.body_state(),
                port._store(STORE).segment.body_state())


def test_engine_takes_an_explicit_mesh():
    mesh4 = make_mesh(4, devices=[CPU] * 4)
    e = Engine(EngineConfig(dim=64, device="cpu", index_mode="ivf_flat",
                            nlist=8, build_threshold=64, chunk_tokens=12,
                            chunk_overlap=2), mesh=mesh4)
    e.create_store("s")
    e.ingest_document("s", "d", "a.txt", " ".join(
        f"tok{i} alpha beta gamma" for i in range(300)))
    seg = e._store("s").segment
    assert seg.mesh is mesh4 and len(seg.body.shards) == 4
    assert e.search(["s"], "tok123 alpha", k=3)
    with pytest.raises(ValueError, match="mesh of 4 shards"):
        Engine(EngineConfig(dim=64, device="cpu", mesh_shards=8),
               mesh=mesh4)
    assert Engine(EngineConfig(dim=64, device="cpu",
                               mesh_shards=8)).mesh.shape["shard"] == 8
    assert Engine(EngineConfig(dim=64, device="cpu")).mesh is None


def _spawn_engine_main(tmp_path, sock):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(PYTHONPATH=str(ROOT), RAGTPU_ENVIRONMENT="test",
               RAGTPU_ENGINE_PLATFORM="cpu", RAGTPU_ENGINE_MESH_SHARDS="8",
               RAGTPU_DATA_DIR=str(tmp_path / "engine-data"),
               RAGTPU_ENGINE_RPC_SOCKET=sock, RAGTPU_ENGINE_DIM="64",
               RAGTPU_ENGINE_CHUNK_TOKENS="40",
               RAGTPU_ENGINE_CHUNK_OVERLAP="8")
    return subprocess.Popen(
        [sys.executable, "-m", "rag_foundation_tpu_torch.engine_main"],
        cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)


def test_jax_app_chat_over_a_sharded_port_engine_main(tmp_path):
    """The app's chat (upload -> ingest -> SSE) through the JAX
    ``RemoteEngine`` against the port's ``engine_main`` started with
    ``ENGINE_MESH_SHARDS=8`` on the CPU (tests/test_sharded_index.py's
    end-to-end case, the engine in its own process)."""
    from rag_foundation_tpu.engine.rpc import RemoteEngine as JaxRemote
    from tests.app_helpers import (create_store, drain_worker, make_app,
                                   signup, upload_text)
    assert config_from_env({"RAGTPU_ENGINE_MESH_SHARDS": "8"})[0] \
        .mesh_shards == 8
    sock = str(tmp_path / "engine.sock")
    proc = _spawn_engine_main(tmp_path, sock)
    try:
        remote = JaxRemote(sock, timeout=60.0)
        deadline = time.time() + 60
        while True:
            if proc.poll() is not None:
                raise RuntimeError(proc.stderr.read())
            try:
                if remote.ping():
                    break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.15)    # conftest bans sleeps > 0.2 s
        client, ctx = make_app(tmp_path, ENGINE_RPC_MODE="connect",
                               ENGINE_RPC_SOCKET=sock, ENGINE_DIM=64)
        headers = signup(client)
        store = create_store(client, headers)
        upload_text(client, headers, store["id"],
                    "Penguins are flightless seabirds of Antarctica. " * 30,
                    "penguins.txt")
        upload_text(client, headers, store["id"],
                    "The quarterly revenue grew twelve percent. " * 30,
                    "revenue.txt")
        drain_worker(ctx)
        r = client.post("/api/chat", headers=headers,
                        json_body={"question": "where do penguins live",
                                   "store_ids": [store["id"]]})
        assert r.status_code == 200
        assert "penguins.txt" in r.text
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
            log = proc.stderr.read()
        finally:
            proc.stderr.close()
    started = [json.loads(line) for line in log.splitlines()
               if "engine_rpc_started" in line]
    assert started and started[0]["mesh_shards"] == 8, log
    assert proc.returncode == 0


def test_engine_main_exits_when_the_mesh_needs_more_cards(tmp_path,
                                                          monkeypatch):
    from rag_foundation_tpu_torch import engine_main
    from rag_foundation_tpu_torch.engine import api
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    # a card-backed engine without resolving a card: the mesh is what
    # must fail, before the socket opens
    monkeypatch.setattr(api, "resolve_device", lambda d: torch.device(d))
    monkeypatch.setattr(api, "_make_encoder", lambda cfg, dev: None)
    for k, val in dict(RAGTPU_ENGINE_MESH_SHARDS=str(have + 2),
                       RAGTPU_DATA_DIR=str(tmp_path),
                       RAGTPU_ENGINE_RPC_SOCKET=str(tmp_path / "s")).items():
        monkeypatch.setenv(k, val)
    monkeypatch.delenv("RAGTPU_ENGINE_PLATFORM", raising=False)
    with pytest.raises(SystemExit,
                       match=f"need {have + 2} devices, have {have}"):
        engine_main.main()
    assert not (tmp_path / "s").exists()
