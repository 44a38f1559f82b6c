"""The 100M capacity tier's configuration (``ENGINE_INDEX_MODE=ivf_pq``,
``ENGINE_PQ_PACKED=true``, ``ENGINE_PQ_REFINE=host``: m=256 nibble-packed
4-bit codes, ``cap_slack`` 1.09, a host int8 archive re-ranking the ADC
candidates) in the port's ``StoreIndex`` against the JAX package's, on
the same int8 ``HostArchive`` rows, at a CPU size (d=512, 24,000 rows,
nlist 64). ``chip_smoke.py`` phase 26 runs it at 100M on the card.

Both stores take the rows through ``bulk_load_archive``. The JAX store
runs its Pallas kernels in interpret mode on the CPU by itself.
``torch.Generator`` k-means finds other centroids than ``jax.random``, so
the port's build is handed the JAX build's centroids and codebooks.

Stated parity (every id comparison is exact):
- the port's streaming build lays the rows out bit for bit as the JAX
  build (codes, row ids, ``n``), and the same overflow rows, spill pass
  included, land in the tail with the same vectors;
- with the JAX body carried across (``engine/convert.py``), ``search``
  returns the JAX store's ids under ``pq_refine`` host and none (scores:
  host re-rank within 1e-5, an f32 sum in another order in the two
  packages' native shims; ADC sums within 1e-6), and ``search_many``
  equals ``search``;
- ``_sized_nlist`` and ``pq_cap_len`` give 24,415 lists of 4,480 slots at
  100M in both (``default_qcap`` 8 at Q=1024);
- ``exact_reference_search`` over the archive names the JAX store's ids;
  the archive's scan (``archive_topk``) with one thread, three and one a
  core gives the rows of the JAX store's one-pass scan, and the values
  and rows of ``tools/time_archive_scan.py``'s one-pass form, bit for
  bit, and that tool's forms agree at a CPU size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.engine import ivfpq as jpq
from rag_foundation_tpu.engine.archive import HostArchive as JaxArchive
from rag_foundation_tpu.engine.index import StoreIndex as JaxStoreIndex
from rag_foundation_tpu_torch.engine import ivf as tivf
from rag_foundation_tpu_torch.engine import ivfpq as tpq
from rag_foundation_tpu_torch.engine.archive import HostArchive
from rag_foundation_tpu_torch.engine.index import StoreIndex
from rag_foundation_tpu_torch.ops.kmeans import assign_clusters_top2
from rag_foundation_tpu_torch.ops.pq import PQCodebook

N, D, M, NLIST = 24_000, 512, 256, 64
TIER = dict(mode="ivf_pq", nlist=NLIST, nprobe=8, pq_m=M, pq_packed=True,
            pq_refine="host", pq_cap_slack=1.09, build_threshold=1)
CHUNK_BASE = 1_000          # chunk ids: row i holds chunk CHUNK_BASE + i


def _rows():
    """int8 rows at the archive's 1/127 scale: clusters of skewed sizes
    (some lists overflow their capacity at cap_slack 1.09), and queries
    near stored rows."""
    rng = np.random.default_rng(2026)
    c = rng.standard_normal((40, D)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    weight = 1.0 / np.arange(1, 41) ** 0.8
    v = c[rng.choice(40, N, p=weight / weight.sum())] \
        + 0.06 * rng.standard_normal((N, D)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    q = v[rng.choice(N, 64, replace=False)] \
        + 0.02 * rng.standard_normal((64, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.clip(np.rint(v * 127.0), -127, 127).astype(np.int8), q


@pytest.fixture(scope="module")
def tier():
    rows, q = _rows()
    cids = np.arange(CHUNK_BASE, CHUNK_BASE + N, dtype=np.int64)
    jarch = JaxArchive(D)
    jarch.reserve(N)
    jarch.append(rows)
    jax_store = JaxStoreIndex(D, **TIER)
    jax_store.bulk_load_archive(jarch, cids)

    # the port's build, handed the JAX build's centroids and codebooks
    body = jax_store.body
    cents = torch.as_tensor(np.asarray(body.centroids).copy())
    books = torch.as_tensor(np.asarray(body.codebook_centroids).copy())
    mp = pytest.MonkeyPatch()
    mp.setattr(tpq, "kmeans_fit", lambda *a, **k: (cents.clone(), None))
    mp.setattr(tpq, "pq_train",
               lambda *a, **k: PQCodebook(centroids=books.clone()))
    try:
        arch = HostArchive(D)
        arch.reserve(N)
        arch.append(rows)
        port_store = StoreIndex(D, device="cpu", **TIER)
        port_store.bulk_load_archive(arch, cids)
    finally:
        mp.undo()

    # the JAX body carried across, with its archive and its tail
    carried = StoreIndex(D, device="cpu", **TIER)
    carried.restore_body(jax_store.body_state())
    st = jax_store.tail.state()
    carried.tail.add(np.asarray(st["vectors"]), np.asarray(st["ids"]))
    return rows, q, cids, jax_store, port_store, carried


def test_tier_build_bit_equal_to_jax(tier):
    rows, _, cids, jax_store, port_store, _ = tier
    jb, tb = jax_store.body, port_store.body
    assert (tb.nlist, tb.cap_len, tb.m, tb.packed) == (
        NLIST, tpq.pq_cap_len(N, NLIST, 1.09), M, True)
    assert tb.codes.shape[2] == M // 2 and tb.refine.shape == (0, 0)
    np.testing.assert_array_equal(tb.row_ids.numpy(), np.asarray(jb.row_ids))
    np.testing.assert_array_equal(tb.codes.numpy(), np.asarray(jb.codes))
    assert tb.n == jb.n
    # the same overflow rows leave the body for the tail
    np.testing.assert_array_equal(port_store.body_chunk_ids,
                                  jax_store.body_chunk_ids)
    over = np.nonzero(port_store.body_chunk_ids < 0)[0]
    assert len(over) and tb.n == N - len(over)
    tst, jst = port_store.tail.state(), jax_store.tail.state()
    np.testing.assert_array_equal(tst["ids"], np.asarray(jst["ids"]))
    np.testing.assert_array_equal(tst["ids"], cids[over])
    np.testing.assert_array_equal(tst["vectors"], np.asarray(jst["vectors"]))
    np.testing.assert_array_equal(
        tst["vectors"], rows[over].astype(np.float32) * np.float32(1 / 127))
    # the spill pass moved rows into their second-nearest list
    ids = tb.row_ids.numpy()
    live = ids >= 0
    lists = np.nonzero(live)[0]          # ids is [nlist, cap_len]
    a1, a2 = assign_clusters_top2(
        torch.as_tensor(rows.astype(np.float32) * np.float32(1 / 127)),
        tb.centroids)
    placed = ids[live]
    moved = lists != a1.numpy()[placed]
    assert moved.any()
    np.testing.assert_array_equal(lists[moved], a2.numpy()[placed[moved]])
    # the archive is the rows, row i at position i
    np.testing.assert_array_equal(port_store._pq_archive.chunk_i8(0, N), rows)


@pytest.mark.parametrize("refine", ["host", "none"])
def test_tier_search_equal_to_jax(tier, refine):
    _, q, _, jax_store, _, carried = tier
    jax_store.pq_refine = carried.pq_refine = refine
    try:
        jv, ji = jax_store.search(q, 10)
        tv, ti = carried.search(q, 10)
        many = carried.search_many([q, q[:40], q], 10)
        part = carried.search(q[:40], 10)
    finally:
        jax_store.pq_refine = carried.pq_refine = "host"
    np.testing.assert_array_equal(ti, np.asarray(ji))
    assert (ti >= 0).all()
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=0,
                               atol=1e-5 if refine == "host" else 1e-6)
    # search_many pipelines the batches: each equals its own search (the
    # int8 query transport scales a batch by its own absmax)
    for (mv, mi), (wv, wi) in zip(many, ((tv, ti), part, (tv, ti))):
        np.testing.assert_array_equal(mi, wi)
        np.testing.assert_array_equal(mv, wv)
    # each query finds the stored row it was drawn near
    exact = carried.exact_reference_search(q, 1)[:, 0]
    assert (ti[:, 0] == exact).mean() >= 0.95


def test_tier_sizes_at_100m_equal_to_jax():
    kw = dict(mode="ivf_pq", nlist=16384, pq_m=256, pq_packed=True,
              pq_refine="host", pq_cap_slack=1.09)
    ours = StoreIndex(768, device="cpu", **kw)._sized_nlist(100_000_000)
    assert ours == JaxStoreIndex(768, **kw)._sized_nlist(100_000_000) \
        == 24_415
    assert tpq.pq_cap_len(100_000_000, ours, 1.09) == jpq.pq_cap_len(
        100_000_000, ours, 1.09) == 4_480
    # the JAX package computes it inline (rag_foundation_tpu/engine/ivf.py)
    assert tivf.default_qcap(1024, 32, ours) == 8


def test_tier_archive_scan_in_steps_equal_to_jax():
    # the archive's exact scan over more than two of its 524,288-row steps
    # (the last one partial), dead rows and a tombstone among them: the
    # port widens each step in slices over threads, JAX in one pass
    import jax

    n, d = 2 * (1 << 19) + 777, 16
    rng = np.random.default_rng(5)
    rows = rng.integers(-127, 128, (n, d)).astype(np.int8)
    q = rng.standard_normal((8, d)).astype(np.float32)
    table = np.arange(n, dtype=np.int64)
    table[[3, 600_000, n - 1]] = -1
    v = rows[:512].astype(np.float32) / 127.0
    jbody = jpq.build_ivf_pq(jnp.asarray(v), 4, 8, key=jax.random.key(0),
                             refine=False)
    kw = dict(mode="ivf_pq", pq_m=8, pq_refine="host")
    stores = (JaxStoreIndex(d, **kw), StoreIndex(d, device="cpu", **kw))
    for store, arch in zip(stores, (JaxArchive(d), HostArchive(d))):
        arch.append(rows)
        store.restore_body({
            "kind": "IVFPQIndex", "body_chunk_ids": table,
            "dead": np.zeros(0, np.int64), **{
                "f_" + name: (np.int64(val) if isinstance(val, int)
                              else np.asarray(val))
                for name, val in jbody._asdict().items()}})
        store._pq_archive = arch
        store.delete_ids({1_048_000})
    want, got = (st.exact_reference_search(q, 10) for st in stores)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not np.isin(got, [-1, 3, 600_000, n - 1, 1_048_000]).any()


def test_tier_exact_reference_equal_to_jax(tier):
    _, q, _, jax_store, port_store, carried = tier
    want = jax_store.exact_reference_search(q[:32], 10)
    for store in (port_store, carried):
        np.testing.assert_array_equal(
            store.exact_reference_search(q[:32], 10), np.asarray(want))


@pytest.mark.parametrize("workers", [1, 3, None])
def test_tier_archive_scan_threads_equal_to_jax_one_pass(workers):
    # the port's archive scan with one thread, three and one a core names
    # the rows of the JAX store's one-pass scan, over more than two steps
    # with dead rows, and its values are those of the one-pass form
    import jax

    from rag_foundation_tpu_torch.engine.index import archive_topk
    from rag_foundation_tpu_torch.tools.time_archive_scan import one_pass

    n, d = 2 * (1 << 19) + 777, 16
    rng = np.random.default_rng(11)
    rows = rng.integers(-127, 128, (n, d)).astype(np.int8)
    q = rng.standard_normal((8, d)).astype(np.float32)
    table = np.arange(n, dtype=np.int64)
    table[[0, 524_288, 700_001, n - 1]] = -1
    jbody = jpq.build_ivf_pq(
        jnp.asarray(rows[:512].astype(np.float32) / 127.0), 4, 8,
        key=jax.random.key(0), refine=False)
    jstore = JaxStoreIndex(d, mode="ivf_pq", pq_m=8, pq_refine="host")
    jstore.restore_body({
        "kind": "IVFPQIndex", "body_chunk_ids": table,
        "dead": np.zeros(0, np.int64), **{
            "f_" + name: (np.int64(val) if isinstance(val, int)
                          else np.asarray(val))
            for name, val in jbody._asdict().items()}})
    jstore._pq_archive = JaxArchive(d)
    jstore._pq_archive.append(rows)
    arch = HostArchive(d)
    arch.append(rows)
    got_v, got_r = archive_topk(arch, table >= 0, q, 10, workers=workers)
    np.testing.assert_array_equal(
        table[got_r], np.asarray(jstore.exact_reference_search(q, 10)))
    want_v, want_r = one_pass(arch, table >= 0, q, 10)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_r, want_r)


def test_time_archive_scan_tool_on_the_cpu(monkeypatch, capsys):
    # the timing tool's forms agree with the engine's scan at a CPU size
    import json
    import sys

    from rag_foundation_tpu_torch.tools import time_archive_scan

    monkeypatch.setattr(sys, "argv", [
        "time_archive_scan", "--device", "cpu", "--rows", "600000",
        "--dim", "64", "--forms", "engine", "single", "one_pass",
        "blocked"])
    time_archive_scan.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["form"] for r in out["runs"]] == [
        "engine", "single", "one_pass", "blocked"]
    for r in out["runs"][:3]:
        assert r["values_equal"] and r["rows_equal"], r
    assert out["runs"][3]["rows_equal"], out["runs"][3]
