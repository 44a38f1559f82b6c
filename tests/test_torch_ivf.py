"""Port IVF-Flat (rag_foundation_tpu_torch/engine/ivf.py, ops/kmeans.py)
against the JAX package.

A body built by JAX is carried into the port with ``body_from_state``,
so both sides scan identical lists. Tolerances: int8 search is exact
(identical ids and values); f32 search values agree within 1e-5
relative (matmul summation order) with identical ids. The two RNGs
differ, so k-means/build quality is compared by recall, not ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.engine import ivf as jivf
from rag_foundation_tpu.engine.index import StoreIndex as JaxStoreIndex
from rag_foundation_tpu.engine.segments import VectorSegment as JaxSegment
from rag_foundation_tpu.ops.kmeans import assign_clusters as jax_assign
from rag_foundation_tpu.ops.kmeans import kmeans_fit as jax_kmeans
from rag_foundation_tpu_torch.engine import ivf as tivf
from rag_foundation_tpu_torch.engine.convert import (body_from_state,
                                                     body_to_state,
                                                     segment_from_state)
from rag_foundation_tpu_torch.ops.kmeans import assign_clusters, kmeans_fit
from rag_foundation_tpu_torch.ops.topk import exact_topk


def _clustered(n, d=64, centers=48, noise=0.15, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] \
        + noise * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _recall(approx, exact, k):
    return np.mean([len(set(a[:k]) & set(b[:k])) / k
                    for a, b in zip(approx, exact)])


def _jax_body_state(x, mode, nlist=16):
    idx = JaxStoreIndex(x.shape[1], mode=mode, nlist=nlist,
                        build_threshold=len(x))
    idx.add(x, np.arange(len(x)))
    assert idx.body is not None
    return idx.body, idx.body_state()


@pytest.mark.parametrize("qcap", [4, 16])
def test_build_dispatch_bit_identical(qcap):
    _dispatch_equal_to_jax(qcap)


@pytest.mark.parametrize("qcap", [4, 16])
@pytest.mark.parametrize("kw", [dict(method="sort"), dict(approx=True),
                                dict(method="sort", approx=True)],
                         ids=["sort", "approx", "sort_approx"])
def test_build_dispatch_sort_and_approx_bit_identical(qcap, kw):
    # the stable-argsort inversion equals the cumsum one, in the port and
    # against JAX; approx=True routes exactly in the port, as
    # lax.approx_max_k does on JAX's CPU backend
    got = _dispatch_equal_to_jax(qcap, **kw)
    want = _dispatch_equal_to_jax(qcap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert isinstance(got[3], torch.Tensor)      # no host copy of dropped


def test_build_dispatch_unknown_method_raises():
    with pytest.raises(ValueError, match="method"):
        tivf.build_dispatch(torch.zeros((4, 8)), 2, 4, method="heap")


def _dispatch_equal_to_jax(qcap, **kw):
    rng = np.random.default_rng(7)
    coarse = rng.standard_normal((64, 48)).astype(np.float32)
    coarse[:, 10] = coarse[:, 11]          # ties between lists
    jp, jd, js, jdrop = jivf.build_dispatch(jnp.asarray(coarse), nprobe=8,
                                            qcap=qcap, **kw)
    tp, td, ts, tdrop = tivf.build_dispatch(torch.as_tensor(coarse),
                                            nprobe=8, qcap=qcap, **kw)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tdrop) == int(jdrop)
    if qcap == 4:
        assert int(tdrop) > 0
    return tp, td, ts, tdrop


def test_assign_clusters_equal():
    x = _clustered(3000, seed=1)
    c = _clustered(40, seed=2)
    ja, jb = jax_assign(jnp.asarray(x), jnp.asarray(c), block_size=1024)
    ta, tb = assign_clusters(torch.as_tensor(x), torch.as_tensor(c),
                             block_size=700)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["ivf_flat_int8", "ivf_flat"])
def test_ivf_search_matches_jax_on_shared_body(mode):
    x = _clustered(4000, seed=3)
    jbody, state = _jax_body_state(x, mode)
    tbody = body_from_state(state, "cpu")
    assert tbody.cap_len == jbody.cap_len and tbody.n == jbody.n
    q = x[:40] + 0.01 * np.random.default_rng(4).standard_normal(
        x[:40].shape).astype(np.float32)
    jv, ji, jdrop = jivf.ivf_search(jbody, jnp.asarray(q), 10, nprobe=6,
                                    p=3, interpret=True)
    tv, ti, tdrop = tivf.ivf_search(tbody, torch.as_tensor(q), 10,
                                    nprobe=6, p=3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(tdrop) == int(jdrop)
    if mode == "ivf_flat_int8":
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", ["ivf_flat_int8", "ivf_flat"])
def test_ivf_search_small_matches_jax(mode):
    x = _clustered(3000, seed=5)
    jbody, state = _jax_body_state(x, mode)
    tbody = body_from_state(state, "cpu")
    q = x[100:102]
    jv, ji = jivf.ivf_search_small(jbody, jnp.asarray(q), 8, nprobe=4)
    tv, ti = tivf.ivf_search_small(tbody, torch.as_tensor(q), 8, nprobe=4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if mode == "ivf_flat_int8":
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-6)


def test_int8_query_transport_matches_jax():
    x = _clustered(3000, seed=6)
    jbody, state = _jax_body_state(x, "ivf_flat_int8")
    tbody = body_from_state(state, "cpu")
    s = np.float32(state["f_scale"])
    q8 = np.clip(np.round(x[:32] / s), -127, 127).astype(np.int8)
    jv, ji, _ = jivf.ivf_search(jbody, jnp.asarray(q8), 5, nprobe=6, p=3,
                                interpret=True)
    tv, ti, _ = tivf.ivf_search(tbody, torch.as_tensor(q8), 5, nprobe=6,
                                p=3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_skewed_batch_drops_no_probe():
    # 48 near-identical queries probe the same lists. At the default qcap
    # (the engine's path) both packages drop the same probes and return
    # the same ids and values; with qcap large enough no probe is dropped
    # and every query's exact top-k within its probed lists is found
    # (p >= k makes the per-sub-block capture exact, so the batched path
    # equals the gather path)
    x = _clustered(4000, seed=13)
    jbody, state = _jax_body_state(x, "ivf_flat_int8")
    tbody = body_from_state(state, "cpu")
    q = np.repeat(x[5:6], 48, axis=0) + 1e-3 * np.random.default_rng(
        14).standard_normal((48, 64)).astype(np.float32)
    jv, ji, jdrop = jivf.ivf_search(jbody, jnp.asarray(q), 5, nprobe=6,
                                    p=5, interpret=True)
    assert int(jdrop) > 0
    dv, di, ddrop = tivf.ivf_search(tbody, torch.as_tensor(q), 5, nprobe=6,
                                    p=5)
    assert int(ddrop) == int(jdrop)
    np.testing.assert_array_equal(di.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(dv.numpy(), np.asarray(jv))

    tv, ti, tdrop = tivf.ivf_search(tbody, torch.as_tensor(q), 5, nprobe=6,
                                    p=5, qcap=48)
    assert int(tdrop) == 0
    sv, si = tivf.ivf_search_small(tbody, torch.as_tensor(q), 5, nprobe=6)
    np.testing.assert_array_equal(tv.numpy(), sv.numpy())
    # rows of equal int8 score (also across the top-k cut) may come in
    # either path's candidate order: a differing id must score the same
    ids = tbody.row_ids.numpy()
    lists = tbody.lists.numpy().astype(np.int64)
    s8 = np.clip(np.round(q / np.float32(tbody.scale)), -127, 127)
    for qi, (a, b) in enumerate(zip(ti.numpy(), si.numpy())):
        for j in np.nonzero(a != b)[0]:
            (la, sa), (lb, sb) = (np.argwhere(ids == r)[0] for r in
                                  (a[j], b[j]))
            assert s8[qi] @ lists[la, sa] == s8[qi] @ lists[lb, sb]


@pytest.mark.parametrize("mode", ["ivf_flat_int8", "ivf_flat"])
def test_ivf_append_same_layout(mode):
    x = _clustered(2600, seed=8)
    jbody, state = _jax_body_state(x[:2000], mode)
    tbody = body_from_state(state, "cpu")
    new = x[2000:]
    rows = np.arange(2000, 2600, dtype=np.int32)
    jnew, jdropped = jivf.ivf_append(jbody, jnp.asarray(new), rows)
    tnew, tdropped = tivf.ivf_append(tbody, torch.as_tensor(new), rows)
    np.testing.assert_array_equal(tdropped, jdropped)
    np.testing.assert_array_equal(tnew.row_ids.numpy(),
                                  np.asarray(jnew.row_ids))
    np.testing.assert_array_equal(tnew.lists.numpy(),
                                  np.asarray(jnew.lists))
    assert tnew.n == jnew.n


def test_segment_from_jax_state_searches_alike():
    x = _clustered(1500, seed=9)
    jseg = JaxSegment(64)
    jseg.add(x, np.arange(1500))
    jseg.delete_ids({3, 7, 11})
    tseg = segment_from_state(jseg.state(), "cpu")
    assert set(jseg.state()) == {"vectors", "ids", "dim"}
    jv, ji = jseg.search(jnp.asarray(x[:8]), 6)
    tv, ti = tseg.search(x[:8], 6)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)


def test_kmeans_and_build_recall_within_jax():
    x = _clustered(6000, d=48, centers=64, noise=0.3, seed=10)
    q = x[:64]
    _, exact = exact_topk(torch.as_tensor(q), torch.as_tensor(x), 10)
    exact = exact.numpy()
    jidx = jivf.build_ivf_flat(jnp.asarray(x), 32, key=jax.random.key(0),
                               int8=True)
    _, ji, _ = jivf.ivf_search(jidx, jnp.asarray(q), 10, nprobe=4, p=3,
                               interpret=True)
    gen = torch.Generator().manual_seed(0)
    tidx = tivf.build_ivf_flat(torch.as_tensor(x), 32, generator=gen,
                               int8=True)
    _, ti, _ = tivf.ivf_search(tidx, torch.as_tensor(q), 10, nprobe=4, p=3)
    rj = _recall(np.asarray(ji), exact, 10)
    rt = _recall(ti.numpy(), exact, 10)
    assert rt >= rj - 0.02, (rt, rj)
    # every row placed exactly once
    live = tidx.row_ids.numpy()
    assert sorted(live[live >= 0]) == list(range(len(x)))
    # k-means alone: mean distance to the assigned centroid within JAX's
    jc, ja = jax_kmeans(jnp.asarray(x), 32, key=jax.random.key(1))
    tc, ta = kmeans_fit(torch.as_tensor(x), 32,
                        generator=torch.Generator().manual_seed(1))
    jd = np.mean(np.sum((x - np.asarray(jc)[np.asarray(ja)]) ** 2, 1))
    td = np.mean(np.sum((x - tc.numpy()[ta.numpy()]) ** 2, 1))
    assert td <= jd * 1.05, (td, jd)


def test_device_build_layout_and_overflow():
    d, n, nlist = 32, 5000, 16
    centers = torch.as_tensor(_clustered(8, d=d, seed=11))

    def gen(ci):
        g = torch.Generator().manual_seed(ci)
        v = centers[torch.randint(0, 8, (1024,), generator=g)] \
            + 0.1 * torch.randn((1024, d), generator=g)
        return v / v.norm(dim=1, keepdim=True)

    head = _clustered(100, d=d, seed=12)
    idx, overflow = tivf.build_ivf_flat_device(
        gen, n, d, nlist, generator=torch.Generator().manual_seed(0),
        device=torch.device("cpu"), head=head, chunk=1024,
        capacity_slack=1.0)
    ids = idx.row_ids.numpy()
    placed = np.sort(ids[ids >= 0])
    assert len(placed) == idx.n == n + 100 - overflow.sum()
    np.testing.assert_array_equal(placed, np.nonzero(~overflow)[0])
    # the head rows are stored quantized where their ids say
    l, s = np.nonzero(ids == 42)
    np.testing.assert_allclose(idx.lists[l[0], s[0]].float().numpy()
                               * idx.scale, head[42], atol=1 / 127)


def _share_centroids(monkeypatch, x, nlist):
    """Both packages' k-means differ in their random draws: hand both
    builds the same centroids (a JAX fit of the same sample)."""
    cents, _ = jax_kmeans(jnp.asarray(x), nlist, key=jax.random.key(0),
                          spherical=True)
    cents = np.asarray(cents)
    monkeypatch.setattr(jivf, "kmeans_fit",
                        lambda *a, **k: (jnp.asarray(cents), None))
    monkeypatch.setattr(tivf, "kmeans_fit",
                        lambda *a, **k: (torch.as_tensor(cents.copy()), None))


def _unit_rows(n, d, seed):
    v = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("src,slack", [("f32", 1.0), ("int8", 1.0),
                                       ("f32", 0.6)],
                         ids=["f32", "int8", "f32_overflow"])
def test_streaming_build_bit_equal_to_jax(monkeypatch, src, slack):
    n, d, nlist = 5000, 64, 8
    vecs = _unit_rows(n, d, 3)
    _share_centroids(monkeypatch, vecs, nlist)
    q8 = np.clip(np.rint(vecs * 127.0), -127, 127).astype(np.int8)
    source = (lambda lo, hi: q8[lo:hi]) if src == "int8" else (
        lambda lo, hi: vecs[lo:hi])
    scale = 1.0 / 127.0 if src == "int8" else None
    jidx, jover = jivf.build_ivf_flat_streaming(
        source, n, d, nlist, key=jax.random.key(0), chunk=1024,
        capacity_slack=slack, source_scale=scale)
    seen = []
    tidx, tover = tivf.build_ivf_flat_streaming(
        source, n, d, nlist, generator=torch.Generator().manual_seed(0),
        device="cpu", chunk=1024, capacity_slack=slack, source_scale=scale,
        progress=lambda done, total: seen.append((done, total)))
    assert seen == [(1024, n), (2048, n), (3072, n), (4096, n), (n, n)]
    np.testing.assert_array_equal(tover, jover)
    assert bool(tover.any()) == (slack < 1)
    assert tidx.n == jidx.n == n - int(tover.sum())
    np.testing.assert_array_equal(tidx.row_ids.numpy(),
                                  np.asarray(jidx.row_ids))
    np.testing.assert_array_equal(tidx.lists.numpy(), np.asarray(jidx.lists))
    assert np.float32(tidx.scale) == np.float32(jidx.scale)
    if src == "int8":      # the source ints, verbatim, where the ids say
        l, s = np.nonzero(tidx.row_ids.numpy() == 0)
        np.testing.assert_array_equal(tidx.lists[l[0], s[0]].numpy(), q8[0])
    # and the searches agree to the bit (int8 scores are exact)
    q = vecs[:64]
    jv, ji, _ = jivf.ivf_search(jidx, jnp.asarray(q), 5, nprobe=4, p=5,
                                interpret=True)
    tv, ti, _ = tivf.ivf_search(tidx, torch.as_tensor(q), 5, nprobe=4, p=5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_streaming_build_matches_direct_build_on_the_port():
    # tests/test_ivf.py::test_build_ivf_flat_streaming_matches_direct, on
    # the port alone: same generator seed, same sample, so the same
    # centroids and layout; quantization agrees up to 1 lsb
    n, d, nlist = 5000, 64, 8
    vecs = _unit_rows(n, d, 3)
    direct = tivf.build_ivf_flat(torch.as_tensor(vecs), nlist,
                                 generator=torch.Generator().manual_seed(0),
                                 int8=True)
    stream, overflow = tivf.build_ivf_flat_streaming(
        lambda lo, hi: vecs[lo:hi], n, d, nlist,
        generator=torch.Generator().manual_seed(0), device="cpu", chunk=1024)
    assert not overflow.any() and stream.n == direct.n == n
    assert torch.equal(stream.row_ids, direct.row_ids)
    diff = (stream.lists.int() - direct.lists.int()).abs()
    assert int(diff.max()) <= 1
    q = torch.as_tensor(vecs[:64])
    _, ia, _ = tivf.ivf_search(direct, q, 5, nprobe=4, p=5)
    _, ib, _ = tivf.ivf_search(stream, q, 5, nprobe=4, p=5)
    assert _recall(ia.numpy(), ib.numpy(), 5) >= 0.99
    assert (ib[:, 0].numpy() == np.arange(64)).mean() >= 0.98


def test_streaming_build_int8_source_needs_scale():
    q8 = np.zeros((100, 16), np.int8)
    with pytest.raises(ValueError, match="source_scale"):
        tivf.build_ivf_flat_streaming(
            lambda lo, hi: q8[lo:hi], 100, 16, 4,
            generator=torch.Generator().manual_seed(0), device="cpu")


def test_streamed_body_converts_both_ways():
    # a streamed body is an IVFFlatIndex like any other: its state loads
    # in the JAX package and comes back, and both search it alike
    n, d, nlist = 3000, 32, 8
    vecs = _unit_rows(n, d, 9)
    tidx, _ = tivf.build_ivf_flat_streaming(
        lambda lo, hi: vecs[lo:hi], n, d, nlist,
        generator=torch.Generator().manual_seed(0), device="cpu", chunk=700)
    state = body_to_state(tidx)
    jidx = jivf.IVFFlatIndex(
        centroids=jnp.asarray(state["f_centroids"]),
        lists=jnp.asarray(state["f_lists"]),
        row_ids=jnp.asarray(state["f_row_ids"]),
        scale=jnp.asarray(state["f_scale"], jnp.float32), n=int(state["f_n"]))
    back = body_from_state(state, "cpu")
    for a, b in zip(back, tidx):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    q = vecs[:32]
    jv, ji, _ = jivf.ivf_search(jidx, jnp.asarray(q), 5, nprobe=4, p=3,
                                approx_select=True, interpret=True)
    tv, ti, _ = tivf.ivf_search(back, torch.as_tensor(q), 5, nprobe=4, p=3,
                                approx_select=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
