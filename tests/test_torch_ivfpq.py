"""Port IVF-PQ index (rag_foundation_tpu_torch/engine/ivfpq.py, archive.py,
convert.py) against the JAX package's.

k-means from ``torch.Generator`` finds other centroids than ``jax.random``,
so the parity tests TRAIN IN JAX, carry the index across with
``engine/convert.py``, and search or extend it in both packages.

Stated parity: layouts (codes, row ids, overflow masks) are bit-equal.
``ivfpq_search`` is not bit parity end to end: ``pq_lut`` is an f32 sum
whose order differs between XLA and PyTorch, one ulp can flip a rounding
in the int8 LUT and move a candidate at the ADC cut. So the search is
held to the same row id on at least 0.99 of (query, rank) pairs and, with
a refine store, bit-equal values wherever both return the same id (int8
dots times the two scales). Without a refine store the values are ADC
sums: 1e-3 absolute (the int8 LUT's own step is ~1e-2 of a unit score).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.engine import archive as jarchive
from rag_foundation_tpu.engine import ivfpq as jpq
from rag_foundation_tpu_torch.engine import ivfpq as tpq
from rag_foundation_tpu_torch.engine.archive import HostArchive
from rag_foundation_tpu_torch.engine.convert import (archive_from_state,
                                                     body_from_state,
                                                     body_to_state)

N, D, NLIST, M = 4096, 64, 16, 16


def _corpus(n=N, d=D, centers=NLIST, noise=0.25, seed=7):
    """Clustered unit vectors (PQ codes residuals of clusters), queries
    near stored rows."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    v = c[rng.integers(0, centers, n)] + noise * rng.standard_normal(
        (n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    q = v[:64] + 0.1 * rng.standard_normal((64, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return v, q


def _state(jidx) -> dict:
    """``body_state()``'s fields of a JAX IVFPQIndex."""
    out = {"kind": "IVFPQIndex"}
    for name, val in jidx._asdict().items():
        out["f_" + name] = np.int64(val) if isinstance(val, int) \
            else np.asarray(val)
    return out


def _to_jax(tidx) -> jpq.IVFPQIndex:
    st = body_to_state(tidx)
    return jpq.IVFPQIndex(
        centroids=jnp.asarray(st["f_centroids"]),
        codebook_centroids=jnp.asarray(st["f_codebook_centroids"]),
        codes=jnp.asarray(st["f_codes"]),
        row_ids=jnp.asarray(st["f_row_ids"]), n=int(st["f_n"]),
        refine=jnp.asarray(st["f_refine"]),
        refine_scale=jnp.asarray(st["f_refine_scale"]))


def _assert_search_parity(tv, tr, jv, jr, refine=True):
    tv, tr, jv, jr = (np.asarray(x) for x in (tv, tr, jv, jr))
    assert tv.shape == jv.shape and tr.shape == jr.shape
    same = tr == jr
    assert same.mean() >= 0.99, same.mean()
    both = same & (tr >= 0)
    if refine:
        np.testing.assert_array_equal(tv[both], jv[both])
    else:
        np.testing.assert_allclose(tv[both], jv[both], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(np.isneginf(tv[same]), tr[same] < 0)


@pytest.fixture(scope="module")
def jax_index():
    v, q = _corpus()
    idx = jpq.build_ivf_pq(jnp.asarray(v), NLIST, M, key=jax.random.key(0))
    return v, q, idx


def test_convert_round_trip(jax_index):
    _, _, jidx = jax_index
    st = _state(jidx)
    tidx = body_from_state(st, "cpu")
    assert (tidx.nlist, tidx.m, tidx.k_codes, tidx.n, tidx.packed) == (
        NLIST, M, 16, N, False)
    assert tidx.cap_len == jidx.cap_len and tidx.codebook.dsub == D // M
    back = body_to_state(tidx)
    assert sorted(back) == sorted(k for k in st if k != "kind")
    for k, v in back.items():
        np.testing.assert_array_equal(v, st[k])
        assert v.dtype == st[k].dtype, k
    # a copy: appends in the port never write through to the source
    tidx.codes.fill_(0)
    assert np.asarray(jidx.codes).any()
    with pytest.raises(ValueError, match="unknown body kind"):
        body_from_state({"kind": "Other"}, "cpu")


def test_build_layout_matches_jax(jax_index):
    # the JAX assignment and codes, carried across, laid out by the port
    _, _, jidx = jax_index
    ids = np.asarray(jidx.row_ids)
    codes = np.asarray(jidx.codes)
    live = ids >= 0
    assign = np.empty(N, np.int32)
    assign[ids[live]] = np.nonzero(live)[0]
    row_codes = np.empty((N, M), np.uint8)
    row_codes[ids[live]] = codes[live]
    c3, i2 = tpq.layout_lists(assign, row_codes, NLIST)
    np.testing.assert_array_equal(i2, ids)
    np.testing.assert_array_equal(c3, codes)


@pytest.mark.parametrize("packed", [False, True])
def test_build_ivf_pq_on_the_port(packed):
    v, q = _corpus(n=2048)
    idx = tpq.build_ivf_pq(torch.as_tensor(v), NLIST, M, packed=packed,
                           generator=torch.Generator().manual_seed(0))
    assert idx.packed == packed and idx.codes.shape[2] == (
        M // 2 if packed else M)
    ids = idx.row_ids.numpy()
    assert sorted(ids[ids >= 0].tolist()) == list(range(2048))
    assert idx.refine.shape == (2048, D) and idx.refine.dtype == torch.int8
    vals, rows, _ = tpq.ivfpq_search(idx, torch.as_tensor(q), 10,
                                     nprobe=NLIST, p=8)
    exact = np.argsort(-(q @ v.T), axis=1)[:, :10]
    recall = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(rows.numpy(), exact)])
    assert recall >= 0.7, recall
    # the JAX search over the port-built index agrees
    jv, jr, _ = jpq.ivfpq_search(_to_jax(idx), jnp.asarray(q), 10,
                                 nprobe=NLIST, p=8)
    _assert_search_parity(vals, rows, jv, jr)
    with pytest.raises(ValueError, match="packed codes require"):
        tpq.build_ivf_pq(torch.as_tensor(v), NLIST, 15, packed=True,
                         generator=torch.Generator().manual_seed(0))


def test_refine_table_padded_to_eight_rows():
    v, _ = _corpus(n=1001)
    idx = tpq.build_ivf_pq(torch.as_tensor(v), 8, M,
                           generator=torch.Generator().manual_seed(0))
    jidx = jpq.build_ivf_pq(jnp.asarray(v), 8, M, key=jax.random.key(0))
    assert idx.refine.shape == tuple(jidx.refine.shape) == (1008, D)
    assert not idx.refine[1001:].any()
    np.testing.assert_array_equal(idx.refine.numpy(),
                                  np.asarray(jidx.refine))
    assert np.float32(idx.refine_scale) == np.float32(jidx.refine_scale)


@pytest.mark.parametrize("kw", [
    dict(nprobe=8, p=8), dict(nprobe=4, p=2, lut_dtype="bf16"),
    dict(nprobe=16, p=4, refine_c=48), dict(nprobe=8, p=4, qcap=8)],
    ids=["int8lut", "bf16lut", "refine_c", "qcap_drops"])
def test_search_parity_on_a_jax_built_index(jax_index, kw):
    _, q, jidx = jax_index
    tidx = body_from_state(_state(jidx), "cpu")
    jv, jr, jd = jpq.ivfpq_search(jidx, jnp.asarray(q), 10, **kw)
    tv, tr, td = tpq.ivfpq_search(tidx, torch.as_tensor(q), 10, **kw)
    assert int(td) == int(jd)
    if "qcap" in kw:
        assert int(td) > 0          # probes past qcap dropped alike
    _assert_search_parity(tv, tr, jv, jr)


def test_search_parity_with_int8_query_transport(jax_index):
    _, q, jidx = jax_index
    tidx = body_from_state(_state(jidx), "cpu")
    s = float(np.abs(q).max()) / 127.0
    q8 = np.clip(np.round(q / s), -127, 127).astype(np.int8)
    jv, jr, _ = jpq.ivfpq_search(jidx, jnp.asarray(q8), 10, nprobe=8, p=4,
                                 q_scale=jnp.float32(s))
    tv, tr, _ = tpq.ivfpq_search(tidx, torch.as_tensor(q8), 10, nprobe=8,
                                 p=4, q_scale=s)
    _assert_search_parity(tv, tr, jv, jr)


def test_search_parity_packed_and_no_refine():
    v, q = _corpus(n=2048, seed=3)
    jidx = jpq.build_ivf_pq(jnp.asarray(v), NLIST, M, key=jax.random.key(1),
                            packed=True, refine=False)
    tidx = body_from_state(_state(jidx), "cpu")
    assert tidx.packed and tidx.refine.shape == (0, 0)
    jv, jr, _ = jpq.ivfpq_search(jidx, jnp.asarray(q), 10, nprobe=8, p=4)
    tv, tr, _ = tpq.ivfpq_search(tidx, torch.as_tensor(q), 10, nprobe=8, p=4)
    _assert_search_parity(tv, tr, jv, jr, refine=False)
    # k beyond the candidate width pads with (-inf, -1) in both
    jv, jr, _ = jpq.ivfpq_search(jidx, jnp.asarray(q[:4]), 40, nprobe=1, p=1)
    tv, tr, _ = tpq.ivfpq_search(tidx, torch.as_tensor(q[:4]), 40, nprobe=1,
                                 p=1)
    assert tv.shape == (4, 40)
    _assert_search_parity(tv, tr, jv, jr, refine=False)


def test_search_parity_byte_codes():
    # K=256: the plain PyTorch decode path against the JAX XLA decode.
    # Scores are bf16-rounded inputs summed in f32 in another order, then
    # re-ranked by the refine store: same parity as the kernel path
    v, q = _corpus(n=1536, seed=5)
    jidx = jpq.build_ivf_pq(jnp.asarray(v), 8, 8, key=jax.random.key(2),
                            nbits=8)
    tidx = body_from_state(_state(jidx), "cpu")
    assert tidx.k_codes == 256
    for kw in (dict(nprobe=4, p=8), dict(nprobe=8, p=4, list_block=3)):
        jv, jr, _ = jpq.ivfpq_search(jidx, jnp.asarray(q), 10, **kw)
        tv, tr, _ = tpq.ivfpq_search(tidx, torch.as_tensor(q), 10, **kw)
        _assert_search_parity(tv, tr, jv, jr)


def test_host_scatter_bit_equal_to_jax():
    rng = np.random.default_rng(11)
    n, nlist, cap_len, mb = 3000, 12, 256, 8
    ours = tpq.HostScatter(n, nlist, cap_len, mb)
    ref = jpq.HostScatter(n, nlist, cap_len, mb)
    for lo in range(0, n, 700):
        rows = min(700, n - lo)
        a = rng.integers(0, nlist, rows).astype(np.int32)
        a[: rows // 3] = 2                      # overflow list 2
        c = rng.integers(0, 256, (rows, mb)).astype(np.uint8)
        ours.scatter(a, c, lo, rows)
        ref.scatter(a, c, lo, rows)
    assert ours.overflow.any()
    spilled = np.nonzero(ours.overflow)[0]
    to = rng.integers(0, nlist, len(spilled)).astype(np.int32)
    c = rng.integers(0, 256, (len(spilled), mb)).astype(np.uint8)
    np.testing.assert_array_equal(ours.place_at(to, c, spilled),
                                  ref.place_at(to, c, spilled))
    for name in ("codes", "ids", "next_slot", "overflow"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(ref, name))
    assert tpq.pq_cap_len(10_000_000, 4096, 1.5) == jpq.pq_cap_len(
        10_000_000, 4096, 1.5) == 3712
    assert tpq.pq_cap_len(10, 64, 1.5) == 128


def _jax_streaming(v, **kw):
    return jpq.build_ivf_pq_streaming(lambda lo, hi: v[lo:hi], len(v), D,
                                      NLIST, M, key=jax.random.key(0), **kw)


def _device_build(v, tidx, chunk):
    nlist, cap_len, mb = tidx.codes.shape
    codes = torch.zeros((nlist * cap_len, mb), dtype=torch.uint8)
    ids = torch.full((nlist * cap_len,), -1, dtype=torch.int32)
    nxt = torch.zeros(nlist, dtype=torch.int32)
    dropped = 0
    for lo in range(0, len(v), chunk):
        out = tpq.pq_build_step(
            codes, ids, nxt, torch.as_tensor(v[lo:lo + chunk]), lo,
            tidx.centroids, tidx.codebook_centroids, 1.0, packed=tidx.packed)
        assert out[0] is codes and out[1] is ids and out[2] is nxt
        dropped += int(out[3])
    return codes.view(nlist, cap_len, mb), ids.view(nlist, cap_len), dropped


@pytest.mark.parametrize("packed,cap_slack", [(True, 2.0), (False, 2.0),
                                              (True, 0.5)])
def test_pq_build_step_matches_host_staged_layout(packed, cap_slack):
    # codebooks trained by the JAX streaming build; the port's in-place
    # device step lays the same chunks out as JAX's host-staged pass,
    # dropping the same rows past capacity
    v, _ = _corpus()
    jidx, overflow = _jax_streaming(v, packed=packed, chunk=1024,
                                    cap_slack=cap_slack)
    assert bool(overflow.any()) == (cap_slack < 1)
    tidx = body_from_state(_state(jidx), "cpu")
    codes, ids, dropped = _device_build(v, tidx, 1024)
    assert dropped == int(overflow.sum())
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jidx.row_ids))
    live = ids.numpy() >= 0
    same = (codes.numpy()[live] == np.asarray(jidx.codes)[live])
    assert same.mean() >= 0.999      # a code may differ at an argmax tie


@pytest.mark.parametrize("src", ["f32", "int8"])
def test_streaming_build_on_the_port(src):
    v, q = _corpus()
    arch = HostArchive(D)
    arch.append(v)
    source = arch.chunk_i8 if src == "int8" else (lambda lo, hi: v[lo:hi])
    seen = []
    idx, overflow = tpq.build_ivf_pq_streaming(
        source, N, D, NLIST, M, generator=torch.Generator().manual_seed(0),
        device="cpu", packed=True, chunk=1000, pq_iters=8, refine="device",
        cap_slack=2.0, source_scale=arch.scale, source_rows=arch.rows_i8,
        progress=lambda done, total: seen.append((done, total)))
    assert not overflow.any() and idx.n == N
    assert seen == [(1000, N), (2000, N), (3000, N), (4000, N), (N, N)]
    assert idx.cap_len == tpq.pq_cap_len(N, NLIST, 2.0)
    ids = idx.row_ids.numpy()
    assert sorted(ids[ids >= 0].tolist()) == list(range(N))
    # the refine table is the archive's int8 rows (or the f32 rows
    # quantized at 1/127), row i at position i
    np.testing.assert_array_equal(idx.refine.numpy(), arch.chunk_i8(0, N))
    assert np.float32(idx.refine_scale) == np.float32(1 / 127)
    _, rows, _ = tpq.ivfpq_search(idx, torch.as_tensor(q), 10, nprobe=8, p=8)
    exact = np.argsort(-(q @ v.T), axis=1)[:, :10]
    recall = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(rows.numpy(), exact)])
    # the same quality as the JAX streaming build of the same corpus
    # (toy sizes: the ADC cut at 40 candidates limits both)
    jidx, _ = _jax_streaming(v, packed=True, chunk=1000, pq_iters=8,
                             refine="device", cap_slack=2.0)
    _, jrows, _ = jpq.ivfpq_search(jidx, jnp.asarray(q), 10, nprobe=8, p=8)
    jrecall = np.mean([len(set(a) & set(b)) / 10
                       for a, b in zip(np.asarray(jrows), exact)])
    assert recall >= 0.55 and recall >= jrecall - 0.05, (recall, jrecall)


def test_streaming_build_spills_overflow_to_second_list():
    # tight capacity: rows past their first list land in the runner-up
    # list (re-encoded against it); the rest are reported
    v, _ = _corpus(noise=0.6, seed=13)
    arch = HostArchive(D)
    arch.append(v)
    kw = dict(generator=torch.Generator().manual_seed(0), device="cpu",
              packed=False, chunk=1024, cap_slack=1.0,
              source_scale=arch.scale)
    plain, over_plain = tpq.build_ivf_pq_streaming(arch.chunk_i8, N, D,
                                                   NLIST, M, **kw)
    kw["generator"] = torch.Generator().manual_seed(0)
    spill, over_spill = tpq.build_ivf_pq_streaming(
        arch.chunk_i8, N, D, NLIST, M, source_rows=arch.rows_i8, **kw)
    assert over_plain.sum() > 0
    assert over_spill.sum() < over_plain.sum()
    assert spill.n == N - int(over_spill.sum())
    ids = spill.row_ids.numpy()
    placed = ids[ids >= 0]
    assert len(set(placed.tolist())) == len(placed) == spill.n
    assert not np.isin(np.nonzero(over_spill)[0], placed).any()
    # a spilled row sits in its second-nearest list, coded against it
    moved = np.nonzero(over_plain & ~over_spill)[0][:20]
    a1, a2 = tpq.assign_clusters_top2(
        torch.as_tensor(arch.chunk_f32(0, N)), spill.centroids)
    for r in moved:
        lst = int(np.argwhere(ids == r)[0][0])
        assert lst == int(a2[r]) != int(a1[r])


def test_spill_pass_respects_resid_cap():
    v, _ = _corpus(n=512)
    g = torch.Generator().manual_seed(0)
    idx = tpq.build_ivf_pq(torch.as_tensor(v), 4, M, generator=g,
                           refine=False)
    hs = tpq.HostScatter(512, 4, 128, M)
    hs.overflow[:10] = True
    a2 = np.zeros(512, np.int32)
    tpq._spill_pass(hs, a2, lambda i: v[i], 1.0, idx.centroids,
                    idx.codebook_centroids, packed=False, resid_cap=0.0)
    assert hs.overflow[:10].all() and (hs.ids < 0).all()
    tpq._spill_pass(hs, a2, lambda i: v[i], 1.0, idx.centroids,
                    idx.codebook_centroids, packed=False)
    assert not hs.overflow.any() and (hs.ids >= 0).sum() == 10


@pytest.mark.parametrize("packed", [False, True])
def test_append_matches_jax(packed):
    v, q = _corpus(n=3000, seed=17)
    jidx = jpq.build_ivf_pq(jnp.asarray(v[:2000]), NLIST, M,
                            key=jax.random.key(3), packed=packed)
    tidx = body_from_state(_state(jidx), "cpu")
    codes_before = tidx.codes
    new_rows = np.arange(2000, 3000, dtype=np.int32)
    jnew, jdrop = jpq.ivfpq_append(jidx, jnp.asarray(v[2000:]), new_rows)
    tnew, tdrop = tpq.ivfpq_append(tidx, torch.as_tensor(v[2000:]), new_rows)
    assert tnew.codes is codes_before          # in place, no relayout
    np.testing.assert_array_equal(tdrop, jdrop)
    assert tnew.n == jnew.n
    np.testing.assert_array_equal(tnew.row_ids.numpy(),
                                  np.asarray(jnew.row_ids))
    live = tnew.row_ids.numpy() >= 0
    assert (tnew.codes.numpy()[live]
            == np.asarray(jnew.codes)[live]).mean() >= 0.999
    # the refine table grew with 12.5% slack to a multiple of 8
    assert tnew.refine.shape == tuple(jnew.refine.shape) == (3000, D)
    np.testing.assert_array_equal(tnew.refine.numpy(),
                                  np.asarray(jnew.refine))
    jv, jr, _ = jpq.ivfpq_search(jnew, jnp.asarray(q), 10, nprobe=8, p=4)
    tv, tr, _ = tpq.ivfpq_search(tnew, torch.as_tensor(q), 10, nprobe=8, p=4)
    _assert_search_parity(tv, tr, jv, jr)


def test_append_drops_rows_past_capacity_like_jax():
    v, _ = _corpus(n=1200, centers=2, seed=19)
    jidx = jpq.build_ivf_pq(jnp.asarray(v[:200]), 2, M,
                            key=jax.random.key(4))
    tidx = body_from_state(_state(jidx), "cpu")
    rows = np.arange(200, 1200, dtype=np.int32)
    jnew, jdrop = jpq.ivfpq_append(jidx, jnp.asarray(v[200:]), rows)
    tnew, tdrop = tpq.ivfpq_append(tidx, torch.as_tensor(v[200:]), rows)
    assert tdrop.any()
    np.testing.assert_array_equal(tdrop, jdrop)
    np.testing.assert_array_equal(tnew.row_ids.numpy(),
                                  np.asarray(jnew.row_ids))
    assert tnew.n == jnew.n == 1200 - int(tdrop.sum())
    # refine growth: max(need, have + have // 8) rounded up to 8
    assert tnew.refine.shape[0] == jnew.refine.shape[0] == 1200


def test_host_archive_matches_jax(tmp_path):
    rng = np.random.default_rng(23)
    v = rng.standard_normal((300, 16)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    ours = HostArchive(16, path=str(tmp_path / "a" / "arch-1.i8"))
    ref = jarchive.HostArchive(16)
    for a in (ours, ref):
        assert a.append(v[:100]) == (0, 100)
        a.reserve(250)
        assert a.append(v[100:]) == (100, 300)
    np.testing.assert_array_equal(ours.chunk_i8(0, 300), ref.chunk_i8(0, 300))
    np.testing.assert_array_equal(ours.chunk_f32(5, 50), ref.chunk_f32(5, 50))
    idx = np.array([3, 299, -1, 1000])
    np.testing.assert_array_equal(ours.rows_f32(idx), ref.rows_f32(idx))
    np.testing.assert_array_equal(ours.rows_i8(idx), ref.rows_i8(idx))
    # rescore: the numpy path of both (the JAX package's native rescore
    # sums in another order, so it is compared within 1e-5)
    q = v[:7]
    cand = rng.integers(-1, 300, (7, 12))
    got = ours.rescore(q, cand)
    want = (ref.chunk_f32(0, 300)[np.clip(cand, 0, 299)]
            * q[:, None, :]).sum(-1)
    assert np.all(np.isneginf(got[cand < 0]))
    np.testing.assert_allclose(got[cand >= 0], want[cand >= 0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[cand >= 0],
                               ref.rescore(q, cand)[cand >= 0], rtol=1e-5,
                               atol=1e-6)
    keep = rng.random(300) < 0.5
    small = ours.compact(keep)
    np.testing.assert_array_equal(small.chunk_i8(0, small.n),
                                  ref.compact(keep).chunk_i8(0, small.n))
    assert small.n == int(keep.sum())
    st = ours.state()
    np.testing.assert_array_equal(st["rows"], ref.state()["rows"])
    assert st["scale"] == ref.state()["scale"]
    back = archive_from_state({"archive_rows": st["rows"],
                               "archive_scale": st["scale"]})
    np.testing.assert_array_equal(back.chunk_i8(0, back.n), st["rows"])
    assert np.float32(back.scale) == np.float32(ours.scale)
    assert archive_from_state({}) is None
    ours.close()
    assert ours.n == 0
