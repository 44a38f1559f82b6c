"""Port sharded IVF (rag_foundation_tpu_torch/parallel/sharded_ivf.py)
against the JAX package's on the conftest's 8 virtual CPU devices (its
Pallas kernels in interpret mode); the port shards over ``[cpu] * 8``.

Both sides scan the same body: JAX builds it, and ``body_from_state``
carries it into the port. Tolerances: int8 IVF-Flat ids and values are
bit-identical (exact int8 dots); f32 IVF-Flat ids are equal and values
agree within 1e-5 relative (the matmuls sum in another order). The
ADC scan with an int8 LUT sums integers exactly; its ids are equal and
its values (LUT scale times the sum, plus the coarse score) within 1e-5.
Appends are compared layout for layout (exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.engine import ivf as jivf
from rag_foundation_tpu.engine import ivfpq as jpq
from rag_foundation_tpu.parallel import sharded_ivf as jsivf
from rag_foundation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rag_foundation_tpu_torch.engine import ivf as tivf
from rag_foundation_tpu_torch.engine import ivfpq as tpq
from rag_foundation_tpu_torch.engine.archive import HostArchive
from rag_foundation_tpu_torch.engine.convert import (body_from_state,
                                                     body_to_state)
from rag_foundation_tpu_torch.ops import ivf_scan, pq_scan
from rag_foundation_tpu_torch.parallel import sharded_ivf as tsivf
from rag_foundation_tpu_torch.parallel.mesh import make_mesh

TOL = dict(rtol=1e-5, atol=1e-6)
D = 64


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax_make_mesh(8)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=[torch.device("cpu")] * 8)


def _clustered(n, d=D, centers=48, noise=0.2, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] \
        + noise * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _queries(x, n, seed):
    rng = np.random.default_rng(seed)
    q = x[:n] + 0.05 * rng.standard_normal((n, x.shape[1])).astype(
        np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _state(jbody, kind) -> dict:
    out = {"kind": kind}
    for name, val in jbody._asdict().items():
        out["f_" + name] = np.int64(val) if isinstance(val, int) \
            else np.asarray(val)
    return out


def _flat(x, int8, nlist=64, slack=1.0, seed=0):
    jbody = jivf.build_ivf_flat(jnp.asarray(x), nlist,
                                key=jax.random.key(seed), int8=int8,
                                capacity_slack=slack)
    return jbody, body_from_state(_state(jbody, "IVFFlatIndex"), "cpu")


@pytest.fixture(scope="module", params=["int8", "f32"])
def flat_bodies(request):
    x = _clustered(8192, seed=21)
    jbody, tbody = _flat(x, request.param == "int8")
    return request.param, x, jbody, tbody


@pytest.mark.parametrize("q_n,nprobe_local,p", [(64, 2, 4), (5, 3, 2),
                                                (300, 1, 3)])
def test_sharded_ivf_search_matches_jax(flat_bodies, jmesh, mesh, q_n,
                                        nprobe_local, p):
    kind, x, jbody, tbody = flat_bodies
    q = _queries(x, q_n, seed=q_n)
    jv, jr = jsivf.sharded_ivf_search(
        jsivf.shard_ivf_index(jbody, jmesh), jnp.asarray(q), 10, mesh=jmesh,
        nprobe_local=nprobe_local, p=p, interpret=True)
    sbody = tsivf.shard_ivf_index(tbody, mesh)
    n0 = ivf_scan.LAUNCHES.count
    tv, tr = tsivf.sharded_ivf_search(sbody, torch.as_tensor(q), 10,
                                      mesh=mesh, nprobe_local=nprobe_local,
                                      p=p)
    assert ivf_scan.LAUNCHES.count == n0        # the CPU path counts none
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    if kind == "int8":
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    assert tr.shape == (q_n, 10) and tr.dtype == torch.int32


def test_over_fetch_past_the_shard_width_pads_like_jax(jmesh, mesh):
    x = _clustered(2048, seed=3)
    jbody, tbody = _flat(x, True, nlist=16)
    q = _queries(x, 4, seed=3)
    # width a shard: 1 list x (cap_len / 128) sub-blocks x p=1
    k = 64
    jv, jr = jsivf.sharded_ivf_search(
        jsivf.shard_ivf_index(jbody, jmesh), jnp.asarray(q), k, mesh=jmesh,
        nprobe_local=1, p=1, interpret=True)
    tv, tr = tsivf.sharded_ivf_search(tsivf.shard_ivf_index(tbody, mesh),
                                      torch.as_tensor(q), k, mesh=mesh,
                                      nprobe_local=1, p=1)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (tr.numpy() == -1).any() and tr.shape == (4, k)


def test_all_lists_probed_equals_single_device_routing(flat_bodies, mesh):
    # with every list probed and room for every probe, the shard-local
    # routing scans what one device scans: the same rows in the same
    # order
    _, x, _, tbody = flat_bodies
    q = torch.as_tensor(_queries(x, 32, seed=9))
    rv, rr, drop = tivf.ivf_search(tbody, q, 10, nprobe=64, p=3, qcap=32)
    assert int(drop) == 0
    tv, tr = tsivf.sharded_ivf_search(tsivf.shard_ivf_index(tbody, mesh), q,
                                      10, mesh=mesh, nprobe_local=8, p=3,
                                      qcap=32)
    assert torch.equal(tr, rr) and torch.equal(tv, rv)


def test_recall_against_single_device_at_the_same_global_nprobe(
        flat_bodies, mesh):
    # 8 shards x nprobe_local 2 against one device at nprobe 16 (the
    # JAX package's own bound for this corpus, tests/test_sharded_ivf.py)
    _, x, _, tbody = flat_bodies
    q = torch.as_tensor(_queries(x, 64, seed=11))
    _, rr, _ = tivf.ivf_search(tbody, q, 10, nprobe=16, p=10)
    _, tr = tsivf.sharded_ivf_search(tsivf.shard_ivf_index(tbody, mesh), q,
                                     10, mesh=mesh, nprobe_local=2, p=10)
    rec = np.mean([len(set(a) & set(b)) / 10
                   for a, b in zip(tr.numpy(), rr.numpy())])
    assert rec >= 0.95, rec


def test_shards_are_views_of_the_body(mesh):
    x = _clustered(2048, seed=4)
    _, tbody = _flat(x, True, nlist=16)
    sbody = tsivf.shard_ivf_index(tbody, mesh)
    assert sbody.nlist == 16 and sbody.nlist_local == 2
    assert sbody.n == tbody.n == sum(s.n for s in sbody.shards)
    for s, shard in enumerate(sbody.shards):
        assert shard.lists.data_ptr() == tbody.lists[2 * s].data_ptr()
        assert shard.row_ids.data_ptr() == tbody.row_ids[2 * s].data_ptr()
    # the gathered state is the unsharded body's, field for field
    want = body_to_state(tbody)
    got = body_to_state(sbody)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype, k


def test_a_sharded_body_reads_only_its_replicated_fields(mesh):
    x = _clustered(2048, seed=4)
    _, tbody = _flat(x, True, nlist=16)
    sbody = tsivf.shard_ivf_index(tbody, mesh)
    assert sbody.scale == tbody.scale and sbody.dtype == torch.int8
    # a list-indexed field would be one shard's eighth of the body
    for name in ("lists", "row_ids", "centroids", "codes"):
        with pytest.raises(AttributeError, match="split over the shards"):
            getattr(sbody, name)
    with pytest.raises(AttributeError):
        sbody.no_such_field
    # the gathered body is the unsharded one on the host
    whole = tsivf.gather_body(sbody)
    for name, val in tbody._asdict().items():
        if isinstance(val, torch.Tensor):
            assert torch.equal(getattr(whole, name), val), name
        else:
            assert getattr(whole, name) == val, name


@pytest.mark.parametrize("int8", [True, False])
def test_sharded_append_matches_jax(jmesh, mesh, int8):
    x = _clustered(4800, seed=6)
    jbody, tbody = _flat(x[:2400], int8, nlist=16, slack=1.0, seed=1)
    new_rows = np.arange(2400, 4800, dtype=np.int32)
    jnew, jdrop = jsivf.sharded_ivf_append(
        jsivf.shard_ivf_index(jbody, jmesh), jnp.asarray(x[2400:]),
        new_rows, mesh=jmesh)
    sbody = tsivf.shard_ivf_index(tbody, mesh)
    tnew, tdrop = tsivf.sharded_ivf_append(
        sbody, torch.as_tensor(x[2400:]), new_rows, mesh=mesh)
    np.testing.assert_array_equal(tdrop, np.asarray(jdrop))
    assert tdrop.any() and not tdrop.all()      # twice the rows overflow
    assert tnew.n == jnew.n == 4800 - int(tdrop.sum())
    assert sum(s.n for s in tnew.shards) == tnew.n
    got = body_to_state(tnew)
    want = _state(jnew, "IVFFlatIndex")
    for name in ("lists", "row_ids", "centroids"):
        np.testing.assert_array_equal(got["f_" + name],
                                      want["f_" + name])
    # the shards are views: the append wrote the unsharded body in place,
    # which now equals the one-device append's layout
    _, tbody2 = _flat(x[:2400], int8, nlist=16, slack=1.0, seed=1)
    single, sdrop = tivf.ivf_append(tbody2, torch.as_tensor(x[2400:]),
                                    new_rows)
    np.testing.assert_array_equal(sdrop, tdrop)
    assert torch.equal(tbody.lists, single.lists)
    assert torch.equal(tbody.row_ids, single.row_ids)
    # an appended row is found again through the sharded search
    _, tr = tsivf.sharded_ivf_search(tnew, torch.as_tensor(x[2500:2510]), 3,
                                     mesh=mesh, nprobe_local=2, p=3)
    landed = ~tdrop[100:110]
    assert (tr.numpy()[landed, 0] == np.arange(2500, 2510)[landed]).all()


def test_divisibility_and_mesh_errors(mesh):
    x = _clustered(1024, seed=8)
    _, tbody = _flat(x, False, nlist=12)
    with pytest.raises(ValueError, match="nlist 12 must divide by 8"):
        tsivf.shard_ivf_index(tbody, mesh)
    _, tbody16 = _flat(x, False, nlist=16)
    sbody = tsivf.shard_ivf_index(tbody16, mesh)
    mesh4 = make_mesh(4, devices=[torch.device("cpu")] * 4)
    with pytest.raises(ValueError, match="8 shards on a mesh of 4"):
        tsivf.sharded_ivf_search(sbody, torch.as_tensor(x[:2]), 3,
                                 mesh=mesh4)
    with pytest.raises(ValueError, match="8 shards on a mesh of 4"):
        tsivf.sharded_ivf_append(sbody, torch.as_tensor(x[:2]),
                                 np.arange(2, dtype=np.int32), mesh=mesh4)


# -- IVF-PQ ---------------------------------------------------------------

NLIST, M = 32, 16


@pytest.fixture(scope="module")
def pq_corpus():
    # tests/test_sharded_ivfpq.py's corpus: unit centres, N(0, 0.25^2) a
    # coordinate, so rows spread past the 4-bit codes' resolution
    rng = np.random.default_rng(17)
    c = rng.standard_normal((NLIST, D)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = c[rng.integers(0, NLIST, 8192)] + 0.25 * rng.standard_normal(
        (8192, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x, _queries(x, 32, seed=17)


@pytest.fixture(scope="module", params=[True, False],
                ids=["packed", "unpacked"])
def pq_bodies(request, pq_corpus):
    x, _ = pq_corpus
    jbody = jpq.build_ivf_pq(jnp.asarray(x), NLIST, M,
                             key=jax.random.key(0), packed=request.param,
                             refine=False)
    return jbody, body_from_state(_state(jbody, "IVFPQIndex"), "cpu")


@pytest.mark.parametrize("k,nprobe_local,p", [(10, 4, 8), (40, 2, 4)])
def test_sharded_ivfpq_search_matches_jax(pq_corpus, pq_bodies, jmesh,
                                          mesh, k, nprobe_local, p):
    _, q = pq_corpus
    jbody, tbody = pq_bodies
    jv, jr = jsivf.sharded_ivfpq_search(
        jsivf.shard_ivfpq_index(jbody, jmesh), jnp.asarray(q), k,
        mesh=jmesh, nprobe_local=nprobe_local, p=p, lut_dtype="int8",
        interpret=True)
    sbody = tsivf.shard_ivfpq_index(tbody, mesh)
    n0 = pq_scan.LAUNCHES.count
    tv, tr = tsivf.sharded_ivfpq_search(sbody, torch.as_tensor(q), k,
                                        mesh=mesh,
                                        nprobe_local=nprobe_local, p=p,
                                        lut_dtype="int8")
    assert pq_scan.LAUNCHES.count == n0
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_sharded_ivfpq_host_rerank_and_adc_overlap(pq_corpus, pq_bodies,
                                                   mesh):
    x, q = pq_corpus
    _, tbody = pq_bodies
    sbody = tsivf.shard_ivfpq_index(tbody, mesh)
    qt = torch.as_tensor(q)
    # the ADC candidates against one device at the same global nprobe
    # (8 x 4 against 32: tests/test_sharded_ivfpq.py's bound)
    _, rr, _ = tpq.ivfpq_search(tbody, qt, 10, nprobe=16, p=8)
    _, tr = tsivf.sharded_ivfpq_search(sbody, qt, 10, mesh=mesh,
                                       nprobe_local=4, p=8)
    overlap = np.mean([len(set(a) & set(b)) / 10
                       for a, b in zip(tr.numpy(), rr.numpy())])
    assert overlap >= 0.9, overlap
    # the host archive's exact re-rank puts the source row first
    arch = HostArchive(D)
    arch.append(x)
    _, cand = tsivf.sharded_ivfpq_search(sbody, qt, 40, mesh=mesh,
                                         nprobe_local=4, p=8)
    cand = cand.numpy()
    scores = arch.rescore(q, cand)
    top = np.take_along_axis(cand, np.argsort(-scores, axis=1,
                                              kind="stable")[:, :1], 1)
    assert (top[:, 0] == np.arange(32)).mean() >= 0.9


def test_a_sharded_pq_body_reads_its_codebook_not_its_codes(pq_bodies,
                                                           mesh):
    _, tbody = pq_bodies
    sbody = tsivf.shard_ivfpq_index(tbody, mesh)
    assert (sbody.m, sbody.k_codes, sbody.packed) \
        == (tbody.m, tbody.k_codes, tbody.packed)
    assert sbody.dtype == torch.uint8 and sbody.refine.shape[0] == 0
    assert torch.equal(sbody.codebook_centroids, tbody.codebook_centroids)
    with pytest.raises(AttributeError, match="split over the shards"):
        sbody.codes


def test_shard_ivfpq_rejects_device_refine(pq_corpus, mesh):
    x, _ = pq_corpus
    jbody = jpq.build_ivf_pq(jnp.asarray(x[:2048]), NLIST, M,
                             key=jax.random.key(0), refine=True)
    tbody = body_from_state(_state(jbody, "IVFPQIndex"), "cpu")
    with pytest.raises(ValueError, match="refine-free"):
        tsivf.shard_ivfpq_index(tbody, mesh)
