"""Port mesh and sharded top-k (rag_foundation_tpu_torch/parallel/mesh.py,
topk_merge.py) against the JAX package's on the conftest's 8 virtual
CPU devices; the port shards over ``[cpu] * 8``.

Tolerances: the port's ``sharded_topk`` is bit-identical to its own
single-device ``exact_topk`` (ids and values) for any sharding. Against
JAX ids are equal; f32 values agree within 1e-5 relative (the two
matmuls sum in another order), and integer-valued rows, whose every
partial sum is exact in f32, give bit-identical values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rag_foundation_tpu.parallel.mesh import shard_rows as jax_shard_rows
from rag_foundation_tpu.parallel.topk_merge import \
    sharded_topk as jax_sharded_topk
from rag_foundation_tpu_torch.ops.topk import exact_topk
from rag_foundation_tpu_torch.parallel import make_mesh, sharded_topk
from rag_foundation_tpu_torch.parallel.mesh import replicate, shard_rows
from rag_foundation_tpu_torch.parallel.topk_merge import \
    merge_shard_candidates

CPU8 = [torch.device("cpu")] * 8
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax_make_mesh(8)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=CPU8)


def _jax(jmesh, q, x, k, **kw):
    v, i = jax_sharded_topk(jnp.asarray(q), jax_shard_rows(
        jmesh, jnp.asarray(x)), k, mesh=jmesh, **kw)
    return np.asarray(v), np.asarray(i)


def _port(mesh, q, x, k, **kw):
    v, i = sharded_topk(torch.as_tensor(q), shard_rows(
        mesh, torch.as_tensor(x)), k, mesh=mesh, **kw)
    return v.numpy(), i.numpy()


def test_mesh_shapes_as_jax(jmesh):
    m = make_mesh(4, devices=CPU8)
    jm = jax_make_mesh(4)
    assert m.shape == dict(jm.shape) == {"data": 1, "shard": 4}
    assert m.axis_names == tuple(jm.axis_names) == ("data", "shard")
    assert m.devices == tuple(CPU8[:4]) and m.lead == CPU8[0]
    assert make_mesh(devices=CPU8).shape == {"data": 1, "shard": 8}
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        make_mesh(16, devices=CPU8)
    # rows of the "data" axis would only repeat the replicated work
    with pytest.raises(ValueError, match="only one row of shards"):
        make_mesh(4, data=2, devices=CPU8)


def test_mesh_of_visible_cards_raises_when_too_few():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError,
                       match=f"need {have + 1} devices, have {have}"):
        make_mesh(have + 1)


def test_shard_rows_are_views_on_their_own_device(mesh):
    x = torch.arange(64 * 3, dtype=torch.float32).view(64, 3)
    blocks = shard_rows(mesh, x)
    assert len(blocks) == 8
    for s, b in enumerate(blocks):
        assert b.data_ptr() == x[s * 8].data_ptr()     # no copy
        assert torch.equal(b, x[s * 8:(s + 1) * 8])
    blocks[2][0, 0] = -1.0                             # writes x itself
    assert x[16, 0] == -1.0
    assert all(r is x for r in replicate(mesh, x))
    with pytest.raises(ValueError, match="divide"):
        shard_rows(mesh, x[:60])


@pytest.mark.parametrize("block_size", [64, 256, 8192])
def test_sharded_topk_matches_jax_and_single_device(jmesh, mesh,
                                                    block_size):
    rng = np.random.default_rng(0)
    n, d, q_n, k = 4096, 64, 9, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((q_n, d)).astype(np.float32)
    jv, ji = _jax(jmesh, q, x, k, block_size=256)
    tv, ti = _port(mesh, q, x, k, block_size=block_size)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, **TOL)
    # bit-identical to one device scanning the whole corpus
    rv, ri = exact_topk(torch.as_tensor(q), torch.as_tensor(x), k,
                        block_size=block_size)
    np.testing.assert_array_equal(ti, ri.numpy())
    np.testing.assert_array_equal(tv, rv.numpy())
    assert ti.dtype == np.int32 and tv.dtype == np.float32


def test_integer_rows_bit_identical_to_jax(jmesh, mesh):
    # small integers: every partial sum is exact in f32, so the scores do
    # not depend on the summation order; duplicated rows across shards
    # tie and must go to the lowest global index
    rng = np.random.default_rng(5)
    x = rng.integers(-3, 4, (1024, 32)).astype(np.float32)
    x[700:760] = x[10:70]
    q = np.concatenate([x[10:14], rng.integers(-3, 4, (4, 32)).astype(
        np.float32)])
    jv, ji = _jax(jmesh, q, x, 12, block_size=128)
    tv, ti = _port(mesh, q, x, 12, block_size=64)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    assert list(ti[0, :2]) == [10, 700]


def test_all_ties_take_the_lowest_global_index(jmesh, mesh):
    x = np.zeros((1024, 16), np.float32)
    x[:, 0] = 1.0
    q = np.zeros((2, 16), np.float32)
    q[:, 0] = 1.0
    _, ji = _jax(jmesh, q, x, 5, block_size=128)
    _, ti = _port(mesh, q, x, 5, block_size=32)
    np.testing.assert_array_equal(ti, np.tile(np.arange(5), (2, 1)))
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_valid_counts_hide_poisoned_rows(jmesh, mesh, as_tensor):
    rng = np.random.default_rng(1)
    n, d, k = 2048, 32, 8
    x = rng.standard_normal((n, d)).astype(np.float32)
    shard = n // 8
    counts = np.array([100, 0, 256, 1, 37, 100, 200, 5], np.int32)
    mask = np.zeros(n, bool)
    for s in range(8):
        x[s * shard + counts[s]:(s + 1) * shard] = 50.0     # poison
        mask[s * shard:s * shard + counts[s]] = True
    q = rng.standard_normal((4, d)).astype(np.float32)
    jv, ji = _jax(jmesh, q, x, k, valid_counts=jnp.asarray(counts),
                  block_size=128)
    vc = torch.as_tensor(counts) if as_tensor else counts
    tv, ti = _port(mesh, q, x, k, valid_counts=vc, block_size=64)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, **TOL)
    assert mask[ti[ti >= 0]].all()
    rv, ri = exact_topk(torch.as_tensor(q), torch.as_tensor(x), k,
                        live_mask=torch.as_tensor(mask), block_size=64)
    np.testing.assert_array_equal(ti, ri.numpy())
    np.testing.assert_array_equal(tv, rv.numpy())


def test_k_past_the_live_rows_pads(mesh):
    x = np.eye(16, dtype=np.float32)
    counts = [1, 0, 0, 1, 0, 0, 0, 0]
    v, i = _port(mesh, x[:2], x, 6, valid_counts=counts)
    assert list(i[0]) == [0, 6, -1, -1, -1, -1]
    assert np.isneginf(v[0, 2:]).all()


def test_merge_prefers_the_earlier_shard_on_ties():
    v = [torch.tensor([[1.0, 0.5]]), torch.tensor([[1.0, 0.5]])]
    i = [torch.tensor([[3, 4]], dtype=torch.int32),
         torch.tensor([[9, 8]], dtype=torch.int32)]
    mv, mi = merge_shard_candidates(v, i, 3, torch.device("cpu"))
    assert mi.tolist() == [[3, 9, 4]] and mv.tolist() == [[1.0, 1.0, 0.5]]


def test_shard_count_must_match_the_mesh(mesh):
    x = torch.zeros((64, 4))
    with pytest.raises(ValueError, match="row blocks"):
        sharded_topk(x[:2], shard_rows(make_mesh(4, devices=CPU8), x), 3,
                     mesh=mesh)
