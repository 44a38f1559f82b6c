"""Port PQ ops (rag_foundation_tpu_torch/ops/pq.py, ops/kmeans.py,
ops/pq_scan.py helpers) against the JAX package's on the same numpy
inputs and codebooks.

Tolerances: ``pq_lut``, ``pq_decode`` and ``pq_adc_scores`` are f32 sums
of a few products whose order differs between XLA and PyTorch: 1e-5
(rtol and atol; inputs are unit-scale). ``pq_encode`` is an argmax over
such sums, so a code may differ only where the two best sub-centroids
score within 1e-5 of each other. ``flatten_luts`` and ``pack_codes`` are
layout and exact rounding: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.ops import kmeans as jkm
from rag_foundation_tpu.ops import pallas_pq as jpq_scan
from rag_foundation_tpu.ops import pq as jpq
from rag_foundation_tpu_torch.ops import kmeans, pq, pq_scan

TOL = dict(rtol=1e-5, atol=1e-5)


def _data(n=600, d=32, m=8, k=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cb = rng.standard_normal((m, k, d // m)).astype(np.float32) * 0.5
    return x, cb


def _books(cb):
    return (pq.PQCodebook(torch.as_tensor(cb)),
            jpq.PQCodebook(jnp.asarray(cb)))


@pytest.mark.parametrize("k", [16, 256])
def test_pq_encode_matches_jax(k):
    x, cb = _data(k=k, seed=k)
    tb, jb = _books(cb)
    ours = pq.pq_encode(tb, torch.as_tensor(x), block_size=256).numpy()
    ref = np.asarray(jpq.pq_encode(jb, jnp.asarray(x)))
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    diff = np.argwhere(ours != ref)
    assert len(diff) <= 1e-3 * ours.size
    dsub = cb.shape[2]
    for r, mm in diff:      # only a near-tie may differ
        sub = x[r, mm * dsub:(mm + 1) * dsub]
        s = cb[mm] @ sub - 0.5 * (cb[mm] ** 2).sum(1)
        assert abs(s[ours[r, mm]] - s[ref[r, mm]]) <= 1e-5


def test_pq_encode_ties_go_to_the_lowest_code():
    _, cb = _data()
    cb[:, 5] = cb[:, 2]            # duplicate sub-centroids
    x = np.tile(cb[:, 2].reshape(1, -1), (4, 1))
    ours = pq.pq_encode(pq.PQCodebook(torch.as_tensor(cb)),
                        torch.as_tensor(x)).numpy()
    ref = np.asarray(jpq.pq_encode(jpq.PQCodebook(jnp.asarray(cb)),
                                   jnp.asarray(x)))
    assert np.all(ours == 2) and np.all(ref == 2)


@pytest.mark.parametrize("k", [16, 256])
def test_pq_decode_lut_adc_match_jax(k):
    x, cb = _data(k=k, seed=3)
    tb, jb = _books(cb)
    rng = np.random.default_rng(4)
    codes = rng.integers(0, k, (x.shape[0], cb.shape[0])).astype(np.uint8)
    q = x[:9]
    np.testing.assert_array_equal(
        pq.pq_decode(tb, torch.as_tensor(codes)).numpy(),
        np.asarray(jpq.pq_decode(jb, jnp.asarray(codes))))
    lut = pq.pq_lut(tb, torch.as_tensor(q))
    jlut = jpq.pq_lut(jb, jnp.asarray(q))
    assert lut.shape == (9, cb.shape[0], k)
    np.testing.assert_allclose(lut.numpy(), np.asarray(jlut), **TOL)
    adc = pq.pq_adc_scores(lut, torch.as_tensor(codes), block_size=128)
    jadc = jpq.pq_adc_scores(jlut, jnp.asarray(codes))
    np.testing.assert_allclose(adc.numpy(), np.asarray(jadc), **TOL)
    # the ADC sum is the dot with the decoded vector
    dec = pq.pq_decode(tb, torch.as_tensor(codes))
    np.testing.assert_allclose(adc.numpy(), q @ dec.numpy().T, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("nbits", [4, 8])
def test_pq_train_distortion_close_to_jax(nbits):
    # k-means from torch.Generator finds other centroids than jax.random:
    # compare the quantization error, not the codebooks. Within 10% of
    # each other on clustered sub-vectors
    rng = np.random.default_rng(5)
    n, d, m = 3000, 32, 8
    centers = rng.standard_normal((40, d)).astype(np.float32)
    x = centers[rng.integers(0, 40, n)] + 0.2 * rng.standard_normal(
        (n, d)).astype(np.float32)
    tb = pq.pq_train(torch.as_tensor(x), m, nbits=nbits, iters=8,
                     generator=torch.Generator().manual_seed(0))
    jb = jpq.pq_train(jnp.asarray(x), m, key=jax.random.key(0), iters=8,
                      nbits=nbits)
    assert tuple(tb.centroids.shape) == tuple(jb.centroids.shape) == (
        m, 1 << nbits, d // m)
    assert (tb.m, tb.k, tb.dsub, tb.dim) == (m, 1 << nbits, d // m, d)

    def err(book):
        xt = torch.as_tensor(x)
        rec = pq.pq_decode(book, pq.pq_encode(book, xt))
        return float(((xt - rec) ** 2).sum(1).mean())

    ours = err(tb)
    ref = err(pq.PQCodebook(torch.tensor(np.array(jb.centroids))))
    assert ours <= 1.1 * ref and ref <= 1.1 * ours, (ours, ref)
    assert ours < 0.5 * float((x ** 2).sum(1).mean())


def test_pq_train_rejects_bad_shapes():
    x = torch.zeros((10, 30))
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="not divisible"):
        pq.pq_train(x, 8, generator=g)
    with pytest.raises(ValueError, match="nbits"):
        pq.pq_train(x, 5, nbits=6, generator=g)


def test_batched_kmeans_of_one_problem_is_kmeans_fit():
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((500, 6)).astype(np.float32))
    one, _ = kmeans.kmeans_fit(x, 16, iters=5, seed_method="farthest",
                               generator=torch.Generator().manual_seed(7))
    many = kmeans.kmeans_fit_batched(
        x[None], 16, iters=5, generator=torch.Generator().manual_seed(7))
    np.testing.assert_allclose(many[0].numpy(), one.numpy(), **TOL)


def test_assign_clusters_top2_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((700, 24)).astype(np.float32)
    c = rng.standard_normal((33, 24)).astype(np.float32)
    c[9] = c[4]                                   # a tie: lower index first
    a1, a2 = kmeans.assign_clusters_top2(torch.as_tensor(x),
                                         torch.as_tensor(c), block_size=256)
    j1, j2 = jkm.assign_clusters_top2(jnp.asarray(x), jnp.asarray(c))
    assert a1.dtype == torch.int32 and a2.dtype == torch.int32
    np.testing.assert_array_equal(a1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(a2.numpy(), np.asarray(j2))
    first, _ = kmeans.assign_clusters(torch.as_tensor(x), torch.as_tensor(c))
    np.testing.assert_array_equal(a1.numpy(), first.numpy())


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_flatten_luts_bit_equal_to_jax(dtype, packed):
    rng = np.random.default_rng(9)
    lut = rng.standard_normal((7, 12, 16)).astype(np.float32)
    lut[3] = 0.0                                   # the scale floor
    jdt = jnp.int8 if dtype == "int8" else jnp.bfloat16
    jf, js = jpq_scan.flatten_luts(jnp.asarray(lut), jdt, packed=packed)
    tf, ts = pq_scan.flatten_luts(torch.as_tensor(lut), dtype, packed=packed)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf.float().numpy(),
                                  np.asarray(jf.astype(jnp.float32)))
    assert tf.dtype == (torch.int8 if dtype == "int8" else torch.bfloat16)
    # K-major: flat[q, k*m + pos]
    pos = np.concatenate([np.arange(0, 12, 2), np.arange(1, 12, 2)]) \
        if packed else np.arange(12)
    if dtype == "bf16":
        want = torch.as_tensor(lut[:, pos, :]).bfloat16().float().numpy()
        np.testing.assert_array_equal(
            tf.float().numpy().reshape(7, 16, 12),
            want.transpose(0, 2, 1))
    with pytest.raises(ValueError, match="LUT dtype"):
        pq_scan.flatten_luts(torch.as_tensor(lut), torch.float16)


def test_pack_codes_bit_equal_to_jax():
    rng = np.random.default_rng(10)
    codes = rng.integers(0, 16, (3, 50, 12)).astype(np.uint8)
    ours = pq_scan.pack_codes(torch.as_tensor(codes)).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(jpq_scan.pack_codes(jnp.asarray(codes))))
    assert ours.shape == (3, 50, 6) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours & 15, codes[..., 0::2])
    np.testing.assert_array_equal(ours >> 4, codes[..., 1::2])
