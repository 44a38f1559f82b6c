"""Port exact top-k (rag_foundation_tpu_torch/ops/topk.py) against the JAX
package's ``exact_topk`` / ``merge_topk``.

Inputs use duplicated rows, so ties must go to the lowest global index in
both packages, for every block size. Indices must be equal; f32 values
agree within 1e-5 relative (matmul summation order), int8 values are
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.ops.topk import exact_topk as jax_exact_topk
from rag_foundation_tpu.ops.topk import merge_topk as jax_merge_topk
from rag_foundation_tpu_torch.ops.topk import exact_topk, merge_topk


def _corpus(n=700, d=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[1::3] = x[0::3][: len(x[1::3])]     # duplicated rows -> exact ties
    q = np.concatenate([x[:6], rng.standard_normal((4, d)).astype(
        np.float32)])
    return q, x


def _jax(q, x, k, **kw):
    kw = {key: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for key, v in kw.items()}
    v, i = jax_exact_topk(jnp.asarray(q), jnp.asarray(x), k, **kw)
    return np.asarray(v), np.asarray(i)


def _torch(q, x, k, **kw):
    kw = {key: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
          for key, v in kw.items()}
    v, i = exact_topk(torch.as_tensor(q), torch.as_tensor(x), k, **kw)
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("block_size", [7, 64, 256, 8192])
def test_exact_topk_ties_to_lowest_index(block_size):
    q, x = _corpus()
    jv, ji = _jax(q, x, 12, block_size=256)
    tv, ti = _torch(q, x, 12, block_size=block_size)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    # a query equal to row 0 ties rows 0 and 1: lowest first
    assert list(ti[0, :2]) == [0, 1]


def test_valid_count_past_n_is_clamped():
    q, x = _corpus(n=300)
    jv, ji = _jax(q, x, 10, valid_count=10_000, block_size=64)
    tv, ti = _torch(q, x, 10, valid_count=10_000, block_size=64)
    np.testing.assert_array_equal(ti, ji)
    assert ti.max() < 300


@pytest.mark.parametrize("valid_count", [0, 5, 150])
def test_valid_count_and_live_mask(valid_count):
    q, x = _corpus(n=300, seed=1)
    live = np.random.default_rng(2).random(300) > 0.4
    jv, ji = _jax(q, x, 10, valid_count=valid_count, live_mask=live,
                  block_size=64)
    tv, ti = _torch(q, x, 10, valid_count=valid_count, live_mask=live,
                    block_size=32)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    assert np.all(live[ti[ti >= 0]]) and np.all(ti[ti >= 0] < valid_count)


def test_k_beyond_live_rows_pads_with_neg_inf():
    q, x = _corpus(n=64, seed=3)
    live = np.zeros(64, bool)
    live[[3, 9, 40]] = True
    jv, ji = _jax(q, x, 8, live_mask=live, block_size=16)
    tv, ti = _torch(q, x, 8, live_mask=live, block_size=16)
    np.testing.assert_array_equal(ti, ji)
    assert np.all(ti[:, 3:] == -1) and np.all(np.isneginf(tv[:, 3:]))
    assert np.all(np.isneginf(jv[:, 3:]))


def test_int8_corpus_exact():
    rng = np.random.default_rng(4)
    x = rng.integers(-127, 128, (500, 48)).astype(np.int8)
    x[250:] = x[:250]
    q = rng.integers(-127, 128, (5, 48)).astype(np.int8)
    jv, ji = _jax(q, x, 10, block_size=128)
    tv, ti = _torch(q, x, 10, block_size=100)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)


def test_merge_topk_prefers_first_set_on_ties():
    rng = np.random.default_rng(5)
    va = np.round(rng.standard_normal((4, 6)), 1).astype(np.float32)
    vb = np.round(rng.standard_normal((4, 9)), 1).astype(np.float32)
    vb[:, :3] = va[:, :3]                 # cross-set ties
    ia = np.arange(24, dtype=np.int32).reshape(4, 6)
    ib = 100 + np.arange(36, dtype=np.int32).reshape(4, 9)
    jv, ji = jax_merge_topk(*(jnp.asarray(a) for a in (va, ia, vb, ib)), 7)
    tv, ti = merge_topk(*(torch.as_tensor(a) for a in (va, ia, vb, ib)), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
