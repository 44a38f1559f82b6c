"""Port ``ops/hosted_topk.py`` against the JAX package and the port's own
device scan.

The same numpy corpus (an ndarray or an ``np.memmap``) and queries go
through ``exact_topk_hosted`` of both packages, on the CPU. Ids must be
equal to JAX's and to ``exact_topk`` over the same rows; f32 values
agree within ``rtol=atol=1e-5`` with JAX (matmul summation order) and
are equal to the port's ``exact_topk`` with the same block size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.ops.hosted_topk import \
    exact_topk_hosted as jax_hosted
from rag_foundation_tpu_torch.ops.hosted_topk import exact_topk_hosted
from rag_foundation_tpu_torch.ops.topk import exact_topk


def _both(queries, corpus, k, block_rows):
    jv, ji = jax_hosted(jnp.asarray(queries), corpus, k,
                        block_rows=block_rows)
    tv, ti = exact_topk_hosted(torch.as_tensor(queries), corpus, k,
                               block_rows=block_rows)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    dv, di = exact_topk(torch.as_tensor(queries),
                        torch.as_tensor(np.array(corpus)), k)
    assert torch.equal(ti, di)
    return tv, ti


@pytest.mark.parametrize("n,d,q_n,k,block_rows", [
    (5000, 64, 32, 10, 768),       # a ragged tail block
    (300, 16, 4, 64, 50),          # k wider than a block
    (1024, 16, 3, 5, 4096),        # one block larger than the corpus
], ids=["matches_device_exact", "k_wider_than_block", "single_block"])
def test_matches_jax_and_device_scan(n, d, q_n, k, block_rows):
    rng = np.random.default_rng(n)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q_n, d)).astype(np.float32)
    _both(queries, corpus, k, block_rows)


def test_tie_break_lowest_id():
    # duplicate rows across different blocks: the LOWER row id must win
    rng = np.random.default_rng(1)
    base = rng.standard_normal((600, 32)).astype(np.float32)
    corpus = np.concatenate([base, base], axis=0)  # dup at +600
    _, ids = _both(base[:8] * 2.0, corpus, 1, 256)
    assert (ids[:, 0].numpy() == np.arange(8)).all()


def test_memmap_corpus(tmp_path):
    rng = np.random.default_rng(3)
    data = rng.standard_normal((4096, 32)).astype(np.float32)
    path = tmp_path / "corpus.f32"
    data.tofile(path)
    mm = np.memmap(path, dtype=np.float32, mode="r", shape=(4096, 32))
    _both(data[:8], mm, 5, 512)


def test_int8_corpus_scores_exact_dots():
    rng = np.random.default_rng(4)
    corpus = rng.integers(-127, 128, (2000, 48)).astype(np.int8)
    queries = rng.integers(-127, 128, (6, 48)).astype(np.int8)
    tv, ti = exact_topk_hosted(torch.as_tensor(queries), corpus, 7,
                               block_rows=300)
    scores = queries.astype(np.int64) @ corpus.astype(np.int64).T
    want = np.argsort(-scores, axis=1, kind="stable")[:, :7]
    np.testing.assert_array_equal(ti.numpy(), want)
    np.testing.assert_array_equal(
        tv.numpy(), np.take_along_axis(scores, want, 1).astype(np.float32))


def test_empty_corpus_and_host_queries():
    tv, ti = exact_topk_hosted(np.zeros((3, 8), np.float32),
                               np.zeros((0, 8), np.float32), 4, device="cpu")
    assert tuple(tv.shape) == (3, 4) and bool(torch.isneginf(tv).all())
    assert ti.dtype == torch.int32 and bool((ti == -1).all())
    # host queries without a device go to the card, which is absent here
    with pytest.raises(RuntimeError, match="CUDA"):
        exact_topk_hosted(np.zeros((3, 8), np.float32),
                          np.zeros((5, 8), np.float32), 4)
    with pytest.raises(ValueError, match="dtype"):
        exact_topk_hosted(torch.zeros((3, 8)), np.zeros((5, 8), np.float64),
                          4)
