"""Port ``ops/fused_topk.py`` against the JAX package's Pallas kernel.

The same numpy inputs go through ``fused_topk`` of the JAX package (its
Pallas kernel in interpret mode, as ``tests/test_pallas_topk.py`` runs
it) and through the port on the CPU, where the wrapper takes the plain
PyTorch version. Ids must be equal; f32 values agree within
``rtol=atol=1e-5`` (the JAX tests' own tolerance: the two matmuls sum in
different orders). bf16 cases use bf16-representable small integers, so
every product and partial sum is exact and values are equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.ops.pallas_topk import fused_topk as jax_fused_topk
from rag_foundation_tpu_torch.ops import fused_topk as port
from rag_foundation_tpu_torch.ops.fused_topk import (fused_topk,
                                                     fused_topk_reference)
from rag_foundation_tpu_torch.ops.topk import exact_topk


def _both(q, c, k, valid=None, **jax_kw):
    jv, ji = jax_fused_topk(jnp.asarray(q), jnp.asarray(c), k,
                            valid_count=valid, interpret=True, **jax_kw)
    tv, ti = fused_topk(torch.as_tensor(q), torch.as_tensor(c), k,
                        valid_count=valid)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    return tv, ti


@pytest.mark.parametrize("n,d,q_n,k,valid,kw", [
    (2048, 128, 32, 10, None, dict(block_q=16, block_n=512)),
    (1000, 64, 13, 7, None, dict(block_q=8, block_n=256)),    # unaligned
    (768, 32, 4, 5, 500, dict(block_q=8, block_n=256)),       # valid_count
    (256, 16, 2, 8, 3, dict(block_q=8, block_n=128)),         # k > live rows
    (300, 16, 3, 4, 10_000, dict(block_q=8, block_n=128)),    # count > N
], ids=["aligned", "unaligned", "valid_count", "k_exceeds_live",
        "count_past_n"])
def test_matches_jax_kernel(n, d, q_n, k, valid, kw):
    rng = np.random.default_rng(n + k)
    c = rng.standard_normal((n, d)).astype(np.float32)
    if valid is not None and valid < n:
        c[valid:] = 99.0         # masked rows would win if they were read
    q = rng.standard_normal((q_n, d)).astype(np.float32)
    tv, ti = _both(q, c, k, valid, **kw)
    live = n if valid is None else min(valid, n)
    assert int(ti.max()) < live
    if live < k:
        assert bool((ti[:, live:] == -1).all())
        assert bool(torch.isneginf(tv[:, live:]).all())


def test_ties_prefer_lower_index():
    c = np.zeros((512, 16), np.float32)
    c[:, 0] = 1.0
    q = np.zeros((2, 16), np.float32)
    q[:, 0] = 1.0
    _, ti = _both(q, c, 6, block_q=8, block_n=128)
    np.testing.assert_array_equal(ti.numpy(), np.tile(np.arange(6), (2, 1)))


def test_duplicate_rows_across_blocks_bit_identical():
    # small-integer values: every partial sum is exact in f32, so ids AND
    # values must be equal bit for bit, duplicates included
    rng = np.random.default_rng(5)
    base = rng.integers(-3, 4, (300, 32)).astype(np.float32)
    c = np.concatenate([base, base, base[:100]])
    q = base[:9] * 2.0
    jv, ji = jax_fused_topk(jnp.asarray(q), jnp.asarray(c), 12,
                            interpret=True, block_q=8, block_n=128)
    tv, ti = fused_topk(torch.as_tensor(q), torch.as_tensor(c), 12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (ti[:, 0].numpy() == np.arange(9)).all()     # not the copy at +300


def test_bf16_corpus_casts_queries_and_matches_jax():
    rng = np.random.default_rng(6)
    c = rng.integers(-8, 9, (640, 64)).astype(np.float32)
    q = rng.integers(-8, 9, (5, 64)).astype(np.float32)
    jv, ji = jax_fused_topk(jnp.asarray(q), jnp.asarray(c, jnp.bfloat16), 9,
                            interpret=True, block_q=8, block_n=128)
    tv, ti = fused_topk(torch.as_tensor(q),
                        torch.as_tensor(c).bfloat16(), 9)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_valid_count_as_tensor_and_reference_equals_exact_topk():
    rng = np.random.default_rng(7)
    c = torch.as_tensor(rng.standard_normal((900, 24)).astype(np.float32))
    q = torch.as_tensor(rng.standard_normal((6, 24)).astype(np.float32))
    ev, ei = exact_topk(q, c, 5, valid_count=700)
    for vc in (700, torch.tensor(700), torch.tensor([700], dtype=torch.int64)):
        tv, ti = fused_topk(q, c, 5, valid_count=vc, block_q=8, block_n=64,
                            n_splits=3)
        assert torch.equal(ti, ei) and torch.equal(tv, ev)
    rv, ri = fused_topk_reference(q, c, 5, valid_count=700)
    assert torch.equal(ri, ei) and torch.equal(rv, ev)


def test_cpu_launches_no_kernel_and_bad_arguments_raise():
    before = port.LAUNCHES.count
    q, c = torch.zeros((2, 8)), torch.zeros((16, 8))
    fused_topk(q, c, 3)
    assert port.LAUNCHES.count == before
    with pytest.raises(ValueError, match="expected queries"):
        fused_topk(torch.zeros((2, 4)), c, 3)
    with pytest.raises(ValueError, match="k must be"):
        fused_topk(q, c, 0)
    with pytest.raises(ValueError, match="one value"):
        fused_topk(q, c, 3, valid_count=torch.tensor([1, 2]))


def test_empty_corpus_gives_pads():
    tv, ti = fused_topk(torch.zeros((3, 8)), torch.zeros((0, 8)), 4)
    assert tuple(tv.shape) == (3, 4) and bool(torch.isneginf(tv).all())
    assert bool((ti == -1).all())
