"""Port ``ops/block_topk.py`` against the JAX package's Pallas kernel.

The same numpy inputs go through ``block_topk`` of the JAX package (its
Pallas kernel in interpret mode, as ``tests/test_pallas_block_topk.py``
runs it) and through the port on the CPU, where the wrapper takes the
plain PyTorch version. With equal ``p`` and ``block_n`` the two keep the
same candidates, so ids must be equal, also where ``p < k`` makes the
result approximate; f32 values agree within ``rtol=atol=1e-5`` (the two
matmuls sum in different orders). Integer-valued and bf16 cases are
exact in f32 and compared bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.ops.pallas_block_topk import \
    block_topk as jax_block_topk
from rag_foundation_tpu_torch.ops import block_topk as port
from rag_foundation_tpu_torch.ops.block_topk import (
    block_candidates_reference, block_topk, block_topk_reference)
from rag_foundation_tpu_torch.ops.topk import exact_topk
from rag_foundation_tpu_torch.tools.exact_scan import run_exact_1m


def _both(q, c, k, *, p, block_n, valid=None, block_q=8):
    jv, ji = jax_block_topk(jnp.asarray(q), jnp.asarray(c), k, p=p,
                            valid_count=valid, block_q=block_q,
                            block_n=block_n, interpret=True)
    tv, ti = block_topk(torch.as_tensor(q), torch.as_tensor(c), k, p=p,
                        valid_count=valid, block_q=block_q, block_n=block_n)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    return tv, ti


@pytest.mark.parametrize("n,d,q_n,k,p,block_n,valid", [
    (2048, 64, 16, 10, 10, 512, None),     # exact when p = k
    (8192, 32, 8, 10, 2, 128, None),       # p < k over 64 blocks
    (700, 32, 5, 6, 6, 256, 400),          # valid_count and a ragged tail
    (1000, 16, 3, 4, 1, 100, 950),         # p = 1, block_n not a tile size
    (640, 16, 2, 5, 9, 128, None),         # p > k is clamped to k
], ids=["p_equals_k", "p2_many_blocks", "valid_count_and_padding", "p1",
        "p_clamped"])
def test_matches_jax_kernel(n, d, q_n, k, p, block_n, valid):
    rng = np.random.default_rng(n + k)
    c = rng.standard_normal((n, d)).astype(np.float32)
    if valid is not None:
        c[valid:] = 99.0         # masked rows would win if they were read
    q = rng.standard_normal((q_n, d)).astype(np.float32)
    tv, ti = _both(q, c, k, p=p, block_n=block_n, valid=valid)
    _, ei = exact_topk(torch.as_tensor(q), torch.as_tensor(c), k,
                       valid_count=valid)
    if p >= k:
        assert torch.equal(ti, ei)
    else:
        rec = np.mean([len(set(a) & set(b)) / k
                       for a, b in zip(ti.tolist(), ei.tolist())])
        assert rec >= (0.95 if p > 1 else 0.5)
    if valid is not None:
        assert int(ti.max()) < valid


def test_ties_prefer_lower_index():
    c = np.zeros((512, 16), np.float32)
    c[:, 0] = 1.0
    q = np.zeros((2, 16), np.float32)
    q[:, 0] = 1.0
    _, ti = _both(q, c, 4, p=4, block_n=128)
    np.testing.assert_array_equal(ti.numpy(), np.tile(np.arange(4), (2, 1)))


def test_duplicate_rows_across_blocks_bit_identical():
    rng = np.random.default_rng(5)
    base = rng.integers(-3, 4, (300, 32)).astype(np.float32)
    c = np.concatenate([base, base, base[:100]])
    q = base[:9] * 2.0
    for p in (12, 3):
        jv, ji = jax_block_topk(jnp.asarray(q), jnp.asarray(c), 12, p=p,
                                block_q=8, block_n=128, interpret=True)
        tv, ti = block_topk(torch.as_tensor(q), torch.as_tensor(c), 12, p=p,
                            block_n=128)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (ti[:, 0].numpy() == np.arange(9)).all()     # not the copy at +300


def test_bf16_corpus_matches_jax():
    rng = np.random.default_rng(6)
    c = rng.integers(-8, 9, (640, 64)).astype(np.float32)
    q = rng.integers(-8, 9, (5, 64)).astype(np.float32)
    jv, ji = jax_block_topk(jnp.asarray(q), jnp.asarray(c, jnp.bfloat16), 9,
                            p=2, block_q=8, block_n=128, interpret=True)
    tv, ti = block_topk(torch.as_tensor(q), torch.as_tensor(c).bfloat16(),
                        9, p=2, block_n=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_candidates_layout_and_tensor_valid_count():
    # stage 1 writes [Q, num_blocks, p], -1 where a block has fewer than p
    # live rows; a 0-d tensor valid_count masks like an int
    rng = np.random.default_rng(8)
    c = torch.as_tensor(rng.standard_normal((300, 8)).astype(np.float32))
    q = torch.as_tensor(rng.standard_normal((4, 8)).astype(np.float32))
    cv, ci = block_candidates_reference(q, c, 3, torch.tensor(130), 128)
    assert tuple(cv.shape) == tuple(ci.shape) == (4, 3, 3)
    assert bool((ci[:, 0] < 128).all()) and bool((ci[:, 0] >= 0).all())
    assert bool((ci[:, 1, :2] >= 128).all()) and bool((ci[:, 1, 2] == -1).all())
    assert bool((ci[:, 2] == -1).all()) and bool(torch.isneginf(cv[:, 2]).all())
    a = block_topk(q, c, 4, p=3, valid_count=torch.tensor(130), block_n=128)
    b = block_topk_reference(q, c, 4, p=3, valid_count=130, block_n=128)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_cpu_launches_no_kernel_and_bad_arguments_raise():
    before = port.LAUNCHES.count
    q, c = torch.zeros((2, 8)), torch.zeros((300, 8))
    block_topk(q, c, 3, block_n=100)
    assert port.LAUNCHES.count == before
    with pytest.raises(ValueError, match="candidates"):
        block_topk(q, c, 10, p=2, block_n=100)     # 3 blocks x 2 < 10
    with pytest.raises(ValueError, match="p must be"):
        block_topk(q, c, 3, p=0)
    with pytest.raises(ValueError, match="expected queries"):
        block_topk(torch.zeros((2, 4)), c, 3)


def test_exact_scan_tool_runs_the_plain_versions_on_the_cpu():
    # the port's counterpart of bench.py::run_exact_1m, at a small size:
    # block_topk(p=2, block_n=1024) timed, its recall against fused_topk
    # and exact_topk, which agree to the id
    res = run_exact_1m("cpu", n=20_000, d=64, q_n=48, k=10, seed=1, reps=1)
    assert (res["rows"], res["d"], res["queries"], res["k"]) == (20_000, 64,
                                                                 48, 10)
    assert res["dtype"] == "bfloat16" and res["device"] == "cpu"
    assert res["card"] is None and "vs_baseline" not in res
    assert res["qps"] > 0 and res["ms_per_batch"] > 0
    assert res["fused_vs_exact_near_ties"] == 0
    assert res["recall_vs_fused"] == res["recall_vs_exact"] >= 0.9
    assert res["recall_queries"] == 48
