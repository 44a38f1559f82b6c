"""Port list scan (rag_foundation_tpu_torch/ops/ivf_scan.py) against the
JAX package's Pallas ``ivf_list_scan`` (interpret mode on the CPU).

Tolerances: int8 scores are exact int32 dots times one f32 scale, so the
plain PyTorch version must match bit for bit. f32 and bf16 dots sum in
another order than XLA, so values agree within 1e-5 relative (unit-scale
inputs) and the selected rows must be the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.ops.pallas_ivf import ivf_list_scan as jax_scan
from rag_foundation_tpu_torch.ops import cuda_lib, ivf_scan
from rag_foundation_tpu_torch.ops.ivf_scan import ivf_list_scan


def _inputs(dtype, nlist=5, qcap=8, d=64, cap_len=384, dead=0.3, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        q = rng.integers(-127, 128, (nlist, qcap, d)).astype(np.int8)
        lists = rng.integers(-127, 128, (nlist, cap_len, d)).astype(np.int8)
    else:
        q = rng.standard_normal((nlist, qcap, d)).astype(np.float32)
        lists = rng.standard_normal((nlist, cap_len, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        lists /= np.linalg.norm(lists, axis=-1, keepdims=True)
    ids = np.arange(nlist * cap_len, dtype=np.int32).reshape(nlist, cap_len)
    ids[rng.random(ids.shape) < dead] = -1
    ids[1, 128:256] = -1        # one whole dead sub-block
    return q, lists, ids


def _jax(q, lists, ids, p, scale, dtype=None):
    jq, jl = jnp.asarray(q), jnp.asarray(lists)
    if dtype is not None:
        jq, jl = jq.astype(dtype), jl.astype(dtype)
    v, i = jax_scan(jq, jl, jnp.asarray(ids),
                    jnp.zeros(ids.shape[:1] + q.shape[1:2], jnp.int32),
                    p=p, scale=scale, interpret=True)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("qcap", [8, 24])
def test_int8_bit_identical_to_jax(p, qcap):
    q, lists, ids = _inputs("int8", qcap=qcap, seed=p)
    scale = float(np.float32(3e-5) * np.float32(3e-5))
    jv, ji = _jax(q, lists, ids, p, np.float32(scale))
    tv, ti = ivf_list_scan(torch.as_tensor(q), torch.as_tensor(lists),
                           torch.as_tensor(ids), p=p, scale=scale)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)
    # the dead sub-block yields only (-inf, -1)
    nsub = lists.shape[1] // 128
    assert np.all(ti.numpy()[1, :, 1::nsub] == -1)


@pytest.mark.parametrize("p", [1, 3])
def test_f32_matches_jax(p):
    q, lists, ids = _inputs("f32", seed=10 + p)
    jv, ji = _jax(q, lists, ids, p, 1.0)
    tv, ti = ivf_list_scan(torch.as_tensor(q), torch.as_tensor(lists),
                           torch.as_tensor(ids), p=p)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), ji)


def test_bf16_matches_jax():
    q, lists, ids = _inputs("f32", seed=21)
    jv, ji = _jax(q, lists, ids, 3, 1.0, dtype=jnp.bfloat16)
    tq = torch.as_tensor(q).to(torch.bfloat16)
    tl = torch.as_tensor(lists).to(torch.bfloat16)
    tv, ti = ivf_list_scan(tq, tl, torch.as_tensor(ids), p=3)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), ji)


def test_ties_first_row_wins():
    # duplicated rows inside each sub-block: the lowest row must win and
    # the next pass must take the duplicate
    q, lists, ids = _inputs("int8", dead=0.0, seed=3)
    lists[:, 1::2] = lists[:, 0::2]
    jv, ji = _jax(q, lists, ids, 2, np.float32(1.0))
    tv, ti = ivf_list_scan(torch.as_tensor(q), torch.as_tensor(lists),
                           torch.as_tensor(ids), p=2)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tv.numpy(), jv)
    nsub = lists.shape[1] // 128
    live = ti.numpy()[[0, 2, 3, 4]]     # list 1 has a dead sub-block
    first, second = live[..., :nsub], live[..., nsub:]
    assert np.all(first % 2 == 0) and np.all(second == first + 1)


def test_cap_len_not_multiple_of_128_raises():
    q, lists, ids = _inputs("int8", cap_len=200)
    with pytest.raises(ValueError, match="multiple of 128"):
        ivf_list_scan(torch.as_tensor(q), torch.as_tensor(lists),
                      torch.as_tensor(ids))
    with pytest.raises(ValueError, match="multiple of 128"):
        _jax(q, lists, ids, 2, 1.0)


def test_cap_block_has_no_effect():
    q, lists, ids = _inputs("int8", seed=5)
    args = (torch.as_tensor(q), torch.as_tensor(lists), torch.as_tensor(ids))
    a = ivf_list_scan(*args, p=2, cap_block=128)
    b = ivf_list_scan(*args, p=2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_dead_dispatch_tail_yields_neg_inf():
    q, lists, ids = _inputs("int8", qcap=24, seed=7)
    disp = np.full((5, 24), -1, np.int32)
    disp[0, :24] = 1        # full
    disp[1, :3] = 2         # 3 live slots
    disp[2, [0, 9]] = 0     # a hole: slots up to 9 are computed
    # lists 3 and 4: no live slot at all
    args = [torch.as_tensor(a) for a in (q, lists, ids)]
    full_v, full_i = ivf_list_scan(*args, p=3)
    v, i = ivf_list_scan(*args, torch.as_tensor(disp), p=3)
    for l, n in enumerate([24, 3, 10, 0, 0]):
        assert torch.equal(v[l, :n], full_v[l, :n])
        assert torch.equal(i[l, :n], full_i[l, :n])
        assert torch.all(torch.isneginf(v[l, n:])) and torch.all(
            i[l, n:] == -1)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    real = ivf_scan.ivf_list_scan_reference

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    def no_build(name):
        raise AssertionError("the CPU path must not build a kernel")

    monkeypatch.setattr(ivf_scan, "ivf_list_scan_reference", spy)
    monkeypatch.setattr(cuda_lib, "load", no_build)
    before = ivf_scan.LAUNCHES.count
    q, lists, ids = _inputs("int8")
    ivf_list_scan(torch.as_tensor(q), torch.as_tensor(lists),
                  torch.as_tensor(ids), p=2)
    assert calls == [1]
    assert ivf_scan.LAUNCHES.count == before
