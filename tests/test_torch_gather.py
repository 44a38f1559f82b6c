"""Port gather-and-rescore (rag_foundation_tpu_torch/ops/gather.py) against
the JAX package's ``gather_rescore_int8(..., impl="xla")``, the arithmetic
its engine runs. int8 dots summed in int32 are exact: bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.ops.pallas_gather import \
    gather_rescore_int8 as jax_gather
from rag_foundation_tpu_torch.ops import cuda_lib, gather
from rag_foundation_tpu_torch.ops.gather import (
    gather_rescore_int8, gather_rescore_int8_reference)


def _inputs(n=203, d=64, q=9, c=17, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.integers(-127, 128, (n, d)).astype(np.int8)
    rows = rng.integers(0, n, (q, c)).astype(np.int32)
    qq = rng.integers(-127, 128, (q, d)).astype(np.int8)
    return table, rows, qq


@pytest.mark.parametrize("n,d", [(203, 64), (64, 128), (1, 20)])
def test_bit_equal_to_jax(n, d):
    table, rows, qq = _inputs(n=n, d=d, seed=n)
    rows[0, :3] = [-1, -7, n - 1]          # negative ids clip to row 0
    ours = gather_rescore_int8(torch.as_tensor(table), torch.as_tensor(rows),
                               torch.as_tensor(qq))
    ref = jax_gather(jnp.asarray(table), jnp.asarray(rows), jnp.asarray(qq),
                     impl="xla")
    assert ours.dtype == torch.float32 and tuple(ours.shape) == rows.shape
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    want = (table[np.clip(rows, 0, n - 1)].astype(np.int64)
            * qq[:, None, :].astype(np.int64)).sum(-1)
    np.testing.assert_array_equal(ours.numpy(), want.astype(np.float32))
    assert ours[0, 0] == ours[0, 1] == float(
        table[0].astype(np.int64) @ qq[0].astype(np.int64))


def test_extreme_values_do_not_overflow():
    table = np.full((8, 1024), -127, np.int8)
    qq = np.full((2, 1024), 127, np.int8)
    rows = np.zeros((2, 4), np.int32)
    out = gather_rescore_int8(torch.as_tensor(table), torch.as_tensor(rows),
                              torch.as_tensor(qq))
    assert torch.all(out == -127.0 * 127.0 * 1024)


def test_query_blocking_of_the_plain_version(monkeypatch):
    table, rows, qq = _inputs(seed=3)
    args = [torch.as_tensor(x) for x in (table, rows, qq)]
    whole = gather_rescore_int8_reference(*args)
    monkeypatch.setattr(gather, "_REF_ELEMS", 1)     # one query a step
    assert torch.equal(gather_rescore_int8_reference(*args), whole)


def test_bad_inputs_raise():
    table, rows, qq = _inputs()
    t, r, q = (torch.as_tensor(x) for x in (table, rows, qq))
    with pytest.raises(ValueError, match="int8"):
        gather_rescore_int8(t.float(), r, q)
    with pytest.raises(ValueError, match="shape mismatch"):
        gather_rescore_int8(t, r, q[:-1])
    with pytest.raises(ValueError, match="no rows"):
        gather_rescore_int8(t[:0], r, q)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    real = gather.gather_rescore_int8_reference

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    def no_build(name):
        raise AssertionError("the CPU path must not build a kernel")

    monkeypatch.setattr(gather, "gather_rescore_int8_reference", spy)
    monkeypatch.setattr(cuda_lib, "load", no_build)
    before = gather.LAUNCHES.count
    gather_rescore_int8(*[torch.as_tensor(x) for x in _inputs()])
    assert calls == [1]
    assert gather.LAUNCHES.count == before
