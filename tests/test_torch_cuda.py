"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports no JAX, so it also runs where only PyTorch is
installed (``tests/conftest.py`` imports JAX; skip it there)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: int8 list scans are bit-identical to the plain PyTorch
version; f32/bf16 sums run in another order, so values agree within 1e-5
(unit-norm rows, d=256) and the selected rows must be the same.
"""

import numpy as np
import pytest
import torch

from rag_foundation_tpu_torch.ops import cuda_lib, ivf_scan
from rag_foundation_tpu_torch.ops.ivf_scan import (ivf_list_scan,
                                                   ivf_list_scan_reference)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(kind, nlist=5, qcap=20, d=256, cap_len=640, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "int8":
        q = rng.integers(-127, 128, (nlist, qcap, d)).astype(np.int8)
        lists = rng.integers(-127, 128, (nlist, cap_len, d)).astype(np.int8)
    else:
        q = rng.standard_normal((nlist, qcap, d)).astype(np.float32)
        lists = rng.standard_normal((nlist, cap_len, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        lists /= np.linalg.norm(lists, axis=-1, keepdims=True)
    ids = np.arange(nlist * cap_len, dtype=np.int32).reshape(nlist, cap_len)
    ids[rng.random(ids.shape) < 0.3] = -1
    ids[1, 128:256] = -1
    return q, lists, ids


@pytest.mark.cuda
def test_cuda_without_kernel_raises(card, monkeypatch):
    def missing(name):
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(cuda_lib, "load", missing)
    args = [torch.as_tensor(x, device=card) for x in _inputs("int8")]
    with pytest.raises(RuntimeError, match="unavailable"):
        ivf_list_scan(*args, p=2)
    with pytest.raises(ValueError, match="dtype"):
        ivf_list_scan(args[0].half(), args[1].half(), args[2], p=2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "f32", "bf16"])
def test_kernel_matches_plain_version_on_card(card, kind):
    q, lists, ids = _inputs("int8" if kind == "int8" else "f32")
    tq, tl = torch.as_tensor(q, device=card), torch.as_tensor(lists,
                                                                device=card)
    if kind == "bf16":
        tq, tl = tq.bfloat16(), tl.bfloat16()
    tids = torch.as_tensor(ids, device=card)
    disp = torch.full((5, 20), -1, dtype=torch.int32, device=card)
    disp[0, :] = 0          # all 20 slots (two query tiles)
    disp[1, :7] = 1
    disp[2, [0, 12]] = 2    # a hole: slots up to 12 are computed
    # lists 3 and 4: no query
    for dispatch in (None, disp):
        before = ivf_scan.LAUNCHES.count
        kv, ki = ivf_list_scan(tq, tl, tids, dispatch, p=3, scale=1e-4)
        torch.cuda.synchronize()
        assert ivf_scan.LAUNCHES.count == before + 1
        rv, ri = ivf_list_scan_reference(tq, tl, tids, dispatch, p=3,
                                         scale=1e-4)
        if kind == "int8":
            assert torch.equal(kv, rv) and torch.equal(ki, ri)
        else:
            torch.testing.assert_close(kv, rv, rtol=1e-5, atol=1e-5)
            assert torch.equal(ki, ri)
