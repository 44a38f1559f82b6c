"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports no JAX, so it also runs where only PyTorch is
installed (``tests/conftest.py`` imports JAX; skip it there)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: int8 list scans are bit-identical to the plain PyTorch
version; f32/bf16 sums run in another order, so values agree within 1e-5
(unit-norm rows, d=256) and the selected rows must be the same. The ADC
list scan with an int8 LUT and the int8 gather-and-rescore are exact
integer sums: bit-identical. With a bf16 LUT the f32 sum of m = 24
unit-scale entries runs in another order: 1e-5 relative, and an index
may differ only between rows scoring within that.
"""

import numpy as np
import pytest
import torch

from rag_foundation_tpu_torch.ops import cuda_lib, gather, ivf_scan, pq_scan
from rag_foundation_tpu_torch.ops.gather import (
    gather_rescore_int8, gather_rescore_int8_reference)
from rag_foundation_tpu_torch.ops.ivf_scan import (ivf_list_scan,
                                                   ivf_list_scan_reference)
from rag_foundation_tpu_torch.ops.pq_scan import (pack_codes, pq_list_scan,
                                                  pq_list_scan_reference)


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


def _pq_inputs(card, lut, packed, m, qcap, nlist=5, cap_len=640, seed=0):
    rng = np.random.default_rng(seed)
    if lut == "int8":
        l = torch.as_tensor(rng.integers(-127, 128, (nlist, qcap, 16 * m))
                            .astype(np.int8), device=card)
    else:
        l = torch.as_tensor(rng.standard_normal((nlist, qcap, 16 * m))
                            .astype(np.float32), device=card).bfloat16()
    codes = torch.as_tensor(rng.integers(0, 16, (nlist, cap_len, m))
                            .astype(np.uint8), device=card)
    if packed:
        codes = pack_codes(codes).contiguous()
    ids = np.arange(nlist * cap_len, dtype=np.int32).reshape(nlist, cap_len)
    ids[rng.random(ids.shape) < 0.3] = -1
    ids[1, 128:256] = -1
    return l, codes, torch.as_tensor(ids, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("lut", ["int8", "bf16"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,qcap", [(24, 20), (192, 16), (8, 8), (6, 3),
                                    (320, 9)])
def test_pq_kernel_matches_plain_version_on_card(card, lut, packed, m, qcap):
    l, codes, ids = _pq_inputs(card, lut, packed, m, qcap, seed=m + qcap)
    disp = torch.full((5, qcap), -1, dtype=torch.int32, device=card)
    disp[0, :] = 0
    disp[1, :min(7, qcap)] = 1
    disp[2, [0, qcap - 1]] = 2
    # lists 3 and 4: no query
    for dispatch in (None, disp):
        before = pq_scan.LAUNCHES.count
        kv, ki = pq_list_scan(l, codes, ids, dispatch, p=3)
        torch.cuda.synchronize()
        assert pq_scan.LAUNCHES.count == before + 1
        rv, ri = pq_list_scan_reference(l, codes, ids, dispatch, p=3)
        if lut == "int8":
            assert torch.equal(kv, rv) and torch.equal(ki, ri)
        else:
            fin = torch.isfinite(rv)
            assert torch.equal(torch.isfinite(kv), fin)
            torch.testing.assert_close(kv[fin], rv[fin], rtol=1e-5,
                                       atol=1e-4)
            off = ki != ri
            assert torch.all((kv[off] - rv[off]).abs() <= 1e-4)


@pytest.mark.cuda
def test_pq_kernel_cuda_checks(card, monkeypatch):
    l, codes, ids = _pq_inputs(card, "int8", False, 24, 8)
    with pytest.raises(ValueError, match="int32"):
        pq_list_scan(l, codes, ids.long())
    with pytest.raises(ValueError, match="contiguous"):
        pq_list_scan(l, codes.transpose(0, 1).contiguous().transpose(0, 1),
                     ids)

    def missing(name):
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(cuda_lib, "load", missing)
    with pytest.raises(RuntimeError, match="unavailable"):
        pq_list_scan(l, codes, ids)
    table = torch.zeros((16, 64), dtype=torch.int8, device=card)
    with pytest.raises(RuntimeError, match="unavailable"):
        gather_rescore_int8(table, torch.zeros((2, 3), dtype=torch.int32,
                                               device=card), table[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,q,c", [(1003, 768, 33, 40), (50, 64, 5, 7),
                                     (9, 20, 3, 130), (4096, 1024, 4, 8)])
def test_gather_kernel_matches_plain_version_on_card(card, n, d, q, c):
    rng = np.random.default_rng(n)
    table = torch.as_tensor(rng.integers(-127, 128, (n, d)).astype(np.int8),
                            device=card)
    rows = rng.integers(0, n, (q, c)).astype(np.int32)
    rows[0, :2] = [-1, -9]
    rows = torch.as_tensor(rows, device=card)
    qq = torch.as_tensor(rng.integers(-127, 128, (q, d)).astype(np.int8),
                         device=card)
    before = gather.LAUNCHES.count
    out = gather_rescore_int8(table, rows, qq)
    torch.cuda.synchronize()
    assert gather.LAUNCHES.count == before + 1
    assert torch.equal(out, gather_rescore_int8_reference(table, rows, qq))
