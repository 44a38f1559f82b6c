"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports no JAX, so it also runs where only PyTorch is
installed (``tests/conftest.py`` imports JAX; skip it there)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: int8 list scans are bit-identical to the plain PyTorch
version; f32/bf16 sums run in another order, so values agree within 1e-5
(unit-norm rows, d=256) and the selected rows must be the same; on the
f32 and bf16 routes' shape classes (d up to 768) within
``ivf_scan.F32_TOL`` (5e-5), an index differing only between rows scoring
within that, and tied copies of a row taken lowest first by the f32 route. The ADC
list scan with an int8 LUT and the int8 gather-and-rescore are exact
integer sums: bit-identical. With a bf16 LUT the f32 sum of m = 24
unit-scale entries runs in another order: 1e-5 relative, and an index
may differ only between rows scoring within that. The exact-scan kernels
(``fused_topk``, ``block_topk``) sum each score over d in another order
than the plain version's matmul: unit-norm rows agree within 1e-5, and
an index may differ only between rows scoring within that;
small-integer inputs (every partial sum exact in f32) are bit-identical,
duplicate rows across blocks and splits included. ``flash_attention``:
the plain version computes in f32 and rounds its output to the input
dtype; the bf16 kernel also rounds each softmax weight to bf16 before
the P.V product, so the two differ by at most three bf16 roundings of a
convex combination of v: 3 * 2^-9 * max|v| (``BF16_ATTN_TOL``); in f32
both sum in f32 in another order: 1e-5 * max|v|. The backward kernels
(``flash_attention_bwd_dkv``, ``flash_attention_bwd_dq``) against their
plain versions on the same ``lse`` and ``di``: each output is a sum of
products a.b (p.dO for dV, ds.q for dK, ds.k for dQ); the bf16 kernel
rounds each p and ds to bf16 before its product (2^-9 relative a term)
and its output to bf16 (2^-9), the plain version only its output. ds =
p (dO.v - di) * scale cancels, so its f32 error is relative to
|a| = p (sum|dO||v| + |di|) * scale, not to |ds|: an element differs by
at most 2^-8 * (sum|a||b| + |plain|) (``BWD_TOL``); in f32, exp2 against
exp and sums in another order: 1e-5 of the same. ``FlashAttention`` against autograd
of the plain forward (which keeps o and the weights in f32): the
relative norm error of each gradient within 2^-6 in bf16 (three roundings
of 2^-9 a term, o's included through di) and 1e-5 in f32. The generative
decoder (plain PyTorch products, no kernel of its own) on the card
against its CPU path: bf16 logits against f32 within 2^-3
(``chip_smoke.DECODER_LOGIT_TOL``'s reason), f32 within 1e-4 (f32 sums in
another order), and greedy ids equal wherever the CPU's top-1/top-2
margin exceeds twice the tolerance; its products' gradients
(``_F32Product``) on the card against the CPU path within one bf16
rounding plus 1e-5 of the sums' magnitudes, and ``lm_loss``'s gradients
in bf16 at cosine >= 0.99 against the CPU's f32.
"""

import numpy as np
import pytest
import torch

from rag_foundation_tpu_torch.models import encoder as tenc
from rag_foundation_tpu_torch.models import optim
from rag_foundation_tpu_torch.ops import block_topk as block_topk_mod
from rag_foundation_tpu_torch.ops import flash_attention as fa
from rag_foundation_tpu_torch.ops import cuda_lib
from rag_foundation_tpu_torch.ops import fused_topk as fused_topk_mod
from rag_foundation_tpu_torch.ops import gather, ivf_scan, pq_scan
from rag_foundation_tpu_torch.ops.block_topk import (block_topk,
                                                     block_topk_reference)
from rag_foundation_tpu_torch.ops.fused_topk import (fused_topk,
                                                     fused_topk_reference)
from rag_foundation_tpu_torch.ops.gather import (
    gather_rescore_int8, gather_rescore_int8_reference)
from rag_foundation_tpu_torch.ops.ivf_scan import (ivf_list_scan,
                                                   ivf_list_scan_reference)
from rag_foundation_tpu_torch.ops.pq_scan import (pack_codes, pq_list_scan,
                                                  pq_list_scan_reference)


BF16_ATTN_TOL = 3 * 2 ** -9     # times max|v|, see the module docstring
F32_ATTN_TOL = 1e-5
BWD_TOL = {torch.bfloat16: 2 ** -8, torch.float32: 1e-5}
APPLY_TOL = {torch.bfloat16: 2 ** -6, torch.float32: 1e-5}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
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


# -- edge cases of the redesigned list scans: live slots 0, 1, 8, 9, 16 and
# 17 of qcap 32 (one list each), sub-blocks of 0, 1 and 128 live rows
# beside a 30%-dead one, p from 1 to 8

EDGE_LIVE = (0, 1, 8, 9, 16, 17)
# lists of 29 sub-blocks at nlist 4: the ADC scan gives each list several
# blocks (the walk of a list split between blocks)
SPLIT_LIVE = (0, 8, 9, 17)


def _edge_rows(card, cap_len=512, seed=0, live=EDGE_LIVE):
    rng = np.random.default_rng(seed)
    nlist = len(live)
    ids = np.arange(nlist * cap_len, dtype=np.int32).reshape(nlist, cap_len)
    ids[:, :128] = -1                       # a sub-block of no live row
    one = ids[np.arange(nlist), 128 + 37 + np.arange(nlist)].copy()
    ids[:, 128:256] = -1                    # ... of one live row
    ids[np.arange(nlist), 128 + 37 + np.arange(nlist)] = one
    # 256:384 all live; the rest about 30% dead
    tail = ids[:, 384:]
    tail[rng.random(tail.shape) < 0.3] = -1
    disp = np.full((nlist, 32), -1, np.int32)
    for l, n in enumerate(live):
        disp[l, :n] = l
    return (torch.as_tensor(ids, device=card),
            torch.as_tensor(disp, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,d", [("int8", 768), ("int8", 48),
                                    ("f32", 96), ("bf16", 256),
                                    ("f32", 768), ("f32", 384)])
@pytest.mark.parametrize("p", [1, 2, 5, 8])
def test_flat_kernel_edge_cases_on_card(card, kind, d, p):
    ids, disp = _edge_rows(card, seed=d + p)
    q, lists, _ = _inputs("int8" if kind == "int8" else "f32",
                          nlist=len(EDGE_LIVE), qcap=32, d=d, cap_len=512,
                          seed=p)
    tq, tl = torch.as_tensor(q, device=card), torch.as_tensor(lists,
                                                                device=card)
    if kind == "bf16":
        tq, tl = tq.bfloat16(), tl.bfloat16()
    for dispatch in (disp, None):
        kv, ki = ivf_list_scan(tq, tl, ids, dispatch, p=p, scale=1e-4)
        torch.cuda.synchronize()
        rv, ri = ivf_list_scan_reference(tq, tl, ids, dispatch, p=p,
                                         scale=1e-4)
        if kind == "int8":
            assert torch.equal(kv, rv) and torch.equal(ki, ri)
        else:
            assert torch.equal(torch.isfinite(kv), torch.isfinite(rv))
            torch.testing.assert_close(kv, rv, rtol=1e-5, atol=1e-5)
            assert torch.equal(ki, ri)


@pytest.mark.cuda
@pytest.mark.parametrize("lut,packed", [("int8", False), ("int8", True),
                                        ("bf16", False)])
@pytest.mark.parametrize("p", [1, 2, 5, 8])
def test_pq_kernel_edge_cases_on_card(card, lut, packed, p):
    m = 192
    ids, disp = _edge_rows(card, seed=m + p)
    l, codes, _ = _pq_inputs(card, lut, packed, m, 32,
                             nlist=len(EDGE_LIVE), cap_len=512, seed=p)
    for dispatch in (disp, None):
        kv, ki = pq_list_scan(l, codes, ids, dispatch, p=p)
        torch.cuda.synchronize()
        rv, ri = pq_list_scan_reference(l, codes, ids, dispatch, p=p)
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
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("p", [1, 3, 8])
def test_pq_kernel_split_lists_on_card(card, packed, p):
    """nlist 4, cap_len 3712: several blocks a list, each staging the LUT
    tile, walking its share of the sub-blocks and filling its share of the
    dispatch's dead tail."""
    m, cap_len = 192, 3712
    ids, disp = _edge_rows(card, cap_len=cap_len, seed=p, live=SPLIT_LIVE)
    l, codes, _ = _pq_inputs(card, "int8", packed, m, 32,
                             nlist=len(SPLIT_LIVE), cap_len=cap_len, seed=p)
    for dispatch in (disp, None):
        kv, ki = pq_list_scan(l, codes, ids, dispatch, p=p)
        torch.cuda.synchronize()
        rv, ri = pq_list_scan_reference(l, codes, ids, dispatch, p=p)
        assert torch.equal(kv, rv) and torch.equal(ki, ri)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,p", [("int8", 40), ("f32", 33)])
def test_flat_scan_per_subblock_route_on_card(card, kind, p):
    """p > 32 leaves the redesigned int8 and f32 flat scans for the
    per-sub-block kernel: the same outputs (f32 within F32_TOL, an index
    differing only at a near-tie)."""
    ids, disp = _edge_rows(card, seed=7)
    q, lists, _ = _inputs(kind, nlist=len(EDGE_LIVE), qcap=32, d=256,
                          cap_len=512, seed=7)
    args = (torch.as_tensor(q, device=card),
            torch.as_tensor(lists, device=card), ids, disp)
    assert ivf_scan.scan_route(args[0].dtype, 32, 256, p) == "scalar"
    kv, ki = ivf_list_scan(*args, p=p, scale=1e-4)
    rv, ri = ivf_list_scan_reference(*args, p=p, scale=1e-4)
    if kind == "int8":
        assert torch.equal(kv, rv) and torch.equal(ki, ri)
    else:
        fin = torch.isfinite(rv)
        assert torch.equal(torch.isfinite(kv), fin)
        assert float((kv[fin] - rv[fin]).abs().max()) <= ivf_scan.F32_TOL
        _near_tie_ids(kv, ki, rv, ri, args[0], args[1])


# live slots of the bf16 flat route's lists (capped at qcap): none, one,
# a full pass of 16, one past it, one past 32, a full pass of 64
BF16_LIVE = (0, 1, 16, 17, 33, 64)


def _bf16_lists(card, cap_len, qcap, d, seed):
    """Lists laid out as ``engine/ivf.py`` interleaves them (the live rows
    of a list are the first ceil(m / nsub) of each sub-block) with m from
    none to every row, so that sub-blocks of no live row, and of live
    extents of at most 32, 64 and 128 rows all occur; one list also has a
    sub-block of dead rows among live ones. The dispatch of list l has its
    first ``BF16_LIVE[l % 6]`` slots (capped at qcap) live."""
    rng = np.random.default_rng(seed)
    nsub = cap_len // 128
    members = (0, 5, 30 * nsub, 40 * nsub, 70 * nsub, cap_len, 130, 9)
    nlist = len(members)
    slot = np.arange(cap_len)
    rank = (slot % 128) * nsub + slot // 128
    ids = np.arange(nlist * cap_len, dtype=np.int32).reshape(nlist, cap_len)
    ids[rank[None, :] >= np.asarray(members)[:, None]] = -1
    ids[5, 128:256] = -1                     # a dead sub-block among live
    q = rng.standard_normal((nlist, qcap, d)).astype(np.float32)
    lists = rng.standard_normal((nlist, cap_len, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    lists /= np.linalg.norm(lists, axis=-1, keepdims=True)
    disp = np.full((nlist, qcap), -1, np.int32)
    for l in range(nlist):
        disp[l, :min(qcap, BF16_LIVE[l % len(BF16_LIVE)])] = l
    return [torch.as_tensor(x, device=card) for x in (q, lists, ids, disp)]


def _near_tie_ids(kv, ki, rv, ri, q, lists, tol=ivf_scan.F32_TOL):
    """Indices may differ only between rows scoring within ``tol``."""
    cap_len = lists.shape[1]
    for l, s, j in (ki != ri).nonzero().tolist():
        a, b = int(ki[l, s, j]), int(ri[l, s, j])
        qa = q[l, s].float()
        sa = float(qa @ lists[a // cap_len, a % cap_len].float())
        sb = float(qa @ lists[b // cap_len, b % cap_len].float())
        assert abs(sa - sb) <= tol, ((l, s, j), a, sa, b, sb)


@pytest.mark.cuda
@pytest.mark.parametrize("cap_len", [512, 768, 1024])
@pytest.mark.parametrize("qcap", [8, 16, 32, 64])
@pytest.mark.parametrize("p", [1, 3, 4])
def test_bf16_flat_route_on_card(card, cap_len, qcap, p):
    """The bf16 tensor-core route against its plain version across config
    3's shape class: d 768, cap_len 512-1,024, qcap 8-64 (its 16- and
    32-slot passes, two of 32 at qcap 64), 0, 1, 16, 17, 33 and 64 live
    slots, lists of no live row, sub-blocks of no live row and of every
    fold; p 1, config 3's 3 and the 4 phase 27 also sweeps."""
    q, lists, ids, disp = _bf16_lists(card, cap_len, qcap, 768,
                                      seed=cap_len + qcap + p)
    q, lists = q.bfloat16(), lists.bfloat16()
    assert ivf_scan.scan_route(torch.bfloat16, qcap, 768, p).startswith(
        "bf16")
    for dispatch in (disp, None):
        before = ivf_scan.LAUNCHES.count
        kv, ki = ivf_list_scan(q, lists, ids, dispatch, p=p)
        torch.cuda.synchronize()
        assert ivf_scan.LAUNCHES.count == before + 1
        rv, ri = ivf_list_scan_reference(q, lists, ids, dispatch, p=p)
        assert torch.equal(torch.isfinite(kv), torch.isfinite(rv))
        fin = torch.isfinite(rv)
        assert float((kv[fin] - rv[fin]).abs().max()) <= ivf_scan.F32_TOL
        _near_tie_ids(kv, ki, rv, ri, q, lists)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [200, 64, 8])
def test_bf16_flat_route_k_padding_on_card(card, d):
    """Rows whose bytes are not a whole number of 32-byte k-steps or of
    128-byte chunks: the K tail is zero-filled."""
    q, lists, ids, disp = _bf16_lists(card, 640, 24, d, seed=d)
    q, lists = q.bfloat16(), lists.bfloat16()
    kv, ki = ivf_list_scan(q, lists, ids, disp, p=3)
    torch.cuda.synchronize()
    rv, ri = ivf_list_scan_reference(q, lists, ids, disp, p=3)
    assert torch.equal(torch.isfinite(kv), torch.isfinite(rv))
    fin = torch.isfinite(rv)
    assert float((kv[fin] - rv[fin]).abs().max()) <= ivf_scan.F32_TOL
    _near_tie_ids(kv, ki, rv, ri, q, lists)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,qcap,d,p,want", [
    (torch.bfloat16, 8, 768, 3, "bf16_qt16"),
    (torch.bfloat16, 16, 768, 3, "bf16_qt16"),
    (torch.bfloat16, 32, 768, 3, "bf16_qt32"),
    (torch.bfloat16, 64, 768, 4, "bf16_qt32"),
    (torch.bfloat16, 128, 768, 3, "bf16_qt32"),
    (torch.bfloat16, 64, 4096, 3, "bf16_qt16"),
    (torch.bfloat16, 16, 768, 33, "scalar"),
    (torch.float32, 16, 768, 3, "f32"),
    (torch.int8, 16, 768, 3, "s8"),
    (torch.int8, 16, 768, 40, "scalar"),
    (torch.float32, 8, 768, 3, "f32"),
    (torch.float32, 32, 768, 3, "f32"),
    (torch.float32, 64, 768, 4, "f32"),
    (torch.float32, 8, 384, 10, "f32"),
    (torch.float32, 64, 384, 32, "f32"),
    (torch.float32, 128, 4096, 3, "f32"),
    (torch.float32, 16, 768, 33, "scalar"),
    (torch.float32, 8, 384, 33, "scalar"),
])
def test_flat_scan_route_on_card(card, dtype, qcap, d, p, want):
    """The C entry's choice (``ivf_list_scan_route``): config 3's qcap
    8-64 at d 768 take the bf16 tensor-core route, 16 or 32 slots a
    pass, or as f32 lists the f32 route (any qcap and width, the MiniLM
    store's d 384 included) while p <= 32."""
    assert ivf_scan.scan_route(dtype, qcap, d, p) == want


def _poisson_dispatch(card, nlist, qcap, seed):
    """Live slots a list Poisson(qcap / 2) capped at qcap (config 3's
    dispatches: nprobe 32 gives Poisson(8) at qcap 16, nprobe 128
    Poisson(32) at qcap 64), with a hole: slot 1 dead where 3 are live."""
    rng = np.random.default_rng(seed)
    n = np.minimum(rng.poisson(qcap / 2, nlist), qcap)
    disp = np.where(np.arange(qcap)[None, :] < n[:, None],
                    np.arange(nlist)[:, None], -1).astype(np.int32)
    disp[n >= 3, 1] = -1
    return torch.as_tensor(disp, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("cap_len,qcap,d,p", [
    *((c, qc, 768, p) for c in (512, 768, 1024) for qc in (8, 16, 32, 64)
      for p in (1, 3, 4)),
    (256, 8, 384, 10),   # the MiniLM store's dispatch (phases 13, 16)
    (384, 24, 96, 3),    # d not a multiple of 32: a part K chunk
    (640, 128, 200, 2),  # two passes of 64 slots; 800-byte rows
])
def test_f32_and_bf16_flat_routes_side_by_side_on_card(card, cap_len, qcap,
                                                       d, p):
    """The same lists as f32 (the f32 route) and as bf16 (the tensor-core
    route) across config 3's shape class, the MiniLM store's dispatch and
    part K chunks: lists of no live row, sub-blocks of no live row and of
    every fold, dead dispatch tails and a Poisson dispatch with holes,
    duplicated rows tied at the top of each list's slot 0. Each against
    its plain version within F32_TOL (an index differing only at a
    near-tie; the tied copies in K order alike, the lower first), and the
    two agree but for bf16's rounding of the rows and queries."""
    q, lists, ids, disp = _bf16_lists(card, cap_len, qcap, d,
                                      seed=cap_len + qcap + d + p)
    lists[:, 1::128] = lists[:, 0::128]      # ties in every sub-block
    q[:, 0] = lists[:, 0]
    assert ivf_scan.scan_route(torch.float32, qcap, d, p) == "f32"
    assert ivf_scan.scan_route(torch.bfloat16, qcap, d, p).startswith("bf16")
    for dispatch in (disp, _poisson_dispatch(card, len(ids), qcap, p)):
        out = {}
        for dt in (torch.float32, torch.bfloat16):
            qt, lt = q.to(dt), lists.to(dt)
            before = ivf_scan.LAUNCHES.count
            kv, ki = ivf_list_scan(qt, lt, ids, dispatch, p=p)
            torch.cuda.synchronize()
            assert ivf_scan.LAUNCHES.count == before + 1
            rv, ri = ivf_list_scan_reference(qt, lt, ids, dispatch, p=p)
            fin = torch.isfinite(rv)
            assert torch.equal(torch.isfinite(kv), fin)
            assert float((kv[fin] - rv[fin]).abs().max()) <= ivf_scan.F32_TOL
            _near_tie_ids(kv, ki, rv, ri, qt, lt)
            if dt == torch.float32 and p > 1:
                # the tie: row 0 then its copy, one value
                live = (ids[:, 1] >= 0) & (ivf_scan.live_slots(dispatch) > 0)
                nsub = cap_len // 128
                base = torch.arange(len(ids), device=card) * cap_len
                assert torch.equal(ki[live, 0, 0], base[live].int())
                assert torch.equal(ki[live, 0, nsub], base[live].int() + 1)
                assert torch.equal(kv[live, 0, 0], kv[live, 0, nsub])
            out[dt] = kv
        fin = torch.isfinite(out[torch.float32])
        assert torch.equal(fin, torch.isfinite(out[torch.bfloat16]))
        # unit rows rounded to bf16 (2^-9 relative an element) move a dot
        # by at most about 2 * 2^-9
        assert float((out[torch.float32][fin]
                      - out[torch.bfloat16][fin]).abs().max()) <= 2 ** -7


# live slots of the ADC scan's route lists: none; one to eight, which
# packed m = 256 lists take by the pair route (a pass for every two) and
# unpacked ones by the lookup; the one-hot product's 9 and 16; 17, a
# lookup pass after it (capped at qcap)
ROUTE_LIVE = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17)


def _route_lists(card, lut, packed, m, qcap, seed):
    """The 100M tier's shape class (chip_smoke.py phase 26): lists of 35
    sub-blocks (cap_len 4480), one list for each entry of ROUTE_LIVE
    (capped at qcap), about 9% dead rows, a sub-block of one live row, a
    dead sub-block and one of duplicated rows (ties for every LUT). int8
    LUTs reach their extremes: slot 0 all -127, slot 1 all +127."""
    cap_len = 4480
    live = sorted({min(n, qcap) for n in ROUTE_LIVE})
    nlist = len(live)
    rng = np.random.default_rng(seed)
    if lut == "int8":
        l = rng.integers(-127, 128, (nlist, qcap, 16 * m)).astype(np.int8)
        l[:, 0] = -127
        l[:, 1] = 127
        l = torch.as_tensor(l, device=card)
    else:
        l = torch.as_tensor(rng.standard_normal((nlist, qcap, 16 * m))
                            .astype(np.float32), device=card).bfloat16()
    codes = rng.integers(0, 16, (nlist, cap_len, m)).astype(np.uint8)
    codes[:, 384:512:2] = codes[:, 385:512:2]
    codes = torch.as_tensor(codes, device=card)
    if packed:
        codes = pack_codes(codes).contiguous()
    ids = np.arange(nlist * cap_len, dtype=np.int32).reshape(nlist, cap_len)
    ids[rng.random(ids.shape) < 0.09] = -1
    lone = ids[np.arange(nlist), 37 + np.arange(nlist)].copy()
    ids[:, :128] = -1
    ids[np.arange(nlist), 37 + np.arange(nlist)] = lone
    ids[:, 256:384] = -1
    disp = np.full((nlist, qcap), -1, np.int32)
    for li, n in enumerate(live):
        disp[li, :n] = li
    return (l, codes, torch.as_tensor(ids, device=card),
            torch.as_tensor(disp, device=card), live)


@pytest.mark.cuda
@pytest.mark.parametrize("lut,packed,m,qcap", [
    ("int8", True, 256, 8), ("int8", True, 256, 24), ("int8", False, 256, 8),
    ("int8", False, 256, 24), ("bf16", True, 256, 24),
    ("bf16", False, 256, 8), ("bf16", True, 264, 8), ("int8", True, 264, 8),
    ("int8", False, 24, 8)])
@pytest.mark.parametrize("p", [4, 1])
def test_pq_list_scan_routes_on_card(card, lut, packed, m, qcap, p):
    """Every route of the ADC scan at the 100M tier's shape class: int8
    LUTs at m = 256 take pq_scan_v2 (packed lists of at most eight live
    slots its pair route, unpacked ones the lookup, more slots the one-hot
    product); bf16 LUTs, m = 264 and p > 32 take pq_scan_kernel. Each is
    the plain version, bit for bit with an int8 LUT."""
    l, codes, ids, disp, live = _route_lists(card, lut, packed, m, qcap,
                                             seed=m + qcap + p)
    routes = pq_scan.scan_routes(l.dtype, packed, m, p,
                                 pq_scan.live_slots(disp))
    if lut == "int8" and m <= 256:
        assert routes["pair"] == (sum(1 for n in live
                                      if 1 <= n <= pq_scan.PAIR_MAX)
                                  if packed and m == 256 else 0)
    else:
        assert routes["pq_scan_kernel"] == len(live) - 1
    before = pq_scan.LAUNCHES.count
    kv, ki = pq_list_scan(l, codes, ids, disp, p=p)
    torch.cuda.synchronize()
    assert pq_scan.LAUNCHES.count == before + 1
    rv, ri = pq_list_scan_reference(l, codes, ids, disp, p=p)
    if lut == "int8":
        assert torch.equal(kv, rv) and torch.equal(ki, ri)
        # the extremes: every live row ties, the lowest rows win
        for slot, score in ((0, -127 * m), (1, 127 * m)):
            got = kv[:, slot][ki[:, slot] >= 0]
            assert bool((got == score).all())
    else:
        fin = torch.isfinite(rv)
        assert torch.equal(torch.isfinite(kv), fin)
        torch.testing.assert_close(kv[fin], rv[fin], rtol=1e-5, atol=1e-3)
        off = ki != ri
        assert torch.all((kv[off] - rv[off]).abs() <= 1e-3)
    # p > 32 leaves pq_scan_v2 for pq_scan_kernel: the same outputs
    if lut == "int8" and packed and m == 256 and qcap == 8 and p == 4:
        kv, ki = pq_list_scan(l, codes, ids, disp, p=40)
        rv, ri = pq_list_scan_reference(l, codes, ids, disp, p=40)
        assert torch.equal(kv, rv) and torch.equal(ki, ri)


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


def _unit(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _assert_topk_close(kv, ki, rv, ri, tol=1e-5):
    fin = torch.isfinite(rv)
    assert torch.equal(torch.isfinite(kv), fin)
    assert torch.equal(ki < 0, ri < 0)
    torch.testing.assert_close(kv[fin], rv[fin], rtol=tol, atol=tol)
    off = ki != ri          # only between rows scoring within the tolerance
    assert torch.all((kv[off] - rv[off]).abs() <= tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_n,n,d,k", [(13, 1000, 64, 7), (200, 5000, 768, 10),
                                       (300, 3000, 72, 64), (1, 130, 8, 3)])
def test_exact_scan_kernels_match_plain_versions_on_card(card, dtype, q_n, n,
                                                         d, k):
    rng = np.random.default_rng(n + k)
    c = torch.as_tensor(_unit(rng, n, d), device=card).to(dtype)
    q = torch.as_tensor(_unit(rng, q_n, d), device=card).to(dtype)
    for vc in (None, n - 37, torch.tensor(n // 2, device=card), 3):
        before = fused_topk_mod.LAUNCHES.count
        kv, ki = fused_topk(q, c, k, valid_count=vc)
        torch.cuda.synchronize()
        assert fused_topk_mod.LAUNCHES.count == before + 1
        rv, ri = fused_topk_reference(q, c, k, valid_count=vc)
        _assert_topk_close(kv, ki, rv, ri)
        live = n if vc is None else int(vc)
        assert int(ki.max()) < live
        # the number of splits is no part of the result
        for splits in (1, 3):
            sv, si = fused_topk(q, c, k, valid_count=vc, n_splits=splits)
            assert torch.equal(sv, kv) and torch.equal(si, ki)
        if n < 1000:
            continue
        before = block_topk_mod.LAUNCHES.count
        bv, bi = block_topk(q, c, min(k, 8), p=2, valid_count=vc,
                            block_n=200)
        torch.cuda.synchronize()
        assert block_topk_mod.LAUNCHES.count == before + 1
        rv, ri = block_topk_reference(q, c, min(k, 8), p=2, valid_count=vc,
                                      block_n=200)
        _assert_topk_close(bv, bi, rv, ri)
        # p = k is exact: the fused kernel's answer, to the bit
        ev, ei = block_topk(q, c, k, p=k, valid_count=vc, block_n=256)
        assert torch.equal(ev, kv) and torch.equal(ei, ki)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exact_scan_kernels_tie_rule_bit_identical_on_card(card, dtype):
    rng = np.random.default_rng(5)
    base = rng.integers(-3, 4, (700, 64)).astype(np.float32)
    c = torch.as_tensor(np.concatenate([base, base, base[:300]]),
                        device=card).to(dtype)
    q = torch.as_tensor(base[:50] * 2.0, device=card).to(dtype)
    rv, ri = fused_topk_reference(q, c, 12)
    for splits in (None, 1, 5):
        kv, ki = fused_topk(q, c, 12, n_splits=splits)
        assert torch.equal(kv, rv) and torch.equal(ki, ri)
    bv, bi = block_topk(q, c, 12, p=12, block_n=128)
    assert torch.equal(bv, rv) and torch.equal(bi, ri)
    bv, bi = block_topk(q, c, 12, p=3, block_n=128)
    rv, ri = block_topk_reference(q, c, 12, p=3, block_n=128)
    assert torch.equal(bv, rv) and torch.equal(bi, ri)
    # -0.0 and +0.0 tie: the lower row wins
    z = torch.zeros((300, 16), device=card, dtype=dtype)
    z[::2] = -z[::2]
    _, zi = fused_topk(torch.ones((2, 16), device=card, dtype=dtype), z, 5)
    assert torch.equal(zi.cpu(), torch.arange(5, dtype=torch.int32)
                       .expand(2, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 10, 64])
@pytest.mark.parametrize("q_n,n", [(1, 1), (77, 10_007), (130, 383),
                                   (257, 4_100)])
def test_exact_scan_bf16_route_on_card(card, k, q_n, n):
    """The bf16 scan's route: Q and N off the 128-row tiles, d = 200 (a
    last chunk of 8 of 32), each row two or three times and small-integer
    values (every partial sum exact in f32, so every tie is real), all
    valid or a device valid count below N: bit-identical to the plain
    version, ties to the lowest row, block_topk(p=k) equal to fused_topk,
    and block_topk(p=2) over blocks that end inside a tile equal to its
    plain version."""
    rng = np.random.default_rng(q_n + n + k)
    d = 200
    base = rng.integers(-3, 4, (max(1, n // 2), d)).astype(np.float32)
    rows = np.concatenate([base, base, base])[:n]
    c = torch.as_tensor(rows, device=card).bfloat16()
    q = torch.as_tensor(rng.integers(-3, 4, (q_n, d)).astype(np.float32),
                        device=card).bfloat16()
    for vc in (None, torch.tensor(max(1, n - n // 3), device=card)):
        rv, ri = fused_topk_reference(q, c, k, valid_count=vc)
        kv, ki = fused_topk(q, c, k, valid_count=vc)
        torch.cuda.synchronize()
        assert torch.equal(kv, rv) and torch.equal(ki, ri)
        ev, ei = block_topk(q, c, k, p=k, valid_count=vc, block_n=256)
        assert torch.equal(ev, kv) and torch.equal(ei, ki)
        kw = dict(p=min(k, 2), valid_count=vc, block_n=1000)
        kb = min(k, -(-n // 1000) * min(k, 2))   # at most the candidates
        bv, bi = block_topk(q, c, kb, **kw)
        wv, wi = block_topk_reference(q, c, kb, **kw)
        assert torch.equal(bv, wv) and torch.equal(bi, wi)


@pytest.mark.cuda
def test_exact_scan_kernels_cuda_checks(card, monkeypatch):
    q = torch.zeros((4, 64), device=card)
    c = torch.zeros((3000, 64), device=card)
    for fn in (fused_topk, block_topk):
        with pytest.raises(ValueError, match="dtype"):
            fn(q.half(), c.half(), 3)
        with pytest.raises(ValueError, match="contiguous"):
            fn(q, torch.zeros((64, 3000), device=card).T, 3)
        with pytest.raises(ValueError, match="16-byte"):
            fn(q[:, :6].contiguous(), c[:, :6].contiguous().bfloat16(), 3)
    with pytest.raises(ValueError, match="at most"):
        fused_topk(q, c, 65)

    def missing(name):
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(cuda_lib, "load", missing)
    for fn in (fused_topk, block_topk):
        with pytest.raises(RuntimeError, match="unavailable"):
            fn(q, c, 3)


def _attn_inputs(b, h, s, d, dtype, device, seed=0):
    """q, k, v normal; segments 1 for tokens, 0 for pads: rows of every
    length from full down, one all-pad row, one of a single token."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.standard_normal((b, h, s, d)).astype(
        np.float32), device=device).to(dtype) for _ in range(3))
    lengths = [s, 0, 1] + list(rng.integers(1, s + 1, max(0, b - 3)))
    seg = torch.zeros((b, s), dtype=torch.int32)
    for i, n in enumerate(lengths[:b]):
        seg[i, :n] = 1
    return q, k, v, seg.to(device)


def _check_attention(out, ref, v):
    tol = (BF16_ATTN_TOL if v.dtype == torch.bfloat16 else F32_ATTN_TOL) \
        * float(v.float().abs().max())
    assert out.dtype == ref.dtype and bool(torch.isfinite(out).all())
    err = float((out.float() - ref.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,s,d", [(4, 3, 16, 32), (5, 2, 32, 32),
                                     (4, 12, 100, 32), (3, 4, 128, 32),
                                     (24, 12, 512, 32), (3, 2, 77, 16),
                                     (3, 2, 200, 64)])
def test_flash_attention_matches_plain_version_on_card(card, dtype, b, h, s,
                                                       d):
    q, k, v, seg = _attn_inputs(b, h, s, d, dtype, card, seed=s + d)
    before = fa.LAUNCHES.count
    out = fa.flash_attention(q, k, v, seg, seg, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.LAUNCHES.count == before + 1
    _check_attention(out, fa.flash_attention_reference(q, k, v, seg, seg,
                                                       d ** -0.5), v)
    # q and kv segments apart: a query of segment 2 sees no key of its own
    # segment but pads of 2 in the kv ids
    seg_kv = torch.where(seg == 0, 2, seg).int()
    seg_q = seg.clone()
    out = fa.flash_attention(q, k, v, seg_q, seg_kv, 1.0)
    ref = fa.flash_attention_reference(q, k, v, seg_q, seg_kv, 1.0)
    live = (seg_q[:, None, :, None] == 1).expand_as(out)
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               rtol=0, atol=float(v.float().abs().max()) * (
                                   BF16_ATTN_TOL if dtype == torch.bfloat16
                                   else F32_ATTN_TOL))


@pytest.mark.cuda
def test_flash_attention_cuda_checks(card, monkeypatch):
    q, k, v, seg = _attn_inputs(2, 2, 64, 48, torch.bfloat16, card)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, v, seg, seg, 1.0)
    q, k, v, seg = _attn_inputs(2, 2, 64, 32, torch.bfloat16, card)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v, seg, seg, 1.0)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half(), seg, seg, 1.0)
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention(q, k, v, seg.cpu(), seg, 1.0)

    def missing(name):
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(cuda_lib, "load", missing)
    with pytest.raises(RuntimeError, match="unavailable"):
        fa.flash_attention(q, k, v, seg, seg, 1.0)


FWD_PATTERNS = ("pads", "one_segment", "packed", "random")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 16, 32, 33, 64, 100, 128, 512])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("pattern", FWD_PATTERNS)
def test_flash_attention_tiles_on_card(card, s, d, pattern):
    """The bf16 forward's tile shapes (S <= 32: 32-row tiles of 32 keys;
    past that 16-row warps and 64-key tiles; from S = 256 at D = 32 32-row
    warps): rows of every length, an all-pad row and a one-token row
    ("pads"), every tile of one segment ("one_segment", no test a pair),
    packed and random ids; out and lse against the plain version, and the
    instantiation without lse gives the same out."""
    q, k, v, seg = _attn_inputs(5, 3, s, d, torch.bfloat16, card, seed=s + d)
    if pattern == "one_segment":
        sq = skv = torch.ones_like(seg)
    else:
        sq, skv = _bwd_segments(seg, pattern, s + d)
    out, lse = fa.flash_attention_forward(q, k, v, sq, skv, d ** -0.5,
                                          with_lse=True)
    torch.cuda.synchronize()
    ref, rlse = fa.flash_attention_reference(q, k, v, sq, skv, d ** -0.5,
                                             with_lse=True)
    _check_attention(out, ref, v)
    fin = torch.isfinite(rlse)
    assert torch.equal(torch.isfinite(lse), fin)
    torch.testing.assert_close(lse[fin], rlse[fin], rtol=0, atol=1e-4)
    assert torch.equal(fa.flash_attention_forward(q, k, v, sq, skv,
                                                  d ** -0.5), out)


@pytest.mark.cuda
def test_flash_attention_scale_and_alignment_on_card(card):
    q, k, v, seg = _attn_inputs(2, 2, 64, 32, torch.bfloat16, card)
    with pytest.raises(ValueError, match="sm_scale"):
        fa.flash_attention(q, k, v, seg, seg, 0.0)
    # a contiguous view 2 bytes off 16: the ring's 16-byte copies refuse it
    odd = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)[1:] \
        .view(q.shape).copy_(q)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa.flash_attention(odd, k, v, seg, seg, 1.0)


@pytest.mark.cuda
def test_minilm_encoder_on_card_launches_the_kernel(card):
    cfg = tenc.EncoderConfig(vocab_size=512, hidden=64, layers=2, heads=2,
                             ffn=128, max_len=64)
    enc = tenc.MiniLMEncoder(dim=64, cfg=cfg, seed=3, device="cuda")
    texts = ["revenue grew", "penguins live in antarctica", "x",
             "The codename for project Kalomi is ZEBRA42 and its budget is "
             "913 thousand credits in sector 4 of campus north."]
    before = fa.LAUNCHES.count
    out = enc.encode(texts)
    assert fa.LAUNCHES.count == before + cfg.layers
    ids = torch.as_tensor(enc.tokenizer.encode_batch(texts, 64)[:, :32],
                          device=card)
    with torch.inference_mode():
        ref = tenc.encode_tokens(enc.params, ids, cfg,
                                 attention=fa.flash_attention_reference)
    ref = ref.cpu().numpy()
    assert out.shape == (4, 64) and np.isfinite(out).all()
    assert (out * ref).sum(axis=1).min() >= 0.999


BWD_PATTERNS = ("pads", "packed", "random", "kv_differs", "no_key")


def _bwd_segments(seg, pattern, seed):
    """seg_q, seg_kv [B, S] int32 of a segment pattern; ``seg`` is the
    real-then-pad rows of ``_attn_inputs``. "packed": three segments a
    row, packed end to end (ids 1, 2, 3) before the pads; "random": ids 0-4
    drawn a token, in no order; "kv_differs": random ids, and row 0's keys
    drawn apart from its queries; "no_key": random ids, and row 0's keys in
    a segment no query of the row has (every p of the row is 0, lse is
    -inf)."""
    b, s = seg.shape
    rng = np.random.default_rng(seed)
    if pattern == "pads":
        return seg, seg
    if pattern == "packed":
        cuts = np.sort(rng.integers(0, s + 1, (b, 2)), axis=1)
        pos = np.arange(s)[None, :]
        ids = 1 + (pos >= cuts[:, :1]) + (pos >= cuts[:, 1:])
        out = torch.as_tensor(ids.astype(np.int32), device=seg.device)
        return (out * seg).contiguous(), (out * seg).contiguous()
    sq = rng.integers(0, 5, (b, s)).astype(np.int32)
    skv = sq.copy()
    if pattern == "kv_differs":
        skv[0] = rng.integers(0, 5, s)
    elif pattern == "no_key":
        skv[0] = 7
    return (torch.as_tensor(sq, device=seg.device),
            torch.as_tensor(skv, device=seg.device))


def _bwd_case(b, h, s, d, dtype, device, seed, pattern="pads"):
    """Inputs of the backward kernels: the plain forward's lse and di.
    Returns q, k, v, seg_q, seg_kv, lse, do, di."""
    q, k, v, seg = _attn_inputs(b, h, s, d, dtype, device, seed=seed)
    sq, skv = _bwd_segments(seg, pattern, seed)
    g = torch.Generator(device=device).manual_seed(seed)
    do = torch.randn((b, h, s, d), generator=g, device=device).to(dtype)
    out, lse = fa.flash_attention_reference(q, k, v, sq, skv, d ** -0.5,
                                            with_lse=True)
    di = (out.float() * do.float()).sum(dim=-1)
    return q, k, v, sq, skv, lse, do, di


def _bwd_bounds(q, k, v, sq, skv, lse, do, di, scale):
    """sum |a||b| of each output's products, with ds's magnitude before
    its cancellation: (dq, dk, dv)."""
    p, _ = fa.backward_terms_reference(q, k, v, sq, skv, lse, do, di,
                                       scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float().abs(), v.float().abs())
    ds = p * (dp + di.abs()[..., None]) * scale
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float().abs()),
            torch.einsum("bhqk,bhqd->bhkd", ds, q.float().abs()),
            torch.einsum("bhqk,bhqd->bhkd", p, do.float().abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,s,d", [(4, 3, 16, 32), (5, 2, 32, 32),
                                     (4, 12, 100, 32), (3, 4, 128, 32),
                                     (6, 12, 512, 32), (3, 2, 77, 16),
                                     (3, 2, 200, 64), (4, 3, 1, 32),
                                     (4, 3, 8, 16), (4, 3, 33, 32),
                                     (4, 3, 64, 64), (4, 3, 65, 32),
                                     (4, 5, 256, 32), (3, 2, 300, 16),
                                     (2, 3, 320, 64)])
@pytest.mark.parametrize("pattern", BWD_PATTERNS)
def test_flash_attention_bwd_kernels_match_plain_versions_on_card(
        card, dtype, b, h, s, d, pattern):
    q, k, v, sq, skv, lse, do, di = _bwd_case(b, h, s, d, dtype, card,
                                              s + d, pattern)
    scale = d ** -0.5
    n_dkv, n_dq = fa.BWD_DKV_LAUNCHES.count, fa.BWD_DQ_LAUNCHES.count
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, sq, skv, lse, do, di,
                                        scale)
    dq = fa.flash_attention_bwd_dq(q, k, v, sq, skv, lse, do, di, scale)
    torch.cuda.synchronize()
    assert (fa.BWD_DKV_LAUNCHES.count, fa.BWD_DQ_LAUNCHES.count) == \
        (n_dkv + 1, n_dq + 1)
    rk, rv = fa.flash_attention_bwd_dkv_reference(q, k, v, sq, skv, lse, do,
                                                  di, scale)
    rq = fa.flash_attention_bwd_dq_reference(q, k, v, sq, skv, lse, do, di,
                                             scale)
    for got, want, bound in zip((dq, dk, dv), (rq, rk, rv),
                                _bwd_bounds(q, k, v, sq, skv, lse, do, di,
                                            scale)):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        excess = (got.float() - want.float()).abs() \
            - BWD_TOL[dtype] * (bound + want.float().abs())
        assert float(excess.max()) <= 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,s,d", [(4, 12, 100, 32), (6, 12, 512, 32),
                                     (3, 2, 77, 16), (3, 2, 200, 64)])
def test_flash_attention_autograd_on_card(card, dtype, b, h, s, d):
    q, k, v, seg, _, lse, do, _ = _bwd_case(b, h, s, d, dtype, card, s)
    # the forward kernel's lse against the plain one
    _, klse = fa.flash_attention_forward(q, k, v, seg, seg, d ** -0.5,
                                         with_lse=True)
    torch.testing.assert_close(klse, lse, rtol=0, atol=1e-4)
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        t = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fn(*t, seg, seg, d ** -0.5).backward(do)
        grads.append([x.grad.float() for x in t])
    for got, want in zip(*grads):
        assert bool(torch.isfinite(got).all())
        err = float((got - want).norm() / want.norm())
        assert err <= APPLY_TOL[dtype], err


@pytest.mark.cuda
def test_flash_attention_bwd_cuda_checks(card, monkeypatch):
    q, k, v, seg, _, lse, do, di = _bwd_case(2, 2, 64, 32,
                                             torch.bfloat16, card, 0)
    for fn in (fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq):
        with pytest.raises(ValueError, match="one device"):
            fn(q, k, v, seg, seg, lse.cpu(), do, di, 1.0)
        with pytest.raises(ValueError, match="do"):
            fn(q, k, v, seg, seg, lse, do.float(), di, 1.0)
    q48, k48, v48, seg48, _, lse48, do48, di48 = _bwd_case(
        2, 2, 64, 48, torch.bfloat16, card, 0)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bwd_dq(q48, k48, v48, seg48, seg48, lse48, do48,
                                  di48, 1.0)
    # a contiguous view 2 bytes off 16: the ring's 16-byte copies refuse it
    odd = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)[1:] \
        .view(q.shape).copy_(q)
    for fn in (fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq):
        with pytest.raises(RuntimeError, match="CUDA error"):
            fn(odd, k, v, seg, seg, lse, do, di, 1.0)

    def missing(name):
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(cuda_lib, "load", missing)
    with pytest.raises(RuntimeError, match="unavailable"):
        fa.flash_attention_bwd_dkv(q, k, v, seg, seg, lse, do, di, 1.0)


@pytest.mark.cuda
def test_minilm_train_step_on_card_launches_the_kernels(card):
    cfg = tenc.EncoderConfig(vocab_size=512, hidden=64, layers=2, heads=2,
                             ffn=128, max_len=64)
    params = tenc.init_params(torch.Generator(device="cuda").manual_seed(3),
                              cfg)
    step = tenc.make_train_step(cfg, optim.adamw(1e-3), max_grad_norm=1.0,
                                symmetric=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    q_ids = torch.randint(1, 512, (8, 16), generator=g, device="cuda")
    d_ids = torch.randint(1, 512, (8, 64), generator=g, device="cuda")
    d_ids[:, 40:] = 0
    counters = (fa.LAUNCHES, fa.BWD_DKV_LAUNCHES, fa.BWD_DQ_LAUNCHES)
    before = [c.count for c in counters]
    losses = [float(step(params, q_ids, d_ids)) for _ in range(3)]
    assert [c.count - n for c, n in zip(counters, before)] == \
        [3 * 2 * cfg.layers] * 3
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2 ** -3),
                                       ("float32", 1e-4)])
def test_decoder_on_card_matches_the_cpu_path(card, dtype, tol):
    from pathlib import Path

    from rag_foundation_tpu_torch.models import decoder as tdec
    ckpt = str(Path(__file__).resolve().parents[1] / "checkpoints"
               / "decoder_smoke.npz")
    p_cpu, cfg, tok = tdec.load_decoder(ckpt, device="cpu")
    cfg = cfg._replace(dtype=dtype)
    p_cpu = tenc._map(p_cpu, lambda k, t: t if k.endswith(("['g']", "['b']"))
                      else t.to(cfg.tdtype))
    p_card = tenc._map(p_cpu, lambda _, t: t.to(card))
    p32 = tenc._map(p_cpu, lambda _, t: t.float())
    c32 = cfg._replace(dtype="float32")
    ids = tok.encode_prompt("how long does maintenance of the optics unit "
                            "take?", ["Maintenance of the optics unit takes "
                                      "12 hours on average."] * 3,
                            cfg.prefix_len)
    padded = torch.zeros((1, cfg.prefix_len), dtype=torch.int64)
    padded[0, :len(ids)] = torch.tensor(ids)
    bias = torch.zeros(cfg.vocab_size)
    bias[tdec.EOS_ID] = -1e9              # the answer runs all 32 steps
    with torch.inference_mode():
        cache, logits = tdec.prefill(p_card, padded.to(card),
                                     torch.tensor([len(ids)], device=card),
                                     cfg)
        first = torch.argmax(logits + bias.to(card), -1)
        blk, _, pos = tdec.decode_block(p_card, cache, first, len(ids),
                                        cfg=cfg, k_steps=32,
                                        bias=bias.to(card))
        out = [int(first[0])] + blk[0].tolist()
        want = tdec.forward(p32, torch.tensor([ids + out[:-1]]), c32)[
            0, len(ids) - 1:]
    assert pos == len(ids) + 32
    assert float((logits[0].cpu() - want[0]).abs().max()) <= tol
    checked = 0
    for j, got in enumerate(out):
        row = want[j] + bias
        top2 = torch.topk(row, 2).values
        if float(top2[0] - top2[1]) > 2 * tol:
            checked += 1
            assert int(torch.argmax(row)) == got, j
    assert checked >= len(out) // 2
    gen = tdec.TextGenerator(ckpt, block=8, device=card)
    gen.prewarm()
    text = "".join(gen.stream("how fast?", ["it is fast"]))
    assert text == "".join(gen.stream("how fast?", ["it is fast"]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ["dot", "dot+bias", "bmm"])
def test_decoder_products_differentiate_on_card_as_on_the_cpu(card, dtype,
                                                              shape):
    """``_F32Product`` (``_dot``/``_bmm``): the card's forward (one cuBLAS
    call with an f32 output) and backward against the CPU path on the
    same operands and cotangent. Both sum exact products in f32 in
    another order: the forward within 1e-5 of sum|a||b|; each operand's
    gradient is an f32 product rounded once to the operand's dtype, so in
    bf16 a sum in another order can land one ulp (2^-8 relative) away:
    within 2^-8 |plain| + 1e-5 of its sum of magnitudes."""
    from rag_foundation_tpu_torch.models import decoder as tdec
    g = torch.Generator().manual_seed(7)

    def make(*size):
        return torch.randn(*size, generator=g).to(dtype)

    if shape == "bmm":
        a, b, bias, gy = make(6, 33, 40), make(6, 40, 17), None, \
            torch.randn(6, 33, 17, generator=g)
    else:
        a, b, gy = make(65, 96), make(96, 130), torch.randn(65, 130,
                                                            generator=g)
        bias = make(130) if shape == "dot+bias" else None
    outs = {}
    for dev in ("cpu", card):
        ins = [x.detach().to(dev).requires_grad_(True) if x is not None
               else None for x in (a, b, bias)]
        y = tdec._F32Product.apply(*ins)
        y.backward(gy.to(dev))
        assert y.dtype == torch.float32
        outs[str(dev)] = [y.detach().cpu()] + [
            x.grad.cpu() for x in ins if x is not None]
    cpu, gpu = outs["cpu"], outs[str(card)]
    aa, ab = a.float().abs(), b.float().abs()
    ag = gy.abs()
    sums = [aa @ ab, ag @ ab.transpose(-1, -2), aa.transpose(-1, -2) @ ag]
    if bias is not None:
        sums.append(ag.sum(0))
    for i, (got, want, mag) in enumerate(zip(gpu, cpu, sums)):
        assert got.dtype == want.dtype and got.shape == want.shape, i
        rel = 0.0 if i == 0 or dtype == torch.float32 else 2.0 ** -8
        err = (got.float() - want.float()).abs()
        assert bool((err <= rel * want.float().abs() + 1e-5 * mag).all()), i


@pytest.mark.cuda
def test_decoder_train_step_on_card(card):
    """``lm_loss`` on the card in bf16 against the CPU path in f32 on
    ``decoder_smoke.npz``: every leaf's gradient at cosine >= 0.99 (the
    card rounds activations to bf16, 2^-8 relative, through two layers;
    a wrong product or mask turns whole gradients) but the key third of
    ``qkv_b``, whose gradient is 0 in exact arithmetic; then ten steps of
    ``make_train_step`` on one batch lower its loss."""
    from pathlib import Path

    from rag_foundation_tpu_torch.models import decoder as tdec
    ckpt = str(Path(__file__).resolve().parents[1] / "checkpoints"
               / "decoder_smoke.npz")
    p_cpu, cfg, tok = tdec.load_decoder(ckpt, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(5, cfg.vocab_size, (8, cfg.max_len)).astype(np.int32)
    toks[2, 100:] = tdec.PAD_ID
    mask = np.zeros(toks.shape, np.int8)
    mask[:, 60:120] = 1
    mask[2, 100:] = 0
    grads = {}
    for name, dev, params, c in (
            ("card", card, tenc._map(p_cpu, lambda _, t: t.detach().to(card)),
             cfg),
            ("f32", "cpu", tenc._map(p_cpu, lambda _, t: t.detach().float()),
             cfg._replace(dtype="float32"))):
        leaves = tenc._leaves(params)
        for t in leaves.values():
            t.requires_grad_(True)
        loss = tdec.lm_loss(params, torch.from_numpy(toks).to(dev),
                            torch.from_numpy(mask).to(dev), c)
        loss.backward()
        grads[name] = {k: t.grad.double().cpu().ravel()
                       for k, t in leaves.items()}
    h = cfg.hidden
    for key, want in grads["f32"].items():
        got = grads["card"][key]
        if key.endswith("['qkv_b']"):
            got, want = torch.cat([got[:h], got[2 * h:]]), \
                torch.cat([want[:h], want[2 * h:]])
        if float(want.norm()) == 0.0:
            assert float(got.norm()) == 0.0, key
            continue
        cos = float(got @ want / (got.norm() * want.norm()))
        assert cos >= 0.99, (key, cos)
    params = tenc._map(p_cpu, lambda _, t: t.detach().to(card))
    step = tdec.make_train_step(cfg, optim.adamw(1e-3), max_grad_norm=1.0)
    tb, mb = torch.from_numpy(toks).to(card), torch.from_numpy(mask).to(card)
    losses = [float(step(params, tb, mb)) for _ in range(10)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.cuda
def test_sharded_paths_on_card_match_the_cpu(card):
    """Four logical shards on one card (``[card] * 4``) against the same
    mesh on the CPU: int8 IVF-Flat scores are exact int8 dots, so ids and
    values are bit-identical; the int8-LUT ADC sums are exact too, but
    its values add the coarse score, an f32 matmul that cuBLAS sums in
    another order: ids equal, values within 1e-5. Each search launches
    its kernel once a shard, and no call in it waits for the card;
    integer-valued rows give a bit-identical sharded top-k."""
    from rag_foundation_tpu_torch.engine import ivf as tivf
    from rag_foundation_tpu_torch.engine import ivfpq as tpq
    from rag_foundation_tpu_torch.engine.convert import (body_from_state,
                                                         body_to_state)
    from rag_foundation_tpu_torch.parallel import make_mesh, sharded_topk
    from rag_foundation_tpu_torch.parallel import sharded_ivf as sivf
    from rag_foundation_tpu_torch.parallel.mesh import shard_rows
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6000, 128)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = torch.as_tensor(x[:64] + 0.01)
    g = torch.Generator().manual_seed(0)
    flat = tivf.build_ivf_flat(torch.as_tensor(x), 32, generator=g,
                               int8=True)
    pq = tpq.build_ivf_pq(torch.as_tensor(x), 32, 16, generator=g,
                          refine=False)
    cpu4 = make_mesh(4, devices=["cpu"] * 4)
    card4 = make_mesh(4, devices=[card] * 4)
    for body, shard, search, counter in (
            (flat, sivf.shard_ivf_index, sivf.sharded_ivf_search,
             ivf_scan.LAUNCHES),
            (pq, sivf.shard_ivfpq_index, sivf.sharded_ivfpq_search,
             pq_scan.LAUNCHES)):
        kind = "IVFPQIndex" if body is pq else "IVFFlatIndex"
        on_card = body_from_state({"kind": kind, **body_to_state(body)},
                                  card)
        want = search(shard(body, cpu4), q, 10, mesh=cpu4, nprobe_local=4,
                      p=4)
        sbody, q_card = shard(on_card, card4), q.to(card)
        search(sbody, q_card, 10, mesh=card4, nprobe_local=4, p=4)  # builds
        n0 = counter.count
        # the per-shard loop never waits for the card (shards on several
        # cards would otherwise run in turn)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = search(sbody, q_card, 10, mesh=card4, nprobe_local=4, p=4)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert counter.count == n0 + 4
        assert torch.equal(got[1].cpu(), want[1])
        if body is pq:
            torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5,
                                       atol=1e-6)
        else:
            assert torch.equal(got[0].cpu(), want[0])
    xi = torch.as_tensor(rng.integers(-3, 4, (4096, 32)).astype(np.float32))
    want = sharded_topk(xi[:8], shard_rows(cpu4, xi), 10, mesh=cpu4)
    got = sharded_topk(xi[:8].to(card), shard_rows(card4, xi.to(card)), 10,
                       mesh=card4)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_mesh_pq_store_on_card_matches_the_cpu(card):
    """A mesh ``ivf_pq`` store with the host re-rank (``StoreIndex`` as the
    engine serves it: bf16 query transport, the ADC top-C over four
    logical shards of the card, the host archive's rescore) against the
    same saved body on a CPU mesh. The coarse matmul sums in another order
    on the card, so one ulp can move a candidate at the ADC cut: the same
    top hit, the same row on 0.95 of the positions, and f32 rescored
    values within 1e-5 where the rows agree. Four launches a search."""
    from rag_foundation_tpu_torch.engine.index import StoreIndex
    from rag_foundation_tpu_torch.parallel import make_mesh
    from rag_foundation_tpu_torch.parallel.sharded_ivf import ShardedBody
    rng = np.random.default_rng(9)
    c = rng.standard_normal((32, 64)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = c[rng.integers(0, 32, 4096)] + 0.25 * rng.standard_normal(
        (4096, 64)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    kw = dict(mode="ivf_pq", nlist=32, nprobe=32, build_threshold=4000,
              pq_m=16, pq_packed=True, pq_refine="host")
    cpu = StoreIndex(64, mesh=make_mesh(4, devices=["cpu"] * 4),
                     device="cpu", **kw)
    cpu.add(x, np.arange(4096))
    on_card = StoreIndex(64, mesh=make_mesh(4, devices=[card] * 4),
                         device=card, **kw)
    on_card.restore_body(cpu.body_state())
    assert isinstance(on_card.body, ShardedBody)
    assert on_card.body.shards[0].codes.device.type == "cuda"
    q = x[100:132]
    want_v, want_i = cpu.search(q, 5)
    on_card.search(q, 5)                                  # builds
    n0 = pq_scan.LAUNCHES.count
    got_v, got_i = on_card.search(q, 5)
    assert pq_scan.LAUNCHES.count == n0 + 4
    np.testing.assert_array_equal(got_i[:, 0], want_i[:, 0])
    assert list(got_i[:4, 0]) == [100, 101, 102, 103]
    same = got_i == want_i
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_allclose(got_v[same], want_v[same], rtol=1e-5,
                               atol=1e-6)


def _traced_store(card, mode):
    """A 16,384-row store on the card and four Q=1024 batches of its rows
    (Q x nprobe x 8 > nlist: the batched path with its list scan)."""
    from rag_foundation_tpu_torch.engine.index import StoreIndex
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16384, 64)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    store = StoreIndex(64, mode=mode, nlist=64, nprobe=8,
                       build_threshold=16384, pq_m=16, device=card)
    store.add(x, np.arange(len(x)))
    assert store.body is not None
    return store, [x[i * 1024:(i + 1) * 1024] for i in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ivf_flat_int8", "ivf_pq"])
def test_device_stages_on_card(card, mode, monkeypatch):
    """Each timed batch adds one call of each device stage, every one
    positive, and one ``own_wait``; ``close_batch`` finds every event of
    its batch complete, so ``elapsed_time`` never waits. By default one
    batch in ``TIMED_EVERY`` is timed."""
    from rag_foundation_tpu_torch.engine import profile as prof
    from rag_foundation_tpu_torch.engine.profile import search_profile
    store, batches = _traced_store(card, mode)
    store.search_many(batches[:1], 10)                    # builds
    real = search_profile.close_batch
    pending = []

    def checked(batch):
        if batch.marks:
            pending.append(sum(not ev.query() for _, ev in batch.marks))
        real(batch)

    monkeypatch.setattr(search_profile, "close_batch", checked)
    with monkeypatch.context() as m:
        m.setattr(prof, "TIMED_EVERY", 1)
        search_profile.reset()
        store.search_many(batches, 10)
    assert pending == [0] * 4
    for name in ("upload", "route", "scan", "regather"):
        assert search_profile.calls["device." + name] == 4, name
        assert search_profile.seconds["device." + name] > 0, name
    assert search_profile.calls["own_wait"] == 4
    assert search_profile.counts()["probes"] == 4 * 1024 * 8
    search_profile.reset()
    store.search_many(batches * (2 * prof.TIMED_EVERY // 4), 10)
    assert search_profile.calls["device.scan"] == 2
    assert search_profile.calls["own_wait"] == 2
    assert search_profile.calls["rows_fetch"] == 2 * prof.TIMED_EVERY


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ivf_flat_int8", "ivf_pq"])
def test_tracing_adds_one_event_wait_a_batch(card, mode, monkeypatch):
    """A profiled timed batch with the drop counter makes the CUDA calls
    it makes without its events or the counter (stream synchronisations
    and copies alike: no host read of a device value) plus exactly one
    ``cudaEventSynchronize``, its own event's."""
    from torch.profiler import ProfilerActivity, profile

    from rag_foundation_tpu_torch.engine import profile as prof
    from rag_foundation_tpu_torch.engine.profile import search_profile
    store, batches = _traced_store(card, mode)
    store.search(batches[0], 10)                          # builds

    def api_calls():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            store.search(batches[1], 10)
        names = [e.name for e in p.events()]
        return {"sync": names.count("cudaStreamSynchronize")
                + names.count("cudaDeviceSynchronize"),
                "copy": sum(n.startswith("cudaMemcpy") for n in names),
                "event_sync": names.count("cudaEventSynchronize")}

    monkeypatch.setattr(prof, "TIMED_EVERY", 1)
    traced = api_calls()
    real_open = search_profile.open_batch
    with monkeypatch.context() as m:
        m.setattr(search_profile, "open_batch", lambda device:
                  real_open(None))
        m.setattr(search_profile, "count_probes", lambda *a: None)
        untraced = api_calls()
    assert untraced["event_sync"] == 0 and untraced["sync"] > 0
    assert traced == dict(untraced, event_sync=1)
