"""Port ADC list scan (rag_foundation_tpu_torch/ops/pq_scan.py) against the
JAX package's Pallas ``pq_list_scan`` (interpret mode on the CPU).

Tolerances: with an int8 LUT the score is an exact int32 sum, so values
and indices must match bit for bit, packed or not. With a bf16 LUT both
sum bf16 entries in f32 but in another order (JAX through a one-hot
product): values agree within 1e-5 relative of the summed magnitude
(entries of unit scale, m = 12), and an index may differ only between
two rows that score within that tolerance.

At m = 256 (the 100M tier's width, packed or not) the LUTs reach the
kernel's extremes: one slot all -127 and one all +127, so the scores are
-32512 and +32512, every live row of a sub-block ties, and the lowest rows
win. ``flatten_luts`` never emits -128, which the kernel's int16 scores
rest on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_foundation_tpu.ops.pallas_pq import flatten_luts as jax_flatten
from rag_foundation_tpu.ops.pallas_pq import pq_list_scan as jax_scan
from rag_foundation_tpu_torch.ops import cuda_lib, pq_scan
from rag_foundation_tpu_torch.ops.pq_scan import (flatten_luts, pack_codes,
                                                  pq_list_scan,
                                                  pq_list_scan_reference,
                                                  scan_routes)

K = 16


def _inputs(lut="int8", nlist=4, qcap=8, m=12, cap_len=384, dead=0.3,
            packed=False, seed=0):
    rng = np.random.default_rng(seed)
    if lut == "int8":
        l = rng.integers(-127, 128, (nlist, qcap, K * m)).astype(np.int8)
    else:
        l = rng.standard_normal((nlist, qcap, K * m)).astype(np.float32)
    codes = rng.integers(0, K, (nlist, cap_len, m)).astype(np.uint8)
    if packed:
        codes = pack_codes(torch.as_tensor(codes)).numpy()
    ids = np.arange(nlist * cap_len, dtype=np.int32).reshape(nlist, cap_len)
    ids[rng.random(ids.shape) < dead] = -1
    ids[1, 128:256] = -1        # one whole dead sub-block
    return l, codes, ids


def _jax(l, codes, ids, p, bf16=False, **kw):
    jl = jnp.asarray(l)
    if bf16:
        jl = jl.astype(jnp.bfloat16)
    v, i = jax_scan(jl, jnp.asarray(codes), jnp.asarray(ids), p=p,
                    interpret=True, **kw)
    return np.asarray(v), np.asarray(i)


def _torch(l, codes, ids, p, bf16=False, dispatch=None, **kw):
    tl = torch.as_tensor(l)
    if bf16:
        tl = tl.bfloat16()
    d = None if dispatch is None else torch.as_tensor(dispatch)
    v, i = pq_list_scan(tl, torch.as_tensor(codes), torch.as_tensor(ids), d,
                        p=p, **kw)
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("qcap", [8, 24])
@pytest.mark.parametrize("packed", [False, True])
def test_int8_lut_bit_identical_to_jax(packed, qcap, p):
    l, codes, ids = _inputs(qcap=qcap, packed=packed, seed=p + qcap)
    jv, ji = _jax(l, codes, ids, p)
    tv, ti = _torch(l, codes, ids, p)
    assert tv.dtype == np.float32 and ti.dtype == np.int32
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    # the dead sub-block yields only (-inf, -1)
    nsub = ids.shape[1] // 128
    assert np.all(ti[1, :, 1::nsub] == -1)
    assert np.all(np.isneginf(tv[1, :, 1::nsub]))


@pytest.mark.parametrize("packed", [False, True])
def test_bf16_lut_matches_jax(packed):
    l, codes, ids = _inputs("bf16", packed=packed, seed=11)
    jv, ji = _jax(l, codes, ids, 3, bf16=True)
    tv, ti = _torch(l, codes, ids, 3, bf16=True)
    live = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), live)
    np.testing.assert_allclose(tv[live], jv[live], rtol=1e-5, atol=1e-5)
    for at in np.argwhere(ti != ji):      # only near-ties may differ
        assert abs(tv[tuple(at)] - jv[tuple(at)]) <= 1e-5


def test_scores_are_the_lut_sums():
    # an independent check of the layout: score = sum_m LUT[q, m, code]
    l, codes, ids = _inputs(nlist=2, cap_len=128, dead=0.0, seed=2)
    ids[1] = np.arange(128, 256)
    tv, ti = _torch(l, codes, ids, 128)       # p = 128: every row, sorted
    m = codes.shape[2]
    lut = l.reshape(2, 8, K, m).astype(np.int64)
    for li in range(2):
        for s in range(8):
            want = lut[li, s, codes[li].astype(int),
                       np.arange(m)[None, :]].sum(1)
            order = np.lexsort((np.arange(128), -want))
            np.testing.assert_array_equal(tv[li, s], want[order])
            np.testing.assert_array_equal(ti[li, s], li * 128 + order)


def test_ties_first_row_wins():
    # duplicated rows inside each sub-block: the lowest row must win and
    # the next pass must take the duplicate
    l, codes, ids = _inputs(dead=0.0, seed=3)
    ids[1] = np.arange(384, 768)
    codes[:, 1::2] = codes[:, 0::2]
    jv, ji = _jax(l, codes, ids, 2)
    tv, ti = _torch(l, codes, ids, 2)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    nsub = codes.shape[1] // 128
    first, second = ti[..., :nsub], ti[..., nsub:]
    assert np.all(first % 2 == 0) and np.all(second == first + 1)


def test_cap_block_has_no_effect():
    l, codes, ids = _inputs(seed=5)
    a = _torch(l, codes, ids, 2, cap_block=128)
    b = _torch(l, codes, ids, 2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # the JAX kernel lays its output out cell by cell, so with one
    # sub-block a cell it is sub-block-major; the same candidates, though
    nlist, qcap, w = a[0].shape
    for ours, ref in zip(a, _jax(l, codes, ids, 2, cap_block=128)):
        np.testing.assert_array_equal(
            ours, ref.reshape(nlist, qcap, w // 2, 2).transpose(
                0, 1, 3, 2).reshape(nlist, qcap, w))


def test_dead_dispatch_tail_yields_neg_inf():
    l, codes, ids = _inputs(nlist=5, qcap=24, seed=7)
    disp = np.full((5, 24), -1, np.int32)
    disp[0, :24] = 1        # full
    disp[1, :3] = 2         # 3 live slots
    disp[2, [0, 9]] = 0     # a hole: slots up to 9 are computed
    # lists 3 and 4: no live slot at all
    full_v, full_i = _torch(l, codes, ids, 3)
    v, i = _torch(l, codes, ids, 3, dispatch=disp)
    for li, n in enumerate([24, 3, 10, 0, 0]):
        np.testing.assert_array_equal(v[li, :n], full_v[li, :n])
        np.testing.assert_array_equal(i[li, :n], full_i[li, :n])
        assert np.all(np.isneginf(v[li, n:])) and np.all(i[li, n:] == -1)


def test_bad_shapes_raise():
    l, codes, ids = _inputs(cap_len=200)
    with pytest.raises(ValueError, match="multiple of 128"):
        _torch(l, codes, ids, 2)
    with pytest.raises(ValueError, match="multiple of 128"):
        _jax(l, codes, ids, 2)
    l, codes, ids = _inputs()
    with pytest.raises(ValueError, match="lut width"):
        _torch(l[:, :, :-16], codes, ids, 2)
    with pytest.raises(ValueError, match="nbits=4"):
        _torch(np.zeros((4, 8, 256 * 12), np.int8), codes, ids, 2,
               k_codes=256)
    with pytest.raises(ValueError, match="LUT dtype"):
        pq_list_scan(torch.zeros((4, 8, K * 12)), torch.as_tensor(codes),
                     torch.as_tensor(ids))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    real = pq_scan.pq_list_scan_reference

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    def no_build(name):
        raise AssertionError("the CPU path must not build a kernel")

    monkeypatch.setattr(pq_scan, "pq_list_scan_reference", spy)
    monkeypatch.setattr(cuda_lib, "load", no_build)
    before = pq_scan.LAUNCHES.count
    l, codes, ids = _inputs()
    _torch(l, codes, ids, 2)
    assert calls == [1]
    assert pq_scan.LAUNCHES.count == before
    # chunking over lists does not change the result
    monkeypatch.setattr(pq_scan, "_REF_BYTES", 1)
    a = pq_list_scan_reference(*[torch.as_tensor(x) for x in (l, codes, ids)],
                               p=2)
    b = real(*[torch.as_tensor(x) for x in (l, codes, ids)], p=2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _extreme_luts(l):
    """Slot 0 of every list all -127, slot 1 all +127, the rest random."""
    l = l.copy()
    l[:, 0] = -127
    l[:, 1] = 127
    return l


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("packed", [False, True])
def test_int8_lut_m256_extremes_bit_identical_to_jax(packed, p):
    m = 256
    l, codes, ids = _inputs(m=m, packed=packed, seed=40 + p)
    l = _extreme_luts(l)
    jv, ji = _jax(l, codes, ids, p)
    tv, ti = _torch(l, codes, ids, p)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    nsub = ids.shape[1] // 128
    for li in range(ids.shape[0]):
        for sb in range(nsub):
            live = np.nonzero(ids[li, sb * 128:(sb + 1) * 128] >= 0)[0]
            got = ti[li, :, [j * nsub + sb for j in range(p)]]   # [p, qcap]
            want = np.full(p, -1)
            want[:min(p, len(live))] = li * ids.shape[1] + sb * 128 \
                + live[:p]
            # every live row ties: the lowest rows, in order
            for slot, score in ((0, -127 * m), (1, 127 * m)):
                np.testing.assert_array_equal(got[:, slot], want)
                vals = tv[li, slot, [j * nsub + sb for j in range(p)]]
                assert np.all(vals[want >= 0] == score)
                assert np.all(np.isneginf(vals[want < 0]))
    # the dead sub-block of list 1
    assert np.all(ti[1, :, 1::nsub] == -1)


@pytest.mark.parametrize("p", [1, 4])
def test_int8_lut_m256_plain_version_matches_jax_with_ties(p):
    # duplicated rows: random LUTs tie inside every sub-block
    l, codes, ids = _inputs(m=256, packed=True, dead=0.1, seed=50 + p)
    codes[:, 1::2] = codes[:, 0::2]
    jv, ji = _jax(l, codes, ids, p)
    tv, ti = _torch(l, codes, ids, p)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)


def test_flatten_luts_m256_packed_never_minus_128():
    rng = np.random.default_rng(60)
    lut = -np.abs(rng.standard_normal((6, 256, K))).astype(np.float32)
    lut[0] = -1.0                       # every entry the query's maximum
    lut[1, 7, 3] = -1e6                 # one entry far past the rest
    jf, js = jax_flatten(jnp.asarray(lut), "int8", packed=True)
    tf, ts = flatten_luts(torch.as_tensor(lut), torch.int8, packed=True)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tf.dtype == torch.int8
    assert int(tf.min()) == -127 and int(tf.max()) <= 0
    # so a score over 256 positions stays above the kernel's dead mark
    assert 256 * int(tf.min()) > -32768


def test_scan_routes_follow_the_shape_and_live_slots():
    live = torch.tensor([0, 1, 2, 3, 4, 5, 8, 9, 16, 17], dtype=torch.int32)
    assert scan_routes(torch.int8, True, 256, 4, live) == {
        "unread": 1, "pair": 6, "lookup": 0, "mma": 3}
    assert scan_routes(torch.int8, False, 256, 4, live) == {
        "unread": 1, "pair": 0, "lookup": 6, "mma": 3}
    assert scan_routes(torch.int8, True, 192, 4, live) == {
        "unread": 1, "pair": 0, "lookup": 6, "mma": 3}
    for args in ((torch.bfloat16, True, 256, 4), (torch.int8, True, 264, 4),
                 (torch.int8, False, 6, 4), (torch.int8, True, 256, 40)):
        assert scan_routes(*args, live) == {"unread": 1,
                                            "pq_scan_kernel": 9}
