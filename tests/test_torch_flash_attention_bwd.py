"""The port's attention backward against the JAX library's, on the CPU.

The JAX side is ``jax.vjp`` through the library's Pallas TPU
``flash_attention`` in TPU interpret mode, which runs its two backward
kernels (``_flash_attention_bwd_dkv``, ``_flash_attention_bwd_dq``), and
through its plain ``mha_reference_no_custom_vjp``. The port's side is the
plain versions ``flash_attention_bwd_dkv_reference`` and
``flash_attention_bwd_dq_reference`` (what the wrappers run on CPU
tensors) fed the plain forward's ``lse`` and ``di = sum(o * do, -1)``,
and ``FlashAttention`` end to end. Inputs are numpy f32 from a seed, B=2,
H=2, D=32, S in {128, 256} (the library's default blocks need S >= 128),
with pads, an all-pad row and a row of one real token.

Tolerance: 1e-5 of the largest magnitude of each gradient (f32 softmax
and sums in another order; observed about 1e-6), 1e-5 absolute on
``lse``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds, flash_attention, mha_reference_no_custom_vjp)

from rag_foundation_tpu_torch.ops import flash_attention as fa

GRAD_TOL = 1e-5
LSE_TOL = 1e-5
CASES = [(128, [77, 0]), (256, [1, 200])]


def _inputs(b, h, s, d, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, s, d)).astype(np.float32)
                   for _ in range(4))
    seg = np.zeros((b, s), np.int32)
    for i, n in enumerate(lengths):
        seg[i, :n] = 1                   # real tokens 1, pads 0
    return q, k, v, do, seg


def _port_grads(q, k, v, do, seg, scale):
    """dq, dk, dv from the plain versions, through the wrappers on CPU
    tensors, given the plain forward's lse and di."""
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    sg = torch.from_numpy(seg)
    out, lse = fa.flash_attention_reference(*t[:3], sg, sg, scale,
                                            with_lse=True)
    di = (out * t[3]).sum(dim=-1)
    dk, dv = fa.flash_attention_bwd_dkv(*t[:3], sg, sg, lse, t[3], di,
                                        scale)
    dq = fa.flash_attention_bwd_dq(*t[:3], sg, sg, lse, t[3], di, scale)
    return [x.numpy() for x in (dq, dk, dv)]


def _jax_grads(fn, q, k, v, do, seg, scale):
    ids = SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))

    @jax.jit
    def grads(q, k, v, do):
        _, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, ids, scale), q, k, v)
        return vjp(do)

    return [np.asarray(g) for g in grads(*map(jnp.asarray, (q, k, v, do)))]


def _library(q, k, v, ids, scale):
    return flash_attention(q, k, v, segment_ids=ids, sm_scale=scale)


def _library_reference(q, k, v, ids, scale):
    return mha_reference_no_custom_vjp(q, k, v, None, ids, sm_scale=scale)


def _assert_grads_close(port, ref):
    for name, a, b in zip(("dq", "dk", "dv"), port, ref):
        assert a.shape == b.shape and np.isfinite(a).all(), name
        np.testing.assert_allclose(
            a, b, rtol=0, atol=GRAD_TOL * float(np.abs(b).max()),
            err_msg=name)


@pytest.mark.parametrize("s,lengths", CASES)
def test_plain_backward_matches_jax_kernels(s, lengths):
    """Against the library's two Pallas backward kernels (interpret
    mode)."""
    d = 32
    q, k, v, do, seg = _inputs(2, 2, s, d, lengths)
    with pltpu.force_tpu_interpret_mode():
        ref = _jax_grads(_library, q, k, v, do, seg, d ** -0.5)
    _assert_grads_close(_port_grads(q, k, v, do, seg, d ** -0.5), ref)


@pytest.mark.parametrize("s,lengths", CASES)
def test_plain_backward_matches_jax_reference(s, lengths):
    """Against ``jax.vjp`` of the library's plain reference (its custom-VJP
    twin raises for ``sm_scale != 1``)."""
    d = 32
    q, k, v, do, seg = _inputs(2, 2, s, d, lengths, seed=1)
    ref = _jax_grads(_library_reference, q, k, v, do, seg, d ** -0.5)
    _assert_grads_close(_port_grads(q, k, v, do, seg, d ** -0.5), ref)


@pytest.mark.parametrize("s,lengths", [(40, [40, 0, 1, 17]),
                                       (128, [128, 5, 0, 1])])
def test_autograd_function_matches_autograd_of_plain_forward(s, lengths):
    q, k, v, do, seg = _inputs(4, 3, s, 16, lengths, seed=2)
    sg = torch.from_numpy(seg)
    grads = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        fn(*t, sg, sg, 0.25).backward(torch.from_numpy(do))
        grads.append([x.grad.numpy() for x in t])
    _assert_grads_close(*grads)
    # straight through FlashAttention.apply, segment ids get no gradient
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fa.FlashAttention.apply(*t, sg, sg, 0.25)
    np.testing.assert_array_equal(
        out.detach().numpy(),
        fa.flash_attention_reference(*t, sg, sg, 0.25).detach().numpy())
    out.backward(torch.from_numpy(do))
    _assert_grads_close([x.grad.numpy() for x in t], grads[1])


def test_plain_lse_is_the_masked_logsumexp():
    q, k, v, _, seg = _inputs(3, 2, 64, 32, [64, 0, 1], seed=3)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    sg = torch.from_numpy(seg)
    seg_kv = sg.clone()
    seg_kv[2] = 2              # row 2's queries (segments 1, 0) see no key
    out, lse = fa.flash_attention_reference(*t, sg, seg_kv, 0.125,
                                            with_lse=True)
    assert lse.shape == (3, 2, 64) and lse.dtype == torch.float32
    logits = torch.einsum("bhqd,bhkd->bhqk", t[0], t[1]) * 0.125
    same = (sg[:, :, None] == seg_kv[:, None, :])[:, None]
    want = torch.logsumexp(logits.masked_fill(~same, float("-inf")), -1)
    torch.testing.assert_close(lse, want, rtol=0, atol=LSE_TOL)
    assert torch.isinf(lse[2]).all() and torch.isfinite(lse[:2]).all()
    torch.testing.assert_close(
        out, fa.flash_attention_reference(*t, sg, seg_kv, 0.125),
        rtol=0, atol=0)


def test_cpu_counts_no_launch_and_asks_no_lse_when_serving(monkeypatch):
    q, k, v, do, seg = _inputs(2, 2, 32, 16, [32, 3], seed=4)
    sg = torch.from_numpy(seg)
    counters = (fa.LAUNCHES, fa.BWD_DKV_LAUNCHES, fa.BWD_DQ_LAUNCHES)
    before = [c.count for c in counters]
    applied = []
    real_apply = fa.FlashAttention.apply
    monkeypatch.setattr(fa.FlashAttention, "apply",
                        lambda *a: applied.append(1) or real_apply(*a))
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    with torch.inference_mode():
        served = fa.flash_attention(*t, sg, sg, 0.25)
    assert not applied and not served.requires_grad
    with torch.no_grad():
        fa.flash_attention(*t, sg, sg, 0.25)
    assert not applied
    fa.flash_attention(*t, sg, sg, 0.25).backward(torch.from_numpy(do))
    assert applied == [1]
    assert [c.count for c in counters] == before


def test_backward_wrappers_raise_on_bad_inputs():
    q, k, v, do, seg = _inputs(2, 2, 16, 16, [16, 3])
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    sg = torch.from_numpy(seg)
    lse = torch.zeros((2, 2, 16))
    di = torch.zeros((2, 2, 16))
    for fn in (fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq):
        with pytest.raises(ValueError, match="lse"):
            fn(*t[:3], sg, sg, lse[:, :, :8], t[3], di, 1.0)
        with pytest.raises(ValueError, match="lse"):
            fn(*t[:3], sg, sg, lse.double(), t[3], di, 1.0)
        with pytest.raises(ValueError, match="di"):
            fn(*t[:3], sg, sg, lse, t[3], di[0], 1.0)
        with pytest.raises(ValueError, match="do"):
            fn(*t[:3], sg, sg, lse, t[3].bfloat16(), di, 1.0)
        with pytest.raises(ValueError, match="do"):
            fn(*t[:3], sg, sg, lse, t[3][:, :, :8], di, 1.0)
        with pytest.raises(ValueError, match="contiguous"):
            fn(*t[:3], sg, sg, lse, t[3].transpose(2, 3).contiguous()
               .transpose(2, 3), di, 1.0)
        with pytest.raises(ValueError, match="seg_kv"):
            fn(*t[:3], sg, sg.long(), lse, t[3], di, 1.0)
        with pytest.raises(ValueError, match="shape"):
            fn(t[0], t[1][:, :, :8], t[2], sg, sg, lse, t[3], di, 1.0)
