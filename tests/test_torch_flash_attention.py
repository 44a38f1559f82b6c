"""The port's segment-masked attention against the JAX library's.

The JAX side is the library's Pallas TPU ``flash_attention`` (the kernel
the encoder calls) run in TPU interpret mode on the CPU, and its plain
``mha_reference``; the port's side is ``flash_attention`` on CPU tensors,
which runs the plain version ``flash_attention_reference``. Inputs are
numpy f32 from a seed, B=2, H=2, D=32, with pads, an all-pad row and a
row of one real token. Tolerance 1e-5: f32 softmax and sums in another
order (observed about 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (SegmentIds,
                                                             flash_attention,
                                                             mha_reference)

from rag_foundation_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, h, s, d, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    seg = np.zeros((b, s), np.int32)
    for i, n in enumerate(lengths):
        seg[i, :n] = 1                   # real tokens 1, pads 0
    return q, k, v, seg


def _port(q, k, v, seg, scale):
    t = [torch.from_numpy(x) for x in (q, k, v)]
    sg = torch.from_numpy(seg)
    return fa.flash_attention(*t, sg, sg, scale).numpy()


@pytest.mark.parametrize("s,lengths", [(128, [77, 0]), (256, [1, 200])])
def test_plain_version_matches_jax_kernel_and_reference(s, lengths):
    d = 32
    q, k, v, seg = _inputs(2, 2, s, d, lengths)
    scale = d ** -0.5
    ids = SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    with pltpu.force_tpu_interpret_mode():
        kern = np.asarray(flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            segment_ids=ids, sm_scale=scale))
    ref = np.asarray(mha_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), None, ids,
                                   sm_scale=scale))
    port = _port(q, k, v, seg, scale)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, kern, **TOL)
    np.testing.assert_allclose(port, ref, **TOL)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    q, k, v, seg = _inputs(2, 3, 40, 16, [40, 7], seed=1)
    before = fa.LAUNCHES.count
    t = [torch.from_numpy(x) for x in (q, k, v)]
    sg = torch.from_numpy(seg)
    out = fa.flash_attention(*t, sg, sg, 0.25)
    ref = fa.flash_attention_reference(*t, sg, sg, 0.25)
    assert torch.equal(out, ref) and fa.LAUNCHES.count == before
    # a real row sees its own segment only: the pads do not move it
    t2 = [x.clone() for x in t]
    for x in t2:
        x[1, :, 7:] = 100.0
    out2 = fa.flash_attention(*t2, sg, sg, 0.25)
    torch.testing.assert_close(out2[1, :, :7], out[1, :, :7], rtol=0,
                               atol=0)
    # bf16 in, bf16 out
    tb = [x.bfloat16() for x in t]
    assert fa.flash_attention(*tb, sg, sg, 0.25).dtype == torch.bfloat16


def test_wrapper_raises_on_bad_inputs():
    q, k, v, seg = _inputs(2, 2, 16, 16, [16, 3])
    t = [torch.from_numpy(x) for x in (q, k, v)]
    sg = torch.from_numpy(seg)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(t[0], t[1][:, :, :8], t[2], sg, sg, 1.0)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(t[0][0], t[1][0], t[2][0], sg, sg, 1.0)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(t[0].half(), t[1].half(), t[2].half(), sg, sg,
                           1.0)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(t[0], t[1].bfloat16(), t[2], sg, sg, 1.0)
    with pytest.raises(ValueError, match="seg_q"):
        fa.flash_attention(*t, sg.long(), sg, 1.0)
    with pytest.raises(ValueError, match="seg_kv"):
        fa.flash_attention(*t, sg, sg[:, :8].contiguous(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(t[0].transpose(1, 2).contiguous().transpose(
            1, 2), t[1], t[2], sg, sg, 1.0)
