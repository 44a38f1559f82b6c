"""Flash attention with segment masking: the encoder's attention, forward
and backward.

Counterpart of the JAX library's Pallas TPU ``flash_attention`` as the
MiniLM encoder calls it (``rag_foundation_tpu/models/encoder.py:100``,
``_attention``): no causal mask, no bias, ``segment_ids`` for q and kv::

    out[b,h,i] = sum_j softmax_j(q[b,h,i] . k[b,h,j] * sm_scale
                                 over j with seg_kv[b,j] == seg_q[b,i]) v[b,h,j]

``q, k, v [B, H, S, D]`` contiguous, float32 or bfloat16 (the output
takes their dtype); ``seg_q, seg_kv [B, S]`` int32 contiguous.

``flash_attention`` launches the hand-written CUDA kernel
(``csrc/flash_attention.cu``: bf16 ``mma.sync`` with an online f32
softmax, or an f32 FMA path for float32; head dim 16, 32 or 64) for CUDA
tensors and runs the plain PyTorch version ``flash_attention_reference``
for CPU tensors. When grad mode is on and an input requires grad it goes
through ``FlashAttention``, whose forward also asks the kernel for the
rows' log-sum-exp and whose backward launches the two kernels of
``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd_dkv``,
``flash_attention_bwd_dq``: the library's ``_flash_attention_bwd_dkv``
and ``_flash_attention_bwd_dq``). There is no fallback: a CUDA tensor gets
the kernel or an exception.
"""

from __future__ import annotations

import ctypes

import torch

from rag_foundation_tpu_torch.ops import cuda_lib

# the JAX library's mask value (flash_attention.DEFAULT_MASK_VALUE): added
# to masked logits, so a row's masked keys weigh exactly 0
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}
HEAD_DIMS = (16, 32, 64)     # the kernels' instantiations

# kernel launches (CUDA path only)
LAUNCHES = cuda_lib.LaunchCounter()
BWD_DKV_LAUNCHES = cuda_lib.LaunchCounter()
BWD_DQ_LAUNCHES = cuda_lib.LaunchCounter()


def _check(q, k, v, seg_q, seg_kv, *rows) -> None:
    """Shapes, dtypes, device and layout of the forward's inputs; ``rows``
    are further ``(name, tensor, kind)``: kind ``"qkv"`` is one more
    ``[B, H, S, D]`` tensor of q's dtype, ``"row"`` a ``[B, H, S]`` f32."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, H, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v dtype must be one of float32/bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, s, _ = q.shape
    for name, seg in (("seg_q", seg_q), ("seg_kv", seg_kv)):
        if seg.shape != (b, s) or seg.dtype != torch.int32:
            raise ValueError(f"{name} must be [B, S] = {(b, s)} int32, got "
                             f"{tuple(seg.shape)} {seg.dtype}")
    for name, t, kind in rows:
        want = (q.shape, q.dtype) if kind == "qkv" else ((b, h, s),
                                                         torch.float32)
        if t.shape != want[0] or t.dtype != want[1]:
            raise ValueError(f"{name} must be {tuple(want[0])} {want[1]}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    tensors = (q, k, v, seg_q, seg_kv) + tuple(t for _, t, _ in rows)
    names = "q, k, v, seg_q, seg_kv" + "".join(f", {n}" for n, _, _ in rows)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{names} must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{names} must be contiguous")


def _same_segment(seg_q, seg_kv) -> torch.Tensor:
    return (seg_q[:, :, None] == seg_kv[:, None, :])[:, None]


def _scores(q, k, sm_scale: float) -> torch.Tensor:
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    return logits * sm_scale if sm_scale != 1.0 else logits


def flash_attention_reference(q, k, v, seg_q, seg_kv, sm_scale: float,
                              with_lse: bool = False):
    """Plain PyTorch version (any device): f32 softmax with the segment
    mask, the function of the JAX library's ``mha_reference``. With
    ``with_lse`` it returns ``(out, lse)``: ``lse [B, H, S]`` f32 is each
    row's natural-log log-sum-exp over the keys of its segment (-inf for
    a row with none)."""
    _check(q, k, v, seg_q, seg_kv)
    logits = _scores(q, k, sm_scale)
    same = _same_segment(seg_q, seg_kv)
    logits = logits + torch.where(same, 0.0, MASK_VALUE)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l, v.float()).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.where(same.any(dim=-1), (m + torch.log(l))[..., 0],
                      float("-inf"))
    return out, lse


def flash_attention_forward(q, k, v, seg_q, seg_kv, sm_scale: float,
                            with_lse: bool = False):
    """The forward without autograd: ``out``, or ``(out, lse)`` with
    ``with_lse``. One launch of the forward kernel for CUDA tensors (its
    ``lse`` output only when asked for), the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, seg_q, seg_kv, sm_scale,
                                         with_lse)
    _check(q, k, v, seg_q, seg_kv)
    _card_shape(q)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if q.numel() > 0:
        rc = _fn("flash_attention", "flash_attention_launch", 7)(
            DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            seg_q.data_ptr(), seg_kv.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, s, d,
            float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES.add()
    return (out, lse) if with_lse else out


def _card_shape(q) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not supported on the card "
                         f"({HEAD_DIMS})")


def backward_terms_reference(q, k, v, seg_q, seg_kv, lse, do, di,
                             sm_scale: float):
    """The plain backward's recomputed weights ``p`` and their ``ds``
    (already times ``sm_scale``), f32 ``[B, H, S, S]``: the formulas of the
    library's ``mha_reference_bwd`` over ``lse`` instead of ``m`` and
    ``l``. dV = p^T.dO, dK = ds^T.q, dQ = ds.k."""
    same = _same_segment(seg_q, seg_kv)
    p = torch.where(same, torch.exp(_scores(q, k, sm_scale)
                                    - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, (p * (dp - di[..., None])) * sm_scale


def backward_error_bounds(q, k, v, seg_q, seg_kv, lse, do, di,
                          sm_scale: float):
    """sum |a||b| of each backward output's products, f32: (dq, dk, dv),
    with ds's magnitude taken before its cancellation, p (sum|dO||v| +
    |di|) * sm_scale: what a kernel's rounding of p and ds to bf16 is
    relative to."""
    p, _ = backward_terms_reference(q, k, v, seg_q, seg_kv, lse, do, di,
                                    sm_scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float().abs(), v.float().abs())
    ds = p * (dp + di.abs()[..., None]) * sm_scale
    del dp
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float().abs()),
            torch.einsum("bhqk,bhqd->bhkd", ds, q.float().abs()),
            torch.einsum("bhqk,bhqd->bhkd", p, do.float().abs()))


def _check_bwd(q, k, v, seg_q, seg_kv, lse, do, di) -> None:
    _check(q, k, v, seg_q, seg_kv, ("lse", lse, "row"), ("do", do, "qkv"),
           ("di", di, "row"))


def flash_attention_bwd_dkv_reference(q, k, v, seg_q, seg_kv, lse, do, di,
                                      sm_scale: float):
    """Plain PyTorch version of the dK/dV kernel (any device): explicit
    formulas over ``lse`` and ``di = sum(o * do, -1)``, not autograd of the
    forward. Returns ``(dk, dv)`` in the inputs' dtype."""
    _check_bwd(q, k, v, seg_q, seg_kv, lse, do, di)
    p, ds = backward_terms_reference(q, k, v, seg_q, seg_kv, lse, do, di,
                                     sm_scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, seg_q, seg_kv, lse, do, di,
                                     sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version of the dQ kernel (any device), as
    ``flash_attention_bwd_dkv_reference``. Returns ``dq``."""
    _check_bwd(q, k, v, seg_q, seg_kv, lse, do, di)
    _, ds = backward_terms_reference(q, k, v, seg_q, seg_kv, lse, do, di,
                                     sm_scale)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def _launch_bwd(symbol: str, counter, outs, q, k, v, seg_q, seg_kv, lse, do,
                di, sm_scale: float) -> None:
    """One launch of a backward kernel into the allocated ``outs``."""
    if q.numel() == 0:
        return
    b, h, s, d = q.shape
    rc = _fn("flash_attention_bwd", symbol, 8 + len(outs))(
        DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        seg_q.data_ptr(), seg_kv.data_ptr(), lse.data_ptr(), do.data_ptr(),
        di.data_ptr(), *(o.data_ptr() for o in outs), b, h, s, d,
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {rc}")
    counter.add()


def flash_attention_bwd_dkv(q, k, v, seg_q, seg_kv, lse, do, di,
                            sm_scale: float):
    """``(dk, dv)`` of the attention: the dK/dV kernel for CUDA tensors, the
    plain version for CPU tensors. ``lse`` is the forward's, ``di =
    sum(o * do, -1)`` f32 ``[B, H, S]``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, seg_q, seg_kv,
                                                 lse, do, di, sm_scale)
    _check_bwd(q, k, v, seg_q, seg_kv, lse, do, di)
    _card_shape(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_attention_bwd_dkv_launch", BWD_DKV_LAUNCHES, (dk, dv),
                q, k, v, seg_q, seg_kv, lse, do, di, sm_scale)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, seg_q, seg_kv, lse, do, di,
                           sm_scale: float) -> torch.Tensor:
    """``dq`` of the attention: the dQ kernel for CUDA tensors, the plain
    version for CPU tensors (arguments as ``flash_attention_bwd_dkv``)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, seg_q, seg_kv, lse,
                                                do, di, sm_scale)
    _check_bwd(q, k, v, seg_q, seg_kv, lse, do, di)
    _card_shape(q)
    dq = torch.empty_like(q)
    _launch_bwd("flash_attention_bwd_dq_launch", BWD_DQ_LAUNCHES, (dq,), q, k,
                v, seg_q, seg_kv, lse, do, di, sm_scale)
    return dq


class FlashAttention(torch.autograd.Function):
    """Differentiable segment-masked attention: the library's custom VJP
    (``_flash_attention_fwd``/``_flash_attention_bwd``, :234-322). The
    forward keeps ``q, k, v, seg_q, seg_kv, out, lse``; the backward
    computes ``di`` in PyTorch, as the library does, then the dK/dV and the
    dQ kernel (their plain versions on the CPU). No gradient for the
    segment ids or the scale."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, sm_scale: float):
        out, lse = flash_attention_forward(q, k, v, seg_q, seg_kv, sm_scale,
                                           with_lse=True)
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_q, seg_kv, out, lse = ctx.saved_tensors
        do = do.contiguous()
        di = (out.float() * do.float()).sum(dim=-1)
        dk, dv = flash_attention_bwd_dkv(q, k, v, seg_q, seg_kv, lse, do, di,
                                         ctx.sm_scale)
        dq = flash_attention_bwd_dq(q, k, v, seg_q, seg_kv, lse, do, di,
                                    ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seg_q: torch.Tensor, seg_kv: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """Segment-masked attention; see the module docstring for the
    contract. Differentiable through ``FlashAttention`` when grad mode is
    on and an input requires grad; otherwise one forward launch that asks
    for no ``lse`` (the serve path, under ``inference_mode``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                     or v.requires_grad):
        return FlashAttention.apply(q, k, v, seg_q, seg_kv, sm_scale)
    return flash_attention_forward(q, k, v, seg_q, seg_kv, sm_scale)


def _fn(lib_name: str, symbol: str, pointers: int):
    """The C entry point ``symbol`` of ``csrc/<lib_name>.cu``, typed: the
    dtype code, ``pointers`` tensor pointers, B, H, S, D, the scale and the
    stream."""
    fn = getattr(cuda_lib.load(lib_name), symbol)
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci] + [vp] * pointers + [ci, ci, ci, ci,
                                                ctypes.c_float, vp]
        fn.restype = ci
    return fn
