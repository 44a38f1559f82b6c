"""Flash attention forward with segment masking: the encoder's attention.

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
for CPU tensors. There is no fallback: a CUDA tensor gets the kernel or
an exception.
"""

from __future__ import annotations

import ctypes

import torch

from rag_foundation_tpu_torch.ops import cuda_lib

# the JAX library's mask value (flash_attention.DEFAULT_MASK_VALUE): added
# to masked logits, so a row's masked keys weigh exactly 0
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}
HEAD_DIMS = (16, 32, 64)     # the kernel's instantiations

LAUNCHES = cuda_lib.LaunchCounter()   # kernel launches (CUDA path only)


def _check(q, k, v, seg_q, seg_kv) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, H, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v dtype must be one of float32/bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, _, s, _ = q.shape
    for name, seg in (("seg_q", seg_q), ("seg_kv", seg_kv)):
        if seg.shape != (b, s) or seg.dtype != torch.int32:
            raise ValueError(f"{name} must be [B, S] = {(b, s)} int32, got "
                             f"{tuple(seg.shape)} {seg.dtype}")
    tensors = (q, k, v, seg_q, seg_kv)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v, seg_q, seg_kv must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k, v, seg_q, seg_kv must be contiguous")


def flash_attention_reference(q, k, v, seg_q, seg_kv,
                              sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version (any device): f32 softmax with the segment
    mask, the function of the JAX library's ``mha_reference``."""
    _check(q, k, v, seg_q, seg_kv)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if sm_scale != 1.0:
        logits = logits * sm_scale
    same = (seg_q[:, :, None] == seg_kv[:, None, :])[:, None]
    logits = logits + torch.where(same, 0.0, MASK_VALUE)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    weights = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seg_q: torch.Tensor, seg_kv: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """Segment-masked attention; see the module docstring for the
    contract."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, seg_q, seg_kv, sm_scale)
    _check(q, k, v, seg_q, seg_kv)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported on the card "
                         f"({HEAD_DIMS})")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    rc = _kernel()(DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr(),
                   out.data_ptr(), b, h, s, d, float(sm_scale),
                   torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES.add()
    return out


def _kernel():
    lib = cuda_lib.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                       ctypes.c_float, vp]
        fn.restype = ci
    return fn
