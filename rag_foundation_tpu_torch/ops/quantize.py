"""Symmetric int8 quantization for corpus storage and int8 list scans.

int8 storage quarters the bytes of an f32 corpus (a 10M x 768 body is
7.7 GB in int8) and the list-scan kernel reads it with ``__dp4a``.
Per-tensor symmetric scaling keeps score ORDER intact (cosine ranking
is scale-invariant); returned scales restore absolute scores.
"""

from __future__ import annotations

import torch

# |int8 . int8| <= 127 * 127 * d. Below 2**24 every partial sum is an
# integer that float32 holds exactly, so an f32 matmul of int8 values
# gives the exact int32 dot in any summation order (d <= 1040).
_F32_EXACT = 1 << 24


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, float]:
    """``x [N, d]`` float -> ``(q [N, d] int8, scale)`` with
    ``x ≈ q * scale``; ``scale`` is a Python float holding an f32 value."""
    x32 = x.float()
    absmax = x32.abs().max() if x32.numel() else x32.new_zeros(())
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, float(scale)


def quantize_with_scale(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Quantize ``x`` to int8 with a given per-tensor ``scale``."""
    return torch.clamp(torch.round(x.float() / scale), -127,
                       127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: float) -> torch.Tensor:
    return q.float() * scale


def int8_dot_dtype(d: int) -> torch.dtype:
    """Float type in which an int8 matmul over depth ``d`` is exact."""
    return torch.float32 if 127 * 127 * d < _F32_EXACT else torch.float64


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b`` of int8 operands as f32 (values are integers).

    CUDA has no integer batched matmul in PyTorch, so the product runs
    in a float type where it is exact (see ``_F32_EXACT``)."""
    dt = int8_dot_dtype(a.shape[-1])
    return torch.matmul(a.to(dt), b.to(dt)).float()
