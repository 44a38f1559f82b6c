"""L2 normalization for cosine scoring.

The engine stores unit-norm vectors so cosine similarity is a plain dot
product.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12,
                 dim: int = -1) -> torch.Tensor:
    """Normalize rows of ``x`` to unit L2 norm (f32 accumulation).

    Zero rows are left at zero (guarded by ``eps``) rather than NaN so
    that padding slots score 0 against any query.
    """
    x32 = x.float()
    sq = torch.sum(x32 * x32, dim=dim, keepdim=True)
    inv = torch.where(sq > eps, 1.0 / torch.sqrt(sq), torch.zeros_like(sq))
    return (x32 * inv).to(x.dtype)
