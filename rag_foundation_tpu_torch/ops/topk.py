"""Streaming exact top-k over a device-resident corpus.

Flash-attention-style blockwise scan: the [Q, N] score matrix is never
materialized. Each corpus block is scored with one matmul and merged
into a running ``[Q, k]`` (values, indices) carry.

Determinism / tie-breaking: ties are broken toward the LOWEST global
corpus index. ``torch.topk`` promises no order among ties, so every
selection here is a STABLE descending sort: the carry (earlier blocks,
lower indices) is concatenated first and a stable sort keeps equal
scores in concatenation order. The result is bit-identical for any
``block_size``.

This is plain PyTorch, as the JAX package leaves its exact scan to XLA
(``rag_foundation_tpu/ops/topk.py``).
"""

from __future__ import annotations

import torch

from rag_foundation_tpu_torch.ops.quantize import int8_matmul

NEG_INF = float("-inf")


def stable_topk(vals: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last axis, descending, ties to the lower
    position (``lax.top_k``'s order). Returns (values, positions)."""
    sv, pos = torch.sort(vals, dim=-1, descending=True, stable=True)
    return sv[..., :k], pos[..., :k]


def merge_topk(
    vals_a: torch.Tensor,
    idxs_a: torch.Tensor,
    vals_b: torch.Tensor,
    idxs_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two (values, indices) candidate sets into a single top-k.

    Ties prefer set ``a`` (callers pass the earlier-index set first), then
    lower position within each set.
    """
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idxs = torch.cat([idxs_a, idxs_b], dim=-1)
    top_vals, top_pos = stable_topk(vals, k)
    return top_vals, torch.gather(idxs, -1, top_pos)


def block_scores(q: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """``q @ block.T`` in f32: exact int32 dots for int8 operands, f32
    accumulation for float ones."""
    if block.dtype == torch.int8:
        return int8_matmul(q, block.T)
    return torch.matmul(q.float(), block.float().T)


def exact_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    *,
    valid_count: int | None = None,
    live_mask: torch.Tensor | None = None,
    block_size: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact batched top-k by dot-product score.

    Args:
      queries: ``[Q, d]`` query matrix (cast to the corpus dtype, as the
        JAX reference does, then scored in f32).
      corpus: ``[N, d]`` corpus matrix. ``N`` may include padding slots
        past ``valid_count``; those never appear in results.
      k: number of neighbors.
      valid_count: number of live rows at the front of ``corpus``
        (clamped to N). ``None`` means all rows are live.
      live_mask: optional ``[N]`` bool; rows with False are excluded
        (tombstoned deletes). Applied inside the scan so masked rows are
        fully replaced by the next-best candidates.
      block_size: corpus rows per scan step. Any value gives the same
        result.

    Returns:
      ``(values [Q, k] f32, indices [Q, k] int32)`` sorted descending,
      ties toward the lower index. Empty / padded slots surface as
      ``(-inf, -1)``.
    """
    n = corpus.shape[0]
    dev = corpus.device
    q = queries.to(device=dev, dtype=corpus.dtype)
    valid_count = n if valid_count is None else max(0, min(int(valid_count),
                                                            n))
    num_q = q.shape[0]
    vals = torch.full((num_q, k), NEG_INF, dtype=torch.float32, device=dev)
    idxs = torch.full((num_q, k), -1, dtype=torch.int32, device=dev)
    block_size = max(1, min(block_size, n))
    # blocks wholly past valid_count only add -inf entries, which the
    # final (-inf -> -1) rewrite turns into pads anyway
    for start in range(0, valid_count, block_size):
        stop = min(start + block_size, n)
        scores = block_scores(q, corpus[start:stop])
        g_idx = torch.arange(start, stop, dtype=torch.int32, device=dev)
        live = g_idx < valid_count
        if live_mask is not None:
            live = live & live_mask[start:stop].to(dev)
        scores = torch.where(live[None, :], scores,
                             torch.full_like(scores, NEG_INF))
        vals, idxs = merge_topk(vals, idxs, scores,
                                g_idx[None, :].expand(num_q, -1), k)
    idxs = torch.where(vals == NEG_INF, torch.full_like(idxs, -1), idxs)
    return vals, idxs
