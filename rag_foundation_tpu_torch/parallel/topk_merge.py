"""Distributed top-k: a per-shard exact scan, then a merge on the lead device.

Counterpart of ``rag_foundation_tpu/parallel/topk_merge.py``. Each shard
scans its row block with the streaming exact top-k (``ops/topk.py``),
offsets its local indices into the global id space, and its ``[Q, k]``
candidates move to the lead device (the counterpart of the ICI
``all_gather``: ``n_shards * Q * k * 8`` bytes, independent of the
corpus size), where one stable top-k merges them.

Determinism: results are bit-identical to a single-device scan of the
concatenated corpus. The candidates are concatenated shard-major, so
their order is the global index order, and the stable selection keeps
the first of equal scores (``lax.top_k``'s lowest-position rule;
``torch.topk`` promises no order among ties). Nothing in the per-shard
loop waits for a device, so shards on different cards run together.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from rag_foundation_tpu_torch.ops.topk import exact_topk, stable_topk
from rag_foundation_tpu_torch.parallel.mesh import Mesh, on_device, place

NEG_INF = float("-inf")


def merge_shard_candidates(vals: Sequence[torch.Tensor],
                           ids: Sequence[torch.Tensor], k: int,
                           lead: torch.device
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` of per-shard ``[Q, k_s]`` candidates (global ids, -1
    pads at -inf), concatenated shard-major on ``lead``; ties go to the
    earlier shard, then the earlier column. Returns ``[Q, min(k, sum
    k_s)]``."""
    cat_v = torch.cat([place(v, lead) for v in vals], dim=1)
    cat_i = torch.cat([place(i, lead) for i in ids], dim=1)
    top_v, pos = stable_topk(cat_v, min(k, cat_v.shape[1]))
    return top_v, torch.gather(cat_i, 1, pos)


def sharded_topk(
    queries: torch.Tensor,
    corpus_sharded: Sequence[torch.Tensor],
    k: int,
    *,
    mesh: Mesh,
    valid_counts: Sequence[int] | torch.Tensor | None = None,
    block_size: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a row-sharded corpus.

    Args:
      queries: ``[Q, d]`` on any device (copied to each shard's).
      corpus_sharded: the ``n_shards`` row blocks of ``shard_rows``, each
        ``[N / n_shards, d]`` on its shard's device.
      valid_counts: live-row count of each block (rows past it never
        appear); None = all rows live. A tensor is read once, before the
        shards are issued.
      mesh: mesh with a "shard" axis.

    Returns ``(values [Q, k] f32, global_indices [Q, k] int32)`` on the
    lead device, ties toward the lower global index, pads ``(-inf, -1)``.
    """
    n_shards = mesh.shape["shard"]
    if len(corpus_sharded) != n_shards:
        raise ValueError(f"{len(corpus_sharded)} row blocks for "
                         f"{n_shards} shards")
    shard_rows = corpus_sharded[0].shape[0]
    if any(c.shape[0] != shard_rows for c in corpus_sharded):
        raise ValueError("row blocks differ in length")
    if valid_counts is None:
        counts = [shard_rows] * n_shards
    elif isinstance(valid_counts, torch.Tensor):
        counts = [int(c) for c in valid_counts.tolist()]
    else:
        counts = [int(c) for c in valid_counts]
    vals, ids = [], []
    for s, (block, dev) in enumerate(zip(corpus_sharded,
                                         mesh.devices)):
        with on_device(dev):
            v, i = exact_topk(place(queries, dev), block, k,
                              valid_count=counts[s], block_size=block_size)
            vals.append(v)
            ids.append(torch.where(i >= 0, i + s * shard_rows,
                                   torch.full_like(i, -1)))
    return merge_shard_candidates(vals, ids, k, mesh.lead)
