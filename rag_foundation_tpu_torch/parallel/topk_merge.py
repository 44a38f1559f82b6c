"""Distributed top-k: a per-shard exact scan, then a merge on the lead device.

Counterpart of ``rag_foundation_tpu/parallel/topk_merge.py``. Each shard
scans its row block with the streaming exact top-k (``ops/topk.py``),
offsets its local indices into the global id space, and its ``[Q, k]``
candidates move to the lead device (the counterpart of the ICI
``all_gather``: ``n_shards * Q * k * 8`` bytes, independent of the
corpus size), where one stable top-k merges them. On a mesh that spans
processes, each process's candidates first go to every process through
one ``torch.distributed.all_gather`` of values and one of ids, so every
process merges the same ``[n_shards, Q, k]`` and returns the same
result.

Determinism: results are bit-identical to a single-device scan of the
concatenated corpus. The candidates are concatenated shard-major, so
their order is the global index order (``all_gather`` returns them in
rank order, and process r holds global shards ``r * n`` onward), and the
stable selection keeps the first of equal scores (``lax.top_k``'s
lowest-position rule; ``torch.topk`` promises no order among ties).
Nothing in the per-shard loop waits for a device, so shards on different
cards run together.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.distributed as dist

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


def gather_over_processes(vals: Sequence[torch.Tensor],
                          ids: Sequence[torch.Tensor], k: int,
                          lead: torch.device
                          ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Every process's per-shard ``[Q, k_s]`` candidates, in global
    shard order, on ``lead``: each set padded to ``k`` columns with
    ``(-inf, -1)`` (a fixed shape on every process), then one
    ``all_gather`` of the values and one of the ids. Every process must
    call it, in the same order as its other collectives.

    gloo gathers host tensors: there the candidates are staged through
    host memory on every call (``8 * n_local * Q * k`` bytes each way).
    Other backends gather them on the card."""
    def padded(t, value):
        t = place(t, lead)
        return torch.nn.functional.pad(t, (0, k - t.shape[1]), value=value)

    v = torch.stack([padded(t, NEG_INF) for t in vals])
    i = torch.stack([padded(t, -1) for t in ids])
    if dist.get_backend() == "gloo":
        v, i = v.cpu(), i.cpu()
    world = dist.get_world_size()
    all_v = [torch.empty_like(v) for _ in range(world)]
    all_i = [torch.empty_like(i) for _ in range(world)]
    dist.all_gather(all_v, v)
    dist.all_gather(all_i, i)
    return (list(place(torch.cat(all_v), lead).unbind()),
            list(place(torch.cat(all_i), lead).unbind()))


def merge_over_mesh(vals: Sequence[torch.Tensor],
                    ids: Sequence[torch.Tensor], k: int, mesh: Mesh
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``merge_shard_candidates`` of this process's shards' candidates
    (global ids) on ``mesh.lead``; on a mesh that spans processes, of
    every process's (``gather_over_processes``)."""
    if mesh.spans_processes:
        vals, ids = gather_over_processes(vals, ids, k, mesh.lead)
    return merge_shard_candidates(vals, ids, k, mesh.lead)


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
      corpus_sharded: this process's row blocks of ``shard_rows``, each
        ``[N / n_shards, d]`` on its shard's device.
      valid_counts: live-row count of each of those blocks (rows past it
        never appear); None = all rows live. A tensor is read once,
        before the shards are issued.
      mesh: mesh with a "shard" axis (on a mesh that spans processes,
        every process calls this with its own blocks).

    Returns ``(values [Q, k] f32, global_indices [Q, k] int32)`` on the
    lead device, ties toward the lower global index, pads ``(-inf, -1)``.
    """
    n_shards = len(mesh.devices)
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
        offset = (mesh.shard_offset + s) * shard_rows
        with on_device(dev):
            v, i = exact_topk(place(queries, dev), block, k,
                              valid_count=counts[s], block_size=block_size)
            vals.append(v)
            ids.append(torch.where(i >= 0, i + offset,
                                   torch.full_like(i, -1)))
    return merge_over_mesh(vals, ids, k, mesh)
