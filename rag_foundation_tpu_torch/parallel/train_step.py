"""The sharded training step: an encoder update over the mesh's "data"
axis, then retrieval and routing of the fresh query embeddings.

Counterpart of ``full_step`` in ``__graft_entry__.dryrun_multichip``
(``__graft_entry__.py:87-99``), which JAX jits over a ``(data, shard)``
mesh: the contrastive update with the batch sharded on "data",
``sharded_topk`` of the updated encoder's query embeddings over a
row-sharded corpus, and ``assign_clusters`` of them to centroids.

Data parallelism without changing the step: each data row encodes its
part of the batch on its device, and the parts' embeddings are
gathered, with their gradients, onto the lead device, so ``info_nce``
takes its in-batch negatives over the GLOBAL batch (logits ``[B, B]``)
as JAX's ``contrastive_loss`` does. A loss per row (plain DDP) would be
another loss with other gradients. One backward then one optimizer
update of the parameters, which live on the lead device: a row on
another device reads a differentiable copy of them (``mesh.place``), so
autograd sums every row's gradient into the lead's ``.grad`` before the
update; rows on the lead's own device use the tensors themselves and
autograd sums their gradients alike. Either way the step is the step of
the global batch, equal to a ``data=1`` step on it.

One process holds the mesh (JAX's dryrun is one program too): a mesh
that spans processes raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rag_foundation_tpu_torch.models.encoder import (EncoderConfig, _map,
                                                     encode_tokens,
                                                     info_nce, make_step)
from rag_foundation_tpu_torch.models.optim import OptimizerFactory
from rag_foundation_tpu_torch.ops.kmeans import assign_clusters
from rag_foundation_tpu_torch.parallel.mesh import Mesh, on_device, place
from rag_foundation_tpu_torch.parallel.topk_merge import sharded_topk


class ShardedStepOut(NamedTuple):
    """What one sharded step returns, on the mesh's lead device (the
    parameters and the optimizer state are updated in place)."""
    loss: torch.Tensor       # 0-d f32, the global batch's, detached
    values: torch.Tensor     # [B, k] f32, sharded_topk of ``queries``
    indices: torch.Tensor    # [B, k] int32 global corpus rows
    assign: torch.Tensor     # [B] int32 nearest centroid of each query
    queries: torch.Tensor    # [B, hidden] f32 query embeddings after the
                             # update, in batch order


def make_sharded_train_step(cfg: EncoderConfig, optimizer: OptimizerFactory,
                            mesh: Mesh, *, k: int, block_size: int = 8192,
                            temperature: float = 0.05,
                            symmetric: bool = False,
                            max_grad_norm: float | None = None):
    """A ``(params, q_ids, d_ids, corpus_sharded, centroids) ->
    ShardedStepOut`` step over ``mesh``: the contrastive update of
    ``params`` (``make_step``: gradients, optional clipping to
    ``max_grad_norm``, one step of ``optimizer``, whose state it keeps)
    with the batch split over the mesh's "data" rows, then, on the
    updated parameters, the top-``k`` of the query embeddings over
    ``corpus_sharded`` (``shard_rows`` of the mesh) and their nearest of
    ``centroids [nlist, hidden]``, each row routing its own part.

    The batch (``q_ids``, ``d_ids [B, S]``, any device) must divide by
    the data rows; ``params`` live on ``mesh.lead``."""
    if mesh.spans_processes:
        raise ValueError("the sharded training step needs a mesh that one "
                         "process holds")
    rows = [row[0] for row in mesh.grid]     # each data row's device
    lead = mesh.lead

    def split(ids: torch.Tensor) -> tuple[torch.Tensor, ...]:
        if ids.shape[0] % len(rows):
            raise ValueError(f"a batch of {ids.shape[0]} does not divide "
                             f"over {len(rows)} data rows")
        return ids.chunk(len(rows))

    def embed_parts(params: dict, ids: torch.Tensor) -> list[torch.Tensor]:
        """Each row's embeddings of its part of ``ids``, on its device."""
        parts = []
        for dev, part in zip(rows, split(ids)):
            with on_device(dev):
                replica = _map(params, lambda _, t: place(t, dev))
                parts.append(encode_tokens(replica, place(part, dev), cfg))
        return parts

    def gathered(parts: list[torch.Tensor]) -> torch.Tensor:
        return torch.cat([place(p, lead) for p in parts])

    def loss_fn(params: dict, q_ids: torch.Tensor,
                d_ids: torch.Tensor) -> torch.Tensor:
        return info_nce(gathered(embed_parts(params, q_ids)),
                        gathered(embed_parts(params, d_ids)),
                        temperature, symmetric)

    update = make_step(loss_fn, optimizer, max_grad_norm=max_grad_norm)

    def step(params: dict, q_ids: torch.Tensor, d_ids: torch.Tensor,
             corpus_sharded, centroids: torch.Tensor) -> ShardedStepOut:
        loss = update(params, q_ids, d_ids)
        with torch.no_grad():
            parts = embed_parts(params, q_ids)
            assign = []
            for dev, part in zip(rows, parts):
                with on_device(dev):
                    assign.append(assign_clusters(
                        part, place(centroids, dev),
                        block_size=block_size)[0])
            queries = gathered(parts)
            vals, idxs = sharded_topk(queries, corpus_sharded, k, mesh=mesh,
                                      block_size=block_size)
        return ShardedStepOut(loss, vals, idxs, gathered(assign), queries)

    return step
