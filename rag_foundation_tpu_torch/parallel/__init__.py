"""Multi-device parallelism: device mesh, sharded scans, top-k merge, the
sharded training step.

Counterpart of ``rag_foundation_tpu/parallel``: corpus rows (the exact
tier) and IVF posting lists (the body) split over a mesh's "shard" axis,
each shard scanned on its device, and the per-shard ``[Q, k]``
candidates merged on the lead device; a training batch split over its
"data" axis (``train_step``). One process drives its devices, as the
JAX engine's single controller does; a mesh may repeat a device (the
CPU tests shard over ``[cpu] * 8``), and processes joined by
``init_distributed`` share one mesh, its shards spread over them.
"""

from rag_foundation_tpu_torch.parallel.mesh import (init_distributed,
                                                    make_mesh)
from rag_foundation_tpu_torch.parallel.topk_merge import sharded_topk
from rag_foundation_tpu_torch.parallel.train_step import \
    make_sharded_train_step

__all__ = ["init_distributed", "make_mesh", "make_sharded_train_step",
           "sharded_topk"]
