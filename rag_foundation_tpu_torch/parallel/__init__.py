"""Multi-device parallelism: device mesh, sharded scans, top-k merge.

Counterpart of ``rag_foundation_tpu/parallel``: corpus rows (the exact
tier) and IVF posting lists (the body) split over a mesh's "shard" axis,
each shard scanned on its device, and the per-shard ``[Q, k]``
candidates merged on the lead device. One process drives every device,
as the JAX engine's single controller does; a mesh may repeat a device
(the CPU tests shard over ``[cpu] * 8``).
"""

from rag_foundation_tpu_torch.parallel.mesh import make_mesh
from rag_foundation_tpu_torch.parallel.topk_merge import sharded_topk

__all__ = ["make_mesh", "sharded_topk"]
