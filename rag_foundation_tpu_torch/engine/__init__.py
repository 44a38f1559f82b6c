"""The index-and-query engine on PyTorch (counterpart of
``rag_foundation_tpu.engine``): encoder -> index (exact / IVF-Flat f32
or int8) -> CUDA list-scan kernel. The host control plane talks to it
through ``engine.api.Engine`` or over ``engine.rpc``."""

from rag_foundation_tpu_torch.engine.api import (Engine, EngineConfig,
                                                 SearchHit)

__all__ = ["Engine", "EngineConfig", "SearchHit"]
