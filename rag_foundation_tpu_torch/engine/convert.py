"""Carry checkpointed index state into the port.

The JAX package's ``StoreIndex.body_state()`` and ``VectorSegment.state()``
return plain numpy dicts (``f_*`` body fields, ``vectors``/``ids``/
``dim``); so do the port's. These functions turn such a dict into the
port's structures on a device, so a body trained by either package is
scanned, list for list, by the other.
"""

from __future__ import annotations

import numpy as np
import torch

from rag_foundation_tpu_torch.engine.ivf import IVFFlatIndex
from rag_foundation_tpu_torch.engine.segments import VectorSegment


def body_from_state(state: dict[str, np.ndarray],
                    device: str | torch.device) -> IVFFlatIndex:
    """``IVFFlatIndex`` from a ``body_state()`` dict (keys ``kind``,
    ``f_centroids``, ``f_lists``, ``f_row_ids``, ``f_scale``, ``f_n``)."""
    kind = str(state.get("kind", "IVFFlatIndex"))
    if kind != "IVFFlatIndex":
        raise ValueError(f"body kind {kind!r} not ported yet")
    dev = torch.device(device)
    # torch.tensor copies: the body is updated in place by appends, and a
    # loaded npz or a JAX-side array must not be written through
    return IVFFlatIndex(
        centroids=torch.tensor(np.asarray(state["f_centroids"], np.float32),
                               device=dev),
        lists=torch.tensor(np.asarray(state["f_lists"]), device=dev),
        row_ids=torch.tensor(np.asarray(state["f_row_ids"], np.int32),
                             device=dev),
        scale=float(np.float32(state["f_scale"])),
        n=int(state["f_n"]))


def body_to_state(body: IVFFlatIndex) -> dict[str, np.ndarray]:
    """The ``f_*`` fields of ``body_state()`` for a port body."""
    return {"f_centroids": body.centroids.cpu().numpy(),
            "f_lists": body.lists.cpu().numpy(),
            "f_row_ids": body.row_ids.cpu().numpy(),
            "f_scale": np.asarray(np.float32(body.scale)),
            "f_n": np.int64(body.n)}


def segment_from_state(state: dict, device: str | torch.device
                       ) -> VectorSegment:
    """``VectorSegment`` from a ``state()`` dict (``vectors``, ``ids``,
    ``dim``)."""
    return VectorSegment.from_state(state, device=device)
