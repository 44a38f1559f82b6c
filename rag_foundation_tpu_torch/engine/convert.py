"""Carry checkpointed index state into the port, and back.

The JAX package's ``StoreIndex.body_state()`` and ``VectorSegment.state()``
return plain numpy dicts (``f_*`` body fields, ``archive_rows`` /
``archive_scale`` for an IVF-PQ store's host archive, ``vectors``/``ids``/
``dim``); so do the port's. These functions turn such a dict into the
port's structures on a device, and a port body into that dict, so a body
trained by either package is scanned, list for list, by the other.
"""

from __future__ import annotations

import numpy as np
import torch

from rag_foundation_tpu_torch.engine.archive import HostArchive
from rag_foundation_tpu_torch.engine.ivf import IVFFlatIndex
from rag_foundation_tpu_torch.engine.ivfpq import IVFPQIndex
from rag_foundation_tpu_torch.engine.segments import VectorSegment
from rag_foundation_tpu_torch.parallel.sharded_ivf import (ShardedBody,
                                                          gather_body)


def body_from_state(state: dict[str, np.ndarray],
                    device: str | torch.device
                    ) -> IVFFlatIndex | IVFPQIndex:
    """The body of a ``body_state()`` dict on ``device``, by its ``kind``:
    ``IVFFlatIndex`` (``f_centroids``, ``f_lists``, ``f_row_ids``,
    ``f_scale``, ``f_n``) or ``IVFPQIndex`` (``f_centroids``,
    ``f_codebook_centroids``, ``f_codes``, ``f_row_ids``, ``f_n`` and,
    unless the checkpoint predates the refine store, ``f_refine`` and
    ``f_refine_scale``)."""
    kind = str(state.get("kind", "IVFFlatIndex"))
    dev = torch.device(device)

    # torch.tensor copies: the body is updated in place by appends, and a
    # loaded npz or a JAX-side array must not be written through
    def on_dev(name: str, dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(state[name], dtype), device=dev)

    if kind == "IVFFlatIndex":
        return IVFFlatIndex(
            centroids=on_dev("f_centroids", np.float32),
            lists=torch.tensor(np.asarray(state["f_lists"]), device=dev),
            row_ids=on_dev("f_row_ids", np.int32),
            scale=float(np.float32(state["f_scale"])),
            n=int(state["f_n"]))
    if kind == "IVFPQIndex":
        # round-1 checkpoints predate the refine store fields
        if "f_refine" in state:
            refine = on_dev("f_refine", np.int8)
        else:
            refine = torch.zeros((0, 0), dtype=torch.int8, device=dev)
        return IVFPQIndex(
            centroids=on_dev("f_centroids", np.float32),
            codebook_centroids=on_dev("f_codebook_centroids", np.float32),
            codes=on_dev("f_codes", np.uint8),
            row_ids=on_dev("f_row_ids", np.int32),
            n=int(state["f_n"]),
            refine=refine,
            refine_scale=float(np.float32(state.get("f_refine_scale", 1.0))))
    raise ValueError(f"unknown body kind {kind!r}")


def body_to_state(body: IVFFlatIndex | IVFPQIndex | ShardedBody
                  ) -> dict[str, np.ndarray]:
    """The ``f_*`` fields of ``body_state()`` for a port body. A sharded
    body saves what the unsharded one would (JAX's ``np.asarray`` of a
    sharded array gathers it likewise)."""
    if isinstance(body, ShardedBody):
        body = gather_body(body)
    out = {}
    for name, val in body._asdict().items():
        if isinstance(val, torch.Tensor):
            out["f_" + name] = val.cpu().numpy()
        elif isinstance(val, int):
            out["f_" + name] = np.int64(val)
        else:
            out["f_" + name] = np.asarray(np.float32(val))
    return out


def archive_from_state(state: dict[str, np.ndarray], *,
                       path: str | None = None) -> HostArchive | None:
    """The host int8 archive saved beside an IVF-PQ body
    (``archive_rows``, ``archive_scale``), or None when the dict has
    none."""
    if "archive_rows" not in state:
        return None
    return HostArchive.from_state(
        {"rows": np.asarray(state["archive_rows"], np.int8),
         "scale": state["archive_scale"]}, path=path)


def segment_from_state(state: dict, device: str | torch.device
                       ) -> VectorSegment:
    """``VectorSegment`` from a ``state()`` dict (``vectors``, ``ids``,
    ``dim``)."""
    return VectorSegment.from_state(state, device=device)
