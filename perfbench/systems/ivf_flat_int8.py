"""The system under test for ``mode: ivf_flat_int8``: a ``StoreIndex``
whose int8 IVF-Flat body is built on the device from the corpus
generator (``engine/ivf.py::build_ivf_flat_device``, the path
``Engine.pad_store`` takes) and published with ``adopt_body``."""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.systems import Built, synchronize
from rag_foundation_tpu_torch.engine.index import StoreIndex
from rag_foundation_tpu_torch.engine.ivf import build_ivf_flat_device


def build(cfg: dict, corpus, device) -> Built:
    n, d = cfg["rows"], cfg["dim"]
    store = StoreIndex(d, mode="ivf_flat_int8", nlist=cfg["nlist"],
                       nprobe=cfg["nprobe"], ivf_p=cfg["ivf_p"],
                       seed=cfg["build_seed"], device=device)
    synchronize(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(cfg["build_seed"])
    body, overflow = build_ivf_flat_device(
        corpus.block, n, d, cfg["nlist"], generator=gen, device=device,
        capacity_slack=cfg["capacity_slack"], chunk=corpus.block_rows,
        scale=cfg["scale"])
    ids = np.arange(n, dtype=np.int64)
    ids[overflow] = -1
    store.adopt_body(body, ids)
    synchronize(device)
    return Built(store, time.perf_counter() - t0, stored_rows, spill=False)


def stored_rows(store: StoreIndex, rows: torch.Tensor) -> torch.Tensor:
    """The int8 list rows the body holds for corpus rows ``rows`` (rows
    it does not hold read as zeros)."""
    body = store.body
    flat_ids = body.row_ids.reshape(-1).long()
    live = torch.nonzero(flat_ids >= 0).squeeze(1)
    where = torch.full((len(store.body_chunk_ids),), -1, dtype=torch.int64,
                       device=flat_ids.device)
    where[flat_ids[live]] = live
    pos = where[rows]
    got = body.lists.reshape(-1, body.lists.shape[-1])[pos.clamp(min=0)]
    return torch.where(pos[:, None] >= 0, got, torch.zeros_like(got))
