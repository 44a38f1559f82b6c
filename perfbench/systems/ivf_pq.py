"""The system under test for ``mode: ivf_pq``: a ``StoreIndex`` filled
as a mass import (rows quantized on the device into a ``HostArchive``,
then ``StoreIndex.bulk_load_archive``: the streaming IVF-PQ build with
its int8 re-rank table on the device). Only the bulk load is timed as
the build; the archive fill is the import's input."""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.systems import Built, synchronize
from rag_foundation_tpu_torch.engine.archive import HostArchive
from rag_foundation_tpu_torch.engine.index import StoreIndex
from rag_foundation_tpu_torch.ops.quantize import quantize_with_scale


def build(cfg: dict, corpus, device) -> Built:
    n, d = cfg["rows"], cfg["dim"]
    store = StoreIndex(d, mode="ivf_pq", nlist=cfg["nlist"],
                       nprobe=cfg["nprobe"], pq_m=cfg["pq_m"],
                       pq_nbits=cfg["pq_nbits"], pq_refine="device",
                       pq_packed=cfg["pq_packed"],
                       pq_cap_slack=cfg["pq_cap_slack"], ivf_p=cfg["ivf_p"],
                       seed=cfg["build_seed"], device=device)
    archive = HostArchive(d, scale=cfg["scale"])
    archive.reserve(n)
    for _, _, x in corpus.blocks():
        archive.append(quantize_with_scale(x, archive.scale).cpu().numpy())
    synchronize(device)
    t0 = time.perf_counter()
    store.bulk_load_archive(archive, np.arange(n, dtype=np.int64))
    synchronize(device)
    return Built(store, time.perf_counter() - t0, stored_rows, spill=True,
                 codes=codes)


def stored_rows(store: StoreIndex, rows: torch.Tensor) -> torch.Tensor:
    """The int8 re-rank rows the body holds for corpus rows ``rows``."""
    return store.body.refine[rows]


def codes(store: StoreIndex) -> dict:
    """The codebook ``[m, K, dsub]`` and the codes ``[nlist, cap, m]``
    (one code a byte)."""
    body = store.body
    if body.packed:
        raise ValueError("the reference reads one code a byte")
    return {"codebook": body.codebook_centroids.float().clone(),
            "codes": body.codes}
