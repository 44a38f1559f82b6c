"""One sharded training step and one sharded IVF-PQ query on an N-device mesh.

    python -m rag_foundation_tpu_torch.tools.dryrun_multichip --devices 8
    python -m rag_foundation_tpu_torch.tools.dryrun_multichip --devices 8 \\
        --device cpu

Counterpart of ``__graft_entry__.dryrun_multichip(n)``: the same mesh
rule (``data = 2`` when N is even and at least 4, the rest on "shard"),
the same tiny encoder config, seeded numpy corpus, centroids and token
ids, and the same checks: the step of
``parallel.train_step.make_sharded_train_step`` (contrastive update with
the batch over "data", ``sharded_topk`` k=4, ``assign_clusters``), then,
with more than one shard, ``build_ivf_pq`` (packed, no refine) split
over a one-row mesh and ``sharded_ivfpq_search`` (nprobe_local 2, p 4).
The mesh is N logical devices on one: ``[card] * N`` (``--device cpu``:
``[cpu] * N``, the plain versions of the kernels). Prints
``dryrun_multichip OK: mesh=... loss=...``; a failed check raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rag_foundation_tpu_torch.engine.ivfpq import build_ivf_pq
from rag_foundation_tpu_torch.models.encoder import EncoderConfig, init_params
from rag_foundation_tpu_torch.models.optim import adam
from rag_foundation_tpu_torch.ops.l2norm import l2_normalize
from rag_foundation_tpu_torch.parallel.mesh import make_mesh, shard_rows
from rag_foundation_tpu_torch.parallel.sharded_ivf import (
    shard_ivfpq_index, sharded_ivfpq_search)
from rag_foundation_tpu_torch.parallel.train_step import \
    make_sharded_train_step
from rag_foundation_tpu_torch.utils.device import resolve_device

# __graft_entry__.dryrun_multichip's config and shapes
CONFIG = EncoderConfig(vocab_size=512, hidden=64, layers=2, heads=4, ffn=128,
                       max_len=32)
K, NLIST = 4, 8


def mesh_shape(n_devices: int) -> tuple[int, int]:
    """(data, shard) of an ``n_devices`` mesh: JAX's rule."""
    data = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    return data, n_devices // data


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int,
                     device: str | torch.device = "cuda") -> dict:
    """Run the step and the query; returns the mesh shape, the loss and
    the step's outputs (on the device)."""
    dev = resolve_device(device)
    cfg = CONFIG
    data, shards = mesh_shape(n_devices)
    mesh = make_mesh(shards, data=data, devices=[dev] * n_devices)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    step = make_sharded_train_step(cfg, adam(1e-4), mesh, k=K, block_size=32)

    rng = np.random.default_rng(0)
    n_corpus = 64 * shards
    corpus = rng.standard_normal((n_corpus, cfg.hidden)).astype(np.float32)
    centroids = rng.standard_normal((NLIST, cfg.hidden)).astype(np.float32)
    batch = 4 * data
    q_ids = np.zeros((batch, cfg.max_len), np.int32)
    q_ids[:, 0] = 1
    q_ids[:, 1:8] = rng.integers(3, 500, (batch, 7))
    d_ids = np.roll(q_ids, 1, axis=1)

    out = step(params, torch.as_tensor(q_ids, device=dev),
               torch.as_tensor(d_ids, device=dev),
               shard_rows(mesh, torch.as_tensor(corpus, device=dev)),
               torch.as_tensor(centroids, device=dev))
    loss = float(out.loss)
    _check(np.isfinite(loss), f"non-finite loss {loss}")
    _check(tuple(out.indices.shape) == (batch, K),
           f"indices of shape {tuple(out.indices.shape)}")
    _check(tuple(out.assign.shape) == (batch,),
           f"assign of shape {tuple(out.assign.shape)}")

    if shards > 1:
        pq_mesh = make_mesh(shards, devices=[dev] * shards)
        pqn, pqd = 512 * shards, 64
        pv = l2_normalize(torch.as_tensor(
            rng.standard_normal((pqn, pqd)).astype(np.float32), device=dev))
        pq_idx = build_ivf_pq(pv, nlist=2 * shards, m=8,
                              generator=torch.Generator(
                                  device=dev).manual_seed(1),
                              packed=True, refine=False)
        pq_vals, pq_rows = sharded_ivfpq_search(
            shard_ivfpq_index(pq_idx, pq_mesh), pv[:8], 5, mesh=pq_mesh,
            nprobe_local=2, p=4)
        _check(tuple(pq_rows.shape) == (8, 5),
               f"IVF-PQ rows of shape {tuple(pq_rows.shape)}")
        _check(bool(torch.isfinite(pq_vals[:, 0]).all()),
               "an IVF-PQ query found no row")
    print(f"dryrun_multichip OK: mesh={dict(mesh.shape)} loss={loss:.4f}",
          flush=True)
    return {"mesh": dict(mesh.shape), "loss": loss, "out": out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="logical devices of the mesh (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="the device they all are (default: the card)")
    args = ap.parse_args()
    dryrun_multichip(args.devices, args.device)


if __name__ == "__main__":
    main()
