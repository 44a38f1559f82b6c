"""Multi-device vector store: rows spread over the mesh's shards.

Counterpart of ``rag_foundation_tpu/parallel/sharded_index.py``, the
exact tier (the streaming tail) of a store on a mesh. Each shard keeps a
``[shard_cap, d]`` buffer on its device; inserts fill the least-loaded
shards first (a water fill, so shards stay within one row of each
other); queries run ``sharded_topk`` over the buffers, bit-identical to
one device scanning the shards' rows in shard order. Deletes are
tombstones by id, applied after the scan with a pow2-bucketed
over-fetch, and reclaimed by ``compact``.

Where the JAX store stages every add and compaction through a host copy
of the whole buffer, this one writes the new rows into each shard's
buffer on its device, in place; growth and compaction allocate new
buffers, so a search issued before them still reads the rows it
snapshot.

Thread model: one ``RLock`` serializes mutation against the search
snapshot (``StoreIndex`` calls search and add concurrently).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from rag_foundation_tpu_torch.parallel.mesh import Mesh, on_device
from rag_foundation_tpu_torch.parallel.topk_merge import sharded_topk
from rag_foundation_tpu_torch.utils.shapes import bucket_pow2

_BLOCK = 1024


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


class ShardedVectorStore:
    """Row-sharded ``[n_shards * shard_cap, d]`` store over a mesh's
    "shard" axis, with the ``VectorSegment`` interface."""

    def __init__(self, dim: int, mesh: Mesh, *,
                 shard_capacity: int = _BLOCK,
                 dtype: torch.dtype = torch.float32):
        if mesh.spans_processes:
            raise ValueError("a ShardedVectorStore places rows on every "
                             "shard: it needs a mesh that one process "
                             "holds")
        self.dim = dim
        self.mesh = mesh
        self.n_shards = mesh.shape["shard"]
        self.dtype = dtype
        self._shard_cap = _round_up(shard_capacity, _BLOCK)
        self._lock = threading.RLock()
        self._bufs = [torch.zeros((self._shard_cap, dim), dtype=dtype,
                                  device=dev)
                      for dev in mesh.devices]
        self._counts = np.zeros(self.n_shards, np.int64)
        self._ids = np.full((self.n_shards, self._shard_cap), -1, np.int64)
        self._dead: set[int] = set()

    # -- capacity -----------------------------------------------------------
    @property
    def count(self) -> int:
        return int(self._counts.sum())

    @property
    def live_count(self) -> int:
        return self.count - len(self._dead)

    def _grow_locked(self, new_cap: int) -> None:
        new_cap = _round_up(new_cap, _BLOCK)
        bufs = []
        for buf, dev in zip(self._bufs, self.mesh.devices):
            grown = torch.zeros((new_cap, self.dim), dtype=self.dtype,
                                device=dev)
            grown[: self._shard_cap] = buf
            bufs.append(grown)
        ids = np.full((self.n_shards, new_cap), -1, np.int64)
        ids[:, : self._shard_cap] = self._ids
        self._bufs = bufs
        self._ids = ids
        self._shard_cap = new_cap

    # -- mutation -----------------------------------------------------------
    def add(self, vecs, ids: np.ndarray) -> None:
        """Append, balancing rows across shards (least-loaded first)."""
        n = len(ids)
        if n == 0:
            return
        with self._lock:
            # closed-form balanced allocation (water fill): the common
            # level L by bisection, shards below it topped up, the rest to
            # the lowest-index shards at the level
            counts = self._counts.copy()
            lo, hi = int(counts.min()), int(counts.max()) + n
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if int(np.maximum(mid - counts, 0).sum()) <= n:
                    lo = mid
                else:
                    hi = mid - 1
            alloc = np.maximum(lo - counts, 0)
            rem = n - int(alloc.sum())
            if rem > 0:
                cand = np.nonzero(counts + alloc == lo)[0][:rem]
                alloc[cand] += 1
            max_needed = int((counts + alloc).max())
            if max_needed > self._shard_cap:
                self._grow_locked(max_needed)
            rows = vecs if isinstance(vecs, torch.Tensor) \
                else torch.from_numpy(np.array(vecs, np.float32))
            ids = np.asarray(ids)
            pos = 0
            for s, dev in enumerate(self.mesh.devices):
                m = int(alloc[s])
                if not m:
                    continue
                start = int(self._counts[s])
                with on_device(dev):
                    self._bufs[s][start: start + m] = rows[pos: pos + m].to(
                        device=dev, dtype=self.dtype)
                self._ids[s, start: start + m] = ids[pos: pos + m]
                self._counts[s] += m
                pos += m

    def delete_ids(self, ids: set[int]) -> None:
        with self._lock:
            self._dead |= ids

    def compact(self) -> None:
        """Physically drop tombstoned rows (copy-on-compact, each shard
        keeping its rows' order)."""
        with self._lock:
            if not self._dead:
                return
            dead = np.fromiter(self._dead, np.int64, len(self._dead))
            bufs = []
            for s, (buf, dev) in enumerate(zip(self._bufs,
                                               self.mesh.devices)):
                kept = np.nonzero(~np.isin(
                    self._ids[s, : self._counts[s]], dead))[0]
                m = len(kept)
                new = torch.zeros_like(buf)
                if m:
                    with on_device(dev):
                        new[:m] = buf[torch.as_tensor(kept, device=dev)]
                bufs.append(new)
                new_ids = np.full(self._shard_cap, -1, np.int64)
                new_ids[:m] = self._ids[s, kept]
                self._ids[s] = new_ids
                self._counts[s] = m
            self._bufs = bufs
            self._dead.clear()

    # -- persistence ----------------------------------------------------------
    def state(self) -> dict:
        """Live vectors + ids in shard order (``VectorSegment.state``'s
        contract)."""
        with self._lock:
            self.compact()
            parts_v, parts_i = [], []
            for s in range(self.n_shards):
                m = int(self._counts[s])
                if m:
                    parts_v.append(self._bufs[s][:m].float().cpu().numpy())
                    parts_i.append(self._ids[s, :m].copy())
        if parts_v:
            return {"vectors": np.concatenate(parts_v),
                    "ids": np.concatenate(parts_i), "dim": self.dim}
        return {"vectors": np.zeros((0, self.dim), np.float32),
                "ids": np.zeros((0,), np.int64), "dim": self.dim}

    # -- search ---------------------------------------------------------------
    def search(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """``(scores [Q, k] f32, chunk ids [Q, k] int64)``; missing
        results are ``(-inf, -1)``."""
        return self.search_finalize(self.search_dispatch(queries, k))

    def search_dispatch(self, queries, k: int):
        """Launch the per-shard scans without fetching results; the
        handle goes to ``search_finalize``."""
        q_n = int(queries.shape[0])
        with self._lock:
            counts = self._counts.copy()
            if counts.sum() == 0:
                return (q_n, k, None)
            dead = set(self._dead)
            # pow2-bucketed over-fetch covers the tombstones (the JAX
            # store's rule, so both return the same rows)
            fetch = bucket_pow2(k + len(dead)) if dead else k
            fetch = min(fetch, self._shard_cap * self.n_shards)
            q = queries if isinstance(queries, torch.Tensor) \
                else torch.as_tensor(np.asarray(queries, np.float32))
            vals, idxs = sharded_topk(q, self._bufs, fetch, mesh=self.mesh,
                                      valid_counts=counts)
            flat_ids = self._ids.reshape(-1).copy()
        return (q_n, k, (vals, idxs, flat_ids, dead))

    def search_finalize(self, handle) -> tuple[np.ndarray, np.ndarray]:
        q_n, k, payload = handle
        if payload is None:
            return (np.full((q_n, k), -np.inf, np.float32),
                    np.full((q_n, k), -1, np.int64))
        vals, idxs, flat_ids, dead = payload
        vals = vals.cpu().numpy()
        idxs = idxs.cpu().numpy()
        out_ids = np.where(idxs >= 0, flat_ids[np.clip(idxs, 0, None)], -1)
        if dead:
            mask = np.isin(out_ids, np.fromiter(dead, np.int64, len(dead)))
            vals = np.where(mask, -np.inf, vals)
            out_ids = np.where(mask, -1, out_ids)
            order = np.argsort(-vals, axis=1, kind="stable")
            vals = np.take_along_axis(vals, order, axis=1)
            out_ids = np.take_along_axis(out_ids, order, axis=1)
        out_ids = np.where(np.isneginf(vals), -1, out_ids)
        if vals.shape[1] < k:  # store smaller than k: pad to the contract
            pad = ((0, 0), (0, k - vals.shape[1]))
            vals = np.pad(vals, pad, constant_values=-np.inf)
            out_ids = np.pad(out_ids, pad, constant_values=-1)
        return vals[:, :k], out_ids[:, :k]
