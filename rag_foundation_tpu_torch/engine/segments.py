"""Streaming-insert vector segment on a device buffer.

Counterpart of ``rag_foundation_tpu/engine/segments.py``. A PyTorch
tensor can be written in place, so appends copy the new rows into a
preallocated buffer (no donation needed); capacity grows by
reallocation + copy (amortized O(1)); deletes are tombstones applied as
a mask inside the scan and reclaimed by compaction. Row ids stay on the
host: only the host maps scan positions to chunk ids.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from rag_foundation_tpu_torch.ops.topk import exact_topk
from rag_foundation_tpu_torch.utils.device import resolve_device

_BLOCK = 1024  # capacity granularity


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


class VectorSegment:
    """A growable [capacity, dim] unit-vector buffer with int32 chunk ids.

    Thread-safe: an internal lock serializes mutations AND searches (a
    growth swaps the buffer a concurrent reader may be scanning).
    """

    def __init__(self, dim: int, *, device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32, capacity: int = _BLOCK):
        self._lock = threading.RLock()
        self.dim = dim
        self.dtype = dtype
        self.device = resolve_device(device)
        capacity = _round_up(capacity, _BLOCK)
        self._buf = torch.zeros((capacity, dim), dtype=dtype,
                                device=self.device)
        self._ids = np.full((capacity,), -1, np.int32)
        self._count = 0          # rows ever written (front-packed)
        self._dead: set[int] = set()  # tombstoned chunk ids
        self._live_mask_dev: torch.Tensor | None = None

    # -- capacity ---------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._buf.shape[0]

    @property
    def count(self) -> int:
        return self._count

    @property
    def live_count(self) -> int:
        return self._count - len(self._dead)

    def _grow_to(self, need: int) -> None:
        new_cap = self.capacity
        while new_cap < need:
            new_cap *= 2
        if new_cap != self.capacity:
            buf = torch.zeros((new_cap, self.dim), dtype=self.dtype,
                              device=self.device)
            buf[: self._count] = self._buf[: self._count]
            self._buf = buf
            ids = np.full((new_cap,), -1, np.int32)
            ids[: self._count] = self._ids[: self._count]
            self._ids = ids
            self._live_mask_dev = None

    # -- mutation ---------------------------------------------------------
    def add(self, vecs, ids: np.ndarray) -> None:
        """Append ``vecs [n, dim]`` (already unit-norm) with chunk ids."""
        n = int(vecs.shape[0])
        if n == 0:
            return
        with self._lock:
            self._grow_to(self._count + n)
            rows = vecs if isinstance(vecs, torch.Tensor) \
                else torch.from_numpy(np.array(vecs, np.float32))
            self._buf[self._count: self._count + n] = rows.to(
                device=self.device, dtype=self.dtype)
            self._ids[self._count: self._count + n] = np.asarray(ids,
                                                                 np.int32)
            self._count += n
            self._live_mask_dev = None

    def delete_ids(self, ids: set[int]) -> None:
        with self._lock:
            self._dead |= ids
            self._live_mask_dev = None

    def compact(self) -> None:
        """Physically drop tombstoned rows (copy-on-compact)."""
        with self._lock:
            self._compact_locked()

    def _compact_locked(self) -> None:
        if not self._dead:
            return
        ids_host = self._ids[: self._count]
        keep = ~np.isin(ids_host, np.fromiter(self._dead, np.int64,
                                              len(self._dead)))
        kept_idx = np.nonzero(keep)[0]
        new_count = int(kept_idx.size)
        cap = _round_up(max(new_count, 1), _BLOCK)
        buf = torch.zeros((cap, self.dim), dtype=self.dtype,
                          device=self.device)
        ids_new = np.full((cap,), -1, np.int32)
        if new_count:
            buf[:new_count] = self._buf[torch.as_tensor(
                kept_idx, device=self.device)]
            ids_new[:new_count] = ids_host[kept_idx]
        self._buf = buf
        self._ids = ids_new
        self._count = new_count
        self._dead.clear()
        self._live_mask_dev = None

    # -- query ------------------------------------------------------------
    def _live_mask(self) -> torch.Tensor | None:
        if not self._dead:
            return None
        if self._live_mask_dev is None:
            mask = ~np.isin(self._ids[: self._count],
                            np.fromiter(self._dead, np.int64,
                                        len(self._dead)))
            self._live_mask_dev = torch.as_tensor(mask, device=self.device)
        return self._live_mask_dev

    def search(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Return ``(scores [Q, k] f32, chunk_ids [Q, k] int32)``.

        Missing results (store smaller than k) have score=-inf, id=-1.
        """
        return self.search_finalize(self.search_dispatch(queries, k))

    def search_dispatch(self, queries, k: int):
        """Launch the scan WITHOUT fetching results — the handle goes to
        ``search_finalize``. Lets StoreIndex queue the tail scan behind
        the body scan and fetch both after."""
        q_n = int(queries.shape[0])
        with self._lock:
            if self._count == 0:
                return (q_n, k, None)
            q = torch.as_tensor(np.asarray(queries, np.float32)) \
                if not isinstance(queries, torch.Tensor) else queries
            vals, idxs = exact_topk(q.to(self.device),
                                    self._buf[: self._count], k,
                                    live_mask=self._live_mask())
            ids_h = self._ids[: self._count].copy()
        return (q_n, k, (vals, idxs, ids_h))

    def search_finalize(self, handle) -> tuple[np.ndarray, np.ndarray]:
        q_n, k, payload = handle
        if payload is None:
            return (np.full((q_n, k), -np.inf, np.float32),
                    np.full((q_n, k), -1, np.int32))
        vals, idxs, ids_h = payload
        vals_h = vals.cpu().numpy()
        idx_h = idxs.cpu().numpy()
        out_ids = np.where(idx_h >= 0, ids_h[np.clip(idx_h, 0, None)], -1)
        out_ids = np.where(np.isneginf(vals_h), -1, out_ids)
        return vals_h, out_ids

    # -- persistence ------------------------------------------------------
    def state(self) -> dict:
        with self._lock:
            self._compact_locked()
            return {
                "vectors": self._buf[: self._count].float().cpu().numpy(),
                "ids": self._ids[: self._count].copy(),
                "dim": self.dim,
            }

    @classmethod
    def from_state(cls, state: dict, *, device: str | torch.device = "cuda",
                   dtype: torch.dtype = torch.float32) -> "VectorSegment":
        seg = cls(int(state["dim"]), device=device, dtype=dtype,
                  capacity=max(_BLOCK, len(state["ids"])))
        if len(state["ids"]):
            seg.add(state["vectors"], state["ids"])
        return seg
