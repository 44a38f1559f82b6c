"""Host-side int8 vector archive: the beyond-device-memory tier of the
memory ladder.

The port's own copy of ``rag_foundation_tpu/engine/archive.py`` (numpy
only). The archive keeps ONE int8 copy of every vector on the host (RAM,
or a memmap under the store's data dir), and serves three roles:

1. **Build source** — ``build_ivf_pq_streaming`` reads it in chunks, so
   an IVF-PQ body of any size is (re)built without a device-resident
   f32 corpus.
2. **Refine tier** — after the device ADC scan returns top-C candidate
   rows, ``rescore`` re-ranks them against exact int8 dot products on
   the host when the int8 table does not fit the card
   (``pq_refine="host"``).
3. **Persistence** — PQ codes are lossy; the archive is the
   rebuild-fidelity source.

Rows are L2-normalized upstream, so a fixed symmetric scale of 1/127
loses nothing; the scale is stored anyway for forward compatibility.
"""

from __future__ import annotations

import os

import numpy as np

_GROW = 1.5
_MIN_CAP = 4096
_RESCORE_CHUNK_ELEMS = 1 << 22   # f32 temp cap per rescore slab (~16 MB)


class HostArchive:
    """Append-only int8 row store with exact rescoring."""

    def __init__(self, dim: int, *, path: str | None = None,
                 scale: float = 1.0 / 127.0):
        self.dim = dim
        self.scale = float(scale)
        self.path = path
        self.n = 0
        self._cap = 0
        self._rows: np.ndarray | None = None

    # -- storage ----------------------------------------------------------
    def reserve(self, total_rows: int) -> None:
        """Pre-allocate EXACT capacity (bulk loads of known size — the
        1.5x growth factor would waste tens of GB on a large store)."""
        self._ensure(max(0, total_rows - self.n), exact=True)

    def _ensure(self, extra: int, *, exact: bool = False) -> None:
        need = self.n + extra
        if self._rows is not None and need <= self._cap:
            return
        new_cap = need if exact else max(_MIN_CAP, int(need * _GROW))
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            grown = np.memmap(self.path + ".grow", dtype=np.int8,
                              mode="w+", shape=(new_cap, self.dim))
        else:
            grown = np.empty((new_cap, self.dim), np.int8)
        if self._rows is not None and self.n:
            grown[: self.n] = self._rows[: self.n]
        if self.path:
            # swap after the copy completes; the OLD mapping is only
            # dropped (GC'd), never closed — racing readers (host-refine
            # rescores) may still hold views into it, and the inode
            # stays valid on Linux until the last mapping goes away
            grown.flush()
            os.replace(self.path + ".grow", self.path)
            grown = np.memmap(self.path, dtype=np.int8, mode="r+",
                              shape=(new_cap, self.dim))
        self._rows = grown
        self._cap = new_cap

    def append(self, vecs: np.ndarray) -> tuple[int, int]:
        """Quantize + append f32 (or pass through int8) rows; returns the
        (start, end) row range."""
        n = len(vecs)
        if n == 0:
            return self.n, self.n
        self._ensure(n)
        lo = self.n
        if vecs.dtype == np.int8:
            self._rows[lo: lo + n] = vecs
        else:
            q = np.clip(np.rint(np.asarray(vecs, np.float32) / self.scale),
                        -127, 127)
            self._rows[lo: lo + n] = q.astype(np.int8)
        self.n += n
        return lo, self.n

    # -- reads ------------------------------------------------------------
    def chunk_i8(self, lo: int, hi: int) -> np.ndarray:
        return self._rows[lo:hi]

    def chunk_f32(self, lo: int, hi: int) -> np.ndarray:
        return self._rows[lo:hi].astype(np.float32) * self.scale

    def rows_f32(self, idx: np.ndarray) -> np.ndarray:
        safe = np.clip(idx, 0, max(0, self.n - 1))
        return self._rows[safe].astype(np.float32) * self.scale

    def rows_i8(self, idx: np.ndarray) -> np.ndarray:
        """Raw int8 rows (scale applies) — the spill re-encode source:
        a quarter of the bytes of rows_f32."""
        safe = np.clip(idx, 0, max(0, self.n - 1))
        return self._rows[safe]

    def rescore(self, q32: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Exact scores for candidate ``rows [Q, C]`` (int; -1 = pad)
        against queries ``q32 [Q, d]``: f32 result with -inf at pads.

        Chunked over Q so the f32 copy of the gathered rows stays
        cache-sized, and batched-GEMV via ``np.matmul`` (BLAS path). The
        JAX package's native C++ rescore is not ported."""
        q = np.ascontiguousarray(q32, np.float32)
        rows = np.asarray(rows)
        safe = np.clip(rows, 0, max(0, self.n - 1))
        out = np.empty(rows.shape, np.float32)
        step = max(1, _RESCORE_CHUNK_ELEMS
                   // max(1, rows.shape[1] * self.dim))
        for lo in range(0, rows.shape[0], step):
            hi = min(rows.shape[0], lo + step)
            gathered = self._rows[safe[lo:hi]]        # [q, C, d] int8
            out[lo:hi] = np.matmul(gathered.astype(np.float32),
                                   q[lo:hi, :, None])[:, :, 0]
        out *= self.scale
        return np.where(rows >= 0, out, -np.inf)

    # -- lifecycle --------------------------------------------------------
    def compact(self, keep: np.ndarray,
                path: str | None = None) -> "HostArchive":
        """New archive with only ``keep``-masked rows (tombstone sweep),
        chunked so no f32 copy of the table ever exists."""
        out = HostArchive(self.dim, path=path, scale=self.scale)
        step = 1 << 20
        for lo in range(0, self.n, step):
            hi = min(self.n, lo + step)
            m = keep[lo:hi]
            if m.any():
                out.append(self._rows[lo:hi][m])
        return out

    def state(self) -> dict:
        return {"rows": np.asarray(self._rows[: self.n])
                if self.n else np.zeros((0, self.dim), np.int8),
                "scale": np.float32(self.scale)}

    @classmethod
    def from_state(cls, state: dict, *, path: str | None = None
                   ) -> "HostArchive":
        a = cls(int(state["rows"].shape[1]) if state["rows"].size
                else int(state.get("dim", state["rows"].shape[1])),
                path=path, scale=float(state["scale"]))
        a.append(np.asarray(state["rows"], np.int8))
        return a

    def close(self) -> None:
        # views may be live in racing readers: drop the reference and
        # let GC unmap
        self._rows = None
        self._cap = 0
        self.n = 0
