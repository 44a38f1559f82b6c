"""Per-store index: streaming exact tail + bulk IVF body.

Counterpart of ``rag_foundation_tpu/engine/index.py`` for the modes
``exact``, ``ivf_flat`` and ``ivf_flat_int8`` on one device. Fresh
inserts land in the exact ``VectorSegment`` tail; once the tail
outgrows ``build_threshold``, vectors are compacted into an IVF-Flat
body (k-means + uniform-capacity posting lists) and the tail restarts
empty. Queries scan body (IVF dispatch) and tail (exact top-k) and
merge.

Deletes tombstone in both structures: the tail masks at scan time, the
body filters candidates post-scan and reclaims space at the next
rebuild.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from rag_foundation_tpu_torch.engine.convert import (body_from_state,
                                                     body_to_state)
from rag_foundation_tpu_torch.engine.ivf import (IVFFlatIndex,
                                                 build_ivf_flat, ivf_append,
                                                 ivf_search,
                                                 ivf_search_small)
from rag_foundation_tpu_torch.engine.profile import search_profile
from rag_foundation_tpu_torch.engine.segments import VectorSegment
from rag_foundation_tpu_torch.ops.quantize import (quantize_int8,
                                                   quantize_with_scale)
from rag_foundation_tpu_torch.ops.topk import exact_topk
from rag_foundation_tpu_torch.utils.device import resolve_device
from rag_foundation_tpu_torch.utils.shapes import bucket_pow2

# dispatch-context marker: the tail was empty at snapshot time, so no
# tail scan was launched and the finalize merge is body-only
_EMPTY_TAIL = object()
# exact audit scans: any block size gives the same result (ops/topk.py)
_AUDIT_BLOCK = 65536


def _exact_int8_topk(qq, table8, live, k, block_size: int = 8192):
    """Exact top-k of int8 queries against an int8 row table [N8, d]:
    int8 dots are exact (recall-audit / ground-truth path)."""
    return exact_topk(qq, table8, k, live_mask=live, block_size=block_size)


class StoreIndex:
    """Mode-aware store index: 'exact' | 'ivf_flat' | 'ivf_flat_int8'."""

    def __init__(self, dim: int, *, mode: str = "exact", nlist: int = 256,
                 nprobe: int = 32, build_threshold: int = 100_000,
                 ivf_p: int = 4, approx_routing: bool = False,
                 seed: int = 0, mesh=None,
                 device: str | torch.device = "cuda"):
        if mode == "ivf_pq":
            raise ValueError("index mode 'ivf_pq' not ported yet")
        if mode not in ("exact", "ivf_flat", "ivf_flat_int8"):
            raise ValueError(f"unknown index mode {mode!r}")
        if mesh is not None:
            raise ValueError("mesh sharding not ported yet")
        if approx_routing:
            raise NotImplementedError("approx routing (lax.approx_max_k) "
                                      "is not ported yet")
        self.device = resolve_device(device)
        self.dim = dim
        self.mode = mode
        self.nlist = nlist
        self.nprobe = nprobe
        self.ivf_p = ivf_p
        self.approx_routing = approx_routing
        self.build_threshold = build_threshold
        self.seed = seed
        self.mesh = None
        # serializes body mutation (in-place appends, swaps) vs body reads
        self._body_lock = threading.RLock()
        self.tail = self._new_tail()
        self.body: IVFFlatIndex | None = None
        self.body_chunk_ids: np.ndarray | None = None  # row -> chunk id
        self._dead: set[int] = set()
        # bumped on every persisted-body mutation (rebuild/flush/
        # restore/delete): lets savers skip rewriting an unchanged body
        self.body_version = 0

    def _new_tail(self) -> VectorSegment:
        return VectorSegment(self.dim, device=self.device)

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.seed)

    # -- mutation ---------------------------------------------------------
    @property
    def count(self) -> int:
        body_n = 0 if self.body is None else int(
            (self.body_chunk_ids >= 0).sum())
        return body_n + self.tail.count

    def add(self, vecs: np.ndarray, ids: np.ndarray) -> None:
        self.tail.add(vecs, ids)
        if self.mode == "exact":
            return
        if self.body is None:
            if self.tail.count >= self.build_threshold:
                self.rebuild()
        elif self.tail.count >= max(1024, self.build_threshold // 8):
            self._flush_tail_to_body()

    def _flush_tail_to_body(self) -> None:
        """Streaming insert: append the tail into the existing IVF body
        (no retrain/relayout); capacity overflow triggers a full rebuild
        (which retrains the coarse quantizer and resizes lists)."""
        st = self.tail.state()
        if not len(st["ids"]):
            return
        row_base = len(self.body_chunk_ids)
        new_rows = np.arange(row_base, row_base + len(st["ids"]),
                             dtype=np.int32)
        with self._body_lock:
            new_body, dropped = ivf_append(
                self.body, torch.as_tensor(st["vectors"],
                                           device=self.device), new_rows)
            # only rows that landed extend the id table; dropped rows
            # keep a -1 sentinel and re-enter through the tail + rebuild
            ids64 = np.asarray(st["ids"], np.int64)
            table_ext = np.where(dropped, -1, ids64)
            self.body_chunk_ids = np.concatenate(
                [self.body_chunk_ids, table_ext])
            self.body = new_body
            self.body_version += 1
        self.tail = self._new_tail()
        if dropped.any():
            self.tail.add(st["vectors"][dropped], ids64[dropped])
            self.rebuild()

    def delete_ids(self, ids: set[int]) -> None:
        self.tail.delete_ids(ids)
        self._dead |= ids
        self.body_version += 1  # the persisted dead set changed

    def _dead_array(self) -> np.ndarray:
        return np.fromiter(self._dead, np.int64, len(self._dead))

    def _body_keep(self) -> np.ndarray:
        keep = self.body_chunk_ids >= 0
        if self._dead:
            keep &= ~np.isin(self.body_chunk_ids, self._dead_array())
        return keep

    def live_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """Host copies of every live row: ``(vectors [n, d] f32,
        chunk_ids [n] int64)`` — tail + body minus tombstones."""
        parts_v, parts_i = [], []
        st = self.tail.state()  # compacts tombstones
        if len(st["ids"]):
            parts_v.append(np.asarray(st["vectors"], np.float32))
            parts_i.append(np.asarray(st["ids"]))
        if self.body is not None:
            keep = self._body_keep()
            parts_v.append(self._body_vectors()[keep])
            parts_i.append(self.body_chunk_ids[keep])
        if not parts_v:
            return (np.empty((0, self.dim), np.float32),
                    np.empty((0,), np.int64))
        return np.concatenate(parts_v), np.concatenate(parts_i)

    def rebuild(self) -> None:
        """Compact tail + body into a fresh IVF body (copy-on-compact)."""
        if self.mode == "exact":
            return
        vecs, cids = self.live_rows()
        if not len(cids):
            with self._body_lock:
                self.body = None
                self.body_version += 1
                self.body_chunk_ids = None
            return
        nlist = self._sized_nlist(len(cids))
        new_body = build_ivf_flat(
            torch.as_tensor(vecs, device=self.device), nlist,
            generator=self._generator(),
            int8=self.mode.endswith("int8"), capacity_slack=1.5)
        # publish body+ids together, THEN swap the tail; a racing search
        # may briefly see rows in both (deduped at merge), never neither
        with self._body_lock:
            self.body_chunk_ids = cids
            self.body = new_body
            self.body_version += 1
        self.tail = self._new_tail()
        self._dead.clear()  # rebuild compacted all tombstones away

    def adopt_body(self, body: IVFFlatIndex, chunk_ids: np.ndarray) -> None:
        """Swap in an externally built body (``build_ivf_flat_device``).
        ``chunk_ids[i]`` is the chunk id of the build's global row i.
        Replaces the current body AND tail — callers pass a build that
        already includes every live row."""
        with self._body_lock:
            self.body_chunk_ids = np.asarray(chunk_ids, np.int64)
            self.body = body
            self.body_version += 1
        self.tail = self._new_tail()
        self._dead.clear()

    # Mean rows/list ceiling for auto-sized IVF bodies (a store padded far
    # past its configured nlist gets more lists, not giant ones).
    MAX_MEAN_LIST_ROWS = 4096

    def _sized_nlist(self, n: int) -> int:
        floor = -(-n // self.MAX_MEAN_LIST_ROWS)
        return max(8, floor, min(self.nlist, n // 64 or 8))

    def _body_vectors(self) -> np.ndarray:
        """Reconstruct body vectors in original row order. Rows whose
        table slot is a -1 sentinel (dropped appends) stay zero."""
        idx = self.body
        flat = idx.lists.reshape(-1, self.dim).float().cpu().numpy()
        if idx.lists.dtype == torch.int8:
            flat = flat * np.float32(idx.scale)
        ids = idx.row_ids.reshape(-1).cpu().numpy()
        live = ids >= 0
        out = np.zeros((len(self.body_chunk_ids), self.dim), np.float32)
        out[ids[live]] = flat[live]
        return out

    # -- search -----------------------------------------------------------
    def search(self, queries: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (scores [Q, k] f32, chunk_ids [Q, k] int64; -1 pads)."""
        return self.search_finalize(self.search_dispatch(queries, k))

    def search_dispatch(self, queries: np.ndarray, k: int):
        """Launch the device work for one search; pass the returned
        handle to ``search_finalize`` for the host side (fetch + merge)."""
        real_q = queries.shape[0]
        bucket = bucket_pow2(real_q)
        if bucket != real_q:
            # pow2 Q buckets: the same batch shapes as the JAX engine, so
            # both take the same small/batched path for a given Q
            queries = np.concatenate(
                [queries, np.zeros((bucket - real_q, queries.shape[1]),
                                   np.asarray(queries).dtype)])
        return (real_q, self._dispatch_padded(queries, k))

    def search_finalize(self, handle) -> tuple[np.ndarray, np.ndarray]:
        real_q, ctx = handle
        vals, ids = self._finalize_padded(ctx)
        return vals[:real_q], ids[:real_q]

    def _dispatch_padded(self, queries: np.ndarray, k: int):
        """Launch all device work for one padded batch; the returned
        context goes to ``_finalize_padded`` (fetch + host merge)."""
        q_n = queries.shape[0]
        # snapshot the tail BEFORE the body work: a racing flush
        # publishes the appended body first and swaps self.tail second,
        # so (old tail, either body) always covers every row
        tail = self.tail
        if self.body is None:
            return ("tail", tail, tail.search_dispatch(queries, k))
        fetch = min(bucket_pow2(k + len(self._dead)),
                    bucket_pow2(k * 4 + 16))
        queries = np.asarray(queries)
        with search_profile.stage("body_dispatch"), self._body_lock:
            # body, its scale and its row->chunk-id table are read
            # together under the lock: the queries are quantized with the
            # scale of the very body they scan
            body = self.body
            body_chunk_ids = self.body_chunk_ids
            nprobe = min(self.nprobe, body.nlist)
            # flat-int8 transport: big batches cross to the device as
            # int8 quantized with the body's own scale (the list scan
            # reads those bytes verbatim — bit-identical scores to an f32
            # upload; only the coarse routing sees dequantized values)
            q_int8 = (self.mode == "ivf_flat_int8" and q_n >= 256
                      and queries.dtype == np.float32)
            with search_profile.stage("q_upload"):
                if q_int8:
                    qj = torch.as_tensor(np.clip(
                        np.round(queries / np.float32(body.scale)), -127,
                        127).astype(np.int8), device=self.device)
                else:
                    qj = torch.as_tensor(queries, device=self.device)
            if q_n * nprobe * 8 <= body.nlist:
                # small batch: gather only the probed lists
                b_vals, b_rows = ivf_search_small(body, qj, fetch,
                                                  nprobe=nprobe)
            else:
                b_vals, b_rows, _ = ivf_search(
                    body, qj, fetch, nprobe=nprobe,
                    p=min(self.ivf_p, fetch),
                    approx_select=self.approx_routing)
        with search_profile.stage("tail_dispatch"):
            if tail.count == 0:
                tail_h = _EMPTY_TAIL
            else:
                qt = qj.float() * body.scale if q_int8 else qj
                tail_h = tail.search_dispatch(qt, k)
        return ("body", q_n, k, body_chunk_ids, b_vals, b_rows, tail,
                tail_h)

    def _finalize_padded(self, ctx) -> tuple[np.ndarray, np.ndarray]:
        if ctx[0] == "tail":
            _, tail, handle = ctx
            return tail.search_finalize(handle)
        (_, q_n, k, body_chunk_ids, b_vals, b_rows, tail, tail_h) = ctx
        with search_profile.stage("tail_fetch"):
            if tail_h is _EMPTY_TAIL:
                t_vals, t_ids = None, None
            else:
                t_vals, t_ids = tail.search_finalize(tail_h)
        with search_profile.stage("rows_fetch"):
            b_rows = b_rows.cpu().numpy()
            b_vals = b_vals.cpu().numpy()
        with search_profile.stage("idmap_merge"):
            # row -> chunk id, tombstone filter
            b_ids = np.where(b_rows >= 0,
                             body_chunk_ids[np.clip(b_rows, 0, None)], -1)
            if self._dead:
                dead = np.isin(b_ids, self._dead_array())
                b_vals = np.where(dead, -np.inf, b_vals)
                b_ids = np.where(dead, -1, b_ids)
            order = np.argsort(-b_vals, axis=1, kind="stable")
            b_vals = np.take_along_axis(b_vals, order, axis=1)[:, :k]
            b_ids = np.take_along_axis(b_ids, order, axis=1)[:, :k]
            if t_vals is None:
                # empty tail: the body top-k IS the answer
                if b_vals.shape[1] < k:
                    w = b_vals.shape[1]
                    b_vals = np.pad(b_vals, ((0, 0), (0, k - w)),
                                    constant_values=-np.inf)
                    b_ids = np.pad(b_ids, ((0, 0), (0, k - w)),
                                   constant_values=-1)
                return b_vals.astype(np.float32, copy=False), \
                    b_ids.astype(np.int64, copy=False)
            # merge tail + body; dedup chunk ids (a rebuild racing this
            # search can surface a row in both tiers)
            vals = np.concatenate([b_vals, t_vals], axis=1)
            ids = np.concatenate([b_ids, t_ids], axis=1)
            order = np.argsort(-vals, axis=1, kind="stable")
            vals = np.take_along_axis(vals, order, axis=1)
            ids = np.take_along_axis(ids, order, axis=1)
            width = ids.shape[1]
            prior = np.tril(np.ones((width, width), bool), -1)
            dup = ((ids[:, :, None] == ids[:, None, :]) & prior[None]
                   ).any(axis=2)
            keep = ~dup & np.isfinite(vals) & (ids >= 0)
            rank = np.cumsum(keep, axis=1) - 1
            take = keep & (rank < k)
            out_v = np.full((q_n, k), -np.inf, np.float32)
            out_i = np.full((q_n, k), -1, np.int64)
            rr, cc = np.nonzero(take)
            out_v[rr, rank[rr, cc]] = vals[rr, cc]
            out_i[rr, rank[rr, cc]] = ids[rr, cc]
            return out_v, out_i

    # -- recall audit -------------------------------------------------------
    def sample_live_rows(self, sample: int, *, seed: int = 0
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Sample up to ``sample`` live vectors as ``(vectors [s, d] f32,
        chunk_ids [s])`` moving only O(sample·d) bytes: body rows are
        rejection-sampled (list, slot) pairs gathered on the device."""
        with self._body_lock:
            body = self.body
            table = self.body_chunk_ids
        tail_st = self.tail.state()  # tail is small by construction
        parts_v, parts_i = [], []
        rng = np.random.default_rng(seed)
        n_tail = len(tail_st["ids"])
        body_live = 0 if body is None else int(
            np.count_nonzero(table >= 0)) if table is not None else 0
        total = n_tail + body_live
        if total == 0:
            return (np.zeros((0, self.dim), np.float32),
                    np.zeros((0,), np.int64))
        want_body = int(round(sample * body_live / total))
        want_tail = min(n_tail, sample - want_body)
        if want_tail:
            take = rng.choice(n_tail, size=want_tail, replace=False)
            parts_v.append(np.asarray(tail_st["vectors"],
                                      np.float32)[take])
            parts_i.append(np.asarray(tail_st["ids"], np.int64)[take])
        if body is not None and want_body:
            nlist, cap_len = body.row_ids.shape
            picked: list[tuple[int, int]] = []
            probe_n = bucket_pow2(max(8, want_body * 2))
            for _ in range(6):
                if len(picked) >= want_body:
                    break
                ls = rng.integers(0, nlist, size=probe_n)
                ss = rng.integers(0, cap_len, size=probe_n)
                ids = body.row_ids[torch.as_tensor(ls, device=self.device),
                                   torch.as_tensor(ss, device=self.device)
                                   ].cpu().numpy()
                for li, si, rid in zip(ls, ss, ids):
                    if rid >= 0 and len(picked) < want_body:
                        picked.append((int(li), int(si)))
            if picked:
                ls = torch.as_tensor([p[0] for p in picked],
                                     device=self.device)
                ss = torch.as_tensor([p[1] for p in picked],
                                     device=self.device)
                vecs = body.lists[ls, ss].float().cpu().numpy()
                if body.lists.dtype == torch.int8:
                    vecs = vecs * np.float32(body.scale)
                rows = body.row_ids[ls, ss].cpu().numpy()
                live = rows >= 0
                parts_v.append(vecs[live])
                parts_i.append(table[rows[live]])
        return (np.concatenate(parts_v) if parts_v
                else np.zeros((0, self.dim), np.float32),
                np.concatenate(parts_i) if parts_i
                else np.zeros((0,), np.int64))

    def exact_reference_search(self, queries: np.ndarray, k: int
                               ) -> np.ndarray:
        """Exact top-k chunk ids over the LIVE store, computed on the
        device against the resident structures. For an int8 body the
        reference is exact over the stored vectors with the queries
        quantized by the body's own scale — the scores the search path
        itself computes — so the audit isolates SEARCH-path loss
        (routing/capture). Returns chunk ids [Q, k]."""
        q32 = np.asarray(queries, np.float32)
        with self._body_lock:
            body = self.body
            table = self.body_chunk_ids
        t_vals, t_ids = self.tail.search(q32, min(k, max(1,
                                                         self.tail.count)))
        if body is None:
            return t_ids[:, :k] if t_ids.shape[1] >= k else np.pad(
                t_ids, ((0, 0), (0, k - t_ids.shape[1])),
                constant_values=-1)
        flat = body.lists.reshape(-1, self.dim)
        flat_rows = body.row_ids.reshape(-1).cpu().numpy()
        live_np = flat_rows >= 0
        if self._dead:  # exclude tombstones IN the scan
            safe_rows = np.clip(flat_rows, 0, len(table) - 1)
            live_np &= ~np.isin(table[safe_rows], self._dead_array())
        mask = torch.as_tensor(live_np, device=self.device)
        qt = torch.as_tensor(q32, device=self.device)
        if body.lists.dtype == torch.int8:
            qq = quantize_with_scale(qt, body.scale)
            vals, pos = _exact_int8_topk(qq, flat, mask, k,
                                         block_size=_AUDIT_BLOCK)
            vals = vals.cpu().numpy() * np.float32(
                np.float32(body.scale) * np.float32(body.scale))
        else:
            vals, pos = exact_topk(qt, flat, k, live_mask=mask,
                                   block_size=_AUDIT_BLOCK)
            vals = vals.cpu().numpy()
        pos = pos.cpu().numpy()
        rows = flat_rows[np.clip(pos, 0, None)]
        rows = np.where(pos >= 0, rows, -1)
        b_ids = np.where(rows >= 0, table[np.clip(rows, 0, None)], -1)
        # merge with the exact tail scan (both tiers are exact)
        allv = np.concatenate([vals, t_vals], axis=1)
        alli = np.concatenate([b_ids, t_ids], axis=1)
        order = np.argsort(-allv, axis=1, kind="stable")
        return np.take_along_axis(alli, order, axis=1)[:, :k]

    # -- persistence ------------------------------------------------------
    def state(self) -> dict:
        """Everything needed to rebuild: live vectors + ids (the IVF body
        is re-derivable and rebuilt lazily on load)."""
        vecs, ids = self.live_rows()
        return {"vectors": vecs, "ids": ids.astype(np.int64),
                "dim": self.dim}

    @classmethod
    def from_state(cls, state: dict, **kw) -> "StoreIndex":
        idx = cls(int(state["dim"]), **kw)
        if len(state["ids"]):
            idx.add(state["vectors"], state["ids"])
        return idx

    # -- direct body checkpointing (a restart reloads the body verbatim:
    # no rebuild, no re-quantization drift)
    def body_state(self) -> dict | None:
        """Numpy snapshot of the IVF body, or None when tail-only. Same
        keys as the JAX package's ``StoreIndex.body_state``."""
        if self.body is None:
            return None
        with self._body_lock:
            out = {
                "kind": type(self.body).__name__,
                "body_chunk_ids": np.asarray(self.body_chunk_ids),
                "dead": self._dead_array(),
            }
            out.update(body_to_state(self.body))
        return out

    def restore_body(self, state: dict) -> None:
        """Install a checkpointed body (tail untouched)."""
        body = body_from_state(state, self.device)
        with self._body_lock:
            self.body = body
            self.body_version += 1
            self.body_chunk_ids = np.asarray(state["body_chunk_ids"],
                                             np.int64)
            self._dead = set(np.asarray(state["dead"], np.int64).tolist())
