"""Per-store index: streaming exact tail + bulk IVF body.

Counterpart of ``rag_foundation_tpu/engine/index.py`` for the modes
``exact``, ``ivf_flat``, ``ivf_flat_int8`` and ``ivf_pq``, on one device
or over a mesh (``parallel/``: the tail's rows and the body's posting
lists split over the mesh's shards, per-shard scans, a top-k merge).
Fresh inserts land in the exact ``VectorSegment`` tail; once the tail
outgrows ``build_threshold``, vectors are compacted into an IVF body
(k-means + uniform-capacity posting lists; for ``ivf_pq`` residual PQ
codes built through the host int8 archive) and the tail restarts empty.
Queries scan body (IVF dispatch) and tail (exact top-k) and merge.

Deletes tombstone in both structures: the tail masks at scan time, the
body filters candidates post-scan and reclaims space at the next
rebuild.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from rag_foundation_tpu_torch.engine.archive import HostArchive
from rag_foundation_tpu_torch.engine.convert import (archive_from_state,
                                                     body_from_state,
                                                     body_to_state)
from rag_foundation_tpu_torch.engine.ivf import (IVFFlatIndex,
                                                 build_ivf_flat, ivf_append,
                                                 ivf_search,
                                                 ivf_search_small)
from rag_foundation_tpu_torch.engine.ivfpq import (IVFPQIndex,
                                                   build_ivf_pq_streaming,
                                                   ivfpq_append,
                                                   ivfpq_search)
from rag_foundation_tpu_torch.ops.pq import pq_decode
from rag_foundation_tpu_torch.engine.profile import search_profile
from rag_foundation_tpu_torch.engine.segments import VectorSegment
from rag_foundation_tpu_torch.ops.quantize import (quantize_int8,
                                                   quantize_with_scale)
from rag_foundation_tpu_torch.ops.topk import exact_topk
from rag_foundation_tpu_torch.parallel.mesh import Mesh, on_device
from rag_foundation_tpu_torch.parallel.sharded_index import \
    ShardedVectorStore
from rag_foundation_tpu_torch.parallel.sharded_ivf import (
    ShardedBody, body_parts, gather_slots, shard_ivf_index,
    shard_ivfpq_index, sharded_ivf_append, sharded_ivf_search,
    sharded_ivfpq_search)
from rag_foundation_tpu_torch.utils.device import resolve_device
from rag_foundation_tpu_torch.utils.shapes import bucket_pow2

# dispatch-context marker: the tail was empty at snapshot time, so no
# tail scan was launched and the finalize merge is body-only
_EMPTY_TAIL = object()
# exact audit scans: any block size gives the same result (ops/topk.py)
_AUDIT_BLOCK = 65536


def _unpack(codes: torch.Tensor, packed: bool) -> torch.Tensor:
    """Code values ``[N, m]`` of a (possibly nibble-packed) code table."""
    if not packed:
        return codes
    out = torch.empty((codes.shape[0], codes.shape[1] * 2),
                      dtype=torch.uint8, device=codes.device)
    out[:, 0::2] = codes & 15
    out[:, 1::2] = codes >> 4
    return out


def _exact_int8_topk(qq, table8, live, k, block_size: int = 8192):
    """Exact top-k of int8 queries against an int8 row table [N8, d]:
    int8 dots are exact (recall-audit / ground-truth path)."""
    return exact_topk(qq, table8, k, live_mask=live, block_size=block_size)


def _is_pq(body) -> bool:
    return isinstance(body_parts(body)[0], IVFPQIndex)


class StoreIndex:
    """Mode-aware store index:
    'exact' | 'ivf_flat' | 'ivf_flat_int8' | 'ivf_pq'."""

    def __init__(self, dim: int, *, mode: str = "exact", nlist: int = 256,
                 nprobe: int = 32, build_threshold: int = 100_000,
                 pq_m: int = 48, pq_nbits: int = 4,
                 pq_refine: bool | str = True,
                 pq_refine_c: int | None = None,
                 pq_packed: bool = False,
                 pq_cap_slack: float = 1.5,
                 ivf_p: int = 4, approx_routing: bool = False,
                 archive_dir: str | None = None,
                 seed: int = 0, mesh: Mesh | None = None,
                 device: str | torch.device = "cuda"):
        if mode not in ("exact", "ivf_flat", "ivf_flat_int8", "ivf_pq"):
            raise ValueError(f"unknown index mode {mode!r}")
        if mode == "ivf_pq" and dim % pq_m:
            raise ValueError(f"dim {dim} not divisible by pq_m {pq_m}")
        self.pq_m = pq_m
        self.pq_nbits = pq_nbits
        self.pq_packed = pq_packed
        # "device" keeps an int8 re-rank table on the card; "host"
        # re-ranks ADC candidates against the host archive — the tier
        # for corpora past the card's memory (engine/archive.py); "none"
        # serves raw ADC ranking
        if isinstance(pq_refine, bool):
            pq_refine = "device" if pq_refine else "none"
        if pq_refine not in ("device", "host", "none"):
            raise ValueError(f"unknown pq_refine {pq_refine!r}")
        if mode == "ivf_pq" and mesh is not None and pq_refine == "device":
            # the row-indexed refine table does not partition by lists;
            # sharded PQ re-ranks against the host archive instead
            raise ValueError("mesh ivf_pq requires pq_refine='host' "
                             "or 'none'")
        self.pq_refine = pq_refine
        # host re-rank fan-out (ADC top-C candidates re-ranked); None =
        # the 4*fetch heuristic. C is the host tier's main cost knob
        self.pq_refine_c = pq_refine_c
        # list-capacity headroom over the mean fill (overflow rows
        # re-route to the tail)
        self.pq_cap_slack = pq_cap_slack
        self.archive_dir = archive_dir
        self._pq_archive: HostArchive | None = None  # mirrors body rows
        self.device = resolve_device(device)
        self.dim = dim
        self.mode = mode
        self.nlist = nlist
        self.nprobe = nprobe
        self.ivf_p = ivf_p
        # accepted and passed to ivf_search as the JAX package passes it;
        # the port's routing is exact either way (ivf.build_dispatch)
        self.approx_routing = approx_routing
        self.build_threshold = build_threshold
        self.seed = seed
        # a mesh splits the tail's rows and the body's lists over its
        # shards (parallel/); the device above stays the lead for builds
        self.mesh = mesh
        # serializes body mutation (in-place appends, swaps) vs body reads
        self._body_lock = threading.RLock()
        self.tail = self._new_tail()
        self.body: IVFFlatIndex | IVFPQIndex | None = None
        self.body_chunk_ids: np.ndarray | None = None  # row -> chunk id
        self._dead: set[int] = set()
        # bumped on every persisted-body mutation (rebuild/flush/
        # restore/delete): lets savers skip rewriting an unchanged body
        self.body_version = 0

    def _new_tail(self) -> VectorSegment | ShardedVectorStore:
        if self.mesh is not None:
            return ShardedVectorStore(self.dim, self.mesh)
        return VectorSegment(self.dim, device=self.device)

    def _shard_body(self, body):
        """``body`` with its lists split over the mesh (as it is without
        one). Raises when they do not split: builds size nlist for the
        shards and a mesh store keeps no device refine table."""
        if self.mesh is None:
            return body
        if isinstance(body, IVFPQIndex):
            return shard_ivfpq_index(body, self.mesh)
        return shard_ivf_index(body, self.mesh)

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
        if self.mesh is not None and self.mode == "ivf_pq":
            # sharded PQ bodies compact through the streaming rebuild
            self.rebuild()
            return
        st = self.tail.state()
        if not len(st["ids"]):
            return
        row_base = len(self.body_chunk_ids)
        new_rows = np.arange(row_base, row_base + len(st["ids"]),
                             dtype=np.int32)
        with self._body_lock:
            vecs = torch.as_tensor(st["vectors"], device=self.device)
            if self.mode == "ivf_pq":
                if self._pq_archive is not None:
                    # archive mirrors body row order — dropped rows get
                    # a -1 table slot below, so they stay dead there
                    self._pq_archive.append(
                        np.asarray(st["vectors"], np.float32))
                new_body, dropped = ivfpq_append(self.body, vecs, new_rows)
            elif isinstance(self.body, ShardedBody):
                new_body, dropped = sharded_ivf_append(
                    self.body, vecs, new_rows, mesh=self.mesh)
            else:
                new_body, dropped = ivf_append(self.body, vecs, new_rows)
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
        """Compact tail + body into a fresh IVF body (copy-on-compact).
        IVF-PQ routes through the host-staged streaming build: its f32
        corpus never materializes on the device or the host."""
        if self.mode == "exact":
            return
        if self.mode == "ivf_pq":
            return self._rebuild_pq()
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
        new_body = self._shard_body(new_body)
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
        already includes every live row. On a mesh the body is split
        over the shards (as views where they share its device)."""
        body = self._shard_body(body)
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
        nlist = max(8, floor, min(self.nlist, n // 64 or 8))
        if self.mesh is not None:
            # lists split over the shards: keep nlist divisible by them
            shards = self.mesh.shape["shard"]
            nlist = max(shards, -(-nlist // shards) * shards)
        return nlist

    def _archive_path(self) -> str | None:
        if not self.archive_dir:
            return None
        return os.path.join(self.archive_dir,
                            f"arch-{self.body_version + 1}.i8")

    def _rebuild_pq(self) -> None:
        """IVF-PQ compaction via the host int8 archive + streaming build.

        The archive mirrors body row order exactly: new-archive row i IS
        body row i, so ``body_chunk_ids`` doubles as the row->chunk-id
        table for both. Rows that overflow their list's capacity are
        marked dead in the table and re-enter through the fresh tail
        (same re-route contract as ivf_append's dropped mask)."""
        st = self.tail.state()  # compacts tombstones
        old_arch = self._pq_archive
        cid_parts: list[np.ndarray] = []
        if self.body is not None:
            keep = self._body_keep()
            if old_arch is not None and bool(keep.all()) \
                    and old_arch.n == len(keep):
                arch = old_arch       # append-only fast path: no copy
            elif old_arch is not None:
                arch = old_arch.compact(keep, path=self._archive_path())
            else:
                # body without an archive (old checkpoint): source the
                # best reconstruction available once
                arch = HostArchive(self.dim, path=self._archive_path())
                arch.append(self._body_vectors()[keep])
            cid_parts.append(self.body_chunk_ids[keep])
        else:
            arch = HostArchive(self.dim, path=self._archive_path())
        if len(st["ids"]):
            arch.append(np.asarray(st["vectors"], np.float32))
            cid_parts.append(np.asarray(st["ids"], np.int64))
        if not cid_parts:
            with self._body_lock:
                self.body = None
                self.body_version += 1
                self.body_chunk_ids = None
                self._pq_archive = None
            return
        self._publish_pq_build(arch, np.concatenate(cid_parts))

    def bulk_load_archive(self, archive: HostArchive, chunk_ids: np.ndarray,
                          progress=None) -> None:
        """Bulk ingestion for ivf_pq stores: take ownership of a filled
        HostArchive (row i holds the vector for ``chunk_ids[i]``) and
        build+publish the body through the same streaming path rebuilds
        use. The entry point for reindex / mass import at scales where
        per-chunk ``add()`` churn is wasteful."""
        if self.mode != "ivf_pq":
            raise ValueError("bulk_load_archive requires mode='ivf_pq'")
        if archive.n != len(chunk_ids):
            raise ValueError("archive rows != chunk_ids length")
        self._publish_pq_build(archive, np.asarray(chunk_ids, np.int64),
                               progress=progress)

    def _publish_pq_build(self, arch: HostArchive, cids: np.ndarray,
                          progress=None) -> None:
        n = arch.n
        refine = "device" if self.pq_refine == "device" else "none"
        new_body, overflow = build_ivf_pq_streaming(
            arch.chunk_i8, n, self.dim, self._sized_nlist(n), self.pq_m,
            generator=self._generator(), device=self.device,
            nbits=self.pq_nbits, packed=self.pq_packed,
            cap_slack=self.pq_cap_slack, source_scale=arch.scale,
            refine=refine, source_rows=arch.rows_i8, progress=progress)
        new_body = self._shard_body(new_body)
        over_rows = np.nonzero(overflow)[0]
        over_vecs = arch.rows_f32(over_rows) if len(over_rows) else None
        over_ids = cids[over_rows] if len(over_rows) else None
        cids = cids.copy()
        cids[over_rows] = -1   # dead in the body; live in the new tail
        with self._body_lock:
            self.body_chunk_ids = cids
            self.body = new_body
            self.body_version += 1
            self._pq_archive = arch
        self.tail = self._new_tail()
        self._dead.clear()
        if over_vecs is not None:
            self.tail.add(over_vecs, over_ids)

    def _pad_rows(self, out: np.ndarray) -> np.ndarray:
        """``out`` cut or zero-padded to one row per table entry."""
        want = len(self.body_chunk_ids)
        if len(out) >= want:
            return out[:want]
        return np.concatenate(
            [out, np.zeros((want - len(out), self.dim), np.float32)])

    def _pq_body_vectors(self) -> np.ndarray:
        idx = self.body
        if self._pq_archive is not None:
            # archive row i IS body row i (rebuild invariant)
            return self._pad_rows(self._pq_archive.chunk_f32(
                0, len(self.body_chunk_ids)))
        if idx.refine.shape[0] > 0:
            # restored body with a refine store: int8 originals are far
            # higher fidelity than decoded PQ codes
            return self._pad_rows(idx.refine.cpu().numpy().astype(
                np.float32) * np.float32(idx.refine_scale))
        # restored body with refine disabled: reconstruct approximately
        # from the codes (coarse centroid + decoded residual) — lossy,
        # but the only material left after a restart, and only rebuilds
        # (re-train + re-encode) consume it
        out = np.zeros((len(self.body_chunk_ids), self.dim), np.float32)
        for part in body_parts(idx):
            nlist, cap_len = part.row_ids.shape
            codes = _unpack(part.codes.reshape(nlist * cap_len, -1),
                            part.packed)
            flat = (pq_decode(part.codebook, codes)
                    + part.centroids.repeat_interleave(cap_len, dim=0)
                    ).cpu().numpy()
            ids = part.row_ids.reshape(-1).cpu().numpy()
            live = ids >= 0
            out[ids[live]] = flat[live]
        return out

    def _body_vectors(self) -> np.ndarray:
        """Reconstruct body vectors in original row order. Rows whose
        table slot is a -1 sentinel (dropped appends) stay zero."""
        if self.mode == "ivf_pq":
            return self._pq_body_vectors()
        out = np.zeros((len(self.body_chunk_ids), self.dim), np.float32)
        for part in body_parts(self.body):
            flat = part.lists.reshape(-1, self.dim).float().cpu().numpy()
            if part.lists.dtype == torch.int8:
                flat = flat * np.float32(part.scale)
            ids = part.row_ids.reshape(-1).cpu().numpy()
            live = ids >= 0
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

    def search_many(self, batches: list[np.ndarray], k: int
                    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Pipelined multi-batch search: batch i+1's device work is
        launched before batch i's host finalize (fetch + rescore +
        merge) runs, so host work overlaps device time. Results match
        ``search`` batch for batch."""
        out: list = [None] * len(batches)
        prev = None   # (index, handle)
        for i, q in enumerate(batches):
            handle = self.search_dispatch(q, k)
            if prev is not None:
                out[prev[0]] = self.search_finalize(prev[1])
            prev = (i, handle)
        if prev is not None:
            out[prev[0]] = self.search_finalize(prev[1])
        return out

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
        if self.mode == "ivf_pq":
            return self._dispatch_pq(queries, k, fetch, tail)
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
            # upload; only the coarse routing sees dequantized values).
            # A mesh store takes f32, as the JAX engine's does
            q_int8 = (self.mode == "ivf_flat_int8" and q_n >= 256
                      and self.mesh is None and queries.dtype == np.float32)
            with search_profile.stage("q_upload"):
                if q_int8:
                    qj = torch.as_tensor(np.clip(
                        np.round(queries / np.float32(body.scale)), -127,
                        127).astype(np.int8), device=self.device)
                else:
                    qj = torch.as_tensor(queries, device=self.device)
            if isinstance(body, ShardedBody):
                # every batch, a single query included: per-shard routing
                # over each shard's lists (no small-batch path)
                shards = self.mesh.shape["shard"]
                b_vals, b_rows = sharded_ivf_search(
                    body, qj, fetch, mesh=self.mesh,
                    nprobe_local=-(-nprobe // shards),
                    p=min(self.ivf_p, fetch))
            elif q_n * nprobe * 8 <= body.nlist:
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
        return ("body", q_n, k, fetch, None, body_chunk_ids, b_vals, b_rows,
                tail, tail_h, None)

    def _dispatch_pq(self, queries: np.ndarray, k: int, fetch: int,
                     tail: VectorSegment):
        """The ``ivf_pq`` body dispatch. There is no small-batch path:
        every batch, a single query included, goes through
        ``ivfpq_search`` (or, for a sharded body, ``sharded_ivfpq_search``)
        and its list-scan kernel."""
        q_n = queries.shape[0]
        host_refine = self.pq_refine == "host" \
            and self._pq_archive is not None
        q_scale = None
        with search_profile.stage("q_upload"):
            if self.mesh is not None:
                # the JAX engine's mesh transport: with the host re-rank
                # the device only proposes candidates and the host f32
                # rescore ranks them, so queries cross as bf16 (the tail
                # scan shares them); else f32
                qj = torch.as_tensor(queries, device=self.device)
                if host_refine and queries.dtype == np.float32:
                    qj = qj.to(torch.bfloat16)
            elif queries.dtype == np.float32:
                # queries cross to the device as int8 + one scale, a
                # quarter of the f32 bytes. The batch-absmax scale is
                # computed here on the host in numpy, as the JAX engine
                # does, so both quantize alike; the noise (~0.4% of
                # range) is far below the 4-bit ADC's own resolution
                q_scale = float(np.abs(queries).max()) / 127.0 or 1.0
                qj = torch.as_tensor(np.clip(np.round(queries / q_scale),
                                             -127, 127).astype(np.int8),
                                     device=self.device)
            else:
                qj = torch.as_tensor(queries, device=self.device)
        rescore_arch = None
        with search_profile.stage("body_dispatch"), self._body_lock:
            body = self.body
            body_chunk_ids = self.body_chunk_ids
            nprobe = min(self.nprobe, body.nlist)
            # per-sub-block capture: 4 as in the JAX engine, which fixes
            # it; here a larger ``ivf_p`` raises it (never below 4). The
            # selection is a small part of the kernel's time on the card,
            # and a dense cluster of near-duplicates in one list needs
            # more than 4 rows a sub-block
            p_cap = max(4, self.ivf_p)
            if isinstance(body, ShardedBody):
                shards = self.mesh.shape["shard"]
                c = (self.pq_refine_c or min(max(4 * fetch, 32), 256)) \
                    if host_refine else fetch
                b_vals, b_rows = sharded_ivfpq_search(
                    body, qj, c, mesh=self.mesh,
                    nprobe_local=-(-nprobe // shards), p=min(p_cap, c))
                if c != fetch:
                    rescore_arch = self._pq_archive
            elif host_refine:
                # tier past the card's memory: the device ADC proposes
                # top-C, the host int8 archive re-ranks exactly (in
                # _finalize_padded)
                c = self.pq_refine_c or min(max(4 * fetch, 32), 256)
                b_vals, b_rows, _ = ivfpq_search(
                    body, qj, c, nprobe=nprobe, p=min(p_cap, c),
                    q_scale=q_scale)
                rescore_arch = self._pq_archive
            else:
                b_vals, b_rows, _ = ivfpq_search(
                    body, qj, fetch, nprobe=nprobe, p=min(p_cap, fetch),
                    q_scale=q_scale)
        with search_profile.stage("tail_dispatch"):
            if tail.count == 0:
                tail_h = _EMPTY_TAIL
            else:
                # int8-uploaded queries dequantize on the device for the
                # exact tail scan
                qt = qj.float() * q_scale if q_scale is not None else qj
                tail_h = tail.search_dispatch(qt, k)
        q32 = np.asarray(queries, np.float32) \
            if rescore_arch is not None else None
        return ("body", q_n, k, fetch, rescore_arch, body_chunk_ids, b_vals,
                b_rows, tail, tail_h, q32)

    def _finalize_padded(self, ctx) -> tuple[np.ndarray, np.ndarray]:
        if ctx[0] == "tail":
            _, tail, handle = ctx
            return tail.search_finalize(handle)
        (_, q_n, k, fetch, rescore_arch, body_chunk_ids, b_vals, b_rows,
         tail, tail_h, q32) = ctx
        with search_profile.stage("tail_fetch"):
            if tail_h is _EMPTY_TAIL:
                t_vals, t_ids = None, None
            else:
                t_vals, t_ids = tail.search_finalize(tail_h)
        with search_profile.stage("rows_fetch"):
            b_rows = b_rows.cpu().numpy()
            if rescore_arch is None:
                b_vals = b_vals.cpu().numpy()
        if rescore_arch is not None:
            # the ADC values are REPLACED by the host rescore, so they
            # are never fetched from the device
            with search_profile.stage("rescore"):
                scores = rescore_arch.rescore(q32, b_rows)
                order = np.argsort(-scores, axis=1,
                                   kind="stable")[:, :fetch]
                b_vals = np.take_along_axis(scores, order, axis=1)
                b_rows = np.take_along_axis(b_rows, order, axis=1)
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
            nlist, cap_len = body.nlist, body.cap_len
            picked: list[tuple[int, int]] = []
            probe_n = bucket_pow2(max(8, want_body * 2))
            for _ in range(6):
                if len(picked) >= want_body:
                    break
                ls = rng.integers(0, nlist, size=probe_n)
                ss = rng.integers(0, cap_len, size=probe_n)
                ids = gather_slots(body, "row_ids", ls, ss,
                                   self.device).cpu().numpy()
                for li, si, rid in zip(ls, ss, ids):
                    if rid >= 0 and len(picked) < want_body:
                        picked.append((int(li), int(si)))
            if picked:
                ls = np.array([p[0] for p in picked], np.int64)
                ss = np.array([p[1] for p in picked], np.int64)
                vecs, rows = self._fetch_body_rows(body, ls, ss)
                live = rows >= 0
                parts_v.append(vecs[live])
                parts_i.append(table[rows[live]])
        return (np.concatenate(parts_v) if parts_v
                else np.zeros((0, self.dim), np.float32),
                np.concatenate(parts_i) if parts_i
                else np.zeros((0,), np.int64))

    def _fetch_body_rows(self, body, ls: np.ndarray, ss: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Sampled body rows (list, slot) as f32 + their global row ids."""
        def at(field, slots=ss):
            return gather_slots(body, field, ls, slots, self.device)

        rows = at("row_ids").cpu().numpy()
        if _is_pq(body):
            if self._pq_archive is not None:
                return (self._pq_archive.rows_f32(np.clip(rows, 0, None)),
                        rows)
            if body.refine.shape[0] > 0:
                safe = torch.as_tensor(np.clip(rows, 0, None),
                                       device=self.device)
                v8 = body.refine[safe].cpu().numpy()
                return (v8.astype(np.float32)
                        * np.float32(body.refine_scale), rows)
            # no refine: reconstruct only the sampled rows from codes
            dec = pq_decode(body.codebook, _unpack(at("codes"), body.packed))
            return (dec + at("centroids", None)).cpu().numpy(), rows
        lists = at("lists")
        vecs = lists.float().cpu().numpy()
        if lists.dtype == torch.int8:
            vecs = vecs * np.float32(body.scale)
        return vecs, rows

    def _table_live(self, table: np.ndarray, nrows: int) -> np.ndarray:
        """Liveness of body rows ``[0, nrows)`` from the HOST table (row
        -> chunk id, -1 for dropped appends), tombstones excluded: the
        served path filters them, so the exact reference must too."""
        live = table[:nrows] >= 0
        if self._dead:
            live &= ~np.isin(table[:nrows], self._dead_array())
        return live

    def _exact_pq(self, body: IVFPQIndex, table: np.ndarray,
                  q32: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Exact (values, body rows) over a PQ body's stored int8 rows:
        the refine table on the device, or a chunked host scan of the
        archive where there is none."""
        if body.refine.shape[0] == 0 and self._pq_archive is not None:
            arch = self._pq_archive
            nrows = min(len(table), arch.n)
            live = self._table_live(table, nrows)
            best_v = np.full((q32.shape[0], k), -np.inf, np.float32)
            best_r = np.full((q32.shape[0], k), -1, np.int64)
            step = 1 << 19
            for lo in range(0, nrows, step):
                hi = min(nrows, lo + step)
                s = q32 @ arch.chunk_f32(lo, hi).T
                s[:, ~live[lo:hi]] = -np.inf
                kk = min(k, hi - lo)
                part = np.argpartition(-s, kk - 1, axis=1)[:, :kk]
                allv = np.concatenate(
                    [best_v, np.take_along_axis(s, part, axis=1)], axis=1)
                allr = np.concatenate([best_r, part + lo], axis=1)
                order = np.argsort(-allv, axis=1, kind="stable")[:, :k]
                best_v = np.take_along_axis(allv, order, axis=1)
                best_r = np.take_along_axis(allr, order, axis=1)
            return best_v, best_r
        if body.refine.shape[0] == 0:
            raise NotImplementedError(
                "exact audit over a PQ body requires the refine store or "
                "the host archive (codes alone are lossy)")
        qq, qscale = quantize_int8(torch.as_tensor(q32, device=self.device))
        n8 = body.refine.shape[0]
        live_np = np.zeros(n8, bool)
        nrows = min(len(table), n8)
        live_np[:nrows] = self._table_live(table, nrows)
        vals, pos = _exact_int8_topk(
            qq, body.refine, torch.as_tensor(live_np, device=self.device), k,
            block_size=_AUDIT_BLOCK)
        vals = vals.cpu().numpy() * np.float32(
            np.float32(qscale) * np.float32(body.refine_scale))
        return vals, pos.cpu().numpy()

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
        if _is_pq(body):
            vals, rows = self._exact_pq(body, table, q32, k)
            return self._merge_exact(vals, rows, table, t_vals, t_ids, k)
        # a sharded body: each shard's exact top-k over its lists, then
        # one merge with the tail (shard-major, so ties keep the order of
        # the unsharded scan)
        parts_v, parts_r = [], []
        for part in body_parts(body):
            dev = part.lists.device
            flat = part.lists.reshape(-1, self.dim)
            flat_rows = part.row_ids.reshape(-1).cpu().numpy()
            live_np = flat_rows >= 0
            if self._dead:  # exclude tombstones IN the scan
                safe_rows = np.clip(flat_rows, 0, len(table) - 1)
                live_np &= ~np.isin(table[safe_rows], self._dead_array())
            mask = torch.as_tensor(live_np, device=dev)
            qt = torch.as_tensor(q32, device=dev)
            with on_device(dev):
                if part.lists.dtype == torch.int8:
                    qq = quantize_with_scale(qt, part.scale)
                    vals, pos = _exact_int8_topk(qq, flat, mask, k,
                                                 block_size=_AUDIT_BLOCK)
                    vals = vals.cpu().numpy() * np.float32(
                        np.float32(part.scale) * np.float32(part.scale))
                else:
                    vals, pos = exact_topk(qt, flat, k, live_mask=mask,
                                           block_size=_AUDIT_BLOCK)
                    vals = vals.cpu().numpy()
            pos = pos.cpu().numpy()
            rows = flat_rows[np.clip(pos, 0, None)]
            parts_v.append(vals)
            parts_r.append(np.where(pos >= 0, rows, -1))
        return self._merge_exact(np.concatenate(parts_v, axis=1),
                                 np.concatenate(parts_r, axis=1), table,
                                 t_vals, t_ids, k)

    @staticmethod
    def _merge_exact(vals, rows, table, t_vals, t_ids, k) -> np.ndarray:
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
                "kind": type(body_parts(self.body)[0]).__name__,
                "body_chunk_ids": np.asarray(self.body_chunk_ids),
                "dead": self._dead_array(),
            }
            out.update(body_to_state(self.body))
            if self._pq_archive is not None:
                ast = self._pq_archive.state()
                out["archive_rows"] = ast["rows"]
                out["archive_scale"] = ast["scale"]
        return out

    def restore_body(self, state: dict) -> None:
        """Install a checkpointed body (tail untouched)."""
        body = body_from_state(state, self.device)
        # a saved body that does not split over this mesh (its nlist, a
        # device refine table) is served whole by the one-device paths,
        # and flushed into whole, until the next rebuild. The JAX engine
        # also keeps it whole but then takes its sharded search and flush
        # paths and raises (tests/test_torch_sharded_index.py)
        if self.mesh is not None \
                and body.nlist % self.mesh.shape["shard"] == 0 \
                and not (_is_pq(body) and body.refine.shape[0] > 0):
            body = self._shard_body(body)
        archive = archive_from_state(state, path=self._archive_path())
        with self._body_lock:
            self.body = body
            self.body_version += 1
            self.body_chunk_ids = np.asarray(state["body_chunk_ids"],
                                             np.int64)
            self._dead = set(np.asarray(state["dead"], np.int64).tolist())
            self._pq_archive = archive
