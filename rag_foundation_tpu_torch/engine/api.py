"""Engine facade — the narrow API the host control plane programs against.

Counterpart of ``rag_foundation_tpu/engine/api.py``: stores are
per-tenant index namespaces, document ingestion chunks + embeds +
inserts on the device, and queries run the exact/IVF top-k path. The
on-disk format (``meta.json``, ``vectors.npz``, ``body.npz`` per store)
is the JAX engine's: a ``data_dir`` written by either engine loads in
the other.

Ported: the ``hash``, ``minilm`` and ``hybrid`` encoders and the
``exact``, ``ivf_flat``, ``ivf_flat_int8`` and ``ivf_pq`` index modes on
one device (``EngineConfig.device``, the card by default; the MiniLM
encoder runs there too), and the engine's Prometheus series
(``engine/metrics.py``, ``Engine.metrics``). Not ported yet: mesh
sharding, the generative decoder and the reader's ``textnorm`` pinning.

Thread model: the RPC server calls in from many threads; each store
serializes mutation under its own lock, searches read the latest
published index state.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from rag_foundation_tpu_torch.engine.chunker import chunk_text
from rag_foundation_tpu_torch.engine.index import StoreIndex
from rag_foundation_tpu_torch.engine.metrics import EngineMetrics
from rag_foundation_tpu_torch.models.hash_encoder import HashingEncoder
from rag_foundation_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class SearchHit:
    store_key: str
    doc_id: str
    doc_name: str
    chunk_id: int
    text: str
    score: float
    start: int
    end: int
    ordinal: int


@dataclass
class EngineConfig:
    dim: int = 384
    chunk_tokens: int = 200
    chunk_overlap: int = 40
    encoder: str = "hash"          # "hash" | "minilm" | "hybrid"
    encoder_ckpt: str | None = None  # MiniLM npz (the JAX format)
    hybrid_w: float = 0.35         # semantic-channel weight (hybrid)
    index_mode: str = "exact"      # "exact" | "ivf_flat" | "ivf_flat_int8"
    #                                 | "ivf_pq"
    nlist: int = 256
    nprobe: int = 32
    build_threshold: int = 100_000  # tail size that triggers IVF build
    pq_m: int = 48                  # PQ subspaces (ivf_pq mode)
    pq_packed: bool = False         # nibble-packed codes
    pq_refine: str = "device"       # device|host|none re-rank tier
    pq_cap_slack: float = 1.5       # PQ list-capacity headroom
    ivf_p: int = 4                  # per-sub-block top-p capture
    approx_routing: bool = False    # accepted; the port routes exactly
    batch_window_s: float = 0.0     # >0: micro-batch concurrent searches
    mesh_shards: int = 1            # not ported (raises when > 1)
    data_dir: str | None = None     # checkpoint root; None = memory-only
    device: str = "cuda"            # "cuda" (raises without a card) | "cpu"

    def __post_init__(self):
        if self.encoder not in ("hash", "minilm", "hybrid"):
            raise ValueError(f"unknown encoder {self.encoder!r}")
        if self.index_mode not in ("exact", "ivf_flat", "ivf_flat_int8",
                                   "ivf_pq"):
            raise ValueError(f"unknown index mode {self.index_mode!r}")
        # fail fast at startup, not at the first index build
        if self.index_mode == "ivf_pq" and self.dim % self.pq_m:
            raise ValueError(
                f"ENGINE_PQ_M={self.pq_m} must divide ENGINE_DIM="
                f"{self.dim} for ivf_pq mode")
        if self.pq_refine not in ("device", "host", "none"):
            raise ValueError(f"invalid pq_refine {self.pq_refine!r}")
        if self.mesh_shards > 1:
            raise ValueError("mesh sharding not ported yet")


@dataclass
class _ChunkMeta:
    doc_id: str
    doc_name: str
    text: str
    start: int
    end: int
    ordinal: int


@dataclass
class _Store:
    key: str
    segment: StoreIndex
    chunks: dict[int, _ChunkMeta] = field(default_factory=dict)
    next_chunk_id: int = 0
    lock: threading.Lock = field(default_factory=threading.Lock)
    created_at: float = field(default_factory=time.time)
    disk_mtime: float = 0.0  # meta.json mtime at load/save (split-proc)
    saved_body_version: int = -1  # StoreIndex.body_version at last save


class StoreNotFound(KeyError):
    pass


def _make_minilm(cfg: EngineConfig, dim: int, device: torch.device):
    from rag_foundation_tpu_torch.models.encoder import (EncoderConfig,
                                                         MiniLMEncoder,
                                                         checkpoint_config,
                                                         load_params)
    if cfg.encoder_ckpt:
        # fail fast on a bad path/arch — a half-loaded encoder would
        # silently embed garbage. The checkpoint carries its
        # EncoderConfig (max_len etc.); dim must match.
        enc_cfg = checkpoint_config(cfg.encoder_ckpt)
        if enc_cfg is not None and enc_cfg.hidden != dim:
            raise ValueError(
                f"encoder checkpoint hidden={enc_cfg.hidden} != "
                f"expected dim {dim}")
        enc_cfg = enc_cfg or EncoderConfig(hidden=dim)
        params = load_params(cfg.encoder_ckpt, enc_cfg, device=device)
        return MiniLMEncoder(dim=dim, cfg=enc_cfg, params=params,
                             device=device)
    return MiniLMEncoder(dim=dim, device=device)


def _make_encoder(cfg: EngineConfig, device: torch.device):
    if cfg.encoder == "hash":
        return HashingEncoder(dim=cfg.dim)
    if cfg.encoder == "minilm":
        return _make_minilm(cfg, cfg.dim, device)
    # hybrid: lexical ⊕ semantic in one dense space. ENGINE_DIM is the
    # TOTAL width; the MiniLM checkpoint fixes its half and the hash
    # channel takes the remainder (models/hybrid_encoder)
    from rag_foundation_tpu_torch.models.encoder import checkpoint_config
    from rag_foundation_tpu_torch.models.hybrid_encoder import HybridEncoder
    mini_dim = cfg.dim // 2
    if cfg.encoder_ckpt:
        enc_cfg = checkpoint_config(cfg.encoder_ckpt)
        if enc_cfg is not None:
            mini_dim = enc_cfg.hidden
    hash_dim = cfg.dim - mini_dim
    if hash_dim <= 0:
        raise ValueError(
            f"ENGINE_DIM={cfg.dim} too small for hybrid with a "
            f"{mini_dim}-dim MiniLM checkpoint")
    return HybridEncoder(hash_dim, _make_minilm(cfg, mini_dim, device),
                         w_mini=cfg.hybrid_w)


class Engine:
    """In-process index-and-query engine on one device."""

    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()
        self.device = resolve_device(self.config.device)
        self.encoder = _make_encoder(self.config, self.device)
        enc_cfg = getattr(getattr(self.encoder, "mini", self.encoder),
                          "cfg", None)
        max_len = getattr(enc_cfg, "max_len", None)
        if max_len is not None and self.config.chunk_tokens > \
                int(max_len * 0.6):
            import logging
            logging.getLogger(__name__).warning(json.dumps({
                "event": "chunk_exceeds_encoder_window",
                "chunk_tokens": self.config.chunk_tokens,
                "encoder_max_len": int(max_len),
                "detail": "suffix splitting expands token counts; chunk "
                          "tails past the window are invisible to the "
                          "semantic channel — lower ENGINE_CHUNK_TOKENS "
                          "or retrain with a longer max_len"}))
        self._stores: dict[str, _Store] = {}
        self._pad_counts: dict[str, int] = {}   # bench pads (pad_store)
        self._registry_lock = threading.Lock()
        self.metrics = EngineMetrics()
        if self.config.data_dir:
            self._load_all()

    # -- store lifecycle ---------------------------------------------------
    def create_store(self, key: str) -> None:
        with self._registry_lock:
            if key in self._stores:
                raise ValueError(f"store {key!r} already exists")
            store = _Store(key=key, segment=self._new_index(key))
            self._stores[key] = store
        if self.config.data_dir:
            # persist immediately so sibling processes see the store
            self._save_store(store)

    def delete_store(self, key: str) -> None:
        with self._registry_lock:
            self._stores.pop(key, None)
        if self.config.data_dir:
            p = self._store_dir(key)
            for f in ("vectors.npz", "meta.json", "body.npz"):
                (p / f).unlink(missing_ok=True)
            for f in p.glob("arch-*.i8*"):   # an ivf_pq store's archive
                f.unlink(missing_ok=True)

    def list_stores(self) -> list[str]:
        return sorted(self._stores)

    def has_store(self, key: str) -> bool:
        return key in self._stores

    @contextlib.contextmanager
    def _mutation_lock(self, key: str):
        """Inter-PROCESS store mutation lock (split API/worker topology):
        mutators take this flock, reload-if-stale inside it, apply, save,
        release. No-op without a data_dir."""
        if not self.config.data_dir:
            yield
            return
        import fcntl
        lock_f = self._store_dir(key) / ".mutex"
        with open(lock_f, "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def encoder_fingerprint(self) -> str:
        """Identity of the embedding space (encoder name, dim,
        checkpoint, hybrid weight), persisted per store and checked on
        reload (the JAX engine writes the same string)."""
        cfg = self.config
        parts = [self.encoder.name, f"dim{cfg.dim}"]
        if cfg.encoder_ckpt:
            import os
            parts.append(os.path.basename(cfg.encoder_ckpt))
        if cfg.encoder == "hybrid":
            parts.append(f"w{cfg.hybrid_w}")
        return ":".join(parts)

    def _index_kwargs(self, archive_dir: str | None) -> dict:
        cfg = self.config
        return dict(mode=cfg.index_mode, nlist=cfg.nlist, nprobe=cfg.nprobe,
                    build_threshold=cfg.build_threshold, pq_m=cfg.pq_m,
                    pq_packed=cfg.pq_packed, pq_refine=cfg.pq_refine,
                    pq_cap_slack=cfg.pq_cap_slack, ivf_p=cfg.ivf_p,
                    approx_routing=cfg.approx_routing,
                    archive_dir=archive_dir, device=self.device)

    def _new_index(self, key: str) -> StoreIndex:
        # an ivf_pq store keeps its host archive under its own directory
        archive_dir = (str(self._store_dir(key))
                       if self.config.data_dir else None)
        return StoreIndex(self.config.dim,
                          **self._index_kwargs(archive_dir))

    def _store(self, key: str) -> _Store:
        store = self._stores.get(key)
        if self.config.data_dir:
            # cross-process freshness: reload when meta.json's mtime moves
            meta_f = (Path(self.config.data_dir) / "stores"
                      / key.replace("/", "_") / "meta.json")
            try:
                mtime = meta_f.stat().st_mtime
            except FileNotFoundError:
                mtime = None
            if mtime is not None and (
                    store is None or mtime > store.disk_mtime):
                with self._registry_lock:
                    store = self._stores.get(key)
                    if store is None or mtime > store.disk_mtime:
                        loaded = self._load_store_dir(self._store_dir(key))
                        if loaded is not None:
                            self._stores[key] = loaded
                            store = loaded
        if store is None:
            raise StoreNotFound(key)
        return store

    # -- ingestion (the write path) -----------------------------------------
    def ingest_document(self, store_key: str, doc_id: str, doc_name: str,
                        text: str) -> dict:
        """Chunk + embed + insert one document. Returns ingestion stats.
        Idempotent per ``doc_id``: re-ingesting deletes prior chunks."""
        chunks = chunk_text(text, max_tokens=self.config.chunk_tokens,
                            overlap_tokens=self.config.chunk_overlap)
        with contextlib.ExitStack() as stack:
            stack.enter_context(self._mutation_lock(store_key))
            store = self._store(store_key)  # reload-if-stale UNDER lock
            stack.enter_context(store.lock)
            self._delete_doc_locked(store, doc_id)
            if chunks:
                ids = np.arange(store.next_chunk_id,
                                store.next_chunk_id + len(chunks),
                                dtype=np.int64)
                store.next_chunk_id += len(chunks)
                for cid, c in zip(ids, chunks):
                    store.chunks[int(cid)] = _ChunkMeta(
                        doc_id=doc_id, doc_name=doc_name, text=c.text,
                        start=c.start, end=c.end, ordinal=c.ordinal)
                from rag_foundation_tpu_torch.engine.pipeline import \
                    pipelined_ingest
                pipelined_ingest(self.encoder.encode, store.segment.add,
                                 [c.text for c in chunks], ids)
            if self.config.data_dir:
                self._save_store(store)
        return {"chunks": len(chunks),
                "vectors": len(chunks),
                "dim": self.config.dim}

    def _delete_doc_locked(self, store: _Store, doc_id: str) -> None:
        dead = {cid for cid, m in store.chunks.items() if m.doc_id == doc_id}
        if dead:
            store.segment.delete_ids(dead)
            for cid in dead:
                del store.chunks[cid]

    def delete_document(self, store_key: str, doc_id: str) -> None:
        with self._mutation_lock(store_key):
            store = self._store(store_key)  # reload-if-stale UNDER lock
            with store.lock:
                self._delete_doc_locked(store, doc_id)
                if self.config.data_dir:
                    self._save_store(store)

    def store_stats(self, store_key: str) -> dict:
        store = self._store(store_key)
        return {"documents": len({m.doc_id for m in store.chunks.values()}),
                "chunks": len(store.chunks),
                "vectors": store.segment.count}

    # -- query (the hot path) ------------------------------------------------
    def search(self, store_keys: list[str], query: str, k: int = 5,
               doc_filter: set[str] | None = None,
               meta_filter: dict | None = None) -> list[SearchHit]:
        """Embed the query, top-k scan each store, merge host-side.

        ``doc_filter`` restricts results to specific engine doc ids
        (over-fetching to keep k results when the filter is selective).
        ``meta_filter`` maps chunk-metadata keys to OR-lists of accepted
        values; keys AND together.

        With ``batch_window_s > 0`` concurrent unfiltered searches over
        the same store-set coalesce into one device call.
        """
        if doc_filter is None and meta_filter is None \
                and self.config.batch_window_s > 0:
            return self._batcher().submit((tuple(store_keys), k), query)
        return self._search_group(store_keys, [query], k,
                                  doc_filter=doc_filter,
                                  meta_filter=meta_filter)[0]

    def _batcher(self):
        if not hasattr(self, "_batcher_obj"):
            from rag_foundation_tpu_torch.engine.batcher import QueryBatcher
            with self._registry_lock:
                if not hasattr(self, "_batcher_obj"):
                    self._batcher_obj = QueryBatcher(
                        lambda key, queries: self._search_group(
                            list(key[0]), queries, key[1]),
                        window_s=self.config.batch_window_s)
        return self._batcher_obj

    def _search_group(self, store_keys: list[str], queries: list[str],
                      k: int, doc_filter: set[str] | None = None,
                      meta_filter: dict | None = None
                      ) -> list[list[SearchHit]]:
        """Batched core: one encode + one scan per store for Q queries."""
        from rag_foundation_tpu_torch.utils.profiling import (StageTimer,
                                                              maybe_trace)
        timer = StageTimer(histogram=self.metrics.query_stage_seconds)
        self.metrics.search_batch_size.observe(len(queries))
        with timer.stage("embed"):
            # query-side encode (stopword-stripped lexical channel) when
            # the encoder distinguishes it (MiniLM does not)
            enc_q = getattr(self.encoder, "encode_queries", None)
            qv = enc_q(queries) if enc_q else self.encoder.encode(queries)
        filtered = doc_filter is not None or meta_filter is not None
        # padded stores (pad_store) drop metadata-less rows in assembly
        # below — over-fetch so k real hits usually survive
        fetch = max(4 * k, 32) if (filtered or self._pad_counts) else k

        def _meta_ok(meta) -> bool:
            if meta_filter is None:
                return True
            for mk, accepted in meta_filter.items():
                attr = getattr(meta, mk, None)
                if attr is None:
                    return False
                vals = accepted if isinstance(accepted, (list, tuple)) \
                    else [accepted]
                if not any(attr == v or str(attr) == str(v)
                           for v in vals):
                    return False
            return True
        per_store: list[tuple] = []
        with maybe_trace("engine_search"), timer.stage("scan"):
            # launch every store's device work before any host finalize
            handles = [(key, self._store(key)) for key in store_keys]
            handles = [(key, store,
                        store.segment.search_dispatch(qv, fetch))
                       for key, store in handles]
            for key, store, h in handles:
                per_store.append(
                    (key, store, store.segment.search_finalize(h)))
        results: list[list[SearchHit]] = []
        with timer.stage("merge"):
            for qi in range(len(queries)):
                hits: list[SearchHit] = []
                for key, store, (scores, cids) in per_store:
                    for score, cid in zip(scores[qi], cids[qi]):
                        if cid < 0 or not np.isfinite(score):
                            continue
                        meta = store.chunks.get(int(cid))
                        if meta is None:
                            continue
                        if doc_filter is not None \
                                and meta.doc_id not in doc_filter:
                            continue
                        if not _meta_ok(meta):
                            continue
                        hits.append(SearchHit(
                            store_key=key, doc_id=meta.doc_id,
                            doc_name=meta.doc_name, chunk_id=int(cid),
                            text=meta.text, score=float(score),
                            start=meta.start, end=meta.end,
                            ordinal=meta.ordinal))
                hits.sort(key=lambda h: (-h.score, h.store_key, h.chunk_id))
                results.append(hits[:k])
        return results

    def search_batch(self, store_key: str, queries: list[str], k: int = 10
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Batched raw search for benchmarking: (scores [Q,k], chunk_ids)."""
        qv = self.encoder.encode(queries)
        return self._store(store_key).segment.search(qv, k)

    # Synthetic pad ids start far above any real chunk id so they can
    # never collide with ingested chunks (and stay within int32).
    PAD_ID_BASE = 1 << 24
    # pad rows: a unit center (one of PAD_CENTERS) + N(0, PAD_NOISE**2)
    # per coordinate, normalized -- the JAX engine's generator
    PAD_CENTERS = 1024
    PAD_NOISE = 0.35

    def pad_store(self, store_key: str, n: int, *, batch: int = 1 << 19,
                  seed: int = 0) -> dict:
        """Bench/dev only: append ``n`` synthetic metadata-less vectors.

        A serving measurement needs the engine to scan a production-scale
        corpus; the harness seeds a few thousand REAL chunks (queries,
        citations and snippets stay honest) and pads the index with
        clustered synthetic rows, which hit assembly skips (they have no
        ``_ChunkMeta``). Pads are not persisted. For ``ivf_flat_int8``
        the rows are generated on the device and built straight into an
        int8 body (``build_ivf_flat_device``); other modes add host
        rows and rebuild.
        """
        if n <= 0:
            return {"padded": 0}
        d = self.config.dim
        ncenters = self.PAD_CENTERS
        centers = self.pad_centers(seed)
        sigma = np.float32(self.PAD_NOISE)
        PBLOCK = 1 << 18   # pads regenerate on demand, block-seeded

        def pad_block(bi: int) -> np.ndarray:
            rng = np.random.default_rng((seed + 1) * 1_000_003 + bi)
            m = int(min(PBLOCK, n - bi * PBLOCK))
            v = centers[rng.integers(0, ncenters, m)] \
                + rng.standard_normal((m, d), np.float32) * sigma
            v /= np.linalg.norm(v, axis=1, keepdims=True)
            return v

        with self._mutation_lock(store_key):
            store = self._store(store_key)
            with store.lock:
                if store.next_chunk_id >= self.PAD_ID_BASE:
                    raise ValueError("store too large to pad safely")
                base = self.PAD_ID_BASE + self._pad_counts.get(
                    store_key, 0)       # repeat pads never reuse ids
                pad_ids = np.arange(base, base + n, dtype=np.int64)
                seg = store.segment
                if seg.mode == "ivf_flat_int8":
                    self._pad_int8_device(seg, n, centers, sigma, seed,
                                          pad_ids)
                else:
                    done = 0
                    while done < n:
                        m = int(min(batch, n - done))
                        bi, off = divmod(done, PBLOCK)
                        v = pad_block(bi)[off: off + m]
                        seg.add(v, pad_ids[done: done + len(v)])
                        done += len(v)
                    if seg.mode != "exact":
                        seg.rebuild()  # body sized for the final N
                self._pad_counts[store_key] = \
                    self._pad_counts.get(store_key, 0) + n
        return {"padded": int(n), "vectors": store.segment.count}

    def pad_generator(self, centers: np.ndarray, sigma: float, seed: int,
                      chunk: int, device: torch.device):
        """``gen(ci) -> f32 [chunk, dim]`` on ``device``: pad rows drawn
        like the JAX engine's (a unit center plus N(0, sigma^2) a
        coordinate, l2-normalized), deterministic in ``ci``."""
        from rag_foundation_tpu_torch.ops.l2norm import l2_normalize
        d = self.config.dim
        centers_t = torch.as_tensor(centers, device=device)

        def gen(ci: int) -> torch.Tensor:
            g = torch.Generator(device=device).manual_seed(
                (seed + 1) * 1_000_003 + ci)
            cid = torch.randint(0, len(centers), (chunk,), generator=g,
                                device=device)
            noise = torch.randn((chunk, d), generator=g, device=device)
            return l2_normalize(centers_t[cid] + float(sigma) * noise)

        return gen

    def pad_centers(self, seed: int) -> np.ndarray:
        """The ``PAD_CENTERS`` unit centers of ``pad_store(seed=seed)``."""
        centers = np.random.default_rng(seed).standard_normal(
            (self.PAD_CENTERS, self.config.dim), dtype=np.float32)
        centers /= np.linalg.norm(centers, axis=1, keepdims=True)
        return centers

    def _pad_int8_device(self, seg: StoreIndex, n: int, centers: np.ndarray,
                         sigma: np.float32, seed: int,
                         pad_ids: np.ndarray) -> None:
        """Generate the pad rows on the device and build the int8 body
        from the store's live rows + the pads, without the rows ever
        visiting the host."""
        from rag_foundation_tpu_torch.engine.ivf import build_ivf_flat_device
        base_v, base_i = seg.live_rows()
        if len(base_i) > 2_000_000:
            raise ValueError("pad_store expects a small seeded store to pad")
        total = len(base_i) + n
        d = self.config.dim
        dev = seg.device
        chunk = 1 << 18
        gen = self.pad_generator(centers, sigma, seed, chunk, dev)

        body, overflow = build_ivf_flat_device(
            gen, n, d, seg._sized_nlist(total),
            generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev, head=base_v, capacity_slack=1.05, chunk=chunk)
        cids = np.concatenate([base_i, pad_ids])
        cids[overflow] = -1    # dropped rows stay dead
        seg.adopt_body(body, cids)

    def prewarm(self, store_key: str, *, k: int = 5,
                max_bucket: int = 64) -> dict:
        """Run one batched search for every pow2 query bucket up to
        ``max_bucket`` (builds the kernel and touches every search path
        the store's current shapes take)."""
        timings = {}
        b = 1
        while b <= max_bucket:
            t0 = time.perf_counter()
            self._search_group([store_key], ["prewarm probe"] * b, k)
            timings[str(b)] = round(time.perf_counter() - t0, 3)
            b *= 2
        return {"store": store_key, "k": k, "buckets_s": timings}

    # -- generative answer composition ----------------------------------------
    def generate_stream(self, question: str, evidences: list[str],
                        *, max_tokens: int | None = None):
        raise ValueError("the generative decoder is not ported yet")

    def prewarm_generator(self) -> dict:
        raise ValueError("the generative decoder is not ported yet")

    def recall_probe(self, store_key: str, *, sample: int = 32,
                     k: int = 10, seed: int = 0) -> dict:
        """Sampled recall-vs-exact audit against live state: probe
        queries are sampled from the device structures and the exact
        reference scan runs on the device. No lock is held during the
        scans."""
        store = self._store(store_key)
        queries, _qids = store.segment.sample_live_rows(sample, seed=seed)
        n = store.segment.count
        if len(queries) == 0 or n == 0:
            return {"recall": None, "sample": 0, "k": k}
        k_eff = min(k, n)
        _, approx_ids = store.segment.search(queries, k_eff)
        exact_ids = store.segment.exact_reference_search(queries, k_eff)
        recall = float(np.mean([
            len(set(a[a >= 0]) & set(b[b >= 0])) / k_eff
            for a, b in zip(np.asarray(approx_ids), exact_ids)]))
        self.metrics.recall_at_k.labels(store=store_key,
                                        k=str(k_eff)).set(recall)
        self.metrics.update_device_memory(self.device)
        return {"recall": recall, "sample": int(len(queries)),
                "k": k_eff}

    # -- checkpoint / resume --------------------------------------------------
    def _store_dir(self, key: str) -> Path:
        safe = key.replace("/", "_")
        p = Path(self.config.data_dir) / "stores" / safe
        p.mkdir(parents=True, exist_ok=True)
        return p

    def save(self) -> None:
        """Persist every store now (stores also save on each mutation)."""
        for store in list(self._stores.values()):
            with store.lock:
                self._save_store(store)

    def _save_store(self, store: _Store) -> None:
        p = self._store_dir(store.key)
        seg = store.segment
        if seg.body is not None:
            bv = seg.body_version
            if bv != store.saved_body_version \
                    or not (p / "body.npz").exists():
                # the body reloads verbatim (no rebuild, no
                # re-quantization drift); vectors.npz holds only the
                # tail. Skipped when the body is unchanged
                body = seg.body_state()
                tmp = p / "body.npz.tmp"
                with open(tmp, "wb") as f:
                    np.savez(f, **body)
                tmp.replace(p / "body.npz")
                store.saved_body_version = bv
            st = seg.tail.state()
            layout = "tail+body"
        else:
            st = seg.state()
            layout = "full"
            (p / "body.npz").unlink(missing_ok=True)
        tmp_v = p / "vectors.npz.tmp"
        with open(tmp_v, "wb") as f:  # atomic: sibling processes reload
            np.savez_compressed(f, vectors=st["vectors"],  # on mtime
                                ids=st["ids"])
        tmp_v.replace(p / "vectors.npz")
        meta = {
            "key": store.key,
            "dim": self.config.dim,
            "encoder": self.encoder_fingerprint(),
            "layout": layout,
            "next_chunk_id": store.next_chunk_id,
            "chunks": {str(cid): vars(m) for cid, m in store.chunks.items()},
        }
        tmp = p / "meta.json.tmp"
        tmp.write_text(json.dumps(meta))
        tmp.replace(p / "meta.json")
        store.disk_mtime = (p / "meta.json").stat().st_mtime

    def _load_store_dir(self, d: Path) -> _Store | None:
        meta_f = d / "meta.json"
        vec_f = d / "vectors.npz"
        if not (meta_f.exists() and vec_f.exists()):
            return None
        mtime = meta_f.stat().st_mtime
        meta = json.loads(meta_f.read_text())
        saved_enc = meta.get("encoder")
        if saved_enc and saved_enc != self.encoder_fingerprint():
            import logging
            logging.getLogger(__name__).warning(
                "store %s was embedded under encoder %s, configured %s: "
                "searches will be near-random until it is reindexed",
                meta.get("key"), saved_enc, self.encoder_fingerprint())
        kw = self._index_kwargs(str(d) if self.config.data_dir else None)
        body_f = d / "body.npz"
        if meta.get("layout") == "tail+body" and body_f.exists():
            # reload the serialized body, then replay only the tail
            seg = StoreIndex(int(meta["dim"]), **kw)
            with np.load(body_f) as z:
                seg.restore_body({k: z[k] for k in z.files})
            with np.load(vec_f) as z:
                if len(z["ids"]):
                    seg.tail.add(z["vectors"], z["ids"])
        else:
            with np.load(vec_f) as z:
                seg = StoreIndex.from_state(
                    {"vectors": z["vectors"], "ids": z["ids"],
                     "dim": meta["dim"]}, **kw)
        store = _Store(key=meta["key"], segment=seg,
                       next_chunk_id=meta["next_chunk_id"],
                       disk_mtime=mtime)
        store.chunks = {int(cid): _ChunkMeta(**m)
                        for cid, m in meta["chunks"].items()}
        return store

    def _load_all(self) -> None:
        root = Path(self.config.data_dir) / "stores"
        if not root.exists():
            return
        for d in sorted(root.iterdir()):
            store = self._load_store_dir(d)
            if store is not None:
                self._stores[store.key] = store
