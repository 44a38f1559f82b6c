"""IVF-PQ index: coarse quantizer + residual product quantization.

Counterpart of ``rag_foundation_tpu/engine/ivfpq.py``, the memory tier
below int8 IVF-Flat: vectors are stored as ``m`` codes over RESIDUALS
(x - coarse_centroid), so ``score(q, x) = q·c_list + ADC(q, codes)``
with per-query LUTs.

Two ADC engines share the IVF batch-inversion dispatch (engine/ivf.py):

- ``nbits=4`` (K=16, the default): the list scan is the CUDA kernel of
  ``ops/pq_scan.py`` (table lookups in shared memory). Candidates are
  then RE-RANKED against an int8 copy of the original vectors
  (``refine``) by the gather kernel of ``ops/gather.py``, recovering the
  exactness 4-bit codes give up.
- ``nbits=8`` (K=256): byte codes, decoded and scored in plain PyTorch;
  kept for byte-code compatibility.

The refine store is optional: where codes + int8 refine do not both fit
the card, run ``refine=None`` (pure-ADC ranking) or keep the int8 rows
host-side and re-rank there (``engine/archive.py``).

Layouts (codes, row ids, slot interleave, refine padding to 8 rows) are
the JAX package's bit for bit, so a body saved by either loads in the
other. Where JAX donated buffers, the port updates tensors in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rag_foundation_tpu_torch.engine.ivf import (LBLOCK, NEG_INF, _pad_k,
                                                 build_dispatch,
                                                 default_qcap,
                                                 interleave_slots)
from rag_foundation_tpu_torch.engine.profile import search_profile
from rag_foundation_tpu_torch.ops.gather import gather_rescore_int8
from rag_foundation_tpu_torch.ops.kmeans import (assign_clusters,
                                                 assign_clusters_top2,
                                                 kmeans_fit)
from rag_foundation_tpu_torch.ops.l2norm import l2_normalize
from rag_foundation_tpu_torch.ops.pq import (PQCodebook, pq_encode, pq_lut,
                                             pq_train)
from rag_foundation_tpu_torch.ops.pq_scan import (flatten_luts, pack_codes,
                                                  pq_list_scan)
from rag_foundation_tpu_torch.ops.quantize import quantize_int8
from rag_foundation_tpu_torch.ops.topk import stable_topk


def pq_cap_len(n: int, nlist: int, cap_slack: float) -> int:
    """Padded per-list capacity (LBLOCK-aligned) for n rows."""
    mean_len = max(1.0, n / nlist)
    return max(LBLOCK, int(-(-(mean_len * cap_slack) // LBLOCK) * LBLOCK))


class HostScatter:
    """Host-side posting-table scatter: rows land in interleaved slots
    per list, capacity overflow is recorded. numpy only and bit-identical
    to the JAX package's class, so the layout does not depend on which
    package (or process) encoded the chunks."""

    def __init__(self, n: int, nlist: int, cap_len: int, m_bytes: int):
        self.nlist, self.cap_len = nlist, cap_len
        self.codes = np.zeros((nlist * cap_len, m_bytes), np.uint8)
        self.ids = np.full((nlist * cap_len,), -1, np.int32)
        self.next_slot = np.zeros(nlist, np.int64)
        self.overflow = np.zeros(n, bool)

    def _slots(self, list_ids: np.ndarray) -> np.ndarray:
        """Insertion rank of each row within its list (rows of one call
        keep their order), continuing from ``next_slot``."""
        order = np.argsort(list_ids, kind="stable")
        sl = list_ids[order]
        counts = np.bincount(list_ids, minlength=self.nlist)
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        slots = np.empty(len(list_ids), np.int64)
        slots[order] = (np.arange(len(list_ids)) - starts[sl]) \
            + self.next_slot[sl]
        self.next_slot += counts
        return slots

    def _dest(self, list_ids: np.ndarray, slots: np.ndarray,
              ok: np.ndarray) -> np.ndarray:
        return (list_ids.astype(np.int64) * self.cap_len
                + interleave_slots(np.minimum(slots, self.cap_len - 1),
                                   self.cap_len))[ok]

    def scatter(self, assign_h: np.ndarray, codes_h: np.ndarray,
                lo: int, rows: int) -> None:
        slots = self._slots(assign_h)
        ok = slots < self.cap_len
        self.overflow[lo: lo + rows] = ~ok
        dest = self._dest(assign_h, slots, ok)
        self.codes[dest] = codes_h[ok]
        self.ids[dest] = (lo + np.arange(rows, dtype=np.int32))[ok]

    def place_at(self, list_ids: np.ndarray, codes_h: np.ndarray,
                 row_ids: np.ndarray) -> np.ndarray:
        """Capacity spilling: place rows into the GIVEN lists where
        space remains. Returns the placed mask; callers route the rest
        to the exact tail. Clears the rows' overflow flags on success."""
        slots = self._slots(list_ids)
        ok = slots < self.cap_len
        dest = self._dest(list_ids, slots, ok)
        self.codes[dest] = codes_h[ok]
        self.ids[dest] = row_ids[ok].astype(np.int32)
        self.overflow[row_ids[ok]] = False
        return ok


class IVFPQIndex(NamedTuple):
    centroids: torch.Tensor    # [nlist, d] f32 coarse quantizer
    codebook_centroids: torch.Tensor  # [m, K, dsub] f32 (residual PQ)
    codes: torch.Tensor        # [nlist, cap_len, m] uint8, values < K
                               # (or [.., m/2] nibble-packed)
    row_ids: torch.Tensor      # [nlist, cap_len] int32, -1 dead
    n: int
    refine: torch.Tensor       # [N8, d] int8 re-rank store (N8 = N
                               # padded to 8, the JAX package's saved
                               # shape; [0, 0] when disabled)
    refine_scale: float        # f32 value (rows ≈ vectors/scale)

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap_len(self) -> int:
        return self.codes.shape[1]

    @property
    def k_codes(self) -> int:
        return self.codebook_centroids.shape[1]

    @property
    def m(self) -> int:
        return self.codebook_centroids.shape[0]

    @property
    def packed(self) -> bool:
        """Nibble-packed code bytes (2 codes/byte; pq_scan.pack_codes)."""
        return self.codes.shape[2] != self.m

    @property
    def codebook(self) -> PQCodebook:
        return PQCodebook(centroids=self.codebook_centroids)


def _no_refine(device: torch.device) -> torch.Tensor:
    return torch.zeros((0, 0), dtype=torch.int8, device=device)


def _check_packed(packed: bool, nbits: int, m: int) -> None:
    if packed and (nbits != 4 or m % 2):
        raise ValueError("packed codes require nbits=4 and even m")


def layout_lists(assign_h: np.ndarray, codes_h: np.ndarray, nlist: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Batch-build layout: rows sorted by list, interleaved over
    sub-blocks, capacity = the fullest list rounded up to LBLOCK.
    Returns (codes [nlist, cap_len, m_bytes] uint8, row_ids
    [nlist, cap_len] int32)."""
    n = len(assign_h)
    counts = np.bincount(assign_h, minlength=nlist)
    cap_len = max(LBLOCK, int(-(-counts.max() // LBLOCK) * LBLOCK))
    order = np.argsort(assign_h, kind="stable")
    starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(n) - starts[assign_h[order]]
    dest = assign_h[order].astype(np.int64) * cap_len \
        + interleave_slots(rank, cap_len)
    m_bytes = codes_h.shape[-1]
    flat_codes = np.zeros((nlist * cap_len, m_bytes), np.uint8)
    flat_codes[dest] = codes_h[order]
    ids = np.full((nlist * cap_len,), -1, np.int32)
    ids[dest] = order.astype(np.int32)
    return (flat_codes.reshape(nlist, cap_len, m_bytes),
            ids.reshape(nlist, cap_len))


def build_ivf_pq(vectors: torch.Tensor, nlist: int, m: int, *,
                 generator: torch.Generator, nbits: int = 4,
                 refine: bool = True, packed: bool = False,
                 kmeans_iters: int = 10, pq_iters: int = 8,
                 sample: int | None = None) -> IVFPQIndex:
    """Train coarse + residual-PQ codebooks and encode ``vectors`` (on
    the device the index will live on). ``packed`` stores 4-bit codes
    two-per-byte (halves the code table)."""
    _check_packed(packed, nbits, m)
    n, _ = vectors.shape
    dev = vectors.device
    sample = min(n, sample or max(nlist * 64, 16384))
    centroids, _ = kmeans_fit(vectors[:sample].float(), nlist,
                              generator=generator, iters=kmeans_iters,
                              spherical=True)
    assign, _ = assign_clusters(vectors, centroids)
    residuals = vectors.float() - centroids[assign.long()]
    codebook = pq_train(residuals[:sample], m, generator=generator,
                        iters=pq_iters, nbits=nbits)
    codes = pq_encode(codebook, residuals)
    if packed:
        codes = pack_codes(codes)
    codes3d, ids2d = layout_lists(assign.cpu().numpy(), codes.cpu().numpy(),
                                  nlist)
    if refine:
        refine_q, refine_scale = quantize_int8(vectors)
        if n % 8:  # the saved shape pads the table to 8-row groups
            refine_q = torch.nn.functional.pad(refine_q,
                                               (0, 0, 0, 8 - n % 8))
    else:
        refine_q, refine_scale = _no_refine(dev), 1.0
    return IVFPQIndex(
        centroids=centroids,
        codebook_centroids=codebook.centroids,
        codes=torch.as_tensor(codes3d, device=dev),
        row_ids=torch.as_tensor(ids2d, device=dev),
        n=n,
        refine=refine_q,
        refine_scale=float(np.float32(refine_scale)))


def _as_f32(v: torch.Tensor, scale: float) -> torch.Tensor:
    """Rows as f32; int8 rows (the HostArchive transport) are scaled on
    the device."""
    return v.float() * scale


def _encode_chunk(v: torch.Tensor, centroids: torch.Tensor,
                  cb_centroids: torch.Tensor, scale: float = 1.0, *,
                  packed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Device encode for one build chunk: coarse assign -> residual ->
    PQ codes (nibble-packed when ``packed``). Returns (assign [n] int32,
    codes [n, m_bytes] uint8)."""
    v32 = _as_f32(v, scale)
    assign, _ = assign_clusters(v32, centroids, block_size=65536)
    return assign, _encode_rows(v32, assign, centroids, cb_centroids,
                                packed)[0]


def _encode_chunk_top2(v: torch.Tensor, centroids: torch.Tensor,
                       cb_centroids: torch.Tensor, scale: float = 1.0, *,
                       packed: bool
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like ``_encode_chunk`` but also returns the SECOND-nearest list
    per row — the spill target when the first list is at capacity
    (codes are still residuals vs the first choice; spilled rows are
    re-encoded vs their landing list by ``_encode_rows_for_lists``)."""
    v32 = _as_f32(v, scale)
    a1, a2 = assign_clusters_top2(v32, centroids, block_size=65536)
    return a1, a2, _encode_rows(v32, a1, centroids, cb_centroids, packed)[0]


def _encode_rows(v32, list_ids, centroids, cb_centroids, packed):
    residual = v32 - centroids[list_ids.long()]
    codes = pq_encode(PQCodebook(centroids=cb_centroids), residual)
    return (pack_codes(codes) if packed else codes), residual


def _encode_rows_for_lists(v: torch.Tensor, list_ids: torch.Tensor,
                           centroids: torch.Tensor,
                           cb_centroids: torch.Tensor, scale: float = 1.0,
                           *, packed: bool
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """PQ codes + residual norms for rows ``v`` as members of the GIVEN
    lists (residual vs that list's centroid) — the spill re-encode. The
    norm lets the caller reject spills whose residual exceeds the
    codebook's training range (quantizing far outside it reconstructs
    ~the landing centroid, not the row)."""
    codes, residual = _encode_rows(_as_f32(v, scale), list_ids, centroids,
                                   cb_centroids, packed)
    return codes, torch.linalg.norm(residual, dim=1)


_SEED_GROUP = 16


def _seed_pool(sample: torch.Tensor, group: int = _SEED_GROUP
               ) -> torch.Tensor | None:
    """Means of ``group`` ADJACENT sample rows, l2-normalized — the
    farthest-seeding pool. Rows arrive document-grouped (chunker
    ordering), so adjacent means estimate document centers: within-
    document drift can rival between-cluster separation, which blinds
    farthest seeding over raw rows; group means suppress it by
    ~sqrt(group). None (seed from rows) when the sample is too small to
    matter."""
    n = (sample.shape[0] // group) * group
    if n < group * 4:
        return None
    means = sample[:n].reshape(n // group, group, -1).mean(dim=1)
    return l2_normalize(means)


def _spill_pass(hs: HostScatter, a2_host: np.ndarray, source_rows,
                source_scale: float, centroids: torch.Tensor,
                cb_centroids: torch.Tensor, *, packed: bool,
                resid_cap: float = np.inf, batch: int = 1 << 20) -> None:
    """Re-encode capacity-overflow rows against their second-nearest
    list and place them where space remains (see
    ``build_ivf_pq_streaming``). Rows whose second-choice residual norm
    exceeds ``resid_cap`` (the codebook's training range) are NOT
    spilled — their codes would reconstruct ~the landing centroid —
    and stay in the overflow mask for the exact tail."""
    dev = centroids.device
    spilled = np.nonzero(hs.overflow)[0]
    for lo_s in range(0, len(spilled), batch):
        idxs = spilled[lo_s: lo_s + batch]
        v_r = np.asarray(source_rows(idxs))
        scale = source_scale if v_r.dtype == np.int8 else 1.0
        lists_r = a2_host[idxs]
        codes_r, rn2 = _encode_rows_for_lists(
            torch.as_tensor(v_r, device=dev),
            torch.as_tensor(lists_r, device=dev), centroids, cb_centroids,
            scale, packed=packed)
        keep = rn2.cpu().numpy() <= resid_cap
        if keep.any():
            hs.place_at(lists_r[keep], codes_r.cpu().numpy()[keep],
                        idxs[keep])


def build_ivf_pq_streaming(
    source,
    n: int,
    d: int,
    nlist: int,
    m: int,
    *,
    generator: torch.Generator,
    device: str | torch.device,
    nbits: int = 4,
    packed: bool = True,
    cap_slack: float = 1.25,
    chunk: int = 262_144,
    kmeans_iters: int = 10,
    pq_iters: int = 6,
    kmeans_sample: int | None = None,
    pq_sample: int = 65_536,
    source_scale: float = 1.0,
    refine: str = "none",
    source_rows=None,
    progress=None,
) -> tuple[IVFPQIndex, np.ndarray]:
    """Host-staged IVF-PQ build from a chunked source — the production
    path for corpora whose f32 form cannot exist on the device OR the
    host.

    ``source(lo, hi)`` returns rows [hi-lo, d] as f32, or int8 to be
    scaled by ``source_scale`` (the HostArchive layout — int8 moves a
    quarter of the bytes to the card). Codes are encoded on the device
    chunk by chunk, fetched, scattered into a host-side table
    (``HostScatter``, so the layout is the JAX package's), and uploaded
    ONCE.

    Device work for chunk i+1 is launched before chunk i's host scatter
    runs: the device-to-host copy of a chunk's codes is the only point
    that waits for the device, so the numpy pass overlaps the next
    encode.

    ``refine="device"`` attaches an int8 refine table built from the
    same source, filled chunk by chunk on the device as the chunks pass
    (requires it to fit the card; use "none" + a HostArchive rescore
    beyond that).

    ``source_rows(idx)`` (optional, HostArchive.rows_i8-shaped) enables
    **capacity spilling**: rows whose first-choice list is full are
    re-encoded against their SECOND-nearest list's centroid and placed
    there if it has space (nprobe-scale probing almost surely visits the
    runner-up list, so recall cost is marginal).

    Returns ``(index, overflow_mask [n] bool)`` — rows still overflowing
    after spilling are NOT in the index; callers keep them searchable
    elsewhere (StoreIndex re-routes them to the exact tail).
    """
    _check_packed(packed, nbits, m)
    dev = torch.device(device)

    def upload(lo, hi) -> tuple[torch.Tensor, float]:
        # int8 sources upload RAW and scale on the device
        raw = np.asarray(source(lo, hi))
        if raw.dtype == np.int8:
            return torch.as_tensor(raw, device=dev), source_scale
        return torch.as_tensor(raw.astype(np.float32, copy=False),
                               device=dev), 1.0

    def fetch(lo, hi) -> torch.Tensor:
        v, s = upload(lo, hi)
        return _as_f32(v, s)

    # -- train coarse + PQ codebooks ---------------------------------------
    # Posting-list balance needs ALL THREE (each alone is insufficient):
    #  * evenly spaced sample windows — real ingestion orders are
    #    temporally clustered and a head-trained quantizer misses later
    #    topics;
    #  * farthest-point seeding over GROUP MEANS (_seed_pool) — random
    #    seeding leaves ~1/e of separated clusters unseeded and Lloyd
    #    cannot split the merged lists; raw-row seeding fails when
    #    within-document drift rivals cluster separation;
    #  * >=128 rows/centroid so Lloyd's centroid noise does not shift
    #    Voronoi boundaries and disperse list sizes.
    sample_n = min(n, kmeans_sample or max(nlist * 128, 16_384))
    windows = 16 if n > 2 * sample_n else 1
    per = -(-sample_n // windows)
    # bases snap to _SEED_GROUP so seed-pool group means stay aligned
    # with document-grouped row order (a group straddling two documents
    # averages two topics into a useless midpoint seed)
    parts = [fetch(0, min(n, per))] if windows == 1 else [
        fetch(base - base % _SEED_GROUP,
              min(n, base - base % _SEED_GROUP + per))
        for base in ((n - per) * wi // (windows - 1)
                     for wi in range(windows))]
    sample = torch.cat(parts)[:sample_n]
    del parts
    centroids, _ = kmeans_fit(sample, nlist, generator=generator,
                              iters=kmeans_iters, spherical=True,
                              seed_method="farthest",
                              seed_pool=_seed_pool(sample))
    ps = min(sample_n, pq_sample)
    assign_s, _ = assign_clusters(sample[:ps], centroids)
    residual_s = sample[:ps] - centroids[assign_s.long()]
    codebook = pq_train(residual_s, m, generator=generator, iters=pq_iters,
                        nbits=nbits)
    # the codebook's useful dynamic range: spills beyond it reconstruct
    # ~the landing centroid instead of the row (see _spill_pass)
    resid_cap = 2.0 * float(torch.quantile(
        torch.linalg.norm(residual_s, dim=1), 0.95))
    del sample, assign_s, residual_s

    # -- host-staged scatter ----------------------------------------------
    cap_len = pq_cap_len(n, nlist, cap_slack)
    m_bytes = m // 2 if packed else m
    hs = HostScatter(n, nlist, cap_len, m_bytes)
    spill = source_rows is not None
    a2_host = np.empty(n, np.int32) if spill else None
    want_refine = refine == "device"
    refine_dev, refine_scale = _no_refine(dev), 1.0
    if want_refine:
        # the refine table keeps ALL source rows — row ids index it;
        # padded to 8 rows (the saved shape), pad rows zero
        refine_dev = torch.zeros((n + (-n) % 8, d), dtype=torch.int8,
                                 device=dev)

    def launch(lo: int):
        """Queue one chunk's device work; nothing here waits for it."""
        nonlocal refine_scale
        hi = min(n, lo + chunk)
        v, vscale = upload(lo, hi)
        if want_refine:
            if v.dtype == torch.int8:
                refine_dev[lo:hi] = v
                refine_scale = source_scale
            else:
                refine_dev[lo:hi] = torch.clamp(
                    torch.round(v * 127.0), -127, 127).to(torch.int8)
                refine_scale = 1.0 / 127.0
        if spill:
            a, a2, c = _encode_chunk_top2(v, centroids, codebook.centroids,
                                          vscale, packed=packed)
        else:
            a, c = _encode_chunk(v, centroids, codebook.centroids, vscale,
                                 packed=packed)
            a2 = None
        return a, a2, c, lo, hi - lo

    pending = launch(0) if n else None
    while pending is not None:
        a_dev, a2_dev, c_dev, plo, prows = pending
        # the one wait: this chunk's results come to the host
        a_h, c_h = a_dev.cpu().numpy(), c_dev.cpu().numpy()
        if spill:
            a2_host[plo: plo + prows] = a2_dev.cpu().numpy()
        nxt = plo + prows
        pending = launch(nxt) if nxt < n else None   # runs during scatter
        hs.scatter(a_h, c_h, plo, prows)
        if progress is not None:
            progress(plo + prows, n)

    if spill and hs.overflow.any():
        _spill_pass(hs, a2_host, source_rows, source_scale, centroids,
                    codebook.centroids, packed=packed, resid_cap=resid_cap)

    # -- single upload ------------------------------------------------------
    codes_dev = torch.as_tensor(hs.codes, device=dev).view(nlist, cap_len,
                                                           m_bytes)
    ids_dev = torch.as_tensor(hs.ids, device=dev).view(nlist, cap_len)
    overflow = hs.overflow
    del hs

    index = IVFPQIndex(
        centroids=centroids,
        codebook_centroids=codebook.centroids,
        codes=codes_dev,
        row_ids=ids_dev,
        n=n - int(overflow.sum()),
        refine=refine_dev,
        refine_scale=float(np.float32(refine_scale)))
    return index, overflow


def pq_build_step(codes_flat: torch.Tensor, ids_flat: torch.Tensor,
                  next_slot: torch.Tensor, v: torch.Tensor, row_base: int,
                  centroids: torch.Tensor, cb_centroids: torch.Tensor,
                  scale: float = 1.0, *, packed: bool = True):
    """One ON-DEVICE chunk step of an IVF-PQ build: encode → per-list
    slot allocation → scatter of codes + ids.

    The device-resident build path: when chunk vectors are already on
    the device nothing crosses to the host. The three tables
    ``codes_flat [M, m_bytes] u8``, ``ids_flat [M] i32`` (-1 = dead) and
    ``next_slot [nlist] i32`` are UPDATED IN PLACE (where the JAX
    function donates them) and returned for the same call shape.

    Slot allocation mirrors the host pass (``HostScatter``) bit for
    bit: stable sort by list id → rank within chunk → ``next_slot``
    offset → sub-block interleave; rows past ``cap_len`` are dropped
    (filtered before the scatter, never wrapped) — callers re-route
    dropped rows.

    ``v [chunk, d]`` is f32, or int8 scaled by ``scale`` on the device.
    Returns ``(codes_flat, ids_flat, next_slot, n_dropped)``.
    """
    nlist = centroids.shape[0]
    cap_len = ids_flat.shape[0] // nlist
    chunk = v.shape[0]
    dev = v.device
    assign, codes = _encode_chunk(v, centroids, cb_centroids, scale,
                                  packed=packed)
    assign = assign.long()
    order = torch.argsort(assign, stable=True)
    sa = assign[order]
    counts = torch.bincount(assign, minlength=nlist)
    starts = torch.cumsum(counts, 0) - counts
    slot_sorted = torch.arange(chunk, device=dev) - starts[sa] \
        + next_slot[sa].long()
    slots = torch.empty(chunk, dtype=torch.int64, device=dev)
    slots[order] = slot_sorted
    ok = slots < cap_len
    nsub = cap_len // LBLOCK
    islot = (slots % nsub) * LBLOCK + slots // nsub
    dest = (assign * cap_len + islot)[ok]
    codes_flat.index_copy_(0, dest, codes[ok])
    ids_flat.index_copy_(0, dest, (row_base + torch.arange(
        chunk, dtype=torch.int32, device=dev))[ok])
    next_slot += counts.to(next_slot.dtype)
    return codes_flat, ids_flat, next_slot, chunk - ok.sum()


def ivfpq_append(
    index: IVFPQIndex,
    vectors: torch.Tensor,    # [n, d] float
    row_ids: np.ndarray,      # [n] int32 global row ids
) -> tuple[IVFPQIndex, np.ndarray]:
    """Streaming PQ insert: encode with the EXISTING coarse + PQ
    codebooks and scatter into free list slots — O(batch), no retrain,
    no relayout.

    Same contract as ivf_append: returns the updated index plus the
    mask of rows DROPPED by list-capacity overflow (the caller keeps
    them searchable and compacts later). The code and id tensors are
    updated in place; callers serialize appends against readers.

    When the index carries a device refine table it is grown with 12.5%
    slack (amortized copies); appended rows land at their row-id
    positions so refine row i always matches global row i.
    """
    n = vectors.shape[0]
    nlist, cap_len, m_bytes = index.codes.shape
    dev = index.codes.device
    v32 = vectors.to(dev).float()
    assign, codes = _encode_chunk(v32, index.centroids,
                                  index.codebook_centroids,
                                  packed=index.packed)
    assign_h = assign.cpu().numpy()
    fill = (index.row_ids >= 0).sum(dim=1).cpu().numpy()
    order = np.argsort(assign_h, kind="stable")
    sa = assign_h[order]
    counts = np.bincount(assign_h, minlength=nlist)
    starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(n) - starts[sa]
    ranks_full = np.empty(n, np.int64)
    ranks_full[order] = rank + fill[sa]
    dropped = ranks_full >= cap_len
    keep = np.nonzero(~dropped)[0]
    if len(keep):
        dest = assign_h[keep].astype(np.int64) * cap_len \
            + interleave_slots(ranks_full[keep], cap_len)
        dst = torch.as_tensor(dest, device=dev)
        src = torch.as_tensor(keep, device=dev)
        index.codes.view(nlist * cap_len, m_bytes).index_copy_(
            0, dst, codes[src])
        index.row_ids.view(nlist * cap_len).index_copy_(
            0, dst, torch.as_tensor(np.asarray(row_ids, np.int32)[keep],
                                    device=dev))

    refine = index.refine
    if refine.shape[0] > 0:
        need = int(np.max(row_ids)) + 1
        have = refine.shape[0]
        if need > have:
            grow = max(need, have + have // 8)
            grow += (-grow) % 8
            refine = torch.nn.functional.pad(refine, (0, 0, 0, grow - have))
        vq = torch.clamp(torch.round(v32 / index.refine_scale), -127,
                         127).to(torch.int8)
        refine.index_copy_(0, torch.as_tensor(
            np.asarray(row_ids, np.int64), device=dev), vq)

    return index._replace(n=index.n + n - int(dropped.sum()),
                          refine=refine), dropped


def _regather(vals, flat_idx, probe_lists, slot, qcap):
    """Per-query candidates from the per-list scan outputs: [Q, nprobe, w]
    values and flat corpus positions."""
    safe_slot = torch.clamp(slot, 0, qcap - 1)
    return vals[probe_lists, safe_slot], flat_idx[probe_lists, safe_slot]


def scan_inputs(index: IVFPQIndex, q32: torch.Tensor, dispatch: torch.Tensor,
                lut_dtype: torch.dtype | str = torch.int8
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ADC list scan's LUT input for a routed batch: per-query LUTs,
    flattened and quantized, gathered per (list, slot) of ``dispatch``.
    Returns (lut_disp [nlist, qcap, K*m], lut_scale [Q])."""
    q_n = q32.shape[0]
    lut = pq_lut(index.codebook, q32)            # [Q, m, K] f32
    lut_flat, lut_scale = flatten_luts(lut, lut_dtype, packed=index.packed)
    safe_q = torch.clamp(dispatch, 0, q_n - 1).long()
    return lut_flat[safe_q], lut_scale


def _kernel_candidates(vals, flat_idx, lut_scale, coarse, probe_lists, slot,
                       qcap):
    """Kernel ADC path (K=16): per-query candidates [Q, nprobe*w] from the
    list scan's outputs."""
    q_n = probe_lists.shape[0]
    cand_vals, cand_idx = _regather(vals, flat_idx, probe_lists, slot, qcap)
    # per-query LUT scale (int8 LUTs), then the coarse term q·c_list —
    # both constant within a (query, list) pair, so neither can change
    # the top-p selection inside a list
    cand_vals = cand_vals * lut_scale[:, None, None]
    coarse_term = torch.gather(coarse, 1, probe_lists)
    cand_vals = cand_vals + coarse_term[:, :, None]
    valid = (slot >= 0)[:, :, None] & (cand_idx >= 0)
    cand_vals = torch.where(valid, cand_vals,
                            torch.full_like(cand_vals, NEG_INF))
    cand_idx = torch.where(valid, cand_idx, torch.full_like(cand_idx, -1))
    return cand_vals.reshape(q_n, -1), cand_idx.reshape(q_n, -1)


def _adc_candidates_decode(index: IVFPQIndex, q32, coarse, dispatch,
                           probe_lists, slot, *, p, qcap, list_block):
    """Byte-code ADC (K=256) in plain PyTorch: decode each list block to
    bf16 vectors and score them against the dispatched queries with f32
    accumulation, top-p per (list, slot)."""
    q_n = q32.shape[0]
    nlist, cap_len, m = index.codes.shape
    dev = q32.device
    safe_q = torch.clamp(dispatch, 0, q_n - 1).long()
    list_block = min(list_block, nlist)
    while nlist % list_block:  # keep blocks exact
        list_block -= 1
    cb = index.codebook_centroids.to(torch.bfloat16).float()
    q_bf = q32.to(torch.bfloat16).float()
    sub = torch.arange(m, device=dev)
    p_eff = min(p, cap_len)
    vals = torch.empty((nlist, qcap, p_eff), dtype=torch.float32, device=dev)
    flat_idx = torch.empty((nlist, qcap, p_eff), dtype=torch.int32,
                           device=dev)
    for sl in range(0, nlist, list_block):
        se = sl + list_block
        dec = cb[sub[None, None, :], index.codes[sl:se].long()].reshape(
            list_block, cap_len, -1)                 # [LB, cap, d]
        safe_b = safe_q[sl:se]
        scores = torch.bmm(q_bf[safe_b], dec.transpose(1, 2))
        list_ids = torch.arange(sl, se, device=dev)
        scores = scores + coarse[safe_b, list_ids[:, None]][:, :, None]
        live = (index.row_ids[sl:se, None, :] >= 0) \
            & (dispatch[sl:se, :, None] >= 0)
        scores = torch.where(live, scores,
                             torch.full_like(scores, NEG_INF))
        top_vals, top_pos = stable_topk(scores, p_eff)   # [LB, qcap, p]
        fi = (list_ids[:, None, None] * cap_len + top_pos).to(torch.int32)
        vals[sl:se] = top_vals
        flat_idx[sl:se] = torch.where(torch.isfinite(top_vals), fi,
                                      torch.full_like(fi, -1))
    cand_vals, cand_idx = _regather(vals, flat_idx, probe_lists, slot, qcap)
    valid = (slot >= 0)[:, :, None]
    cand_vals = torch.where(valid, cand_vals,
                            torch.full_like(cand_vals, NEG_INF))
    cand_idx = torch.where(valid, cand_idx, torch.full_like(cand_idx, -1))
    return cand_vals.reshape(q_n, -1), cand_idx.reshape(q_n, -1)


def _refine_rerank(index: IVFPQIndex, q32: torch.Tensor,
                   top_rows: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Re-rank ADC top-C rows against the int8 refine store.

    ADC (especially 4-bit) is a candidate GENERATOR; exact int8 scores
    restore ranking fidelity. One gather-and-rescore launch per search:
    the kernel never materializes the gathered ``[Q, C, d]`` rows, so
    the query blocking of the JAX function is not needed."""
    c = top_rows.shape[1]
    qq, qscale = quantize_int8(q32)
    scores = gather_rescore_int8(index.refine, top_rows.contiguous(), qq)
    scores = scores * float(np.float32(qscale)
                            * np.float32(index.refine_scale))
    scores = torch.where(top_rows >= 0, scores,
                         torch.full_like(scores, NEG_INF))
    k_eff = min(k, c)
    vals, pos = stable_topk(scores, k_eff)
    rows = torch.gather(top_rows, 1, pos)
    rows = torch.where(torch.isfinite(vals), rows,
                       torch.full_like(rows, -1))
    return vals, rows, k_eff


def route(index: IVFPQIndex, queries: torch.Tensor, nprobe: int,
          qcap: int | None = None, q_scale: float | None = None):
    """Dequantize (``q_scale``), score the coarse centroids and invert the
    batch: (q32, coarse [Q, nlist], probe_lists, dispatch, slot,
    dropped). ``qcap=None`` takes the JAX package's default; probes past
    a list's capacity are dropped, as there, and counted in
    ``search_profile``."""
    q_n = queries.shape[0]
    if qcap is None:
        qcap = default_qcap(q_n, nprobe, index.nlist)
    q32 = queries.to(index.codes.device).float()
    if q_scale is not None:
        q32 = q32 * q_scale
    coarse = q32 @ index.centroids.T                       # [Q, nlist]
    probe_lists, dispatch, slot, dropped = build_dispatch(coarse, nprobe,
                                                          qcap)
    search_profile.count_probes(q_n * nprobe, dropped)
    return q32, coarse, probe_lists, dispatch, slot, dropped


def adc_top_rows(
    index: IVFPQIndex,
    queries: torch.Tensor,
    k: int,
    *,
    nprobe: int = 32,
    p: int = 8,
    qcap: int | None = None,
    refine_c: int | None = None,
    list_block: int = 32,
    lut_dtype: str = "int8",
    q_scale: float | None = None,
    rerank_k: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The candidate stage of ``ivfpq_search``: route, ADC-scan the
    probed lists, and keep the ADC top-C rows (C = ``refine_c`` or
    ``max(4k, 32)`` with a refine store, else ``k``). Returns (q32
    [Q, d], values [Q, C], global row ids [Q, C] int32 (-1 pads),
    dropped_probes). With ``rerank_k``, the values and rows are then
    ``ivfpq_search``'s top ``rerank_k``: re-ranked against the refine
    store where the index has one, padded to ``rerank_k``.

    ``search_profile`` stages: ``route`` (coarse product, dispatch, LUTs),
    ``scan`` (the list scan), ``regather`` (candidates per query, the
    selection, the re-rank)."""
    nlist, cap_len, _ = index.codes.shape
    nprobe = min(nprobe, nlist)
    kernel = index.k_codes == 16
    with search_profile.stage("route"):
        q32, coarse, probe_lists, dispatch, slot, dropped = route(
            index, queries, nprobe, qcap, q_scale)
        qcap = dispatch.shape[1]
        if kernel:
            lut_disp, lut_scale = scan_inputs(
                index, q32, dispatch,
                torch.int8 if lut_dtype == "int8" else torch.bfloat16)
    with search_profile.stage("scan"):
        if kernel:
            vals, flat_idx = pq_list_scan(lut_disp, index.codes,
                                          index.row_ids, dispatch,
                                          k_codes=index.k_codes, p=p)
        else:
            cand_vals, cand_idx = _adc_candidates_decode(
                index, q32, coarse, dispatch, probe_lists, slot, p=p,
                qcap=qcap, list_block=list_block)
    with search_profile.stage("regather"):
        if kernel:
            cand_vals, cand_idx = _kernel_candidates(
                vals, flat_idx, lut_scale, coarse, probe_lists, slot, qcap)
        width = cand_vals.shape[1]
        has_refine = index.refine.shape[0] > 0
        c_eff = min(refine_c or max(4 * k, 32), width) if has_refine \
            else min(k, width)
        top_vals, pos = stable_topk(cand_vals, c_eff)
        top_flat = torch.gather(cand_idx, 1, pos)
        safe_flat = torch.clamp(top_flat, 0, nlist * cap_len - 1).long()
        rows = index.row_ids.reshape(-1)[safe_flat]
        rows = torch.where((top_flat >= 0) & torch.isfinite(top_vals), rows,
                           torch.full_like(rows, -1))
        if rerank_k is not None:
            if has_refine:
                top_vals, rows, _ = _refine_rerank(index, q32, rows,
                                                   rerank_k)
            else:
                top_vals = torch.where(rows >= 0, top_vals,
                                       torch.full_like(top_vals, NEG_INF))
            top_vals, rows = _pad_k(top_vals[:, :rerank_k],
                                    rows[:, :rerank_k], rerank_k)
    return q32, top_vals, rows, dropped


def ivfpq_search(
    index: IVFPQIndex,
    queries: torch.Tensor,
    k: int,
    *,
    nprobe: int = 32,
    p: int = 8,
    qcap: int | None = None,
    refine_c: int | None = None,
    list_block: int = 32,
    lut_dtype: str = "int8",
    cap_block: int | None = None,
    q_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """IVF-PQ top-k: (values [Q,k], row_ids [Q,k], dropped_probes).

    K=16 codes route through the ADC list-scan kernel; K=256 through the
    plain PyTorch decode. When the index carries a refine store, the ADC
    top-``refine_c`` (default ``max(4k, 32)``) candidates are re-ranked
    against int8 originals and values are exact int8 dot products;
    otherwise values are (coarse + ADC) approximations. Every selection
    is a stable sort: ties go to the lower position, as ``lax.top_k``.

    ``q_scale``: queries arrived quantized (int8 xQ/s); dequantized on
    the device before routing and the LUT build. ``cap_block`` is
    accepted for interface parity and has no effect.
    """
    del cap_block
    _, top_vals, rows, dropped = adc_top_rows(
        index, queries, k, nprobe=nprobe, p=p, qcap=qcap, refine_c=refine_c,
        list_block=list_block, lut_dtype=lut_dtype, q_scale=q_scale,
        rerank_k=k)
    return top_vals, rows, dropped
