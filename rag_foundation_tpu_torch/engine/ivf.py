"""IVF-Flat index: k-means coarse quantizer + uniform-capacity posting
lists + inverted query dispatch.

Counterpart of ``rag_foundation_tpu/engine/ivf.py``, with the same
layout bit for bit: vectors are assigned, sorted by list and laid out in
a dense ``[nlist, cap_len, d]`` tensor (dead slots carry id -1),
round-robin interleaved over 128-row sub-blocks.

Query: coarse matmul -> per-query top-``nprobe`` lists -> batch-level
INVERSION (for each list, which queries probe it, capacity ``qcap``) ->
one list scan per list (``ops/ivf_scan.py``, a CUDA kernel on the card)
-> per-query candidate regather -> final top-k. Every selection is a
stable sort, so ties go to the lower position as with ``lax.top_k``.

Supports f32/bf16 storage or int8 (per-tensor symmetric).
"""

from __future__ import annotations

import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from rag_foundation_tpu_torch.engine.profile import search_profile
from rag_foundation_tpu_torch.ops.ivf_scan import (S8_SLOTS, ivf_list_scan,
                                                   live_slots, scan_rows)
from rag_foundation_tpu_torch.ops.kmeans import assign_clusters, kmeans_fit
from rag_foundation_tpu_torch.ops.quantize import (int8_matmul,
                                                   quantize_int8,
                                                   quantize_with_scale)
from rag_foundation_tpu_torch.ops.topk import stable_topk

LBLOCK = 128  # list capacity granularity (sub-block width)
NEG_INF = float("-inf")


def interleave_slots(rank: np.ndarray, cap_len: int) -> np.ndarray:
    """Map in-list insertion ranks to sub-block-interleaved slots.

    The list scan extracts top-p PER 128-wide SUB-BLOCK; round-robin
    placement (slot = (rank % nsub)*128 + rank//nsub) spreads any m
    members evenly across sub-blocks, so the per-sub-block capture model
    holds for every list length. Bijection on [0, cap_len) for
    cap_len = nsub*128.
    """
    nsub = cap_len // LBLOCK
    return (rank % nsub) * LBLOCK + rank // nsub


class IVFFlatIndex(NamedTuple):
    centroids: torch.Tensor   # [nlist, d] f32
    lists: torch.Tensor       # [nlist, cap_len, d] storage dtype
    row_ids: torch.Tensor     # [nlist, cap_len] int32 global row ids, -1 dead
    scale: float              # f32 value (1.0 unless int8)
    n: int                    # live vector count

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap_len(self) -> int:
        return self.lists.shape[1]


def _cap_len(counts: np.ndarray, slack: float) -> int:
    need = int(counts.max() * slack)
    return max(LBLOCK, int(-(-need // LBLOCK) * LBLOCK))


def build_ivf_flat(
    vectors: torch.Tensor,
    nlist: int,
    *,
    generator: torch.Generator,
    kmeans_iters: int = 10,
    sample: int | None = None,
    dtype: torch.dtype | None = None,
    int8: bool = False,
    capacity_slack: float = 1.0,
) -> IVFFlatIndex:
    """Train + populate an IVF-Flat index from ``vectors [N, d]`` (on the
    device the index will live on)."""
    n, d = vectors.shape
    dev = vectors.device
    sample = min(n, sample or max(nlist * 64, 16384))
    centroids, _ = kmeans_fit(vectors[:sample].float(), nlist,
                              generator=generator, iters=kmeans_iters,
                              spherical=True)
    assign, _ = assign_clusters(vectors, centroids)

    # host-side layout (build path; one-time cost)
    assign_h = assign.cpu().numpy()
    counts = np.bincount(assign_h, minlength=nlist)
    cap_len = _cap_len(counts, capacity_slack)
    order = np.argsort(assign_h, kind="stable")
    sorted_assign = assign_h[order]
    starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(n) - starts[sorted_assign]
    dest = sorted_assign.astype(np.int64) * cap_len \
        + interleave_slots(rank, cap_len)

    if int8:
        src, scale = quantize_int8(vectors)
    else:
        src, scale = vectors.to(dtype or vectors.dtype), 1.0
    flat = torch.zeros((nlist * cap_len, d), dtype=src.dtype, device=dev)
    flat[torch.as_tensor(dest, device=dev)] = src[torch.as_tensor(
        order, device=dev)]
    ids = np.full((nlist * cap_len,), -1, np.int32)
    ids[dest] = order.astype(np.int32)
    return IVFFlatIndex(
        centroids=centroids,
        lists=flat.view(nlist, cap_len, d),
        row_ids=torch.as_tensor(ids, device=dev).view(nlist, cap_len),
        scale=float(np.float32(scale)),
        n=n)


def build_ivf_flat_streaming(
    source,
    n: int,
    d: int,
    nlist: int,
    *,
    generator: torch.Generator,
    device: str | torch.device,
    kmeans_iters: int = 10,
    sample: int | None = None,
    capacity_slack: float = 1.0,
    chunk: int = 262_144,
    progress=None,
    source_scale: float | None = None,
) -> tuple[IVFFlatIndex, np.ndarray]:
    """Host-staged int8 IVF-Flat build for corpora whose f32 form cannot
    sit on the device (the direct ``build_ivf_flat`` materializes exactly
    that; flat analog of ``build_ivf_pq_streaming``).

    ``source(lo, hi) -> np f32 [hi-lo, d]``. Device work is the k-means
    sample fit plus per-chunk assignment (int32 down: 4 B/vec);
    quantization and the interleaved layout run in host numpy, and the
    packed int8 table uploads once.

    ``source`` may instead return int8 rows with ``source_scale`` set
    (dequantized value = row * source_scale): pass-1 uploads then move a
    quarter of the bytes (dequantization happens on the device) and pass
    2 stores the rows verbatim with ``scale = source_scale``.

    Returns ``(index, overflow_mask [n])``: with the default
    ``capacity_slack=1.0`` capacity tracks the true max list count and
    nothing overflows; a tighter explicit cap (memory-bounded callers)
    drops the masked rows, which callers must re-route (exact tail).
    """
    dev = torch.device(device)

    def fetch(lo, hi) -> np.ndarray:
        raw = np.asarray(source(lo, hi))
        if raw.dtype == np.int8:
            if source_scale is None:
                raise ValueError("int8 source requires source_scale")
            return raw
        return raw.astype(np.float32, copy=False)

    def upload(rows: np.ndarray) -> torch.Tensor:
        # int8 sources upload RAW and scale on the device
        v = torch.as_tensor(rows, device=dev)
        return v.float() * source_scale if v.dtype == torch.int8 else v

    sample_n = min(n, sample or max(nlist * 64, 16_384))
    centroids, _ = kmeans_fit(upload(fetch(0, sample_n)), nlist,
                              generator=generator, iters=kmeans_iters,
                              spherical=True)

    # pass 1: assignments (4 B/vec come down) + global absmax for the
    # shared int8 scale
    assigns = np.empty(n, np.int32)
    absmax = 1e-12
    int8_src = False

    def launch(lo: int):
        """Upload one chunk and queue its assignment; nothing here waits
        for the device."""
        nonlocal absmax, int8_src
        hi = min(n, lo + chunk)
        rows = fetch(lo, hi)
        int8_src = rows.dtype == np.int8
        if not int8_src:
            absmax = max(absmax, float(np.abs(rows).max()))
        return lo, hi, assign_clusters(upload(rows), centroids)[0]

    pending = launch(0) if n else None
    while pending is not None:
        lo, hi, a_dev = pending
        pending = launch(hi) if hi < n else None    # queued before the wait
        assigns[lo:hi] = a_dev.cpu().numpy()

    counts = np.bincount(assigns, minlength=nlist)
    cap_len = _cap_len(counts, capacity_slack)
    scale = float(source_scale) if int8_src else absmax / 127.0

    # pass 2: host quantize + interleaved scatter (same dest math as
    # build_ivf_flat: bit-identical layout)
    flat = np.zeros((nlist * cap_len, d), np.int8)
    ids = np.full((nlist * cap_len,), -1, np.int32)
    next_slot = np.zeros(nlist, np.int64)
    overflow = np.zeros(n, bool)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        rows = fetch(lo, hi)
        a = assigns[lo:hi]
        order = np.argsort(a, kind="stable")
        sa = a[order]
        ccounts = np.bincount(a, minlength=nlist)
        cstarts = np.concatenate(([0], np.cumsum(ccounts)[:-1]))
        rank = (np.arange(hi - lo) - cstarts[sa]) + next_slot[sa]
        next_slot += ccounts
        ok = rank < cap_len
        overflow[lo:hi][order] = ~ok
        dest = (sa.astype(np.int64) * cap_len
                + interleave_slots(np.minimum(rank, cap_len - 1),
                                   cap_len))[ok]
        flat[dest] = (rows[order][ok] if int8_src
                      else np.clip(np.rint(rows[order][ok] / scale),
                                   -127, 127).astype(np.int8))
        ids[dest] = (lo + order[ok]).astype(np.int32)
        if progress is not None:
            progress(hi, n)

    # single upload
    index = IVFFlatIndex(
        centroids=centroids,
        lists=torch.as_tensor(flat, device=dev).view(nlist, cap_len, d),
        row_ids=torch.as_tensor(ids, device=dev).view(nlist, cap_len),
        scale=float(np.float32(scale)),
        n=n - int(overflow.sum()))
    return index, overflow


def build_ivf_flat_device(
    gen: Callable[[int], torch.Tensor],
    n: int,
    d: int,
    nlist: int,
    *,
    generator: torch.Generator,
    device: torch.device,
    head: np.ndarray | None = None,
    kmeans_iters: int = 10,
    sample: int | None = None,
    capacity_slack: float = 1.05,
    chunk: int = 262_144,
    scale: float = 1.0 / 127.0,
) -> tuple[IVFFlatIndex, np.ndarray]:
    """Device-sourced int8 IVF-Flat build: generated rows never visit the
    host.

    ``gen(ci) -> f32 [chunk, d]`` produces rows ON the device
    (deterministic in ``ci``; regenerated once per pass). Only int32
    assignments come down and int64 destination slots go up. Rows are
    assumed unit-norm (``scale`` defaults to 1/127).

    ``head``: optional real rows (np f32 [nb, d], global rows ``0..nb``)
    stored ahead of the generated rows ``nb..nb+n``.

    Layout (interleave + next_slot math) is that of the JAX package's
    ``build_ivf_flat_device``; returns ``(index, overflow[nb+n])``.
    """
    nb = 0 if head is None else len(head)
    total = nb + n
    n_chunks = -(-n // chunk)
    head_t = None
    if nb:
        head_t = torch.as_tensor(np.asarray(head, np.float32), device=device)

    # quantize-dequantize before fit/assign: the stored representation is
    # int8, so assignment is consistent with what queries scan
    def q8(v):
        return quantize_with_scale(v, scale)

    def dq(v):
        return q8(v).float() * scale

    sample_n = min(total, sample or max(nlist * 64, 16_384))
    parts = []
    if nb:
        parts.append(dq(head_t[: min(nb, sample_n)]))
    got = sum(int(p.shape[0]) for p in parts)
    ci = 0
    while got < sample_n and ci < n_chunks:
        blk = gen(ci)
        take = min(int(blk.shape[0]), sample_n - got)
        parts.append(dq(blk[:take]))
        got += take
        ci += 1
    samp = torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]
    centroids, _ = kmeans_fit(samp, nlist, generator=generator,
                              iters=kmeans_iters, spherical=True)
    del samp, parts

    def assign_of(v):
        return assign_clusters(dq(v), centroids)[0]

    # pass 1: assignments only
    assigns = np.empty(total, np.int32)
    if nb:
        assigns[:nb] = assign_of(head_t).cpu().numpy()
    lo = nb
    for ci in range(n_chunks):
        hi = min(total, lo + chunk)
        assigns[lo:hi] = assign_of(gen(ci)).cpu().numpy()[: hi - lo]
        lo = hi

    counts = np.bincount(assigns, minlength=nlist)
    cap_len = _cap_len(counts, capacity_slack)

    # pass 2: regenerate + quantize on the device, scatter in place
    lists3d = torch.zeros((nlist, cap_len, d), dtype=torch.int8,
                          device=device)
    ids2d = torch.full((nlist, cap_len), -1, dtype=torch.int32,
                       device=device)
    next_slot = np.zeros(nlist, np.int64)
    overflow = np.zeros(total, bool)

    def dest_of(lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        a = assigns[lo:hi]
        order = np.argsort(a, kind="stable")
        sa = a[order]
        ccounts = np.bincount(a, minlength=nlist)
        cstarts = np.concatenate(([0], np.cumsum(ccounts)[:-1]))
        rank = (np.arange(hi - lo) - cstarts[sa]) + next_slot[sa]
        next_slot[:] += ccounts
        ok = rank < cap_len
        overflow[lo:hi][order] = ~ok
        dest = np.where(
            ok,
            sa.astype(np.int64) * cap_len
            + interleave_slots(np.minimum(rank, cap_len - 1), cap_len),
            nlist * cap_len)            # out of bounds -> dropped
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        return dest[inv], (lo + np.arange(hi - lo)).astype(np.int32)

    if nb:
        dest, rid = dest_of(0, nb)
        _scatter_rows(lists3d, ids2d, q8(head_t), dest, rid)
    lo = nb
    for ci in range(n_chunks):
        hi = min(total, lo + chunk)
        v8 = q8(gen(ci)[: hi - lo])
        dest, rid = dest_of(lo, hi)
        _scatter_rows(lists3d, ids2d, v8, dest, rid)
        lo = hi

    index = IVFFlatIndex(
        centroids=centroids,
        lists=lists3d,
        row_ids=ids2d,
        scale=float(np.float32(scale)),
        n=total - int(overflow.sum()))
    return index, overflow


def _scatter_rows(lists3d: torch.Tensor, ids2d: torch.Tensor,
                  vecs: torch.Tensor, dest: np.ndarray,
                  row_ids: np.ndarray) -> None:
    """In-place ``flat[dest] = vecs`` on the (viewed-flat) index tensors;
    destinations out of bounds are dropped (capacity overflow)."""
    nlist, cap_len, d = lists3d.shape
    keep = (dest >= 0) & (dest < nlist * cap_len)
    if not keep.any():
        return
    dev = lists3d.device
    dst = torch.as_tensor(dest[keep], dtype=torch.int64, device=dev)
    src = torch.as_tensor(np.nonzero(keep)[0], device=dev) \
        if not keep.all() else None
    v = vecs.to(device=dev, dtype=lists3d.dtype)
    lists3d.view(nlist * cap_len, d).index_copy_(
        0, dst, v if src is None else v[src])
    ids2d.view(nlist * cap_len).index_copy_(
        0, dst, torch.as_tensor(np.asarray(row_ids, np.int32)[keep],
                                device=dev))


def ivf_append(
    index: IVFFlatIndex,
    vectors: torch.Tensor,    # [n, d] float
    row_ids: np.ndarray,      # [n] int32 global ids
) -> tuple[IVFFlatIndex, np.ndarray]:
    """Streaming insert: assign new vectors to existing lists and scatter
    into free slots, in place. Returns the updated index and a boolean
    mask of rows DROPPED by list-capacity overflow — callers MUST
    re-route dropped rows (exact tail / rebuild).

    The index tensors are updated in place; a racing reader of the old
    index sees either the old or the new slot contents of each row.
    """
    n = vectors.shape[0]
    nlist, cap_len = index.row_ids.shape
    assign, _ = assign_clusters(vectors.float(), index.centroids)
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
    dest = np.where(~dropped,
                    assign_h.astype(np.int64) * cap_len
                    + interleave_slots(ranks_full, cap_len),
                    nlist * cap_len)

    if index.lists.dtype == torch.int8:
        vecs_dev = quantize_with_scale(vectors, index.scale)
    else:
        vecs_dev = vectors.to(index.lists.dtype)
    _scatter_rows(index.lists, index.row_ids, vecs_dev, dest,
                  np.asarray(row_ids, np.int32))
    return index._replace(n=index.n + n - int(dropped.sum())), dropped


def build_dispatch(
    coarse_scores: torch.Tensor,   # [Q, nlist] f32
    nprobe: int,
    qcap: int,
    approx: bool = False,
    method: str = "cumsum",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Invert per-query probe lists into per-list query slots.

    Returns (probe_lists [Q, nprobe] int64, dispatch [nlist, qcap] int32,
    slot [Q, nprobe] int64, dropped [] int32). ``dispatch[l, s]`` is the
    query id in slot s of list l (-1 empty); ``slot[q, i]`` is q's slot
    within its i-th probed list (-1 if dropped by capacity).

    ``method="cumsum"`` (default): the rank of query q within list l is
    the number of queries < q that also probe l, an exclusive cumsum over
    the query axis of the [Q, nlist] probe-count matrix.
    ``method="sort"`` inverts with a stable argsort of the flat probe
    list instead; both give BIT-IDENTICAL outputs, because a stable sort
    over the flat index (q*nprobe+i) orders each list's probes by q.
    Both match the JAX package's ``build_dispatch`` bit for bit.

    ``approx``: the JAX package routes with ``lax.approx_max_k`` when
    set. PyTorch has no approximate top-k, so the flag is accepted and
    the routing stays the exact stable top-``nprobe`` (which is what
    ``approx_max_k`` computes on JAX's CPU backend).

    Nothing here waits on the device: ``dropped`` stays a device tensor.
    """
    del approx
    if method not in ("cumsum", "sort"):
        raise ValueError(f"unknown dispatch method {method!r}")
    q_n, nlist = coarse_scores.shape
    dev = coarse_scores.device
    _, probe_lists = stable_topk(coarse_scores, nprobe)
    q_ids = torch.arange(q_n, dtype=torch.int32, device=dev)[:, None] \
        .expand(q_n, nprobe)
    if method == "cumsum":
        # probes of one query are distinct lists, so a scatter of ones is
        # the one-hot count matrix
        counts = torch.zeros((q_n, nlist), dtype=torch.int32, device=dev)
        counts.scatter_(1, probe_lists, 1)
        start = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
        rank = torch.gather(start, 1, probe_lists)
    else:
        flat_l = probe_lists.reshape(-1)
        l_sorted, order = torch.sort(flat_l, stable=True)
        group_start = torch.searchsorted(l_sorted, l_sorted, right=False)
        rank_sorted = torch.arange(q_n * nprobe, device=dev) - group_start
        rank = torch.empty(q_n * nprobe, dtype=torch.int32, device=dev)
        rank[order] = rank_sorted.to(torch.int32)
        rank = rank.view(q_n, nprobe)
    keep = rank < qcap
    dropped = (~keep).sum(dtype=torch.int32)
    # dropped probes land in one spare slot past the table (sliced off);
    # kept (list, rank) pairs are distinct
    dest = torch.where(keep, probe_lists * qcap + rank.long(),
                       torch.full_like(probe_lists, nlist * qcap))
    dispatch = torch.full((nlist * qcap + 1,), -1, dtype=torch.int32,
                          device=dev)
    dispatch.scatter_(0, dest.reshape(-1), q_ids.reshape(-1))
    dispatch = dispatch[:-1].view(nlist, qcap)
    slot = torch.where(keep, rank.long(), torch.full_like(probe_lists, -1))
    return probe_lists, dispatch, slot, dropped


def _queries_f32(index: IVFFlatIndex, queries: torch.Tensor
                 ) -> tuple[torch.Tensor, bool]:
    """(f32 queries for routing, pre-quantized?). int8 queries are the
    pre-quantized transport: list scans consume the bytes verbatim and
    only the coarse routing sees the dequantized values."""
    pre_quant = queries.dtype == torch.int8
    q32 = queries.float() * index.scale if pre_quant else queries.float()
    return q32, pre_quant


def ivf_search_small(
    index: IVFFlatIndex,
    queries: torch.Tensor,    # [Q, d], Q small
    k: int,
    *,
    nprobe: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Latency-oriented IVF path for small batches: gather ONLY the probed
    lists per query and score them exactly (no list-scan kernel).

    The data moved is ``Q x nprobe x cap_len x d`` bytes instead of the
    whole index. Returns (values [Q, k], row ids [Q, k]). No probe is
    dropped: there is no ``qcap``.
    """
    q_n, d = queries.shape
    nlist, cap_len = index.row_ids.shape
    nprobe = min(nprobe, nlist)
    with search_profile.stage("route"):
        queries = queries.to(index.lists.device)
        q32, pre_quant = _queries_f32(index, queries)
        coarse = q32 @ index.centroids.T
        _, probe_lists = stable_topk(coarse, nprobe)      # [Q, nprobe]
        search_profile.count_probes(q_n * nprobe)
        cand_ids = index.row_ids[probe_lists.reshape(-1)].view(
            q_n, nprobe * cap_len)
        int8 = index.lists.dtype == torch.int8
        if int8:
            qq = queries if pre_quant else quantize_with_scale(q32,
                                                               index.scale)
            s2 = float(np.float32(index.scale) * np.float32(index.scale))
    with search_profile.stage("scan"):
        # one query at a time: its probed lists are the only rows
        # gathered (and widened to a float type for the matmul)
        scores = torch.empty((q_n, nprobe * cap_len), dtype=torch.float32,
                             device=q32.device)
        for i in range(q_n):
            cand = index.lists[probe_lists[i]].view(nprobe * cap_len, d)
            if int8:
                scores[i] = int8_matmul(qq[i:i + 1], cand.T)[0] * s2
            else:
                scores[i] = (q32[i:i + 1] @ cand.float().T)[0]
        scores = scores.masked_fill(cand_ids < 0, NEG_INF)
    with search_profile.stage("regather"):
        # clamp: k larger than the candidate width degrades to fewer
        # results
        k_eff = min(k, nprobe * cap_len)
        top_vals, pos = stable_topk(scores, k_eff)
        rows = torch.gather(cand_ids, 1, pos)
        rows = torch.where(torch.isfinite(top_vals), rows,
                           torch.full_like(rows, -1))
        return _pad_k(top_vals, rows, k)


def _pad_k(vals: torch.Tensor, rows: torch.Tensor, k: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
        rows = torch.nn.functional.pad(rows, (0, pad), value=-1)
    return vals, rows


def default_qcap(q_n: int, nprobe: int, nlist: int) -> int:
    """Expected probes per list x 2 slack, rounded up to 8 (the JAX
    package's formula)."""
    return max(8, int(-(-(q_n * nprobe * 2) // nlist // 8) * 8))


def scan_inputs(
    index: IVFFlatIndex,
    queries: torch.Tensor,    # [Q, d] float, or int8 pre-quantized
    nprobe: int,
    qcap: int | None = None,
    approx_select: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, float]:
    """Route a batch and invert it for the list scan: (probe_lists,
    dispatch, slot, dropped, qdisp [nlist, qcap, d], scan scale).
    ``qcap=None`` takes the JAX package's ``default_qcap``; probes past a
    list's capacity are dropped, as there, and counted in
    ``search_profile``."""
    q_n = queries.shape[0]
    if qcap is None:
        qcap = default_qcap(q_n, nprobe, index.nlist)
    queries = queries.to(index.lists.device)
    q32, pre_quant = _queries_f32(index, queries)
    coarse = q32 @ index.centroids.T
    probe_lists, dispatch, slot, dropped = build_dispatch(
        coarse, nprobe, qcap, approx=approx_select)
    search_profile.count_probes(q_n * nprobe, dropped)
    safe_q = torch.clamp(dispatch, 0, q_n - 1).long()
    if index.lists.dtype == torch.int8:
        q_quant = queries if pre_quant else quantize_with_scale(q32,
                                                                index.scale)
        qdisp = q_quant[safe_q]
        scan_scale = float(np.float32(index.scale) * np.float32(index.scale))
    else:
        qdisp = q32.to(index.lists.dtype)[safe_q]
        scan_scale = 1.0
    return probe_lists, dispatch, slot, dropped, qdisp, scan_scale


def ivf_search(
    index: IVFFlatIndex,
    queries: torch.Tensor,    # [Q, d] float, or int8 pre-quantized
    k: int,
    *,
    nprobe: int = 64,
    p: int = 2,
    qcap: int | None = None,
    approx_select: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """IVF top-k. Returns (values [Q,k] f32, row_ids [Q,k] int32 global
    vector ids, dropped_probes [] int32)."""
    nprobe = min(nprobe, index.nlist)
    with search_profile.stage("route"):
        probe_lists, dispatch, slot, dropped, qdisp, scan_scale = \
            scan_inputs(index, queries, nprobe, qcap, approx_select)
    with search_profile.stage("scan"):
        live_n = live_slots(dispatch)
        vals, flat_idx = ivf_list_scan(qdisp, index.lists, index.row_ids,
                                       dispatch, p=p, scale=scan_scale,
                                       live_n=live_n)
        if index.lists.dtype == torch.int8 and p <= 32:
            # the rows ivf_scan_s8 (int8, p <= 32) streams: live and staged
            search_profile.count_scan_rows(
                live_n, cached_scan_rows(index.row_ids), S8_SLOTS)
    with search_profile.stage("regather"):
        top_vals, row_ids = select_rows(index, vals, flat_idx, probe_lists,
                                        slot, k)
        top_vals, row_ids = _pad_k(top_vals, row_ids, k)
    return top_vals, row_ids, dropped


# id(row_ids) -> (a reference to them, their version, scan_rows of them)
_SCAN_ROWS: dict[int, tuple] = {}


def cached_scan_rows(row_ids: torch.Tensor) -> torch.Tensor:
    """``scan_rows(row_ids)``, computed again only once the ids change
    (``ivf_append`` writes them in place, which bumps their version)."""
    hit = _SCAN_ROWS.get(id(row_ids))
    if hit is None or hit[0]() is not row_ids \
            or hit[1] != row_ids._version:
        for key in [k for k, v in _SCAN_ROWS.items() if v[0]() is None]:
            del _SCAN_ROWS[key]
        hit = _SCAN_ROWS[id(row_ids)] = (weakref.ref(row_ids),
                                         row_ids._version,
                                         scan_rows(row_ids))
    return hit[2]


def select_rows(
    index: IVFFlatIndex,
    vals: torch.Tensor,         # [nlist, qcap, w] list-scan values
    flat_idx: torch.Tensor,     # [nlist, qcap, w] flat corpus positions
    probe_lists: torch.Tensor,  # [Q, nprobe]
    slot: torch.Tensor,         # [Q, nprobe] (-1 dropped)
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Regather the list scan's candidates per query and keep the top
    ``k_eff = min(k, nprobe * w)``: (values [Q, k_eff] f32, row ids
    [Q, k_eff] int32 from ``index.row_ids``; -1 at -inf), not padded."""
    q_n, nprobe = probe_lists.shape
    qcap, w = vals.shape[1], vals.shape[2]
    safe_slot = torch.clamp(slot, 0, qcap - 1)
    cand_vals = vals[probe_lists, safe_slot]
    cand_idx = flat_idx[probe_lists, safe_slot]
    valid = (slot >= 0)[:, :, None]
    cand_vals = torch.where(valid, cand_vals,
                            torch.full_like(cand_vals, NEG_INF))
    cand_idx = torch.where(valid, cand_idx, torch.full_like(cand_idx, -1))
    cand_vals = cand_vals.reshape(q_n, nprobe * w)
    cand_idx = cand_idx.reshape(q_n, nprobe * w)
    k_eff = min(k, nprobe * w)
    top_vals, pos = stable_topk(cand_vals, k_eff)
    top_flat = torch.gather(cand_idx, 1, pos)
    # flat corpus position -> original row id
    safe_flat = torch.clamp(top_flat, 0, index.nlist * index.cap_len - 1
                            ).long()
    row_ids = index.row_ids.reshape(-1)[safe_flat]
    row_ids = torch.where((top_flat >= 0) & torch.isfinite(top_vals),
                          row_ids, torch.full_like(row_ids, -1))
    top_vals = torch.where(row_ids >= 0, top_vals,
                           torch.full_like(top_vals, NEG_INF))
    return top_vals, row_ids
