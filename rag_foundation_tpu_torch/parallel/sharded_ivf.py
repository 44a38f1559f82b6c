"""Sharded IVF: posting lists partitioned over the mesh, a top-k merge.

Counterpart of ``rag_foundation_tpu/parallel/sharded_ivf.py``. Each
shard owns ``nlist / n_shards`` consecutive posting lists and their
coarse centroids, so both the coarse routing and the list scans are
local to it; only its ``[Q, k]`` candidates move, to the lead device,
where one stable top-k merges them shard-major.

Probe semantics are the JAX package's: each shard probes its own
top-``nprobe_local`` lists. The union covers the global top-``nprobe``
only when no shard owns more than ``nprobe_local`` of a query's best
lists, so size ``nprobe_local`` with headroom past
``ceil(nprobe / n_shards)`` for skewed corpora. Each shard's qcap is
``default_qcap(Q, nprobe_local, nlist_local)``; probes past it are
dropped without a count in the result, as there; each shard's routing
adds its count to ``engine.profile.search_profile``.

A sharded body is a ``ShardedBody``: one ``IVFFlatIndex`` or
``IVFPQIndex`` a shard, over its lists, on its device. Where every shard
lives on the device of the body it was cut from, each is a view of that
body (a 10M-row body sharded four ways on one card takes no more
memory), and in-place appends write the body's own storage.

The scans are the port's CUDA kernels, one launch a shard:
``ivf_list_scan`` (given ``dispatch``, so empty slots are skipped) and
``pq_list_scan``, which here gets ``dispatch`` too (JAX passes none).

On a mesh that spans processes (``mesh.init_distributed``), a process
keeps only its own shards' lists, routes and scans them, and the
candidates of every process merge through one all-gather
(``topk_merge.merge_over_mesh``): the result depends on the shard count,
not on how the shards are spread over processes. Appends stay with one
process, as JAX's ``device_put`` cannot reach another process's
devices either.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rag_foundation_tpu_torch.engine.ivf import (IVFFlatIndex,
                                                 _pad_k, _scatter_rows,
                                                 default_qcap,
                                                 interleave_slots,
                                                 scan_inputs, select_rows)
from rag_foundation_tpu_torch.engine.ivfpq import IVFPQIndex, adc_top_rows
from rag_foundation_tpu_torch.engine.profile import search_profile
from rag_foundation_tpu_torch.ops.ivf_scan import ivf_list_scan
from rag_foundation_tpu_torch.ops.kmeans import assign_clusters
from rag_foundation_tpu_torch.ops.quantize import quantize_with_scale
from rag_foundation_tpu_torch.parallel.mesh import Mesh, on_device, place
from rag_foundation_tpu_torch.parallel.topk_merge import (NEG_INF,
                                                         merge_over_mesh)

# body fields indexed by list (split over the shards); the rest replicate
LIST_FIELDS = ("centroids", "lists", "codes", "row_ids")
# what a ShardedBody reads from its first shard: fields and properties
# that every shard holds alike
REPLICATED = ("scale", "codebook_centroids", "refine", "refine_scale",
              "codebook", "m", "k_codes", "packed")


class ShardedBody(NamedTuple):
    """An IVF body whose lists are split over a mesh's "shard" axis:
    shard s holds lists ``[s*L, (s+1)*L)`` (its ``n`` counts its live
    rows); ``n`` is the whole body's, as the unsharded body has it. On a
    mesh that spans processes, ``shards`` are this process's."""
    shards: tuple[IVFFlatIndex | IVFPQIndex, ...]
    n: int

    @property
    def kind(self) -> str:
        return type(self.shards[0]).__name__

    @property
    def nlist_local(self) -> int:
        return self.shards[0].nlist

    @property
    def nlist(self) -> int:
        return self.nlist_local * len(self.shards)

    @property
    def cap_len(self) -> int:
        return self.shards[0].cap_len

    @property
    def dtype(self) -> torch.dtype:
        """The storage dtype of the lists (codes for a PQ body)."""
        first = self.shards[0]
        return (first.codes if isinstance(first, IVFPQIndex)
                else first.lists).dtype

    def __getattr__(self, name):
        # only replicated fields read through; a list-indexed field is
        # per shard (``shards[s].lists``), never a whole body's
        if name in REPLICATED:
            return getattr(self.shards[0], name)
        if name in LIST_FIELDS:
            raise AttributeError(f"{name!r} is split over the shards: read "
                                 f"it a shard at a time (ShardedBody.shards)")
        raise AttributeError(name)


def body_parts(body) -> tuple:
    """The per-shard bodies of a ``ShardedBody``, or ``(body,)``."""
    return body.shards if isinstance(body, ShardedBody) else (body,)


def _check_mesh(index: ShardedBody, mesh: Mesh) -> None:
    if len(index.shards) != len(mesh.devices):
        raise ValueError(f"body of {len(index.shards)} shards on a mesh of "
                         f"{len(mesh.devices)}")


def _shard(index, mesh: Mesh) -> ShardedBody:
    n_shards = mesh.shape["shard"]
    if index.nlist % n_shards:
        raise ValueError(f"nlist {index.nlist} must divide by "
                         f"{n_shards} shards")
    lists_local = index.nlist // n_shards
    src = index.row_ids.device
    # views only where every shard stays on the source device: a view on
    # it would otherwise pin the whole body there
    copy = any(dev != src for dev in mesh.devices)
    shards = []
    for g, dev in enumerate(mesh.devices, mesh.shard_offset):
        fields = {}
        for name, val in index._asdict().items():
            if name in LIST_FIELDS:
                fields[name] = place(
                    val[g * lists_local:(g + 1) * lists_local], dev,
                    copy=copy)
            elif isinstance(val, torch.Tensor):
                fields[name] = place(val, dev, copy=copy)
            else:
                fields[name] = val
        fields["n"] = int((fields["row_ids"] >= 0).sum())
        shards.append(type(index)(**fields))
    return ShardedBody(tuple(shards), index.n)


def shard_ivf_index(index: IVFFlatIndex, mesh: Mesh) -> ShardedBody:
    """Split an IVF-Flat body's lists (with their centroids and ids) over
    the mesh "shard" axis and keep this process's shards; the scale
    replicates."""
    return _shard(index, mesh)


def shard_ivfpq_index(index: IVFPQIndex, mesh: Mesh) -> ShardedBody:
    """Split an IVF-PQ body's lists (centroids, codes, row ids) over the
    mesh; the PQ codebook replicates, so each shard builds its query LUTs
    itself. The device refine table is indexed by row, and rows scatter
    across list shards, so a sharded body carries none: it serves ADC
    candidates and re-ranking is the host archive's
    (``pq_refine="host"``)."""
    if index.refine.shape[0] > 0:
        raise ValueError("sharded IVF-PQ requires refine-free bodies "
                         "(use pq_refine='host'; the row-indexed device "
                         "refine table does not partition by lists)")
    return _shard(index, mesh)


# -- IVF-Flat search, stage by stage --------------------------------------

def route_shards(index: ShardedBody, queries: torch.Tensor, nprobe: int,
                 qcap: int, mesh: Mesh) -> list[tuple]:
    """Each shard's coarse product over its centroids and batch inversion
    (``ivf.scan_inputs``): per shard (probe_lists, dispatch, slot,
    dropped, qdisp, scan scale), on its device."""
    out = []
    for shard, dev in zip(index.shards, mesh.devices):
        with on_device(dev):
            out.append(scan_inputs(shard, place(queries, dev), nprobe,
                                   qcap))
    return out


def scan_shards(index: ShardedBody, routed: list[tuple], p: int,
                mesh: Mesh) -> list[tuple]:
    """One ``ivf_list_scan`` launch a shard over its lists."""
    out = []
    for shard, dev, r in zip(index.shards, mesh.devices, routed):
        _, dispatch, _, _, qdisp, scale = r
        with on_device(dev):
            out.append(ivf_list_scan(qdisp, shard.lists, shard.row_ids,
                                     dispatch, p=p, scale=scale))
    return out


def select_shards(index: ShardedBody, routed: list[tuple],
                  scanned: list[tuple], k: int, mesh: Mesh) -> list[tuple]:
    """Each shard's regather and top-``k_eff`` (global row ids)."""
    out = []
    for shard, dev, r, (vals, flat_idx) in zip(
            index.shards, mesh.devices, routed, scanned):
        probe_lists, _, slot = r[:3]
        with on_device(dev):
            out.append(select_rows(shard, vals, flat_idx, probe_lists, slot,
                                   k))
    return out


def sharded_ivf_search(
    index: ShardedBody,       # shard_ivf_index
    queries: torch.Tensor,    # [Q, d] float (or int8 quantized with the
                              # body's scale)
    k: int,
    *,
    mesh: Mesh,
    nprobe_local: int = 8,
    p: int = 2,
    qcap: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(values [Q, k], global row ids [Q, k])`` on the lead
    device. ``k`` is clamped to a shard's candidate width (over-fetches
    past it come back as ``(-inf, -1)`` columns, as in ``ivf_search``).
    Probes past a shard's qcap are dropped (counted in
    ``search_profile``): size qcap generously for skewed routing."""
    _check_mesh(index, mesh)
    if qcap is None:
        qcap = default_qcap(queries.shape[0], nprobe_local,
                            index.nlist_local)
    nprobe = min(nprobe_local, index.nlist_local)
    with search_profile.stage("route"):
        routed = route_shards(index, queries, nprobe, qcap, mesh)
    with search_profile.stage("scan"):
        scanned = scan_shards(index, routed, p, mesh)
    with search_profile.stage("regather"):
        cands = select_shards(index, routed, scanned, k, mesh)
        vals, rows = merge_over_mesh([c[0] for c in cands],
                                     [c[1] for c in cands], k, mesh)
        return _pad_k(vals, rows, k)


def sharded_ivf_append(
    index: ShardedBody,       # shard_ivf_index
    vectors: torch.Tensor,    # [n, d] float
    row_ids: np.ndarray,      # [n] int32 global ids
    *,
    mesh: Mesh,
) -> tuple[ShardedBody, np.ndarray]:
    """Streaming insert into a sharded flat body, O(batch): assign against
    the gathered centroids, compute destination slots on the host exactly
    as ``ivf_append`` does over the whole body, then each shard writes
    only the rows that fall in its list range, in place (a device index
    out of range would be an assert, not JAX's ``mode="drop"``: rows are
    masked first). Callers hold the body lock.

    Same contract as ``ivf_append``: returns (updated index, dropped
    mask); dropped rows (list capacity) must be re-routed by the caller.
    One process holds the whole mesh: raises on a mesh that spans
    processes.
    """
    if mesh.spans_processes:
        raise ValueError("sharded_ivf_append writes every shard: it needs "
                         "a mesh that one process holds")
    _check_mesh(index, mesh)
    n = vectors.shape[0]
    lists_local, cap_len = index.nlist_local, index.cap_len
    nlist = index.nlist
    lead = mesh.lead
    cents = torch.cat([place(s.centroids, lead) for s in index.shards])
    vecs = place(vectors, lead).float()
    assign_h = assign_clusters(vecs, cents)[0].cpu().numpy()
    fill = np.concatenate([(s.row_ids >= 0).sum(dim=1).cpu().numpy()
                           for s in index.shards])
    order = np.argsort(assign_h, kind="stable")
    sa = assign_h[order]
    counts = np.bincount(assign_h, minlength=nlist)
    starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(n) - starts[sa]
    ranks_full = np.empty(n, np.int64)
    ranks_full[order] = rank + fill[sa]
    dropped = ranks_full >= cap_len
    dest = np.where(
        ~dropped,
        assign_h.astype(np.int64) * cap_len
        + interleave_slots(np.minimum(ranks_full, cap_len - 1), cap_len),
        np.int64(nlist) * cap_len)            # past every shard: dropped
    if index.dtype == torch.int8:
        rows_src = quantize_with_scale(vecs, index.scale)
    else:
        rows_src = vecs.to(index.dtype)
    row_ids = np.asarray(row_ids, np.int32)
    local_size = lists_local * cap_len
    shards = []
    for s, (shard, dev) in enumerate(zip(index.shards,
                                         mesh.devices)):
        rel = dest - s * local_size
        mine = np.nonzero((rel >= 0) & (rel < local_size))[0]
        if len(mine):
            with on_device(dev):
                _scatter_rows(shard.lists, shard.row_ids,
                              place(rows_src[torch.as_tensor(
                                  mine, device=lead)], dev),
                              rel[mine], row_ids[mine])
        shards.append(shard._replace(n=shard.n + len(mine)))
    return (ShardedBody(tuple(shards), index.n + n - int(dropped.sum())),
            dropped)


# -- IVF-PQ search ---------------------------------------------------------

def sharded_ivfpq_search(
    index: ShardedBody,       # shard_ivfpq_index
    queries: torch.Tensor,    # [Q, d] float
    k: int,
    *,
    mesh: Mesh,
    nprobe_local: int = 8,
    p: int = 4,
    qcap: int | None = None,
    lut_dtype: str = "int8",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sharded ADC top-k: each shard builds its query LUTs, scans its
    probed lists with ``pq_list_scan`` and keeps its top ``k_eff``; the
    candidates merge on the lead device. Returns ``(values [Q, k],
    global row ids [Q, k])``: coarse + ADC approximations (callers
    re-rank against the host archive for an exact order). K=16 codes
    only."""
    _check_mesh(index, mesh)
    if index.k_codes != 16:
        raise ValueError("sharded IVF-PQ supports K=16 codes only")
    if qcap is None:
        qcap = default_qcap(queries.shape[0], nprobe_local,
                            index.nlist_local)
    nprobe = min(nprobe_local, index.nlist_local)
    vals, rows = [], []
    for shard, dev in zip(index.shards, mesh.devices):
        with on_device(dev):
            _, v, r, _ = adc_top_rows(shard, place(queries, dev), k,
                                      nprobe=nprobe, p=p, qcap=qcap,
                                      lut_dtype=lut_dtype)
            vals.append(torch.where(r >= 0, v, torch.full_like(v, NEG_INF)))
            rows.append(r)
    m_vals, m_rows = merge_over_mesh(vals, rows, k, mesh)
    return _pad_k(m_vals, m_rows, k)


# -- reads of a body by (list, slot), for audits and checkpoints ------------

def gather_slots(body, field: str, ls: np.ndarray, ss: np.ndarray,
                 device: torch.device) -> torch.Tensor:
    """``getattr(body, field)[ls, ss]`` on ``device`` for global list ids
    ``ls`` (and slots ``ss``; None indexes by list alone), whether the
    body is sharded or not."""
    parts = body_parts(body)
    lists_local = parts[0].nlist
    out = None
    for s, part in enumerate(parts):
        mine = np.nonzero(ls // lists_local == s)[0]
        if not len(mine):
            continue
        t = getattr(part, field)
        li = torch.as_tensor(ls[mine] - s * lists_local, device=t.device)
        got = t[li] if ss is None else t[li, torch.as_tensor(
            ss[mine], device=t.device)]
        got = place(got, device)
        if out is None:
            out = torch.empty((len(ls),) + tuple(got.shape[1:]),
                              dtype=got.dtype, device=device)
        out[torch.as_tensor(mine, device=device)] = got
    if out is None:
        t = getattr(parts[0], field)
        shape = t.shape[1:] if ss is None else t.shape[2:]
        out = torch.empty((0,) + tuple(shape), dtype=t.dtype, device=device)
    return out


def gather_body(body: ShardedBody) -> IVFFlatIndex | IVFPQIndex:
    """The unsharded body on the host, as JAX's ``np.asarray`` gathers a
    sharded array: list fields concatenated in list order, the rest from
    the first shard, ``n`` the whole body's."""
    first = body.shards[0]
    fields = {}
    for name, val in first._asdict().items():
        if name in LIST_FIELDS:
            out = torch.empty((body.nlist,) + tuple(val.shape[1:]),
                              dtype=val.dtype)
            lo = 0
            for shard in body.shards:
                part = getattr(shard, name)
                out[lo:lo + part.shape[0]].copy_(part)
                lo += part.shape[0]
            fields[name] = out
        elif isinstance(val, torch.Tensor):
            fields[name] = val.cpu()
        else:
            fields[name] = val
    fields["n"] = body.n
    return type(first)(**fields)
