"""The card's published peaks and the least time of each kernel's work.

Each bound is the larger of two times: the bytes the function must move
(each input read once, each output written once) over the memory rate,
and its operations over the peak rate for their type. Where the work
depends on the data (dead rows, dispatch slots, segments), the counts are
those of the inputs given. Every function returns ``(ms, bound_by, ...)``
from tensors on any device; ``chip_smoke.py`` and
``tools/time_kernels.py`` read them.
"""

from __future__ import annotations

import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense
# operations/s per input type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1.979e15, "bf16": 0.989e15, "f32": 67e12}
# shared memory: 128 bytes per SM per clock, 132 SMs at the 1.98 GHz boost
# clock (NVIDIA's Hopper architecture paper and data sheet): the rate at
# which a table-lookup kernel can read its table entries
SMEM_BYTES_S = 132 * 128 * 1.98e9
# the special-function unit: 16 exponentials (MUFU.EX2) per SM per clock
# on sm_90, 132 SMs at 1.98 GHz
EXP_S = 132 * 16 * 1.98e9


def _pick(t_bytes: float, t_ops: float, ops_name: str = "operations"
          ) -> tuple[float, str]:
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else ops_name


def scan_bound(row_ids, live_n, qcap, p, esize, d, kind
               ) -> tuple[float, str, dict]:
    """(ms, "bytes" | "operations", counts): least time for one list scan
    with ``live_n[l]`` live query slots in list ``l``. The function needs
    the live query rows, the live rows of every list with a query (a dead
    row scores -inf from its id alone) and every id of those lists, read
    once, and writes every output (f32 value + int32 index) once; its
    operations are each live slot's dot with each live row of its list
    at the type's peak."""
    live_rows = (row_ids >= 0).sum(dim=1).double()
    read = live_n > 0
    nlist, cap_len = row_ids.shape
    c = {"lists_read": int(read.sum()), "live_slots": int(live_n.sum()),
         "rows_needed": int(live_rows[read].sum()),
         "rows_in_lists_read": int(read.sum()) * cap_len}
    out_elems = nlist * qcap * (cap_len // 128) * p
    nbytes = (c["live_slots"] + c["rows_needed"]) * d * esize \
        + c["rows_in_lists_read"] * 4 + nlist * 4 + out_elems * 8
    ops = 2.0 * d * float((live_n.double() * live_rows).sum())
    return (*_pick(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[kind]), c)


def pq_scan_bound(row_ids, live_n, qcap, p, m, m_bytes, lut_esize
                  ) -> tuple[float, str, dict]:
    """(ms, "bytes" | "operations", counts): least time for one ADC list
    scan with ``live_n[l]`` live query slots in list ``l``. Bytes: the
    codes of the live rows of every list with a query, every id of those
    lists, the LUTs of the live slots and the per-list slot counts read
    once, every output (f32 value + int32 index) written once.
    Operations: one table lookup per (live slot, live row, subquantizer),
    each a read of one LUT entry from shared memory, at the card's
    shared-memory bandwidth (``SMEM_BYTES_S``)."""
    live_rows = (row_ids >= 0).sum(dim=1).double()
    read = live_n > 0
    nlist, cap_len = row_ids.shape
    c = {"lists_read": int(read.sum()), "live_slots": int(live_n.sum()),
         "rows_needed": int(live_rows[read].sum()),
         "rows_in_lists_read": int(read.sum()) * cap_len}
    out_elems = nlist * qcap * (cap_len // 128) * p
    nbytes = c["rows_needed"] * m_bytes + c["rows_in_lists_read"] * 4 \
        + c["live_slots"] * 16 * m * lut_esize + nlist * 4 + out_elems * 8
    c["lookups"] = int(m * float((live_n.double() * live_rows).sum()))
    return (*_pick(nbytes / HBM_BYTES_S,
                   c["lookups"] * lut_esize / SMEM_BYTES_S), c)


def gather_bound(q_n, c, d) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): Q*C rows of d int8 bytes, the query
    rows and the ids read once, the f32 scores written once; 2*Q*C*d int8
    operations."""
    nbytes = q_n * c * d + q_n * d + q_n * c * 4 + q_n * c * 4
    return _pick(nbytes / HBM_BYTES_S, 2.0 * q_n * c * d / PEAK_OPS_S["int8"])


def topk_bound(q_n, n_live, d, k, esize, kind) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): least time for one exact top-k of
    ``q_n`` queries over ``n_live`` live rows: the live rows and the
    queries read once (a row past the valid count is not read), the
    ``[Q, k]`` values and ids written once; ``2*Q*N*d`` operations at the
    type's peak."""
    nbytes = (n_live + q_n) * d * esize + q_n * k * 8
    return _pick(nbytes / HBM_BYTES_S,
                 2.0 * q_n * n_live * d / PEAK_OPS_S[kind])


def same_segment_pairs(seg_q, seg_kv) -> int:
    """(query, key) pairs of one segment over the batch (one head)."""
    return int((seg_q[:, :, None] == seg_kv[:, None, :]).sum())


def attention_bound(seg_q, seg_kv, h, d, esize) -> tuple[float, str, dict]:
    """(ms, "bytes" | "operations", counts): q, k, v read once and the
    output written once (``esize`` bytes an element), the segment ids read
    once; 4*d operations a head for every (query, key) pair of one
    segment (2*d for the score, 2*d for its share of P.V) at the bf16
    peak; and one exponential a head for each of those pairs on the
    special-function unit (``exp_floor_ms``), which counts as operations:
    the pairs these segments need, not all S^2. The counts also hold
    ``exponentials_issued``, those the forward kernel issues for these
    inputs (``fwd_exponentials_issued``); the bound does not use them,
    since a pair of another segment is work the function does not need."""
    b, s = seg_q.shape
    pairs = same_segment_pairs(seg_q, seg_kv)
    nbytes = 4 * b * h * s * d * esize + 2 * b * s * 4
    ops = 4.0 * h * d * pairs
    exp_ms = exp_floor_ms(pairs, h)
    ms, by = _pick(nbytes / HBM_BYTES_S,
                   max(ops / PEAK_OPS_S["bf16"], exp_ms / 1e3))
    return ms, by, {"pairs": pairs, "dense_pairs": b * s * s,
                    "bytes": nbytes, "operations": ops,
                    "exponentials": pairs * h, "exp_floor_ms": exp_ms,
                    "exponentials_issued": fwd_exponentials_issued(
                        seg_q, seg_kv, h, d)}


def fwd_tile(s: int, d: int) -> tuple[int, int]:
    """(query rows a warp, keys a tile) of the bf16 forward kernel at
    sequence length ``s`` and head dim ``d`` (``csrc/flash_attention.cu``,
    ``launch_as``)."""
    if s <= 32:
        return 16, 32
    return (32, 64) if d <= 32 else (16, 64)


def _id_ranges(seg, size: int) -> tuple:
    """min and max id of each run of ``size`` rows of ``seg [B, S]``
    (rows past S left out; a run with none gets an empty range)."""
    b, s = seg.shape
    n = -(-s // size)
    big = torch.iinfo(torch.int64).max
    x = seg.to(torch.int64)
    pad = n * size - s
    lo = torch.nn.functional.pad(x, (0, pad), value=big).view(b, n, size)
    hi = torch.nn.functional.pad(x, (0, pad), value=-big).view(b, n, size)
    return lo.amin(dim=2), hi.amax(dim=2)


def fwd_exponentials_issued(seg_q, seg_kv, h: int, d: int) -> int:
    """Exponentials the bf16 forward kernel issues over ``h`` heads: every
    pair of each (warp's rows x key tile) it computes, i.e. of each tile
    whose keys' ids meet the range of the warp's rows' ids (the kernel
    skips the others, whose weights are all 0); the rows and keys past S
    of a computed tile included."""
    b, s = seg_q.shape
    rows, cols = fwd_tile(s, d)
    qlo, qhi = _id_ranges(seg_q, rows)
    klo, khi = _id_ranges(seg_kv, cols)
    meet = (khi[:, None, :] >= qlo[:, :, None]) \
        & (klo[:, None, :] <= qhi[:, :, None])
    return int(meet.sum()) * rows * cols * h


def attention_bwd_bound(seg_q, seg_kv, h, d, esize, outputs, ops_per_pair
                        ) -> tuple[float, str, dict]:
    """(ms, "bytes" | "operations", counts) of one backward kernel: q, k, v,
    dO read and ``outputs`` gradients written once (``esize`` bytes an
    element), lse and di read once (f32), the segment ids read once;
    ``ops_per_pair * d`` operations a head for every (query, key) pair of
    one segment at the bf16 peak."""
    b, s = seg_q.shape
    pairs = same_segment_pairs(seg_q, seg_kv)
    nbytes = (4 + outputs) * b * h * s * d * esize + 2 * b * h * s * 4 \
        + 2 * b * s * 4
    ops = float(ops_per_pair) * h * d * pairs
    return (*_pick(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S["bf16"]),
            {"pairs": pairs, "dense_pairs": b * s * s, "bytes": nbytes,
             "operations": ops})


def exp_floor_ms(pairs: int, h: int) -> float:
    """Least time of one exponential for each of ``pairs`` same-segment
    (query, key) pairs in each of ``h`` heads on the special-function
    unit (``EXP_S``): a floor of the attention forward (inside
    ``attention_bound``) and of each backward kernel, which recomputes
    every p, beside ``attention_bwd_bound`` (which counts only the
    tensor-core operations and the bytes)."""
    return pairs * h / EXP_S * 1e3


def empty_block_share(seg_q, seg_kv, block: int = 16) -> float:
    """Share of the ``block`` x ``block`` (query, key) blocks of every
    row of the batch that hold no pair of one segment: the blocks the
    attention backward kernels skip. The last block of a row that S does
    not fill counts its rows before S."""
    b, s = seg_q.shape
    same = seg_q[:, :, None] == seg_kv[:, None, :]
    n = -(-s // block)
    if n * block != s:
        padded = same.new_zeros((b, n * block, n * block))
        padded[:, :s, :s] = same
        same = padded
    hit = same.view(b, n, block, n, block).any(dim=4).any(dim=2)
    return 1.0 - float(hit.double().mean())
