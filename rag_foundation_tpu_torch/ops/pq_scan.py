"""IVF-PQ ADC list scan: per-list lookup-table scoring with sub-block
top-p.

Counterpart of ``rag_foundation_tpu/ops/pallas_pq.py`` for 4-bit codes
(K=16). For each posting list and each query slot dispatched to it,

    score(q, c) = sum_m LUT[q, m, codes[c, m]]

is the residual part of the ADC score (the per-(query, list) coarse term
is constant within a list and is added at regather), dead corpus rows
(``row_ids < 0``) score -inf, and the top-p rows of every 128-row
sub-block are kept (first max wins ties), laid out pass-major:
``[nlist, qcap, p * nsub]`` as in ``ops/ivf_scan.py``.

The public layouts are the JAX package's, so both packages take the same
arrays: LUTs are flattened K-MAJOR (``lut_flat[q, k*m + mm] =
LUT[q, mm, k]``, ``flatten_luts``); nibble-packed codes hold
``code[2j] | code[2j+1] << 4`` per byte (``pack_codes``) and their LUTs
order the m axis ``[evens..., odds...]`` inside each K slab.

``pq_list_scan`` launches the hand-written CUDA kernel
(``csrc/pq_list_scan.cu``) for CUDA tensors and runs the plain PyTorch
version ``pq_list_scan_reference`` for CPU tensors. There is no
fallback: a CUDA tensor gets the kernel or an exception. Given the
``dispatch`` table, the dead tail of each list's slots (past its last
live slot) is not computed and yields ``(-inf, -1)``, so a list no query
probes is never read; other dead slots are computed unmasked, as on the
TPU (the regather never reads them).

int8 LUTs must hold entries in [-127, 127], as ``flatten_luts`` clips
them: the kernel keeps scores as int16 (at m <= 256 a score lies in
[-32512, 32512]) and marks a dead row -32768. ``scan_routes`` says which
of the kernel's routes each list of a launch takes.
"""

from __future__ import annotations

import ctypes

import torch

from rag_foundation_tpu_torch.ops import cuda_lib
from rag_foundation_tpu_torch.ops.ivf_scan import NEG_INF, SUB, live_slots

K_CODES = 16      # the kernel's code regime (nbits=4)
_DTYPE_CODE = {torch.int8: 0, torch.bfloat16: 2}
# bytes of one-hot code expansion per step of the plain version
_REF_BYTES = 512 << 20

LAUNCHES = cuda_lib.LaunchCounter()   # kernel launches (CUDA path only)

# The kernel's routes (csrc/pq_list_scan.cu, ``pq_list_scan_launch``)
V2_MAX_M = 256      # pq_scan_v2: int8 LUTs, m <= 256, m_bytes % 4 == 0, p <= 32
PAIR_BYTES = 128    # its pair route: packed m = 256 ...
PAIR_MAX = 8        # ... lists of at most this many live slots


def flatten_luts(lut: torch.Tensor,
                 dtype: torch.dtype | str = torch.bfloat16,
                 packed: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[Q, m, K] f32 -> ([Q, K*m] int8|bf16, scale [Q] f32)`` in the
    K-major layout. int8 LUTs are per-query symmetric-quantized — a
    per-query monotone scale cannot change the top-p selection inside a
    list, so the scale is applied to the scores at regather.

    ``packed=True`` permutes the m axis to [evens..., odds...] inside
    each K slab, matching nibble-packed code tables (lo nibbles = even
    subquantizers)."""
    q, m, k = lut.shape
    if isinstance(dtype, str):
        dtype = {"int8": torch.int8, "bf16": torch.bfloat16,
                 "bfloat16": torch.bfloat16}.get(dtype, dtype)
    if packed:
        # slices, not an index tensor: no host copy (and no wait) here
        lut = torch.cat([lut[:, 0::2], lut[:, 1::2]], dim=1)
    flat = lut.transpose(1, 2).reshape(q, k * m)
    if dtype == torch.int8:
        scale = torch.clamp(flat.abs().amax(dim=1), min=1e-12) / 127.0
        q8 = torch.clamp(torch.round(flat / scale[:, None]), -127, 127)
        return q8.to(torch.int8), scale
    if dtype != torch.bfloat16:
        raise ValueError(f"unsupported LUT dtype {dtype}")
    return flat.to(dtype), torch.ones((q,), dtype=torch.float32,
                                      device=lut.device)


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """``[..., m] uint8 (values < 16) -> [..., m/2] uint8`` with byte
    ``lo | hi<<4`` = (code[2j], code[2j+1]). Halves the code table and
    the scan's read traffic."""
    lo = codes[..., 0::2].to(torch.uint8)
    hi = codes[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def _check(lut_disp, codes, row_ids, k_codes, p) -> tuple[int, bool]:
    """Validates shapes; returns (m, packed)."""
    if lut_disp.dim() != 3 or codes.dim() != 3 or row_ids.dim() != 2:
        raise ValueError("expected lut_disp [nlist, qcap, K*m], codes "
                         "[nlist, cap_len, m or m/2], row_ids "
                         "[nlist, cap_len]")
    nlist, _, km = lut_disp.shape
    cap_len, m_bytes = codes.shape[1], codes.shape[2]
    packed = km == k_codes * m_bytes * 2
    m = m_bytes * 2 if packed else m_bytes
    if km != k_codes * m:
        raise ValueError(f"lut width {km} != K*m = {k_codes}*{m}")
    if k_codes != K_CODES:
        raise ValueError(f"pq_list_scan scores {K_CODES}-entry codebooks "
                         f"(nbits=4), got K={k_codes}")
    if cap_len % SUB:
        raise ValueError(f"cap_len must be a multiple of {SUB}, got "
                         f"{cap_len} (pad posting lists to LBLOCK)")
    if codes.shape[0] != nlist \
            or tuple(row_ids.shape) != (nlist, cap_len):
        raise ValueError(f"shape mismatch: lut_disp "
                         f"{tuple(lut_disp.shape)}, codes "
                         f"{tuple(codes.shape)}, row_ids "
                         f"{tuple(row_ids.shape)}")
    if codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8, got {codes.dtype}")
    if lut_disp.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported LUT dtype {lut_disp.dtype}")
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    return m, packed


def pq_list_scan_reference(
    lut_disp: torch.Tensor, codes: torch.Tensor, row_ids: torch.Tensor,
    dispatch: torch.Tensor | None = None, *, k_codes: int = K_CODES,
    p: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the ADC list scan (any device): the sum
    of each row's ``m`` LUT entries as a product of the LUT with the
    one-hot expansion of the codes (an f32 matmul: exact for an int8 LUT,
    whose sums stay far below 2**24 in any order; f32 sums of the bf16
    entries otherwise), then ``p`` masked argmax passes per sub-block.
    An elementwise gather of the ``nlist * qcap * cap_len * m`` entries
    gives the same sums but takes minutes at the engine's shapes. Chunked
    over lists to bound the one-hot's memory. Same outputs as
    ``pq_list_scan``."""
    m, packed = _check(lut_disp, codes, row_ids, k_codes, p)
    nlist, qcap, km = lut_disp.shape
    cap_len = codes.shape[1]
    nsub = cap_len // SUB
    dev = lut_disp.device
    out_v = torch.empty((nlist, qcap, nsub * p), dtype=torch.float32,
                        device=dev)
    out_i = torch.empty((nlist, qcap, nsub * p), dtype=torch.int32,
                        device=dev)
    base = torch.arange(nsub, dtype=torch.int32, device=dev) * SUB
    pos = torch.arange(m, device=dev)
    step = max(1, _REF_BYTES // max(1, cap_len * km * 4))
    for lo in range(0, nlist, step):
        hi = min(nlist, lo + step)
        cb = codes[lo:hi].long()
        if packed:   # LUT positions: [lo nibbles..., hi nibbles...]
            cb = torch.cat([cb & 15, cb >> 4], dim=2)
        flat_pos = cb * m + pos                       # [L, cap_len, m]
        n = hi - lo
        onehot = torch.zeros((n, cap_len, km), dtype=torch.float32,
                             device=dev)
        onehot.scatter_(2, flat_pos, 1.0)
        scores = torch.bmm(lut_disp[lo:hi].float(), onehot.transpose(1, 2))
        dead = (row_ids[lo:hi] < 0)[:, None, :]
        s = scores.masked_fill(dead, NEG_INF).view(n, qcap, nsub, SUB)
        flat0 = (torch.arange(lo, hi, dtype=torch.int32, device=dev)
                 * cap_len)[:, None, None] + base[None, None, :]
        for j in range(p):
            mx, am = torch.max(s, dim=3)          # first max wins ties
            idx = flat0 + am.to(torch.int32)
            out_v[lo:hi, :, j * nsub:(j + 1) * nsub] = mx
            out_i[lo:hi, :, j * nsub:(j + 1) * nsub] = torch.where(
                mx == NEG_INF, torch.full_like(idx, -1), idx)
            if j + 1 < p:
                s = s.scatter(3, am[..., None], NEG_INF)
    if dispatch is not None:
        dead_tail = (torch.arange(qcap, device=dev)[None, :]
                     >= live_slots(dispatch)[:, None])[..., None]
        out_v = out_v.masked_fill(dead_tail, NEG_INF)
        out_i = out_i.masked_fill(dead_tail, -1)
    return out_v, out_i


def scan_routes(lut_dtype: torch.dtype, packed: bool, m: int, p: int,
                live_n: torch.Tensor) -> dict[str, int]:
    """Lists of a launch by the kernel's route, as ``pq_list_scan_launch``
    and ``pq_scan_v2`` choose it from the shape and each list's live slots
    ``live_n`` (``live_slots(dispatch)``): ``pair`` (packed m = 256, at
    most ``PAIR_MAX`` live slots), ``lookup`` (at most 8), ``mma`` (more:
    passes of 16 slots, a last pass of at most 8 by lookup),
    ``pq_scan_kernel`` (bf16 LUTs, m_bytes % 4 != 0, m > 256, p > 32) and
    ``unread`` (no live slot)."""
    m_bytes = m // 2 if packed else m
    live = live_n.long()
    out = {"unread": int((live == 0).sum())}
    read = live[live > 0]
    if lut_dtype != torch.int8 or m_bytes % 4 or m > V2_MAX_M or p > 32:
        out["pq_scan_kernel"] = int(read.numel())
        return out
    pair = (read <= PAIR_MAX) if packed and m_bytes == PAIR_BYTES \
        else torch.zeros_like(read, dtype=torch.bool)
    out["pair"] = int(pair.sum())
    out["lookup"] = int((~pair & (read <= 8)).sum())
    out["mma"] = int((read > 8).sum())
    return out


def pq_list_scan(
    lut_disp: torch.Tensor,   # [nlist, qcap, K*m] int8|bf16
                              # (flatten_luts layout)
    codes: torch.Tensor,      # [nlist, cap_len, m] uint8, values < K
                              # (or [nlist, cap_len, m/2] nibble-packed)
    row_ids: torch.Tensor,    # [nlist, cap_len] int32 (-1 dead)
    dispatch: torch.Tensor | None = None,   # [nlist, qcap] query ids
    *,
    k_codes: int = K_CODES,
    p: int = 2,
    cap_block: int | None = None,   # accepted; no effect on results
) -> tuple[torch.Tensor, torch.Tensor]:
    """ADC-score each posting list against its dispatched query LUTs.

    Returns ``(vals [nlist, qcap, w] f32, flat_idx [nlist, qcap, w]
    int32)`` with ``w = (cap_len // 128) * p``; ``flat_idx`` indexes the
    flattened ``[nlist*cap_len]`` corpus. With an int8 LUT the values are
    exact integer sums (as f32); with a bf16 LUT, f32 sums. int8 LUT
    entries lie in [-127, 127] (``flatten_luts``); the kernel's int16
    scores rest on it. ``codes`` may
    be nibble-packed — detected by shape; LUTs must then come from
    ``flatten_luts(packed=True)``. ``cap_block`` is accepted for
    interface parity and has no effect."""
    del cap_block
    m, packed = _check(lut_disp, codes, row_ids, k_codes, p)
    if dispatch is not None and tuple(dispatch.shape) != tuple(
            lut_disp.shape[:2]):
        raise ValueError(f"dispatch shape {tuple(dispatch.shape)} != "
                         f"{tuple(lut_disp.shape[:2])}")
    if lut_disp.device.type == "cpu":
        return pq_list_scan_reference(lut_disp, codes, row_ids, dispatch,
                                      k_codes=k_codes, p=p)
    if lut_disp.device.type != "cuda":
        raise ValueError(f"unsupported device {lut_disp.device}")
    for name, t in (("codes", codes), ("row_ids", row_ids)):
        if t.device != lut_disp.device:
            raise ValueError(f"{name} on {t.device}, lut_disp on "
                             f"{lut_disp.device}")
    if row_ids.dtype != torch.int32:
        raise ValueError(f"row_ids must be int32, got {row_ids.dtype}")
    if not (lut_disp.is_contiguous() and codes.is_contiguous()
            and row_ids.is_contiguous()):
        raise ValueError("pq_list_scan needs contiguous tensors")
    nlist, qcap, _ = lut_disp.shape
    cap_len, m_bytes = codes.shape[1], codes.shape[2]
    if nlist > 65535:
        raise ValueError(f"nlist {nlist} > 65535 (grid y limit)")
    w = (cap_len // SUB) * p
    vals = torch.empty((nlist, qcap, w), dtype=torch.float32,
                       device=lut_disp.device)
    idx = torch.empty((nlist, qcap, w), dtype=torch.int32,
                      device=lut_disp.device)
    if nlist == 0 or qcap == 0 or cap_len == 0:
        return vals, idx
    live_n = None
    if dispatch is not None:
        if dispatch.device != lut_disp.device:
            raise ValueError(f"dispatch on {dispatch.device}, lut_disp on "
                             f"{lut_disp.device}")
        live_n = live_slots(dispatch)
    fn = _kernel()
    stream = torch.cuda.current_stream(lut_disp.device).cuda_stream
    rc = fn(_DTYPE_CODE[lut_disp.dtype], int(packed), lut_disp.data_ptr(),
            codes.data_ptr(), row_ids.data_ptr(),
            None if live_n is None else live_n.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), nlist, qcap, cap_len, m,
            m_bytes, p, stream)
    if rc != 0:
        raise RuntimeError(f"pq_list_scan kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES.add()
    return vals, idx


def _kernel():
    lib = cuda_lib.load("pq_list_scan")
    fn = lib.pq_list_scan_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                       ci, vp]
        fn.restype = ci
    return fn
