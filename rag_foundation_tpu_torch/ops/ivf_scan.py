"""IVF list scan: per-list query-dispatch scoring with sub-block top-p.

Counterpart of ``rag_foundation_tpu/ops/pallas_ivf.py``. The batch is
INVERTED before the scan: for each posting list, the (capacity-bounded)
set of queries probing it is gathered into ``qdisp [nlist, qcap, d]``,
and every probed list is read once per batch.

``ivf_list_scan`` launches the hand-written CUDA kernel
(``csrc/ivf_list_scan.cu``) for CUDA tensors and runs the plain PyTorch
version ``ivf_list_scan_reference`` for CPU tensors. There is no
fallback: a CUDA tensor gets the kernel or an exception.

Per 128-row sub-block, the top-p rows are kept (first max wins ties),
laid out pass-major: ``[nlist, qcap, p * nsub]``. Dead corpus rows
(``row_ids < 0``) score -inf; the kernel does not read their bytes.
Given the ``dispatch`` table, the dead tail
of each list's slots (past its last live slot) is not computed and
yields ``(-inf, -1)``, so a list no query probes is never read; other
dead slots are computed unmasked, as on the TPU (the regather never
reads them).
"""

from __future__ import annotations

import ctypes

import torch

from rag_foundation_tpu_torch.ops import cuda_lib
from rag_foundation_tpu_torch.ops.quantize import int8_matmul

NEG_INF = float("-inf")
SUB = 128  # sub-block width
_DTYPE_CODE = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
# lists per step of the plain version (bounds its f32 temporaries)
_REF_LISTS = 64

LAUNCHES = cuda_lib.LaunchCounter()   # kernel launches (CUDA path only)

# How far the kernel's f32 and bf16 scores may lie from the plain
# version's: the same exact products of unit rows (d <= 768) summed in
# another order differ by at most d * 2^-24 * sum|q_i r_i| <= 4.6e-5
F32_TOL = 5e-5
_ROUTES = {0: "scalar", 1: "s8", 4: "f32", 16: "bf16_qt16", 32: "bf16_qt32"}


def scan_route(dtype: torch.dtype, qcap: int, d: int, p: int) -> str:
    """The kernel ``csrc/ivf_list_scan.cu`` runs for these shapes, as its
    C entry ``ivf_list_scan_route`` decides: ``"s8"`` (int8 tensor
    cores), ``"bf16_qt16"`` or ``"bf16_qt32"`` (bf16 tensor cores, that
    many query slots a pass over the rows), ``"f32"`` (exact f32 FMA, up
    to 64 slots a pass, any row width), or ``"scalar"``
    (``ivf_scan_kernel``: p > 32, int8 and bf16 rows too wide for their
    tiles). Loads (and on first use builds) the library; reads no
    device."""
    fn = cuda_lib.load("ivf_list_scan").ivf_list_scan_route
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    code = fn(_DTYPE_CODE[dtype], qcap, d, p)
    if code not in _ROUTES:
        raise ValueError(f"ivf_list_scan takes no {dtype} lists at qcap "
                         f"{qcap}, d {d}, p {p}")
    return _ROUTES[code]


def live_slots(dispatch: torch.Tensor) -> torch.Tensor:
    """Per list, one past its last live slot (``dispatch >= 0``), int32."""
    nlist, qcap = dispatch.shape
    if qcap == 0:
        return torch.zeros(nlist, dtype=torch.int32, device=dispatch.device)
    pos = torch.arange(1, qcap + 1, dtype=torch.int32,
                       device=dispatch.device)
    live = torch.where(dispatch >= 0, pos, torch.zeros_like(pos))
    return live.amax(dim=1).to(torch.int32).contiguous()


def _check(qdisp, lists, row_ids, p):
    if qdisp.dim() != 3 or lists.dim() != 3 or row_ids.dim() != 2:
        raise ValueError("expected qdisp [nlist, qcap, d], lists "
                         "[nlist, cap_len, d], row_ids [nlist, cap_len]")
    nlist, qcap, d = qdisp.shape
    cap_len = lists.shape[1]
    if cap_len % SUB:
        raise ValueError(f"cap_len must be a multiple of {SUB}, got "
                         f"{cap_len} (pad posting lists to LBLOCK)")
    if lists.shape[0] != nlist or lists.shape[2] != d \
            or tuple(row_ids.shape) != (nlist, cap_len):
        raise ValueError(f"shape mismatch: qdisp {tuple(qdisp.shape)}, "
                         f"lists {tuple(lists.shape)}, row_ids "
                         f"{tuple(row_ids.shape)}")
    if qdisp.dtype != lists.dtype:
        raise ValueError(f"qdisp dtype {qdisp.dtype} != lists dtype "
                         f"{lists.dtype}")
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")


def ivf_list_scan_reference(
    qdisp: torch.Tensor, lists: torch.Tensor, row_ids: torch.Tensor,
    dispatch: torch.Tensor | None = None, *, p: int = 2, scale: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the list scan (any device): batched
    matmuls (exact for int8) then ``p`` masked argmax passes per
    sub-block. Same outputs as ``ivf_list_scan``."""
    _check(qdisp, lists, row_ids, p)
    nlist, qcap, _ = qdisp.shape
    cap_len = lists.shape[1]
    nsub = cap_len // SUB
    dev = qdisp.device
    out_v = torch.empty((nlist, qcap, nsub * p), dtype=torch.float32,
                        device=dev)
    out_i = torch.empty((nlist, qcap, nsub * p), dtype=torch.int32,
                        device=dev)
    base = (torch.arange(nsub, dtype=torch.int32, device=dev) * SUB)
    for lo in range(0, nlist, _REF_LISTS):
        hi = min(nlist, lo + _REF_LISTS)
        if lists.dtype == torch.int8:
            scores = int8_matmul(qdisp[lo:hi], lists[lo:hi].transpose(1, 2))
            scores = scores * scale
        else:
            scores = torch.matmul(qdisp[lo:hi].float(),
                                  lists[lo:hi].float().transpose(1, 2))
        dead = (row_ids[lo:hi] < 0)[:, None, :]
        scores = scores.masked_fill(dead, NEG_INF)
        s = scores.view(hi - lo, qcap, nsub, SUB)
        flat0 = (torch.arange(lo, hi, dtype=torch.int32, device=dev)
                 * cap_len)[:, None, None] + base[None, None, :]
        for j in range(p):
            m, am = torch.max(s, dim=3)          # first max wins ties
            idx = flat0 + am.to(torch.int32)
            out_v[lo:hi, :, j * nsub:(j + 1) * nsub] = m
            out_i[lo:hi, :, j * nsub:(j + 1) * nsub] = torch.where(
                m == NEG_INF, torch.full_like(idx, -1), idx)
            if j + 1 < p:
                s = s.scatter(3, am[..., None], NEG_INF)
    if dispatch is not None:
        dead_tail = (torch.arange(qcap, device=dev)[None, :]
                     >= live_slots(dispatch)[:, None])[..., None]
        out_v = out_v.masked_fill(dead_tail, NEG_INF)
        out_i = out_i.masked_fill(dead_tail, -1)
    return out_v, out_i


def ivf_list_scan(
    qdisp: torch.Tensor,       # [nlist, qcap, d] same dtype as lists
    lists: torch.Tensor,       # [nlist, cap_len, d]
    row_ids: torch.Tensor,     # [nlist, cap_len] int32 (-1 dead)
    dispatch: torch.Tensor | None = None,   # [nlist, qcap] query ids
    *,
    p: int = 2,
    cap_block: int | None = None,   # accepted; no effect on results
    scale: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(vals [nlist, qcap, w] f32, flat_idx [nlist, qcap, w]
    int32)`` with ``w = (cap_len // 128) * p``; ``flat_idx`` indexes the
    flattened ``[nlist*cap_len]`` corpus. For int8 lists the scores are
    ``float(int32 dot) * scale`` (pass ``scale = s*s`` for a per-tensor
    scale ``s`` on both sides). ``cap_block`` is accepted for interface
    parity and has no effect."""
    del cap_block
    _check(qdisp, lists, row_ids, p)
    if dispatch is not None and tuple(dispatch.shape) != tuple(
            qdisp.shape[:2]):
        raise ValueError(f"dispatch shape {tuple(dispatch.shape)} != "
                         f"{tuple(qdisp.shape[:2])}")
    if qdisp.device.type == "cpu":
        return ivf_list_scan_reference(qdisp, lists, row_ids, dispatch,
                                       p=p, scale=scale)
    if qdisp.device.type != "cuda":
        raise ValueError(f"unsupported device {qdisp.device}")
    for name, t in (("lists", lists), ("row_ids", row_ids)):
        if t.device != qdisp.device:
            raise ValueError(f"{name} on {t.device}, qdisp on "
                             f"{qdisp.device}")
    if qdisp.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {qdisp.dtype}")
    if row_ids.dtype != torch.int32:
        raise ValueError(f"row_ids must be int32, got {row_ids.dtype}")
    if not (qdisp.is_contiguous() and lists.is_contiguous()
            and row_ids.is_contiguous()):
        raise ValueError("ivf_list_scan needs contiguous tensors")
    nlist, qcap, d = qdisp.shape
    cap_len = lists.shape[1]
    if (d * qdisp.element_size()) % 16:
        raise ValueError(f"row bytes d*{qdisp.element_size()} must be a "
                         f"multiple of 16, got d={d}")
    if nlist > 65535:
        raise ValueError(f"nlist {nlist} > 65535 (grid y limit)")
    w = (cap_len // SUB) * p
    vals = torch.empty((nlist, qcap, w), dtype=torch.float32,
                       device=qdisp.device)
    idx = torch.empty((nlist, qcap, w), dtype=torch.int32,
                      device=qdisp.device)
    if nlist == 0 or qcap == 0 or cap_len == 0:
        return vals, idx
    live_n = None
    if dispatch is not None:
        if dispatch.device != qdisp.device:
            raise ValueError(f"dispatch on {dispatch.device}, qdisp on "
                             f"{qdisp.device}")
        live_n = live_slots(dispatch)
    fn = _kernel()
    stream = torch.cuda.current_stream(qdisp.device).cuda_stream
    rc = fn(_DTYPE_CODE[qdisp.dtype], qdisp.data_ptr(), lists.data_ptr(),
            row_ids.data_ptr(),
            None if live_n is None else live_n.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), nlist, qcap, cap_len, d, p,
            float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"ivf_list_scan kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES.add()
    return vals, idx


def _kernel():
    lib = cuda_lib.load("ivf_list_scan")
    fn = lib.ivf_list_scan_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                       ctypes.c_float, vp]
        fn.restype = ci
    return fn
