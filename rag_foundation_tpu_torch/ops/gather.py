"""Scattered-row gather + int8 rescore (the IVF-PQ refine stage core).

Counterpart of ``rag_foundation_tpu/ops/pallas_gather.py``: for each
query, read its ``C`` candidate rows of an int8 table by id and return
the unscaled int8 dot products with the query's int8 row, ``[Q, C]`` f32
(the int32 sums are exact). Negative ids are clipped to row 0 and give
scores the caller masks.

``gather_rescore_int8`` launches the hand-written CUDA kernel
(``csrc/gather_rescore_int8.cu``) for CUDA tensors and runs the plain
PyTorch version ``gather_rescore_int8_reference`` for CPU tensors. There
is no fallback: a CUDA tensor gets the kernel or an exception. The
kernel never materializes the gathered ``[Q, C, d]`` rows, so callers
need not block over queries, and ``N`` need not be a multiple of 8.
"""

from __future__ import annotations

import ctypes

import torch

from rag_foundation_tpu_torch.ops import cuda_lib

# query rows per step of the plain version (bounds its [q, C, d] int32
# temporary)
_REF_ELEMS = 1 << 25

LAUNCHES = cuda_lib.LaunchCounter()   # kernel launches (CUDA path only)


def _check(table8, rows, q_int8) -> None:
    if table8.dim() != 2 or rows.dim() != 2 or q_int8.dim() != 2:
        raise ValueError("expected table8 [N, d], rows [Q, C], q_int8 "
                         "[Q, d]")
    if table8.dtype != torch.int8 or q_int8.dtype != torch.int8:
        raise ValueError(f"table8 and q_int8 must be int8, got "
                         f"{table8.dtype} and {q_int8.dtype}")
    if q_int8.shape != (rows.shape[0], table8.shape[1]):
        raise ValueError(f"shape mismatch: table8 {tuple(table8.shape)}, "
                         f"rows {tuple(rows.shape)}, q_int8 "
                         f"{tuple(q_int8.shape)}")
    if table8.shape[0] == 0:
        raise ValueError("table8 has no rows")


def gather_rescore_int8_reference(
    table8: torch.Tensor, rows: torch.Tensor, q_int8: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version (any device): clip, index, widen to int32,
    multiply and sum exactly. Blocked over queries to bound memory."""
    _check(table8, rows, q_int8)
    n, d = table8.shape
    q_n, c = rows.shape
    out = torch.empty((q_n, c), dtype=torch.float32, device=table8.device)
    step = max(1, _REF_ELEMS // max(1, c * d))
    for lo in range(0, q_n, step):
        safe = torch.clamp(rows[lo:lo + step].long(), 0, n - 1)
        vecs = table8[safe.reshape(-1)].view(-1, c, d).to(torch.int32)
        qb = q_int8[lo:lo + step].to(torch.int32)
        out[lo:lo + step] = (vecs * qb[:, None, :]).sum(
            dim=2, dtype=torch.int32).float()
    return out


def gather_rescore_int8(
    table8: torch.Tensor,     # [N, d] int8 rows
    rows: torch.Tensor,       # [Q, C] int32 row ids (negatives allowed,
                              # callers mask the scores)
    q_int8: torch.Tensor,     # [Q, d] int8
) -> torch.Tensor:
    """Unscaled int8 dot products ``[Q, C] f32`` of each query against
    its candidate rows. Invalid (negative) rows return the score of row
    0 — mask them outside."""
    _check(table8, rows, q_int8)
    if table8.device.type == "cpu":
        return gather_rescore_int8_reference(table8, rows, q_int8)
    if table8.device.type != "cuda":
        raise ValueError(f"unsupported device {table8.device}")
    for name, t in (("rows", rows), ("q_int8", q_int8)):
        if t.device != table8.device:
            raise ValueError(f"{name} on {t.device}, table8 on "
                             f"{table8.device}")
    if rows.dtype != torch.int32:
        raise ValueError(f"rows must be int32, got {rows.dtype}")
    if not (table8.is_contiguous() and rows.is_contiguous()
            and q_int8.is_contiguous()):
        raise ValueError("gather_rescore_int8 needs contiguous tensors")
    n, d = table8.shape
    q_n, c = rows.shape
    if c > 8 * 65535:
        raise ValueError(f"C {c} > {8 * 65535} (grid y limit)")
    out = torch.empty((q_n, c), dtype=torch.float32, device=table8.device)
    if q_n == 0 or c == 0:
        return out
    fn = _kernel()
    stream = torch.cuda.current_stream(table8.device).cuda_stream
    rc = fn(table8.data_ptr(), rows.data_ptr(), q_int8.data_ptr(),
            out.data_ptr(), n, q_n, c, d, stream)
    if rc != 0:
        raise RuntimeError(f"gather_rescore_int8 kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES.add()
    return out


def _kernel():
    lib = cuda_lib.load("gather_rescore_int8")
    fn = lib.gather_rescore_int8_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci, vp]
        fn.restype = ci
    return fn
