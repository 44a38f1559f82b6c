"""Two-stage exact scan: top-p per corpus block in a kernel, then a merge.

Counterpart of ``rag_foundation_tpu/ops/pallas_block_topk.py``. Stage 1
scores ``queries @ corpus.T`` block by block and keeps only the best
``p`` rows of every (query, ``block_n``-row block); stage 2 is one stable
top-k over the ``[Q, num_blocks * p]`` candidates, outside the kernel as
in the JAX package. A true top-k row is lost only when more than ``p`` of
a query's top-k lie in one block; ``p = k`` is exact for any layout.

``block_topk`` launches the hand-written CUDA kernel
(``csrc/block_topk.cu``) for CUDA tensors and runs the plain PyTorch
version ``block_topk_reference`` for CPU tensors. There is no fallback: a
CUDA tensor gets the kernel or an exception.

The corpus is never padded or copied: the kernel masks rows at or past
``min(valid_count, N)`` itself. ``valid_count`` may be a 0-d int32 tensor
on the device, which the kernel reads without a host copy.
"""

from __future__ import annotations

import ctypes

import torch

from rag_foundation_tpu_torch.ops import cuda_lib
from rag_foundation_tpu_torch.ops.topk import (NEG_INF, block_scores,
                                               stable_topk)

DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}
K_MAX = 64    # longest per-query list the kernels keep

LAUNCHES = cuda_lib.LaunchCounter()   # kernel launches (CUDA path only)


def scan_args(queries: torch.Tensor, corpus: torch.Tensor, k: int,
              valid_count) -> tuple[torch.Tensor, int | torch.Tensor]:
    """Checks shared by the exact-scan wrappers (this one and
    ``fused_topk``); returns the queries in the corpus dtype and the valid
    count as an int or a 0-d int32 tensor on the corpus device."""
    if queries.dim() != 2 or corpus.dim() != 2 \
            or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"expected queries [Q, d] and corpus [N, d], got "
                         f"{tuple(queries.shape)} and {tuple(corpus.shape)}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if queries.device != corpus.device:
        raise ValueError(f"queries on {queries.device}, corpus on "
                         f"{corpus.device}")
    n = corpus.shape[0]
    if valid_count is None:
        valid_count = n
    elif isinstance(valid_count, torch.Tensor):
        if valid_count.numel() != 1:
            raise ValueError("valid_count must hold one value")
        valid_count = valid_count.reshape(()).to(
            device=corpus.device, dtype=torch.int32)
    else:
        valid_count = max(0, min(int(valid_count), n))
    return queries.to(corpus.dtype), valid_count


def check_cuda(name: str, q: torch.Tensor, corpus: torch.Tensor,
               k: int) -> None:
    """What the exact-scan kernels take on the card; raises otherwise."""
    if corpus.device.type != "cuda":
        raise ValueError(f"unsupported device {corpus.device}")
    if corpus.dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: unsupported dtype {corpus.dtype} "
                         "(float32 or bfloat16)")
    if not (q.is_contiguous() and corpus.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors")
    d = corpus.shape[1]
    if (d * corpus.element_size()) % 16 or q.data_ptr() % 16 \
            or corpus.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte multiples at 16-byte "
                         f"aligned addresses, got d={d} of {corpus.dtype}")
    if corpus.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: N {corpus.shape[0]} >= 2**31")
    if k > K_MAX:
        raise ValueError(f"{name}: the kernel keeps at most {K_MAX} rows a "
                         f"query, got {k}")


def count_args(valid_count) -> tuple[int | None, int]:
    """(device pointer or None, int) as the C entry points take them."""
    if isinstance(valid_count, torch.Tensor):
        return valid_count.data_ptr(), 0
    return None, valid_count


def _blocks(n: int, block_n: int) -> tuple[int, int]:
    block_n = max(1, min(block_n, n))
    return block_n, -(-n // block_n)


def _finish(cand_v: torch.Tensor, cand_i: torch.Tensor, k: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2: ``[Q, num_blocks, p]`` candidates, block-major so equal
    scores prefer the lower block, to the top-k."""
    q_n = cand_v.shape[0]
    top_v, pos = stable_topk(cand_v.reshape(q_n, -1), k)
    top_i = torch.gather(cand_i.reshape(q_n, -1), 1, pos)
    return top_v, torch.where(top_v == NEG_INF, torch.full_like(top_i, -1),
                              top_i)


def _prelude(queries, corpus, k, p, valid_count, block_n):
    """Checked arguments of both versions: (queries in the corpus dtype,
    valid count, p clamped to k)."""
    q, valid_count = scan_args(queries, corpus, k, valid_count)
    p = min(p, k)
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    n = corpus.shape[0]
    num_blocks = _blocks(n, block_n)[1] if n else 0
    if num_blocks * p < k:
        raise ValueError(f"k={k} exceeds the {num_blocks} x {p} candidates "
                         f"of {n} rows in blocks of {block_n}")
    return q, valid_count, p


def block_candidates_reference(q: torch.Tensor, corpus: torch.Tensor, p: int,
                               valid_count, block_n: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch stage 1 (any device): per block one product and ``p``
    first-max passes. Same outputs as the kernel."""
    n = corpus.shape[0]
    q_n, dev = q.shape[0], corpus.device
    block_n, num_blocks = _blocks(n, block_n)
    cand_v = torch.empty((q_n, num_blocks, p), dtype=torch.float32,
                         device=dev)
    cand_i = torch.empty((q_n, num_blocks, p), dtype=torch.int32, device=dev)
    for b in range(num_blocks):
        lo, hi = b * block_n, min(n, (b + 1) * block_n)
        s = block_scores(q, corpus[lo:hi])
        live = torch.arange(lo, hi, dtype=torch.int32, device=dev) \
            < valid_count
        s = s.masked_fill(~live[None, :], NEG_INF)
        for j in range(p):
            m, am = torch.max(s, dim=1)            # first max wins ties
            idx = am.to(torch.int32) + lo
            s = s.scatter(1, am[:, None], NEG_INF)
            cand_v[:, b, j] = m
            cand_i[:, b, j] = torch.where(m == NEG_INF,
                                          torch.full_like(idx, -1), idx)
    return cand_v, cand_i


def block_topk_reference(
    queries: torch.Tensor, corpus: torch.Tensor, k: int, *, p: int = 2,
    valid_count=None, block_n: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``block_topk`` (any device)."""
    q, valid_count, p = _prelude(queries, corpus, k, p, valid_count,
                                 block_n)
    return _finish(*block_candidates_reference(q, corpus, p, valid_count,
                                               block_n), k)


def block_candidates(q: torch.Tensor, corpus: torch.Tensor, p: int,
                     valid_count, block_n: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 on the card: one kernel launch. ``[Q, num_blocks, p]``
    values (f32) and global row ids (int32, -1 where -inf)."""
    check_cuda("block_topk", q, corpus, p)
    n, d = corpus.shape
    q_n = q.shape[0]
    block_n, num_blocks = _blocks(n, block_n)
    cand_v = torch.empty((q_n, num_blocks, p), dtype=torch.float32,
                         device=corpus.device)
    cand_i = torch.empty((q_n, num_blocks, p), dtype=torch.int32,
                         device=corpus.device)
    if q_n == 0:
        return cand_v, cand_i
    fn = _kernel()
    count_ptr, count = count_args(valid_count)
    rc = fn(DTYPE_CODE[corpus.dtype], q.data_ptr(), corpus.data_ptr(),
            count_ptr, count, cand_v.data_ptr(), cand_i.data_ptr(), q_n, n,
            d, block_n, p,
            torch.cuda.current_stream(corpus.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block_topk kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES.add()
    return cand_v, cand_i


def block_topk(
    queries: torch.Tensor,     # [Q, d], cast to the corpus dtype
    corpus: torch.Tensor,      # [N, d] float32 or bfloat16
    k: int,
    *,
    p: int = 2,
    valid_count: int | torch.Tensor | None = None,
    block_q: int | None = None,     # accepted; no effect on results
    block_n: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-stage top-k; same output contract as ``ops.topk.exact_topk``:
    ``(values [Q, k] f32, indices [Q, k] int32)``, pads ``(-inf, -1)``.

    ``p`` = candidates kept per (query, block of ``block_n`` rows), at
    most ``k``; ``p = k`` makes it exact. Ties go to the lowest global
    index, except that more than ``p`` equal scores in one block may
    surface a later index (the documented approximation). ``block_n`` is
    part of the result when ``p < k``; ``block_q`` is accepted for
    interface parity and has no effect."""
    del block_q
    q, valid_count, p = _prelude(queries, corpus, k, p, valid_count,
                                 block_n)
    if corpus.device.type == "cpu":
        cands = block_candidates_reference(q, corpus, p, valid_count,
                                           block_n)
    else:
        cands = block_candidates(q, corpus, p, valid_count, block_n)
    return _finish(*cands, k)


def _kernel():
    lib = cuda_lib.load("block_topk")
    fn = lib.block_topk_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, ci, vp, vp, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return fn
