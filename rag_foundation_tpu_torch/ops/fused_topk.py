"""Exact fused top-k: the product and the running top-k in one kernel.

Counterpart of ``rag_foundation_tpu/ops/pallas_topk.py``, with the
contract of ``ops.topk.exact_topk``: ``corpus [N, d]`` (f32/bf16),
``queries [Q, d]`` cast to the corpus dtype, f32 accumulation; returns
``(values [Q, k] f32, indices [Q, k] int32)`` sorted descending, ties to
the lower index, padding and masked slots as ``(-inf, -1)``. The
``[Q, N]`` score matrix never exists.

``fused_topk`` launches the hand-written CUDA kernels
(``csrc/fused_topk.cu``: a scan over ranges of rows, then a merge of the
ranges) for CUDA tensors and runs the plain PyTorch version
``fused_topk_reference`` for CPU tensors. There is no fallback: a CUDA
tensor gets the kernels or an exception.

The corpus is never padded or copied: the kernel masks rows at or past
``min(valid_count, N)`` itself. ``valid_count`` may be a 0-d int32 tensor
on the device, which the kernel reads without a host copy.
"""

from __future__ import annotations

import ctypes

import torch

from rag_foundation_tpu_torch.ops import cuda_lib
from rag_foundation_tpu_torch.ops.block_topk import (DTYPE_CODE, check_cuda,
                                                     count_args, scan_args)
from rag_foundation_tpu_torch.ops.topk import NEG_INF, exact_topk

_TILE = 128           # rows of a kernel tile: ranges are multiples of it
_BLOCKS_PER_SM = 2    # 128-query tiles an SM works on at once (the bf16
#                       kernel's blocks of 256 queries, one an SM): the
#                       default split is one such wave (the fastest split
#                       measured on an H100)

LAUNCHES = cuda_lib.LaunchCounter()   # kernel launches (CUDA path only)


def fused_topk_reference(
    queries: torch.Tensor, corpus: torch.Tensor, k: int, *,
    valid_count=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (any device): the blockwise stable-sort scan
    ``exact_topk``. A tensor ``valid_count`` is copied to the host."""
    q, valid_count = scan_args(queries, corpus, k, valid_count)
    return exact_topk(q, corpus, k, valid_count=int(valid_count))


def default_splits(q_n: int, n: int, device: torch.device) -> int:
    """Ranges of rows that fill the card once: ``_BLOCKS_PER_SM``
    128-query tiles an SM over all (query tile, range) pairs, at least one
    tile a range."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-q_n // _TILE)
    return max(1, min(-(-n // _TILE), sms * _BLOCKS_PER_SM // q_tiles))


def fused_topk(
    queries: torch.Tensor,     # [Q, d], cast to the corpus dtype
    corpus: torch.Tensor,      # [N, d] float32 or bfloat16
    k: int,
    *,
    valid_count: int | torch.Tensor | None = None,
    block_q: int | None = None,     # accepted; no effect on results
    block_n: int | None = None,     # accepted; no effect on results
    n_splits: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact fused top-k; see the module docstring for the contract.

    ``n_splits`` is the number of row ranges scanned side by side on the
    card (default: enough to fill it); the result does not depend on it.
    ``block_q`` and ``block_n`` are accepted for interface parity and
    have no effect."""
    del block_q, block_n
    if corpus.device.type == "cpu":
        return fused_topk_reference(queries, corpus, k,
                                    valid_count=valid_count)
    q, valid_count = scan_args(queries, corpus, k, valid_count)
    check_cuda("fused_topk", q, corpus, k)
    n, d = corpus.shape
    q_n, dev = q.shape[0], corpus.device
    vals = torch.full((q_n, k), NEG_INF, dtype=torch.float32, device=dev)
    idx = torch.full((q_n, k), -1, dtype=torch.int32, device=dev)
    if q_n == 0 or n == 0:
        return vals, idx
    if n_splits is None:
        n_splits = default_splits(q_n, n, dev)
    if n_splits < 1:
        raise ValueError(f"n_splits must be >= 1, got {n_splits}")
    seg_len = -(-(-(-n // n_splits)) // _TILE) * _TILE
    n_splits = -(-n // seg_len)
    part_v = torch.empty((q_n, n_splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((q_n, n_splits, k), dtype=torch.int32, device=dev)
    fn = _kernel()
    count_ptr, count = count_args(valid_count)
    rc = fn(DTYPE_CODE[corpus.dtype], q.data_ptr(), corpus.data_ptr(),
            count_ptr, count, part_v.data_ptr(), part_i.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), q_n, n, d, seg_len, k,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_topk kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES.add()
    return vals, idx


def _kernel():
    lib = cuda_lib.load("fused_topk")
    fn = lib.fused_topk_launch
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, ci, vp, vp, vp, vp, ci, ci, ci, ci,
                       ci, vp]
        fn.restype = ci
    return fn
