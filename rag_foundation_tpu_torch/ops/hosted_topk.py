"""Host-streaming exact top-k for corpora larger than device memory.

Counterpart of ``rag_foundation_tpu/ops/hosted_topk.py``. The corpus
stays in host RAM (or an ``np.memmap``) and is swept in blocks of
``block_rows`` rows; the running ``[Q, k]`` top-k lives on the device.
Ties break toward the lowest global row id, so the ids equal
``ops/topk.exact_topk`` over the same rows bit for bit.

On a CUDA device the sweep is double-buffered: two pinned staging
buffers and two device buffers, a copy stream and events. While block
``i`` is scored on the current stream, block ``i+1`` is copied from the
corpus into its pinned buffer and from there to the device. The tail
block is a shorter view of the same buffers, not a zero-padded copy.
Scoring and merging are plain PyTorch (``exact_topk`` per block, then
``merge_topk``), as the JAX function leaves them to XLA.

Throughput is transfer-bound: bytes(corpus) over the host-to-device rate
per query batch. This is the correctness backstop for corpora past the
quantization ladder, not a hot path.
"""

from __future__ import annotations

import numpy as np
import torch

from rag_foundation_tpu_torch.ops.topk import NEG_INF, exact_topk, merge_topk
from rag_foundation_tpu_torch.utils.device import resolve_device

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.int8): torch.int8}


class _Stager:
    """Brings blocks of a host corpus to ``device`` through two buffers.

    ``put(b, lo, m)`` stages block ``b`` (rows ``lo..lo+m``) and, on CUDA,
    queues its copy on the copy stream; ``take(b, m)`` returns the block
    on the device once the current stream may read it; ``done(b)`` marks
    the current stream's work on it as queued, after which the slot may
    be overwritten."""

    def __init__(self, corpus, block_rows: int, dtype: torch.dtype,
                 device: torch.device) -> None:
        self.corpus = corpus
        self.cuda = device.type == "cuda"
        shape = (block_rows, corpus.shape[1])
        self.host = [torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
                     for _ in range(2)]
        if self.cuda:
            self.dev = [torch.empty(shape, dtype=dtype, device=device)
                        for _ in range(2)]
            self.stream = torch.cuda.Stream(device)
            self.copied = [torch.cuda.Event() for _ in range(2)]
            self.scored = [torch.cuda.Event() for _ in range(2)]

    def put(self, b: int, lo: int, m: int) -> None:
        slot = b % 2
        if self.cuda:
            # the slot's last copy to the device has read the pinned rows
            self.copied[slot].synchronize()
        self.host[slot].numpy()[:m] = self.corpus[lo:lo + m]
        if self.cuda:
            # the slot's last block has been scored
            self.stream.wait_event(self.scored[slot])
            with torch.cuda.stream(self.stream):
                self.dev[slot][:m].copy_(self.host[slot][:m],
                                         non_blocking=True)
            self.copied[slot].record(self.stream)

    def take(self, b: int, m: int) -> torch.Tensor:
        slot = b % 2
        if not self.cuda:
            return self.host[slot][:m]
        torch.cuda.current_stream(self.stream.device).wait_event(
            self.copied[slot])
        return self.dev[slot][:m]

    def done(self, b: int) -> None:
        if self.cuda:
            self.scored[b % 2].record(
                torch.cuda.current_stream(self.stream.device))


def exact_topk_hosted(
    queries,                       # [Q, d] tensor (or host array)
    corpus: np.ndarray,            # [N, d] HOST-resident (ndarray/memmap)
    k: int,
    *,
    block_rows: int = 262_144,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a host-resident corpus of f32 rows, or of int8
    rows scored as exact integer dots. Returns ``([Q, k] f32 values,
    [Q, k] int32 row ids)`` on the device; semantics match ``exact_topk``
    (an empty corpus gives ``(-inf, -1)``).

    ``device``: where the scan runs; default: the queries' device when
    they are a tensor, else the card."""
    if device is None and isinstance(queries, torch.Tensor):
        dev = queries.device
    else:
        dev = resolve_device("cuda" if device is None else device)
    dtype = _TORCH_DTYPE.get(np.dtype(corpus.dtype))
    if dtype is None:
        raise ValueError(f"corpus dtype {corpus.dtype} not supported "
                         "(float32 or int8)")
    q = torch.as_tensor(queries).to(device=dev, dtype=dtype)
    vals = torch.full((q.shape[0], k), NEG_INF, dtype=torch.float32,
                      device=dev)
    ids = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=dev)
    n = len(corpus)
    if n == 0:
        return vals, ids
    block_rows = max(1, min(block_rows, n))
    stager = _Stager(corpus, block_rows, dtype, dev)
    stager.put(0, 0, min(block_rows, n))
    for b, lo in enumerate(range(0, n, block_rows)):
        m = min(block_rows, n - lo)
        block_v, block_i = exact_topk(q, stager.take(b, m), k)
        stager.done(b)
        nxt = lo + block_rows
        if nxt < n:     # staged and copied while block b is scored
            stager.put(b + 1, nxt, min(block_rows, n - nxt))
        block_i = torch.where(block_i >= 0, block_i + lo, block_i)
        # the carry holds the lower ids and goes first: it wins ties
        vals, ids = merge_topk(vals, ids, block_v, block_i, k)
    return vals, ids
