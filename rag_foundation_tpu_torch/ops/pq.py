"""Product quantization: codebook training, encoding, and ADC scoring.

Counterpart of ``rag_foundation_tpu/ops/pq.py``. PQ splits a ``d``-dim
vector into ``m`` subspaces of ``d/m`` dims and quantizes each to one of
``2**nbits`` centroids (one code per subspace). Asymmetric distance
computation (ADC) scores a float query against codes by building a
per-query lookup table ``LUT[m, K]`` (one small matmul) and summing ``m``
lookups.

Two regimes, as in the JAX package: ``nbits=4`` (K=16), whose list scan
is the CUDA kernel of ``ops/pq_scan.py``, and ``nbits=8`` (K=256), byte
codes scored in plain PyTorch (``engine/ivfpq.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rag_foundation_tpu_torch.ops.kmeans import kmeans_fit_batched

PQ_K = 256  # codes per subspace at the default nbits=8


class PQCodebook(NamedTuple):
    """``centroids [m, K, dsub]`` f32 — per-subspace codebooks
    (K = 2**nbits: 256 for byte codes, 16 for 4-bit codes)."""

    centroids: torch.Tensor

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def k(self) -> int:
        return self.centroids.shape[1]

    @property
    def dsub(self) -> int:
        return self.centroids.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.dsub


def pq_train(
    x: torch.Tensor, m: int, *, generator: torch.Generator, iters: int = 10,
    nbits: int = 8,
) -> PQCodebook:
    """Train per-subspace codebooks on ``x [N, d]`` (d divisible by m):
    ``m`` independent k-means, run as one batched fit."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by m={m}")
    if nbits not in (4, 8):
        raise ValueError(f"nbits must be 4 or 8, got {nbits}")
    xs = x.float().reshape(n, m, d // m).transpose(0, 1)   # [m, N, dsub]
    return PQCodebook(centroids=kmeans_fit_batched(
        xs, 1 << nbits, generator=generator, iters=iters))


def pq_encode(codebook: PQCodebook, x: torch.Tensor,
              block_size: int = 65536) -> torch.Tensor:
    """Encode ``x [N, d]`` → ``codes [N, m] uint8`` (nearest sub-centroid,
    ties to the lowest code). Row-blocked: the ``[block, m, K]`` f32
    score tensor bounds the working set."""
    n = x.shape[0]
    c = codebook.centroids                       # [m, K, dsub]
    m, _, dsub = c.shape
    c_sq = 0.5 * torch.sum(c * c, dim=2)         # [m, K]
    ct = c.transpose(1, 2)                       # [m, dsub, K]
    codes = torch.empty((n, m), dtype=torch.uint8, device=x.device)
    for lo in range(0, n, max(1, block_size)):
        xb = x[lo:lo + block_size].float()
        xs = xb.reshape(len(xb), m, dsub).transpose(0, 1)    # [m, B, dsub]
        score = torch.bmm(xs, ct) - c_sq[:, None, :]         # [m, B, K]
        codes[lo:lo + len(xb)] = torch.argmax(score, dim=2).T.to(
            torch.uint8)
    return codes


def pq_decode(codebook: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct ``[N, d]`` f32 vectors from ``codes [N, m]``."""
    m = codebook.m
    sub = torch.arange(m, device=codes.device)
    gathered = codebook.centroids[sub[None, :], codes.long()]  # [N, m, dsub]
    return gathered.reshape(codes.shape[0], m * codebook.dsub)


def pq_lut(codebook: PQCodebook, queries: torch.Tensor) -> torch.Tensor:
    """Per-query inner-product lookup tables ``[Q, m, K]`` f32.

    ``score(q, n) = sum_m LUT[q, m, codes[n, m]]`` equals
    ``q · decode(codes[n])`` exactly.
    """
    q_ = queries.float().reshape(queries.shape[0], codebook.m,
                                 codebook.dsub).transpose(0, 1)
    return torch.bmm(q_, codebook.centroids.transpose(1, 2)).transpose(0, 1)


def pq_adc_scores(
    lut: torch.Tensor, codes: torch.Tensor, *, block_size: int = 32768
) -> torch.Tensor:
    """ADC scores ``[Q, N]`` from ``lut [Q, m, K]`` and ``codes [N, m]``,
    blockwise over N to bound the gather working set."""
    q, m, _ = lut.shape
    n = codes.shape[0]
    sub = torch.arange(m, device=codes.device)
    out = torch.empty((q, n), dtype=torch.float32, device=lut.device)
    for lo in range(0, n, max(1, block_size)):
        idx = codes[lo:lo + block_size].long()               # [B, m]
        out[:, lo:lo + len(idx)] = lut[:, sub[None, :], idx].sum(dim=2)
    return out
