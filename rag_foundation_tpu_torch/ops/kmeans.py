"""K-means (Lloyd) for IVF coarse quantizers.

Counterpart of ``rag_foundation_tpu/ops/kmeans.py``:
- assignment is a blockwise matmul argmax, never a [N, K, d] blowup;
- the centroid update is a segment sum (``index_add_``) and a count;
- seeding is farthest-point for small k and sampled rows for large k;
- empty clusters are reseeded from the rows farthest from their
  centroid, so every list stays in use.

Randomness comes from an explicit ``torch.Generator``. It does not give
the centroids ``jax.random`` gives for the same seed: compare recall,
not ids, between the two packages.
"""

from __future__ import annotations

import torch

from rag_foundation_tpu_torch.ops.l2norm import l2_normalize


def assign_clusters(
    x: torch.Tensor, centroids: torch.Tensor, *, block_size: int = 16384
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment by squared L2 distance.

    Uses the ||x-c||^2 = ||x||^2 - 2 x.c + ||c||^2 expansion so the inner
    loop is a [B, d] @ [d, K] matmul. Returns (assignment [N] int32,
    x.c - ||c||^2/2 [N] f32 — the score used for worst-row reseeding).
    Ties go to the lowest centroid index.
    """
    n = x.shape[0]
    c32 = centroids.float()
    c_sq = 0.5 * torch.sum(c32 * c32, dim=1)
    assign = torch.empty(n, dtype=torch.int32, device=x.device)
    best = torch.empty(n, dtype=torch.float32, device=x.device)
    for start in range(0, n, max(1, block_size)):
        blk = x[start:start + block_size].float()
        score = blk @ c32.T - c_sq[None, :]
        b, a = torch.max(score, dim=1)   # first max on ties
        assign[start:start + len(blk)] = a.to(torch.int32)
        best[start:start + len(blk)] = b
    return assign, best


def _update_centroids(x: torch.Tensor, assign: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum and count of the rows assigned to each centroid. Returns
    (sums [K, d] f32, counts [K] f32)."""
    x32 = x.float()
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32,
                       device=x.device)
    sums.index_add_(0, assign.long(), x32)
    counts = torch.bincount(assign.long(), minlength=k).float()
    return sums, counts


def kmeans_fit(
    x: torch.Tensor,
    k: int,
    *,
    generator: torch.Generator,
    iters: int = 12,
    block_size: int = 16384,
    spherical: bool = False,
    seed_method: str = "auto",
    seed_pool: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fit ``k`` centroids to ``x [N, d]`` with Lloyd iterations.

    Seeding: ``"farthest"`` (greedy k-means++) for small k; ``"random"``
    sampled rows for large k, where the sequential seeding loop would
    dominate build time. ``"auto"`` switches at k=512. ``seed_pool``
    (optional ``[P>=k, d]``) seeds from those points instead of ``x``.
    ``spherical=True`` renormalizes centroids each round. ``generator``
    must live on ``x``'s device.

    Returns ``(centroids [k, d] f32, assignment [N] int32)``.
    """
    n, d = x.shape
    dev = x.device
    x32 = x.float()
    if seed_method == "auto":
        seed_method = "farthest" if k <= 512 else "random"
    pool = x32 if seed_pool is None else seed_pool.float()
    if len(pool) < k:
        pool = x32
    pn = len(pool)

    if seed_method == "random":
        if pn >= k:
            rows = torch.randperm(pn, generator=generator, device=dev)[:k]
        else:
            rows = torch.randint(0, pn, (k,), generator=generator,
                                 device=dev)
        centroids = pool[rows].clone()
    else:
        first = int(torch.randint(0, pn, (1,), generator=generator,
                                  device=dev))
        centroids = torch.zeros((k, d), dtype=torch.float32, device=dev)
        centroids[0] = pool[first]
        min_d = torch.full((pn,), float("inf"), dtype=torch.float32,
                           device=dev)
        for i in range(1, k):
            dist = torch.sum((pool - centroids[i - 1][None, :]) ** 2, dim=1)
            min_d = torch.minimum(min_d, dist)
            centroids[i] = pool[torch.argmax(min_d)]
    if spherical:
        centroids = l2_normalize(centroids)

    x_sq = 0.5 * torch.sum(x32 * x32, dim=1)
    donor_pos = torch.arange(k, device=dev) % n
    for _ in range(iters):
        assign, best = assign_clusters(x32, centroids, block_size=block_size)
        sums, counts = _update_centroids(x32, assign, k)
        new_c = sums / torch.clamp(counts, min=1.0)[:, None]
        # reseed empties from the FARTHEST rows: best = x.c - ||c||^2/2,
        # so the (negated, halved) distance needs the ||x||^2/2 term back
        order = torch.argsort(best - x_sq, stable=True)  # farthest first
        donor = x32[order[donor_pos]]
        new_c = torch.where((counts > 0)[:, None], new_c, donor)
        if spherical:
            new_c = l2_normalize(new_c)
        centroids = new_c
    assign, _ = assign_clusters(x32, centroids, block_size=block_size)
    return centroids, assign
