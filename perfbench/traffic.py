"""The one traffic generator: a pool of queries and the batches drawn
from it, both from the seed.

A traffic file (``traffic/<name>.json``) holds only parameters:

- ``batch``: queries a batch (a power of two: the index pads others);
- ``pool``: distinct queries, a multiple of ``batch``;
- ``qnoise``: a query is a stored chunk plus ``qnoise``/sqrt(d) normal
  noise, l2-normalised;
- ``skew``: 0 draws the source chunks uniformly over the corpus; s > 0
  draws their documents by Zipf's law with exponent s over a seeded
  order of the documents (hot documents make hot posting lists);
- ``orders``: seeded orders of the pool that the batches cycle through.

The window hands the batches over in a closed loop, as fast as the
program asks for them (``harness.Stream``).

Every seed gets the same sizes: batch ``i`` is the ``i``-th slice of
``batch`` rows of the orders laid end to end, a view of a host array.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.corpus import Docwalk, generator, mix, normalize


def source_rows(corpus: Docwalk, count: int, skew: float, seed: int
                ) -> torch.Tensor:
    """Row ids ``[count]`` of the chunks the queries are made from."""
    dev = corpus.device
    g = generator(seed, 2, device=dev)
    if skew == 0:
        return torch.randint(0, corpus.n, (count,), generator=g, device=dev)
    docs = corpus.n // corpus.cpd
    rank = torch.randperm(docs, generator=g, device=dev)
    weight = (rank.double() + 1.0) ** -skew
    doc = torch.multinomial(weight, count, replacement=True, generator=g)
    return doc * corpus.cpd + torch.randint(0, corpus.cpd, (count,),
                                            generator=g, device=dev)


class Traffic:
    """The pool (host f32 ``[pool, d]``) and the batch schedule."""

    def __init__(self, spec: dict, corpus: Docwalk, seed: int):
        self.batch = int(spec["batch"])
        self.pool_n = int(spec["pool"])
        if self.pool_n % self.batch:
            raise ValueError("pool must be a multiple of batch")
        src = source_rows(corpus, self.pool_n, float(spec.get("skew", 0.0)),
                          seed)
        g = generator(seed, 3, device=corpus.device)
        noise = torch.randn((self.pool_n, corpus.d), generator=g,
                            device=corpus.device)
        q = normalize(corpus.rows(src)
                      + spec["qnoise"] / math.sqrt(corpus.d) * noise)
        self.sources = src.cpu().numpy()
        self.pool = q.cpu().numpy()
        rng = np.random.default_rng(mix(seed, 4))
        self.orders = [rng.permutation(self.pool_n)
                       for _ in range(int(spec.get("orders", 8)))]
        self._views = [np.ascontiguousarray(self.pool[o])
                       for o in self.orders]
        self.per_order = self.pool_n // self.batch

    def batch_ids(self, i: int) -> np.ndarray:
        """Pool rows of batch ``i``."""
        o, j = divmod(i, self.per_order)
        return self.orders[o % len(self.orders)][
            j * self.batch:(j + 1) * self.batch]

    def queries(self, i: int) -> np.ndarray:
        """Batch ``i`` as f32 ``[batch, d]`` (a view, no copy)."""
        o, j = divmod(i, self.per_order)
        return self._views[o % len(self._views)][
            j * self.batch:(j + 1) * self.batch]
