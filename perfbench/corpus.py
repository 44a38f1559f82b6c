"""The docwalk corpus in PyTorch, made on the device from a seed.

The structure of ``benchmarks/corpus.py`` (which draws with
``jax.random``): ``topics`` unit topic centres; a document of ``cpd``
chunks sits near a topic (its centre is the topic plus
``alpha``/sqrt(d) normal noise) and its chunks are a random walk from
that centre in ``delta``/sqrt(d) normal steps; every chunk is
l2-normalised. The true top-10 of a query made from a chunk are that
chunk and its walk neighbours, with score gaps far above int8 noise.

Rows come in blocks of ``block`` rows (whole documents). Block ``b`` is
drawn by a ``torch.Generator`` seeded from ``(seed, b)`` alone, so any
row is a pure function of (seed, row): a block regenerates bit for bit
on the same device, and the build, the queries and the reference each
regenerate what they need instead of holding the f32 corpus.

The corpus's seed is the configuration's (``corpus.seed``), not the
run's, as the source case is one fixed data set: every run builds the
same index, with lists of the same sizes (a k-means over ``topics``
tight clusters is as uneven as its seeding and its rows make it, and
the list scan's work follows the largest list: 8,064 to 12,752 rows over
eight corpus seeds at 10M rows on an H100), and the run's seed draws the
queries and their order (``traffic.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = 1 << 18        # rows a block (the port's build chunk)


def mix(seed: int, *tags: int) -> int:
    """A 63-bit generator seed from the run's seed and a purpose tag."""
    words = np.random.SeedSequence(seed % (1 << 64), spawn_key=tags) \
        .generate_state(2, np.uint32)
    return (int(words[0]) << 31 | int(words[1]) >> 1) & ((1 << 63) - 1)


def generator(seed: int, *tags: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, *tags))


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class Docwalk:
    """Rows ``[0, n)`` of the docwalk corpus of ``seed`` on ``device``."""

    def __init__(self, seed: int, n: int, d: int, *, topics: int, cpd: int,
                 alpha: float, delta: float, device, block: int = BLOCK):
        if block % cpd:
            raise ValueError(f"block {block} is not whole documents of {cpd}")
        self.seed, self.n, self.d, self.cpd = seed, n, d, cpd
        self.block_rows = block
        self.device = torch.device(device)
        self.sig_a = alpha / math.sqrt(d)
        self.sig_s = delta / math.sqrt(d)
        g = generator(seed, 0, device=self.device)
        self.topics = normalize(torch.randn((topics, d), generator=g,
                                            device=self.device))

    @classmethod
    def from_config(cls, cfg: dict, device) -> "Docwalk":
        c = cfg["corpus"]
        return cls(c["seed"], cfg["rows"], cfg["dim"], topics=c["topics"],
                   cpd=c["cpd"], alpha=c["alpha"], delta=c["delta"],
                   device=device, block=c.get("block", BLOCK))

    @property
    def nblocks(self) -> int:
        return -(-self.n // self.block_rows)

    def block(self, bi: int) -> torch.Tensor:
        """Rows ``[bi * block, (bi + 1) * block)`` as f32 ``[block, d]``
        (rows past ``n`` are drawn too; callers cut them)."""
        g = generator(self.seed, 1, bi, device=self.device)
        docs = self.block_rows // self.cpd
        t = torch.randint(0, self.topics.shape[0], (docs,), generator=g,
                          device=self.device)
        centre = self.topics[t] + self.sig_a * torch.randn(
            (docs, self.d), generator=g, device=self.device)
        steps = torch.randn((docs, self.cpd, self.d), generator=g,
                            device=self.device)
        walk = centre[:, None, :] + torch.cumsum(steps, dim=1) * self.sig_s
        return normalize(walk.reshape(self.block_rows, self.d))

    def blocks(self):
        """``(lo, hi, rows [hi - lo, d])`` over the whole corpus."""
        for bi in range(self.nblocks):
            lo = bi * self.block_rows
            hi = min(self.n, lo + self.block_rows)
            yield lo, hi, self.block(bi)[:hi - lo]

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (any order, repeats allowed) as f32 ``[len, d]``,
        each block that holds one regenerated once."""
        idx = idx.to(self.device, torch.int64)
        out = torch.empty((len(idx), self.d), dtype=torch.float32,
                          device=self.device)
        which = idx // self.block_rows
        for bi in torch.unique(which).tolist():
            sel = torch.nonzero(which == bi).squeeze(1)
            out[sel] = self.block(bi)[idx[sel] - bi * self.block_rows]
        return out
