"""The one prompt generator of the generation cells: a pool of prompts of
token ids and the order they are handed over in, both from the seed.

A traffic file of a generation cell (``traffic/<name>.json``) holds only
parameters:

- ``concurrency``: requests in flight at once. The window is a closed
  loop: the system asks for a request when it has room for one, as a
  chat asks its next question once its answer has streamed;
- ``pool``: distinct prompts; ``orders``: seeded orders of the pool that
  the window cycles through;
- ``prompt_len`` ``[lo, hi]``: prompt lengths in tokens, spread evenly
  over ``lo..hi``; ``question_len`` ``[lo, hi]``: the question's tokens,
  spread the same way; ``evidences``: passages after the question;
- ``max_tokens``: the answer budget a request asks for.

A prompt is laid out as the decoder's prompts are, ``[BOS] q [SEP] ev1
[SEP] ... evN [SEP]``, the passages splitting what the question leaves;
its ids other than the specials are drawn uniformly from the seed.
Every seed gets the same set of lengths, in its own order, so the seed
changes which ids are served and not how much work they are.
"""

from __future__ import annotations

import numpy as np

from perfbench.corpus import mix

# ids 0-4 are the decoder's specials: PAD, BOS, SEP, EOS, UNK
BOS_ID, SEP_ID, EOS_ID = 1, 2, 3
SPECIALS = 5


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` whole numbers spread evenly over ``lo..hi``, both ends
    included."""
    return lo + (np.arange(n) * (hi - lo)) // max(1, n - 1)


def answer_tokens(length: int, max_tokens: int, ans_len: int, max_len: int,
                  block: int) -> int:
    """Tokens a greedy answer to a prompt of ``length`` gets: the budget
    (``max_tokens`` or the model's ``ans_len``, at most what the cache has
    left past the prompt), the first token from the prefill and then
    blocks of ``block`` while a whole block fits in the cache, the last
    block cut at the budget."""
    budget = min(max_tokens or ans_len, max_len - length - 1)
    n = 1
    while n < budget and length + n + block <= max_len:
        n += min(block, budget - n)
    return n


class Prompts:
    """The pool (host int64 arrays) and the order of the window's
    requests."""

    def __init__(self, spec: dict, vocab_size: int, seed: int):
        self.concurrency = int(spec["concurrency"])
        self.max_tokens = int(spec["max_tokens"])
        n = int(spec["pool"])
        lengths = spread(*spec["prompt_len"], n)
        questions = spread(*spec["question_len"], n)
        n_ev = int(spec["evidences"])
        rng = np.random.default_rng(mix(seed, 7))
        self.pool = []
        for length, q in zip(lengths.tolist(), questions.tolist()):
            ev = length - q - 2 - n_ev
            if ev < n_ev:
                raise ValueError(f"a prompt of {length} tokens has no room "
                                 f"for {n_ev} passages after {q}")
            ids = rng.integers(SPECIALS, vocab_size, size=length)
            ids[0] = BOS_ID
            ids[q + 1] = SEP_ID
            # passage j ends at a SEP; the first ev % n_ev passages take one
            # token more
            ends = q + 1 + np.cumsum([ev // n_ev + 1 + (j < ev % n_ev)
                                      for j in range(n_ev)])
            ids[ends] = SEP_ID
            self.pool.append(ids.astype(np.int64))
        self.longest = int(lengths.max())
        order_rng = np.random.default_rng(mix(seed, 8))
        self.orders = [order_rng.permutation(n)
                       for _ in range(int(spec.get("orders", 8)))]

    def prompt(self, i: int) -> np.ndarray:
        """The prompt of the window's request ``i``."""
        o, j = divmod(i, len(self.pool))
        return self.pool[self.orders[o % len(self.orders)][j]]
