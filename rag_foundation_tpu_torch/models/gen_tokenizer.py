"""Invertible WordPiece tokenizer for the generative decoder.

A copy of ``rag_foundation_tpu/models/gen_tokenizer.py`` (no JAX in it;
the port keeps its own copy so that it imports nothing of the JAX
package). Vocabularies, ids, decoded text and the JSON vocabulary format
equal the JAX package's bit for bit (``tests/test_torch_gen_tokenizer.py``),
so a decoder checkpoint's embedded vocabulary loads in either package.
Only ``train_gen_vocab`` is written otherwise: it updates its pair counts
merge by merge where JAX's recounts them all, so an 8192-piece vocabulary
of some 6,500 corpus chunks takes seconds, not minutes.

The encoder's hashing tokenizer (models/tokenizer.py) is one-way by
design: ids cannot be mapped back to text. This module owns the
decoder's token space: a learned WordPiece vocabulary (BPE-merge trained
on the corpus) with an id->piece table, plus the detokenizer that turns
greedy-decoded ids back into prose.

Word model: lowercase; a "word" is an alnum run possibly joined by
inner ``.,-`` (so "8.4", "3,000" and "v5e-8" stay single words and
round-trip exactly), or a single punctuation character. Every word
falls back to character pieces, so ANY input word, including ones never
seen in training, is encodable and exactly decodable: the copy skill the
evidence-conditioned decoder needs.

Specials: [PAD]=0 [BOS]=1 [SEP]=2 [EOS]=3 [UNK]=4. [UNK] only appears
for characters outside the trained piece set (e.g. non-ASCII); it
decodes to an empty string.
"""

from __future__ import annotations

import collections
import heapq
import json
import re

import numpy as np

PAD_ID, BOS_ID, SEP_ID, EOS_ID, UNK_ID = 0, 1, 2, 3, 4
_SPECIALS = ("[PAD]", "[BOS]", "[SEP]", "[EOS]", "[UNK]")

# alnum runs with inner . , - kept ("8.4", "3,000", "v5e-8"), else one
# non-space char per token
WORD_RE = re.compile(r"[a-z0-9]+(?:[.,-][a-z0-9]+)*|[^\sa-z0-9]")

# no space BEFORE these when detokenizing …
_TIGHT_LEFT = frozenset(".,:;!?%)]}’'\"")
# … and no space AFTER these
_TIGHT_RIGHT = frozenset("([{$#“\"'")


def train_gen_vocab(texts: list[str], vocab_size: int = 8192,
                    *, min_pair_count: int = 2) -> dict[str, int]:
    """BPE-merge WordPiece training (the objective of
    ``models/vocab.train_wordpiece``) over the generation word model.
    Returns piece -> id with the 5 specials reserved at 0..4.

    The JAX package's trainer recounts every pair of every word for each
    merge and takes ``Counter.most_common(1)``: the most frequent pair,
    a tie going to the pair seen first in its scan (words in order of
    first appearance, each left to right). This one gives the same
    vocabulary, merge for merge, in time that grows with the words each
    merge touches: it keeps the pair counts, the words holding each pair
    and each pair's first occurrence, as (word, character offset), which
    no merge moves, and picks from a heap ordered by (-count, first
    occurrence)."""
    word_freq: collections.Counter[str] = collections.Counter()
    for text in texts:
        word_freq.update(WORD_RE.findall(text.lower()))

    def initial_pieces(word: str) -> tuple[str, ...]:
        return (word[0],) + tuple(f"##{c}" for c in word[1:])

    words = [list(initial_pieces(w)) for w in word_freq]
    freqs = list(word_freq.values())
    vocab: dict[str, int] = {t: i for i, t in enumerate(_SPECIALS)}
    for pieces in words:
        for piece in pieces:
            if piece not in vocab:
                vocab[piece] = len(vocab)

    def pairs_at(pieces: list[str]) -> dict:
        """{pair: (occurrences, character offset of the first)}."""
        out: dict = {}
        offset = 0
        for x, y in zip(pieces, pieces[1:]):
            n, first = out.get((x, y), (0, offset))
            out[(x, y)] = (n + 1, first)
            offset += len(x) - 2 * x.startswith("##")
        return out

    counts: dict[tuple[str, str], int] = {}
    holders: dict[tuple[str, str], set[int]] = {}
    first: dict[tuple[str, str], tuple[int, int]] = {}
    for wi, pieces in enumerate(words):
        for pair, (n, offset) in pairs_at(pieces).items():
            counts[pair] = counts.get(pair, 0) + n * freqs[wi]
            holders.setdefault(pair, set()).add(wi)
            first.setdefault(pair, (wi, offset))
    heap = [(-c, first[pair], pair) for pair, c in counts.items()]
    heapq.heapify(heap)

    while len(vocab) < vocab_size:
        while heap:
            neg, where, pair = heap[0]
            if counts.get(pair) == -neg and first[pair] == where:
                break
            heapq.heappop(heap)           # a stale entry
        if not heap:
            break
        (a, b), count = pair, -neg
        if count < min_pair_count:
            break
        new_piece = a + b.removeprefix("##")
        if new_piece not in vocab:
            vocab[new_piece] = len(vocab)
        touched: set[tuple[str, str]] = set()
        for wi in sorted(holders[(a, b)]):
            pieces = words[wi]
            before = pairs_at(pieces)
            out = []
            i = 0
            while i < len(pieces):
                if i + 1 < len(pieces) and pieces[i] == a \
                        and pieces[i + 1] == b:
                    out.append(new_piece)
                    i += 2
                else:
                    out.append(pieces[i])
                    i += 1
            words[wi] = out
            after = pairs_at(out)
            for p in before.keys() | after.keys():
                old, new = before.get(p), after.get(p)
                if old == new:
                    continue
                touched.add(p)
                delta = ((new[0] if new else 0) - (old[0] if old else 0)) \
                    * freqs[wi]
                counts[p] = counts.get(p, 0) + delta
                if new is None:
                    holders[p].discard(wi)
                else:
                    holders.setdefault(p, set()).add(wi)
                # the first occurrence moves only within or before the
                # word that held it
                if first.get(p) is None or wi <= first[p][0]:
                    first[p] = None
        for p in touched:
            if counts[p] == 0:
                del counts[p], holders[p], first[p]
                continue
            if first[p] is None:
                wi = min(holders[p])
                first[p] = (wi, pairs_at(words[wi])[p][1])
            heapq.heappush(heap, (-counts[p], first[p], p))
    return vocab


class GenTokenizer:
    """Encode/decode against a trained gen vocab (piece -> id)."""

    def __init__(self, vocab: dict[str, int]):
        self.vocab = vocab
        self.vocab_size = max(vocab.values()) + 1
        self._id2piece = [""] * self.vocab_size
        for piece, i in vocab.items():
            self._id2piece[i] = piece

    # -- encode -------------------------------------------------------------
    def _word_ids(self, word: str) -> list[int]:
        # greedy longest-match (models/vocab.tokenize_wordpiece shape)
        ids: list[int] = []
        i = 0
        first = True
        while i < len(word):
            j = len(word)
            while j > i:
                piece = word[i:j] if first else f"##{word[i:j]}"
                pid = self.vocab.get(piece)
                if pid is not None:
                    ids.append(pid)
                    break
                j -= 1
            else:
                # unknown CHARACTER (not in training charset)
                ids.append(UNK_ID)
                j = i + 1
            i = j
            first = False
        return ids

    def encode_text(self, text: str) -> list[int]:
        """Raw piece ids for a text span (no specials)."""
        ids: list[int] = []
        for w in WORD_RE.findall(text.lower()):
            ids.extend(self._word_ids(w))
        return ids

    def encode_prompt(self, question: str, evidences: list[str],
                      max_len: int) -> list[int]:
        """``[BOS] q [SEP] ev1 [SEP] ev2 [SEP] ... [SEP]`` truncated to
        ``max_len``: the question is never truncated; evidence passages
        split the remaining budget equally (leftover rolls forward)."""
        q_ids = self.encode_text(question)[: max_len // 3]
        ids = [BOS_ID] + q_ids + [SEP_ID]
        if evidences:
            budget = max_len - len(ids) - len(evidences)  # SEP each
            per = max(8, budget // len(evidences))
            for ev in evidences:
                take = self.encode_text(ev)[:per]
                room = max_len - len(ids) - 1
                ids.extend(take[:room])
                ids.append(SEP_ID)
                if len(ids) >= max_len:
                    break
        return ids[:max_len]

    # -- decode -------------------------------------------------------------
    def decode(self, ids) -> str:
        """Ids -> prose. Stops at EOS; skips PAD/BOS/SEP/UNK; merges
        ``##`` continuations; tightens punctuation spacing."""
        words: list[str] = []
        for i in np.asarray(ids).reshape(-1).tolist():
            if i == EOS_ID:
                break
            if i in (PAD_ID, BOS_ID, SEP_ID, UNK_ID):
                continue
            piece = self._id2piece[i] if 0 <= i < self.vocab_size else ""
            if not piece:
                continue
            if piece.startswith("##") and words:
                words[-1] += piece[2:]
            else:
                words.append(piece.removeprefix("##"))
        out: list[str] = []
        for w in words:
            if out and not (w in _TIGHT_LEFT and len(w) == 1) \
                    and not (len(out[-1]) == 1 and out[-1] in _TIGHT_RIGHT):
                out.append(" ")
            out.append(w)
        text = "".join(out)
        return text[:1].upper() + text[1:] if text else text

    # -- persistence ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(self.vocab, separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "GenTokenizer":
        return cls(json.loads(s))
