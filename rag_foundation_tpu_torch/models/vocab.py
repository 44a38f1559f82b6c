"""WordPiece vocabulary training for the sentence encoder's tokenizer.

A copy of ``rag_foundation_tpu/models/vocab.py`` (no JAX in it; the port
keeps its own copy so that it imports nothing of the JAX package). A
standard BPE-style merge trainer producing a WordPiece-compatible vocab
(``##`` continuation prefix) that plugs straight into
``models.tokenizer.Tokenizer(vocab=...)``. Pure host-side tooling.
"""

from __future__ import annotations

import collections
import re

_WORD_RE = re.compile(r"[a-z0-9]+")
_RESERVED = ("[PAD]", "[CLS]", "[SEP]")


def train_wordpiece(
    texts: list[str],
    vocab_size: int = 8192,
    *,
    min_pair_count: int = 2,
) -> dict[str, int]:
    """Learn a WordPiece vocab by greedy pair merging (BPE objective).

    Returns ``token -> id`` with ids 0..2 reserved for PAD/CLS/SEP
    (matching models.tokenizer constants). Continuation pieces carry the
    ``##`` prefix.
    """
    # word frequencies
    word_freq: collections.Counter[str] = collections.Counter()
    for text in texts:
        word_freq.update(_WORD_RE.findall(text.lower()))

    # each word as a tuple of pieces: first char, then ##-continuations
    def initial_pieces(word: str) -> tuple[str, ...]:
        return (word[0],) + tuple(f"##{c}" for c in word[1:])

    words: dict[str, tuple[str, ...]] = {
        w: initial_pieces(w) for w in word_freq}
    vocab: dict[str, int] = {t: i for i, t in enumerate(_RESERVED)}
    for pieces in words.values():
        for piece in pieces:
            if piece not in vocab:
                vocab[piece] = len(vocab)

    while len(vocab) < vocab_size:
        pair_counts: collections.Counter[tuple[str, str]] = \
            collections.Counter()
        for word, pieces in words.items():
            freq = word_freq[word]
            for a, b in zip(pieces, pieces[1:]):
                pair_counts[(a, b)] += freq
        if not pair_counts:
            break
        (a, b), count = pair_counts.most_common(1)[0]
        if count < min_pair_count:
            break
        new_piece = a + b.removeprefix("##")
        if new_piece in vocab:
            # merging produced an existing token; still rewrite words so
            # the loop progresses
            pass
        else:
            vocab[new_piece] = len(vocab)
        for word, pieces in list(words.items()):
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
            words[word] = tuple(out)
    return vocab


def tokenize_wordpiece(word: str, vocab: dict[str, int],
                       max_pieces: int = 16) -> list[int] | None:
    """Greedy longest-match WordPiece encoding of one word; None when the
    word cannot be encoded (caller falls back to hashing)."""
    ids: list[int] = []
    i = 0
    first = True
    while i < len(word) and len(ids) < max_pieces:
        j = len(word)
        while j > i:
            piece = word[i:j] if first else f"##{word[i:j]}"
            pid = vocab.get(piece)
            if pid is not None:
                ids.append(pid)
                break
            j -= 1
        else:
            return None
        i = j
        first = False
    return ids if i == len(word) else None
