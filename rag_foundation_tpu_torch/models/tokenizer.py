"""Deterministic hashing subword tokenizer for the sentence encoder.

A copy of ``rag_foundation_tpu/models/tokenizer.py`` (no JAX in it; the
port keeps its own copy): words and sub-word pieces map to stable hash
buckets, fully deterministic, language-agnostic, zero files. A learned
WordPiece vocab can be dropped in via ``Tokenizer(vocab=...)``. Its ids
equal the JAX package's bit for bit (``tests/test_torch_tokenizer.py``),
and checkpoints record ``TOKENIZER_VERSION`` so that both packages refuse
a model trained under another tokenization.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
_RESERVED = 3

# bump when tokenization changes (v2: inflection-suffix splitting).
# Checkpoints record this so a model trained under one tokenization is
# never silently paired with another (embeddings live in incompatible
# spaces — retrieval would degrade without any error).
TOKENIZER_VERSION = 2


def _hash_token(token: str, vocab_size: int) -> int:
    h = hashlib.blake2b(token.encode(), digest_size=4).digest()
    return _RESERVED + int.from_bytes(h, "little") % (vocab_size - _RESERVED)


class Tokenizer:
    def __init__(self, vocab_size: int = 30_522,
                 max_word_len: int = 12,
                 vocab: dict[str, int] | None = None):
        self.vocab_size = vocab_size
        self.max_word_len = max_word_len
        if vocab:
            # a learned id past the embedding table would fail the
            # embedding lookup mid-encode (JAX would silently CLAMP it,
            # collapsing thousands of tokens onto one row)
            top = max(vocab.values())
            if top >= vocab_size:
                raise ValueError(
                    f"vocab ids reach {top} but the embedding table "
                    f"holds {vocab_size} rows")
        self.vocab = vocab  # optional real WordPiece vocab

    # deterministic suffix splits: inflections share their stem id, so a
    # query's "slew" matches a passage's "slews" at the embedding layer —
    # essential for a from-scratch encoder with a hashed vocab (there is
    # no pretrained subword statistics to recover morphology from)
    _SUFFIXES = ("ing", "tion", "ment", "ed", "es", "ly", "er", "s")

    def _word_ids(self, word: str) -> list[int]:
        if self.vocab is not None:
            from rag_foundation_tpu_torch.models.vocab import \
                tokenize_wordpiece
            ids = tokenize_wordpiece(word, self.vocab)
            if ids is not None:
                return ids
            # unknown word under the learned vocab -> hashing fallback
        for suf in self._SUFFIXES:
            if len(word) > len(suf) + 3 and word.endswith(suf):
                stem = word[: len(word) - len(suf)]
                if len(stem) <= self.max_word_len:
                    return [_hash_token(stem, self.vocab_size),
                            _hash_token("##" + suf, self.vocab_size)]
                break
        if len(word) <= self.max_word_len:
            return [_hash_token(word, self.vocab_size)]
        # split long words into pieces so rare compounds share subwords
        pieces = [word[i : i + self.max_word_len]
                  for i in range(0, len(word), self.max_word_len)]
        return [_hash_token(("##" if i else "") + p, self.vocab_size)
                for i, p in enumerate(pieces)]

    def encode(self, text: str, max_len: int = 128) -> np.ndarray:
        """``[max_len] int32`` ids: [CLS] tokens... [SEP] PAD...."""
        ids = [CLS_ID]
        for w in _WORD_RE.findall(text.lower()):
            ids.extend(self._word_ids(w))
            if len(ids) >= max_len - 1:
                break
        ids = ids[: max_len - 1] + [SEP_ID]
        out = np.full((max_len,), PAD_ID, np.int32)
        out[: len(ids)] = ids
        return out

    def encode_batch(self, texts: list[str], max_len: int = 128) -> np.ndarray:
        return np.stack([self.encode(t, max_len) for t in texts])
