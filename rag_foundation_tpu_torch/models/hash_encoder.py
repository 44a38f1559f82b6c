"""Deterministic feature-hashing sentence encoder.

A dependency-free, fully deterministic embedder: word + character-n-gram
feature hashing (FNV-1a 64) into ``dim`` sign buckets, L2-normalized.
Lexically similar texts get high cosine similarity.

Counterpart of ``rag_foundation_tpu.models.hash_encoder``, with its two
paths:

- the native C++ hasher (``native/hasher.cpp`` through ``ctypes``), the
  default and the ingest hot path. Built with the JAX package's flags, it
  gives the JAX package's native vectors bit for bit;
- the pure-Python path (``use_native=False``, or no ``g++``), bit-equal
  to the JAX package's Python path. Its normalization differs from the
  native one in the last float32 ulp (equal within rtol 1e-6, not bit
  for bit), so anything tie-sensitive stays on one path.

The ``name`` is the JAX package's, so stores move between the packages.
"""

from __future__ import annotations

import ctypes
import re

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def _fnv1a(data: bytes, seed: int = 0) -> int:
    h = _FNV_OFFSET ^ seed
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


class HashingEncoder:
    """``encode(list[str]) -> np.ndarray [n, dim] f32`` (unit rows)."""

    name = "hash-fnv-v2"

    def __init__(self, dim: int = 384, ngram: int = 3, seed: int = 0,
                 use_native: bool = True):
        self.dim = dim
        self.ngram = ngram
        self.seed = seed
        self._lib = None
        if use_native:
            from rag_foundation_tpu_torch.native import load_hasher
            self._lib = load_hasher()

    def _encode_native(self, texts: list[str]) -> np.ndarray:
        blobs = [t.encode("utf-8", "ignore") for t in texts]
        lens = (ctypes.c_long * len(blobs))(*[len(b) for b in blobs])
        out = np.zeros((len(texts), self.dim), np.float32)
        self._lib.ragtpu_hash_encode(
            b"".join(blobs), lens, len(blobs),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.dim, self.ngram, ctypes.c_uint64(self.seed))
        return out

    def _encode_python(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        word_re = re.compile(rb"[a-z0-9]+")
        for i, text in enumerate(texts):
            # byte-level, ASCII-only lowercasing — exactly the C++ logic
            data = text.encode("utf-8", "ignore")
            lowered = bytes((b + 32) if 65 <= b <= 90 else b for b in data)
            words = word_re.findall(lowered)
            row = out[i]
            feats = list(words)
            if self.ngram > 0:  # match the C++ guard: ngram<=0 emits
                joined = b" ".join(words)  # no char-gram features
                feats.extend(
                    joined[j: j + self.ngram]
                    for j in range(max(0, len(joined) - self.ngram + 1)))
            for tok in feats:
                h = _fnv1a(tok, self.seed)
                sign = 1.0 if (h >> 63) else -1.0
                row[h % self.dim] += sign
            norm = float(np.linalg.norm(row))
            if norm > 0:
                row /= norm
        return out

    def encode(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        if self._lib is not None:
            return self._encode_native(texts)
        return self._encode_python(texts)

    def encode_queries(self, texts: list[str]) -> np.ndarray:
        """Query-side encode: function words stripped before hashing.

        Feature hashing weighs every word equally, so a verbose question
        ("Considering all of the projects described in the document,
        could you please tell me ...") buries its 3 content words under
        ~20 filler features and the answer chunk falls out of the top-k
        (measured live: a fact present verbatim in one chunk missed at
        top-5). Classic lexical retrieval drops stopwords at QUERY time
        only — document vectors are untouched, so existing stores stay
        compatible and concise queries are nearly unchanged.
        """
        return self.encode([filter_query_terms(t) for t in texts])


# Function words + question/politeness boilerplate. Deliberately
# conservative: no nouns/verbs that could carry meaning in a domain
# ("document", "name", "list" stay — "which document names X" needs
# them). Lowercase [a-z0-9]+ tokens only, matching the hasher's
# tokenization.
_QUERY_STOPWORDS = frozenset("""
a an the is are was were be been being am do does did doing have has
had having what which who whom whose when where why how could would
should can may might must shall will i you he she it we they me him
her us them my your his her its our their this that these those of in
on at by for with about against between into through during before
after above below to from up down out off over under again further
then once here there and or but if because as until while not no nor
only own same such so than too very just also please kindly tell me
precisely exactly considering regarding concerning many all any both
each few more most some s t d ll re ve
""".split())


def filter_query_terms(text: str, min_keep: int = 3,
                       min_words: int = 9) -> str:
    """Strip stopwords from a VERBOSE query; concise queries pass
    through unchanged.

    The gate (``min_words``) exists because short questions are already
    mostly content ("What altitude is the summit at?" has nothing to
    spare — filtering it measurably shifted one quality-bench answer),
    while dilution only bites when filler outnumbers content. Falls
    back to the original text when fewer than ``min_keep`` content
    words survive."""
    words = re.findall(r"[a-zA-Z0-9]+", text)
    if len(words) < min_words:
        return text
    kept = [w for w in words if w.lower() not in _QUERY_STOPWORDS]
    if len(kept) < min_keep:
        return text
    return " ".join(kept)
