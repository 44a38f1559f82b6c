"""Hybrid lexical+semantic encoder: hash n-grams ⊕ trained MiniLM.

Counterpart of ``rag_foundation_tpu/models/hybrid_encoder.py``. The
output is the concatenation of the L2-normalized feature-hash embedding
(scaled by ``sqrt(1-w)``) and the L2-normalized MiniLM embedding (scaled
by ``sqrt(w)``), so the cosine of two hybrid vectors is EXACTLY the
convex blend

    cos_hybrid = (1-w)·cos_hash + w·cos_minilm.

One dense index serves both signals, and every index path (IVF, PQ,
int8) works unchanged because it only ever sees unit vectors. The hash
channel is the port's ``HashingEncoder``, native by default as in JAX.
"""

from __future__ import annotations

import numpy as np

from rag_foundation_tpu_torch.models.hash_encoder import HashingEncoder


class HybridEncoder:
    """``encode(list[str]) -> np.ndarray [n, hash_dim + mini_dim]``."""

    name = "hybrid-hash-minilm"

    def __init__(self, hash_dim: int, mini, *, w_mini: float = 0.35):
        if not 0.0 < w_mini < 1.0:
            raise ValueError("w_mini must be in (0, 1)")
        self.hash_enc = HashingEncoder(dim=hash_dim)
        self.mini = mini
        self.w_mini = w_mini
        self.dim = hash_dim + mini.dim

    def encode(self, texts: list[str]) -> np.ndarray:
        return self._encode(self.hash_enc.encode(texts), texts)

    def encode_queries(self, texts: list[str]) -> np.ndarray:
        """Query-side: the lexical channel drops stopwords (see
        HashingEncoder.encode_queries); the MiniLM channel keeps the
        full sentence (it was trained on natural prose)."""
        return self._encode(self.hash_enc.encode_queries(texts), texts)

    def _encode(self, h: np.ndarray, texts: list[str]) -> np.ndarray:
        h = h * np.float32(np.sqrt(1.0 - self.w_mini))
        m = self.mini.encode(texts) * np.float32(np.sqrt(self.w_mini))
        out = np.concatenate([h, m], axis=1)
        # a text with no [a-z0-9] runs (non-Latin scripts) zeroes the hash
        # channel; the renorm keeps the unit-vector contract in all cases
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-9)
