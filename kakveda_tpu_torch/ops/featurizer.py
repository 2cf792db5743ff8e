"""Hashed n-gram text featurizer — fixed-dimension failure embeddings.

Port of ``kakveda_tpu/ops/featurizer.py`` (pure-Python path): signed
feature hashing (crc32) of word uni+bigrams into ``dim`` buckets, with
field-aware weights for the segments of a ``signature_text``, rows
L2-normalized. The output is identical to the JAX package's, so an index
built by either package matches queries embedded by the other. The C++
encoder the JAX package can use is a host-side speed-up with the same
output; the port runs the Python path only.

Host code: the vectors are numpy arrays, moved to the device by the index.
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9_]+")

# Signature fields, in `signature_text` order: (weight boost, atomic). Atomic
# fields contribute whole comma-separated items as single features.
_FIELD_SPECS: Dict[str, Tuple[float, bool]] = {
    "intent_tags": (3.0, True),
    "prompt_hint": (1.0, False),
    "tools": (1.0, True),
    "env_keys": (0.25, True),
}

_FIELD_SPLIT = " | "


def _terms(text: str) -> List[str]:
    """Word unigrams + adjacent bigrams of the lowercased text."""
    words = _TOKEN_RE.findall(text.lower())
    grams = list(words)
    grams.extend(f"{a} {b}" for a, b in zip(words, words[1:]))
    return grams


def _hash_term(term: str) -> Tuple[int, float]:
    """Stable (bucket, sign) for a term via crc32."""
    h = zlib.crc32(term.encode("utf-8"))
    sign = 1.0 if (h >> 31) & 1 == 0 else -1.0
    return h & 0x7FFFFFFF, sign


class HashedNGramFeaturizer:
    """Signed feature hashing of word 1-2 grams into a fixed power-of-two dim."""

    def __init__(
        self,
        dim: int = 2048,
        field_specs: Dict[str, Tuple[float, bool]] | None = None,
    ):
        if dim & (dim - 1) != 0:
            raise ValueError(f"dim must be a power of two, got {dim}")
        self.dim = dim
        self.field_specs = dict(field_specs or _FIELD_SPECS)

    def _weighted_terms(self, text: str) -> List[Tuple[str, float]]:
        """(term, weight) features for one text: field labels are stripped,
        atomic fields emit each comma-separated item as one feature, free
        text falls back to word n-grams at weight 1.0."""
        feats: List[Tuple[str, float]] = []
        for seg in text.split(_FIELD_SPLIT):
            name, sep, rest = seg.partition(":")
            spec = self.field_specs.get(name.strip().lower()) if sep else None
            if spec is None:
                feats.extend((t, 1.0) for t in _terms(seg))
                continue
            weight, atomic = spec
            if atomic:
                for item in rest.split(","):
                    item = item.strip().lower()
                    if item:
                        feats.append((f"{name}={item}", weight))
            else:
                feats.extend((t, weight) for t in _terms(rest))
        return feats

    def encode(self, text: str) -> np.ndarray:
        """One L2-normalized float32 vector of shape [dim]."""
        return self.encode_batch([text])[0]

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        """[B, dim] float32, rows L2-normalized (zero row for empty text)."""
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        mask = self.dim - 1
        for i, text in enumerate(texts):
            row = out[i]
            for term, w in self._weighted_terms(text):
                h, sign = _hash_term(term)
                row[h & mask] += sign * w
            n = float(np.linalg.norm(row))
            if n > 0.0:
                row /= n
        return out

    def encode_batch_sparse(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Sparse form of :meth:`encode_batch`: ``(idx [B,K] int32, val [B,K]
        f32)``, rows padded to a power-of-two K ≥ 64 with ``idx = dim`` (the
        drop sentinel of the device densify) and ``val = 0``."""
        return dense_rows_to_sparse(self.encode_batch(texts), self.dim)


def dense_rows_to_sparse(dense: np.ndarray, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sparsify dense rows into the (idx [B,K], val [B,K]) pair the device
    scatter consumes (pad idx = dim; K = a power of two ≥ max(64, row nnz))."""
    b = dense.shape[0]
    rows, cols = np.nonzero(dense)
    counts = np.bincount(rows, minlength=b)
    kmax = int(counts.max()) if b else 0
    k = 64
    while k < kmax:
        k <<= 1
    idx = np.full((b, k), dim, dtype=np.int32)
    val = np.zeros((b, k), dtype=np.float32)
    # nonzero() walks row-major: a pair's offset within its row is its rank.
    offs = np.arange(len(rows)) - np.concatenate(([0], np.cumsum(counts)))[rows]
    idx[rows, offs] = cols
    val[rows, offs] = dense[rows, cols]
    return idx, val
