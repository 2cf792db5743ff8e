"""Hashed n-gram text featurizer — fixed-dimension failure embeddings.

Port of ``kakveda_tpu/ops/featurizer.py``: signed feature hashing (crc32)
of word uni+bigrams into ``dim`` buckets, with field-aware weights for the
segments of a ``signature_text``, rows L2-normalized.

Two paths, as in the reference. ASCII batches go through the C++ encoder
(``kakveda_tpu_torch/native``, a copy of the reference's library built with
the same flags), whose output equals the JAX package's native encoder bit
for bit. A batch holding any non-ASCII string, or a process without the
library (``KAKVEDA_NATIVE=0``), takes the pure-Python path. The two paths
are not bit-identical, in the reference either: the C++ L2 norm sums in
double and Python's in float32, so a row may differ by an ulp or so
(≤ 1e-7). Buckets, signs and sparse widths are the same on both, so an
index built by either package matches queries embedded by the other.

Host code: the vectors are numpy arrays, moved to the device by the index.
"""

from __future__ import annotations

import ctypes
import re
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kakveda_tpu_torch import native

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

    def _native_spec(self) -> str:
        """Field specs serialized for the C++ encoder ("name,weight,atomic;…")."""
        return ";".join(
            f"{name},{weight!r},{1 if atomic else 0}"
            for name, (weight, atomic) in self.field_specs.items()
        )

    @staticmethod
    def _native_for(texts: Sequence[str]):
        """The library when this batch may take it (every text ASCII), else None."""
        lib = native.load()
        if lib is not None and all(isinstance(t, str) and t.isascii() for t in texts):
            return lib
        return None

    def encode(self, text: str) -> np.ndarray:
        """One L2-normalized float32 vector of shape [dim]."""
        return self.encode_batch([text])[0]

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        """[B, dim] float32, rows L2-normalized (zero row for empty text).
        ASCII batches take the C++ encoder when it is available; non-ASCII
        strings take Python, where unicode lowercasing is defined."""
        lib = self._native_for(texts)
        if lib is not None:
            out = self._encode_batch_native(lib, texts)
            if out is not None:
                return out
        return self._encode_batch_py(texts)

    def _encode_batch_native(self, lib, texts: Sequence[str]) -> Optional[np.ndarray]:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        arr = (ctypes.c_char_p * len(texts))(*[t.encode("ascii") for t in texts])
        rc = lib.kkv_encode_batch(
            arr,
            len(texts),
            self.dim,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._native_spec().encode("ascii"),
        )
        return out if rc == 0 else None

    def _encode_batch_py(self, texts: Sequence[str]) -> np.ndarray:
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
        drop sentinel of the device densify) and ``val = 0``. The C++
        encoder emits the pairs directly; the Python path densifies, then
        sparsifies."""
        lib = self._native_for(texts)
        if lib is not None:
            out = self._encode_sparse_native(lib, texts)
            if out is not None:
                return out
        return dense_rows_to_sparse(self._encode_batch_py(texts), self.dim)

    def _encode_sparse_native(self, lib, texts: Sequence[str]) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        b = len(texts)
        arr = (ctypes.c_char_p * b)(*[t.encode("ascii") for t in texts])
        spec = self._native_spec().encode("ascii")
        k = 64
        while True:
            idx = np.full((b, k), self.dim, dtype=np.int32)
            val = np.zeros((b, k), dtype=np.float32)
            rc = lib.kkv_encode_sparse_batch(
                arr,
                b,
                self.dim,
                k,
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                val.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                spec,
            )
            if rc == 0:
                return idx, val
            if rc < 0:
                return None  # bad layout; the caller falls back to Python
            while k < rc:  # rc = the K the widest row needs; re-encode with room
                k <<= 1


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
