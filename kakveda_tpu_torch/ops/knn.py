"""Cosine top-k over a device-resident ``[capacity, dim]`` embedding matrix.

Single-device counterpart of ``kakveda_tpu/ops/knn.py::ShardedKnn`` (the
row-sharded version comes with the multi-device slice):

    q = densify(idx, val)               scatter-add, pad features dropped
    scores, rows = fused_topk(emb, valid, q, k)   the CUDA kernel on the card
    packed = [scores | rows as f32]     one [B, 2k] buffer, one fetch

``Knn`` owns no state: callers (``index/gfkb.py``) hold the ``(emb, valid,
types)`` tensors and pass them in. Where the JAX package donates buffers and
returns new ones, the port updates them in place and returns the same
tensors. On one device a logical slot is its physical row.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from kakveda_tpu_torch.ops.device import resolve_device, store_dtype
from kakveda_tpu_torch.ops.fused_topk import fused_topk

# Row ids ride the packed f32 buffer: exact up to 2^24.
MAX_CAPACITY = 1 << 24


class Knn:
    """Insert + cosine top-k over one ``[capacity, dim]`` index tensor."""

    def __init__(
        self,
        capacity: int,
        dim: int,
        k: int = 5,
        device: str | torch.device | None = None,
    ):
        if capacity > MAX_CAPACITY:
            raise ValueError(
                f"capacity {capacity} exceeds 2^24: packed f32 row indices "
                "would lose precision"
            )
        self.device = resolve_device(device)
        self.capacity = capacity
        self.dim = dim
        self.k = k
        self.store_dtype = store_dtype(self.device)

    # --- allocation ------------------------------------------------------

    def alloc(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fresh zeroed (embeddings, valid) tensors on the device."""
        emb = torch.zeros((self.capacity, self.dim), dtype=self.store_dtype, device=self.device)
        valid = torch.zeros((self.capacity,), dtype=torch.bool, device=self.device)
        return emb, valid

    def alloc_i32(self) -> torch.Tensor:
        """Fresh per-slot int32 side-table (-1 = unset)."""
        return torch.full((self.capacity,), -1, dtype=torch.int32, device=self.device)

    def _rows(self, slots) -> torch.Tensor:
        """Logical slots → physical rows on the device (identity on one device)."""
        return torch.as_tensor(np.asarray(slots, dtype=np.int64), device=self.device)

    def scatter_i32(self, arr: torch.Tensor, slots, values) -> torch.Tensor:
        """Write int32 ``values`` at ``slots`` in place (rows ≥ capacity dropped)."""
        rows = self._rows(slots)
        vals = torch.as_tensor(np.asarray(values, dtype=np.int32), device=self.device)
        keep = rows < self.capacity
        arr[rows[keep]] = vals[keep]
        return arr

    def mask_valid(self, valid: torch.Tensor, types: torch.Tensor, type_id: int) -> torch.Tensor:
        """valid AND (types == type_id): the type pre-selection mask."""
        return valid & (types == type_id)

    # --- insert ----------------------------------------------------------

    def densify(self, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
        """[B, K] (bucket, weight) pairs → dense [B, dim] f32 rows by a
        scatter-add (duplicate buckets accumulate); ``idx ≥ dim`` is dropped."""
        b = idx.shape[0]
        out = torch.zeros((b, self.dim + 1), dtype=torch.float32, device=idx.device)
        out.scatter_add_(1, idx.long().clamp(0, self.dim), val.float())
        return out[:, : self.dim]

    def _write(self, emb, valid, types, rows: torch.Tensor, vecs: torch.Tensor, tids=None):
        keep = rows < self.capacity  # pad rows carry capacity → dropped
        rows = rows[keep]
        emb[rows] = vecs[keep].to(emb.dtype)
        valid[rows] = True
        if types is not None:
            types[rows] = tids[keep]

    def insert(self, emb: torch.Tensor, valid: torch.Tensor, vecs, slots):
        """Write dense rows at logical ``slots`` in place."""
        vecs_d = torch.as_tensor(np.asarray(vecs, dtype=np.float32), device=self.device)
        self._write(emb, valid, None, self._rows(slots), vecs_d)
        return emb, valid

    def insert_sparse(self, emb, valid, types, idx, val, slots, tids):
        """Sparse-row insert: ship (idx, val) pairs, densify on the device,
        write rows, validity and type ids in place. Pad features carry
        ``idx == dim``, pad rows ``slot == capacity``; both are dropped."""
        idx_d = torch.as_tensor(np.ascontiguousarray(idx, dtype=np.int32), device=self.device)
        val_d = torch.as_tensor(np.ascontiguousarray(val, dtype=np.float32), device=self.device)
        tids_d = torch.as_tensor(np.asarray(tids, dtype=np.int32), device=self.device)
        self._write(emb, valid, types, self._rows(slots), self.densify(idx_d, val_d), tids_d)
        return emb, valid, types

    def gather_slots(self, emb: torch.Tensor, slots) -> np.ndarray:
        """Host f32 copy of the rows for logical ``slots``, chunked."""
        rows = np.asarray(slots, dtype=np.int64)
        out = np.empty((len(rows), self.dim), dtype=np.float32)
        chunk = 1 << 16
        for i in range(0, len(rows), chunk):
            out[i : i + chunk] = emb[self._rows(rows[i : i + chunk])].float().cpu().numpy()
        return out

    # --- match -----------------------------------------------------------

    def _topk_packed(self, emb, valid, q: torch.Tensor) -> torch.Tensor:
        vals, rows = fused_topk(emb, valid, q, self.k)
        return torch.cat([vals, rows.float()], dim=1)

    def topk_async_sparse(self, emb, valid, idx: np.ndarray, val: np.ndarray) -> torch.Tensor:
        """Sparse-query dispatch: the batch pads to a power-of-two bucket
        (pad rows carry ``idx == dim``), densifies on the device and runs the
        same top-k. Result rows past the caller's batch belong to pad rows
        (an all-zero query), so callers slice to their batch size."""
        b = idx.shape[0]
        bb = batch_bucket(max(b, 1))
        if b != bb:
            pad_i = np.full((bb, idx.shape[1]), self.dim, np.int32)
            pad_v = np.zeros((bb, val.shape[1]), np.float32)
            pad_i[:b] = idx
            pad_v[:b] = val
            idx, val = pad_i, pad_v
        idx_d = torch.as_tensor(np.ascontiguousarray(idx, dtype=np.int32), device=self.device)
        val_d = torch.as_tensor(np.ascontiguousarray(val, dtype=np.float32), device=self.device)
        return self._topk_packed(emb, valid, self.densify(idx_d, val_d))

    def topk_result(self, packed: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """(scores, logical slots) from a packed buffer (one device→host copy)."""
        host = packed.cpu().numpy()
        kk = host.shape[1] // 2
        return host[:, :kk], host[:, kk:].astype(np.int64)


def pow2_bucket(n: int, *, floor: int = 1, cap: int | None = None) -> int:
    """Smallest power of two ≥ ``n`` starting from ``floor``, clamped to ``cap``."""
    b = floor
    while b < n:
        b <<= 1
    return b if cap is None else min(b, cap)


@functools.lru_cache(maxsize=8)
def batch_bucket(b: int) -> int:
    """Query batches pad to power-of-two buckets."""
    return pow2_bucket(b)
