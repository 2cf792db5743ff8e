"""Fused cosine score + streaming top-k: the GFKB match kernel.

Replaces the Pallas TPU kernel ``kakveda_tpu/ops/pallas_knn.py::fused_topk``
(body ``_tile_kernel``). On the card it launches the hand-written CUDA
kernel in ``kakveda_tpu_torch/csrc/fused_topk.cu`` (built by ``nvcc`` for
``sm_90a`` at first use); on a CPU tensor it runs the plain PyTorch version
:func:`fused_topk_reference`, which is also the kernel's oracle on the card.

What both compute, exactly as the Pallas kernel does:

* ``scores = q·embᵀ`` from ``q`` cast to the index dtype, accumulated in f32;
* rows with ``valid == False`` score ``-2.0`` and stay selectable with their
  real row id;
* per tile of ``row_tile`` rows, ``k`` rounds of "max, lowest column on ties,
  overwrite it with -2.0" (a tile with fewer than ``k`` rows above -2.0 thus
  repeats its lowest -2.0 column), pad lanes ``k..7`` carry ``(-2.0, 0)``;
* a stable merge of the ``[B, n_tiles·8]`` candidates: highest score first,
  lowest candidate position on ties (``lax.top_k``'s rule).

Rows past the end of a ragged last tile do not exist (never selected); the
Pallas kernel required ``rows % row_tile == 0`` instead.

Bound on an H100 at the main-path shape (2^20 rows × 2048, bf16, B = 64):
4.29 GB of index read once → 1.28 ms at 3.35 TB/s; 275 GFLOP → 0.28 ms at
989 TFLOP/s bf16. Bytes bound it, provided the product runs on the tensor
cores, which the kernel does (wmma bf16, f32 accumulation).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from kakveda_tpu_torch.ops import _build

NEG = -2.0  # sentinel below any reachable cosine score
KPAD = 8  # candidate lanes per tile: k <= KPAD
ROW_TILE = 1024  # the CUDA kernel's tile (the Pallas kernel's DEFAULT_ROW_TILE)


def fused_topk_reference(
    emb: torch.Tensor,
    valid: torch.Tensor,
    q: torch.Tensor,
    k: int,
    row_tile: int = ROW_TILE,
    chunk_tiles: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (scores [B, k] f32, row ids [B, k] i32).

    An f32 product of the dtype-rounded inputs, chunked over ``chunk_tiles``
    tiles of rows so no ``[B, rows]`` score matrix is ever whole, then the
    per-tile iterative top-k and a stable merge."""
    if not 1 <= k <= KPAD:
        raise ValueError(f"k={k} not in [1, {KPAD}]")
    rows, dim = emb.shape
    b = q.shape[0]
    qf = q.to(emb.dtype).float()
    n_tiles = -(-rows // row_tile)
    col = torch.arange(row_tile, device=emb.device)
    cand_v, cand_i = [], []
    for t0 in range(0, n_tiles, chunk_tiles):
        t1 = min(n_tiles, t0 + chunk_tiles)
        r0, r1 = t0 * row_tile, min(rows, t1 * row_tile)
        s = qf @ emb[r0:r1].float().T
        s = torch.where(valid[r0:r1].bool()[None, :], s, torch.full_like(s, NEG))
        pad = (t1 - t0) * row_tile - (r1 - r0)
        if pad:
            s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
        s = s.view(b, t1 - t0, row_tile)
        base = (torch.arange(t0, t1, device=emb.device) * row_tile)[None, :, None]
        vs, ids = [], []
        for _ in range(k):
            m = s.max(dim=-1, keepdim=True).values
            first = torch.where(s >= m, col, row_tile).min(dim=-1, keepdim=True).values
            vs.append(m)
            ids.append(first + base)
            s = s.masked_fill(col == first, NEG)
        vs.append(torch.full((b, t1 - t0, KPAD - k), NEG, device=emb.device))
        ids.append(torch.zeros((b, t1 - t0, KPAD - k), dtype=torch.long, device=emb.device))
        cand_v.append(torch.cat(vs, dim=-1))
        cand_i.append(torch.cat(ids, dim=-1))
    flat_v = torch.cat(cand_v, dim=1).reshape(b, n_tiles * KPAD)
    flat_i = torch.cat(cand_i, dim=1).reshape(b, n_tiles * KPAD)
    order = torch.sort(flat_v, dim=1, descending=True, stable=True).indices[:, :k]
    return (
        torch.gather(flat_v, 1, order).float(),
        torch.gather(flat_i, 1, order).to(torch.int32),
    )


def _lib():
    lib = _build.load("fused_topk")
    fn = lib.kkv_fused_topk
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def fused_topk(
    emb: torch.Tensor, valid: torch.Tensor, q: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (scores [B, k] f32, row ids [B, k] i32) of ``q @ embᵀ``.

    ``emb [rows, dim]`` is the index (bf16 on the card), ``valid [rows]``
    bool occupancy, ``q [B, dim]`` float queries. A CPU tensor takes
    :func:`fused_topk_reference`; a CUDA tensor launches the kernel or
    raises. ``fused_topk.launches`` counts kernel launches."""
    if emb.device.type == "cpu":
        return fused_topk_reference(emb, valid, q, k)
    if emb.device.type != "cuda":
        raise ValueError(f"fused_topk: unsupported device {emb.device}")
    rows, dim = emb.shape
    b = q.shape[0]
    if emb.dtype != torch.bfloat16 or not emb.is_contiguous():
        raise ValueError("fused_topk: emb must be a contiguous bf16 [rows, dim] tensor")
    if valid.shape != (rows,) or valid.dtype != torch.bool or not valid.is_contiguous():
        raise ValueError("fused_topk: valid must be a contiguous bool [rows] tensor")
    if q.dim() != 2 or q.shape[1] != dim or not q.is_floating_point():
        raise ValueError(f"fused_topk: q must be float [B, {dim}], got {tuple(q.shape)}")
    if valid.device != emb.device or q.device != emb.device:
        raise ValueError("fused_topk: emb, valid and q must be on one device")
    if not 1 <= k <= KPAD:
        raise ValueError(f"k={k} not in [1, {KPAD}]")
    if dim % 64 or rows < 1 or rows > (1 << 24) or emb.data_ptr() % 32:
        raise ValueError(f"fused_topk: unsupported layout rows={rows} dim={dim}")
    out_v = torch.empty((b, k), dtype=torch.float32, device=emb.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=emb.device)
    if b == 0:
        return out_v, out_i
    # The kernel's query block: 16 queries for small batches, else 64.
    bpad = 16 if b <= 16 else -(-b // 64) * 64
    qb = torch.zeros((bpad, dim), dtype=torch.bfloat16, device=emb.device)
    qb[:b] = q
    n_tiles = -(-rows // ROW_TILE)
    cand_v = torch.empty((n_tiles, bpad, KPAD), dtype=torch.float32, device=emb.device)
    cand_i = torch.empty((n_tiles, bpad, KPAD), dtype=torch.int32, device=emb.device)
    fn = _lib()
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        rc = fn(
            emb.data_ptr(), valid.data_ptr(), qb.data_ptr(), rows, dim, bpad, b, k,
            cand_v.data_ptr(), cand_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_topk kernel launch failed: cudaError {rc}")
    fused_topk.launches += 1
    return out_v, out_i


fused_topk.launches = 0
