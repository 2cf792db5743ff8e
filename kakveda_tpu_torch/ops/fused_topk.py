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
cores, which the kernel does (``wgmma`` bf16, f32 accumulation).

The kernel's schedule: one persistent block per SM (``cta_count``) walks a
contiguous range of tiles (``cta_tile_ranges``) and keeps a stable running
top-k of the candidates its tiles emit, so it writes only ``KPAD`` of them
per query; a second kernel merges those ``[B, n_cta·KPAD]`` stably. That is
exact because the ranges are contiguous and in tile order: a candidate left
out of its range's top-k has k better ones before it in the same range.
:func:`fused_topk_schedule_reference` is the schedule's plain version; the
layout helpers below are plain Python so that the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from kakveda_tpu_torch.ops import _build

NEG = -2.0  # sentinel below any reachable cosine score
KPAD = 8  # candidate lanes per tile: k <= KPAD
ROW_TILE = 1024  # the CUDA kernel's tile (the Pallas kernel's DEFAULT_ROW_TILE)
QGROUP = 64  # queries per block: the widest wgmma N the kernel uses


def query_pad(b: int) -> int:
    """Queries the kernel runs for a batch of ``b``: the wgmma width N ∈
    {8, 16, 32, 64} for b ≤ 64, else groups of 64."""
    if b < 1:
        raise ValueError(f"batch {b} < 1")
    if b > QGROUP:
        return -(-b // QGROUP) * QGROUP
    n = 8
    while n < b:
        n <<= 1
    return n


def cta_count(n_tiles: int, n_sm: int) -> int:
    """Blocks of the persistent grid (per query group): one per SM, none
    without a tile."""
    return max(1, min(n_sm, n_tiles))


def cta_tile_ranges(n_tiles: int, n_cta: int) -> List[Tuple[int, int]]:
    """Block c's contiguous tiles ``[start, stop)``: in tile order, sizes
    differing by at most 1 (the larger ones first); blocks past ``n_tiles``
    get empty ranges."""
    base, rem = divmod(n_tiles, n_cta)
    out = []
    for c in range(n_cta):
        start = c * base + min(c, rem)
        out.append((start, start + base + (c < rem)))
    return out


def workspace_shape(b: int, rows: int, n_sm: int) -> Tuple[int, int, int]:
    """The candidate buffer the kernel writes: ``[query_pad(b), n_cta, KPAD]``
    (query-major, so the merge reads each query's candidates in a row)."""
    return query_pad(b), cta_count(-(-rows // ROW_TILE), n_sm), KPAD


def _tile_candidates(emb, valid, q, k, row_tile, chunk_tiles):
    """The per-tile rule's ``[B, n_tiles·KPAD]`` candidates (scores, row ids
    as int64), in tile order."""
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
    return flat_v, flat_i


def _stable_topk(v, i, k):
    """Highest score first, lowest position on ties (``lax.top_k``'s rule)."""
    order = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(v, 1, order), torch.gather(i, 1, order)


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
    flat_v, flat_i = _tile_candidates(emb, valid, q, k, row_tile, chunk_tiles)
    v, i = _stable_topk(flat_v, flat_i, k)
    return v.float(), i.to(torch.int32)


def fused_topk_schedule_reference(
    emb: torch.Tensor,
    valid: torch.Tensor,
    q: torch.Tensor,
    k: int,
    n_cta: int,
    row_tile: int = ROW_TILE,
    chunk_tiles: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's schedule in plain PyTorch: per-tile candidates, a stable
    top-k over each block's contiguous tile range (``cta_tile_ranges`` over
    ``n_cta`` blocks; a block without tiles emits nothing), its KPAD lanes
    padded with (-inf, 0) as the kernel writes them, then the final stable
    merge over the blocks' candidates. Equal to :func:`fused_topk_reference`
    bit for bit."""
    flat_v, flat_i = _tile_candidates(emb, valid, q, k, row_tile, chunk_tiles)
    b = q.shape[0]
    parts_v, parts_i = [], []
    for start, stop in cta_tile_ranges(flat_v.shape[1] // KPAD, n_cta):
        if start == stop:
            continue
        v, i = _stable_topk(flat_v[:, start * KPAD : stop * KPAD], flat_i[:, start * KPAD : stop * KPAD], k)
        parts_v += [v, torch.full((b, KPAD - k), float("-inf"), device=emb.device)]
        parts_i += [i, torch.zeros((b, KPAD - k), dtype=i.dtype, device=emb.device)]
    v, i = _stable_topk(torch.cat(parts_v, dim=1), torch.cat(parts_i, dim=1), k)
    return v.float(), i.to(torch.int32)


def _lib():
    lib = _build.load("fused_topk")
    fn = lib.kkv_fused_topk
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, p, p, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if dim % 64 or rows < 1 or rows > (1 << 24) or emb.data_ptr() % 16:
        raise ValueError(f"fused_topk: unsupported layout rows={rows} dim={dim}")
    out_v = torch.empty((b, k), dtype=torch.float32, device=emb.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=emb.device)
    if b == 0:
        return out_v, out_i
    n_sm = _sm_count(emb.device.index)
    shape = workspace_shape(b, rows, n_sm)
    bpad = shape[0]
    qb = torch.zeros((bpad, dim), dtype=torch.bfloat16, device=emb.device)
    qb[:b] = q
    cand_v = torch.empty(shape, dtype=torch.float32, device=emb.device)
    cand_i = torch.empty(shape, dtype=torch.int32, device=emb.device)
    fn = _lib()
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        rc = fn(
            emb.data_ptr(), valid.data_ptr(), qb.data_ptr(), rows, dim, bpad, b, k, n_sm,
            cand_v.data_ptr(), cand_i.data_ptr(), cand_v.numel(), out_v.data_ptr(), out_i.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_topk kernel launch failed: cudaError {rc}")
    fused_topk.launches += 1
    return out_v, out_i


fused_topk.launches = 0
