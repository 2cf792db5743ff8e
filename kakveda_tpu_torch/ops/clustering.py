"""Clustering of failure embeddings on the device.

Port of ``kakveda_tpu/ops/clustering.py``: connected components of the
union-kNN cosine graph. Each row keeps its k nearest rows; an edge exists
when either endpoint keeps the other and its exact cosine is ≥ threshold;
rows in one component share a label, its smallest member index. The three
tiers switch exactly as the reference switches them:

- **dense** (N ≤ ``_DENSE_MAX``): every row against every row, one
  ``_block_topk`` of the whole corpus.
- **exact sweep** (N ≤ ``_EXACT_SWEEP_MAX`` or d ≤ ``_MINE_DIM``): query
  blocks of ``_QBLOCK`` rows, each one streaming top-k over the corpus.
- **projection** (beyond): the same sweep over a fixed Gaussian projection
  to ``_MINE_DIM`` dims for candidates; every candidate edge is then
  re-scored at full dim (``_rescore_pairs``), so edge weights are exact.

Where the port differs from the reference, and why no output changes:

- ``_block_topk`` is ``torch.mm`` over column blocks of about 1 GB of f32
  scores plus ``torch.topk`` with the ties resolved explicitly: the exact
  top-k by (score descending, row ascending), which is what
  ``approx_max_k`` and ``lax.top_k`` return off the TPU. ``torch.topk``
  alone orders ties in no fixed way, and duplicated rows are routine in a
  GFKB (one signature under two failure types, repeated texts).
- No corpus padding. The reference pads the corpus to a power of two so
  that XLA compiles O(log N) programs; PyTorch compiles nothing, and the
  pad rows were invalid and dropped. The output width is still the
  reference's over its ``_BLOCK``-padded index (``_block_topk``).
- The dense tier's label propagation to a fixpoint becomes the host
  connected components of the same edge set: min-label propagation over a
  symmetric graph with self-edges converges to each component's smallest
  member, which is the components' min-member labelling.
- ``_project``'s default Gaussian is drawn by ``torch.Generator`` seeded 7,
  not by the reference's ``PRNGKey(7)`` stream; ``projection=`` takes the
  reference's matrix (``convert.mine_projection_from_jax``).

Precision on the card: the GFKB stores bf16 rows, which are exact in f32,
so the exact tiers multiply them as bf16 on the tensor cores with f32
accumulation — the reference's f32 products, summed in another order. The
projection and its sweep run in f32 (TF32 off), and the re-score sums f32
products. On the CPU everything is f32.

The tunable constants are module globals read at call time, so tests can
shrink them.
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from typing import Optional, Tuple

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from kakveda_tpu_torch.ops.device import resolve_device

_DENSE_MAX = 8192
_BLOCK = 1024
_QBLOCK = 4096  # query rows per sweep block
_EXACT_SWEEP_MAX = 1 << 17  # full-dim candidate sweep up to 131k rows
_MINE_DIM = 256  # projection dim for the candidate sweep beyond that
_KNN_K = 32
_SCORE_BLOCK_BYTES = 1 << 30  # f32 scores per column block of the streaming top-k
_RESCORE_CHUNK = 1 << 17  # candidate pairs per re-score gather


def _scores(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``q @ vᵀ`` in f32. bf16 operands multiply on the tensor cores with
    f32 accumulation; f32 operands (and anything on the CPU) in f32."""
    if q.device.type == "cpu" or (q.dtype == torch.float32 and v.dtype == torch.float32):
        return q.float() @ v.float().T
    return torch.mm(q, v.T, out_dtype=torch.float32)


def _exact_topk(s: torch.Tensor, kb: int, skip: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``kb`` of each row of ``s`` [Q, C] by (score descending, column
    ascending), leaving out the first ``skip`` columns (``kb ≤ C - skip``):
    values f32 and columns int64, [Q, kb]. ``torch.topk`` finds the kb-th
    score t exactly; the columns are then the ones above t (fewer than kb)
    followed by the lowest columns that score exactly t. Overwrites ``s``'s
    skipped columns; no host synchronization."""
    c = s.shape[1]
    s[:, :skip] = float("-inf")
    t = torch.topk(s, kb, dim=1).values[:, -1:]
    col = torch.arange(c, device=s.device, dtype=torch.int32)
    key = torch.where(s > t, col, torch.where(s == t, col + c, 2 * c))
    key[:, :skip] = 3 * c
    cols = (torch.topk(key, kb, dim=1, largest=False).values % c).long()
    vals = s.gather(1, cols)
    # cols run above-t in column order, then the ties in column order: a
    # stable descending sort by score keeps the columns ascending in a tie.
    vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
    return vals, cols.gather(1, order)


def _block_topk(q: torch.Tensor, v: torch.Tensor, valid: Optional[torch.Tensor], k: int) -> torch.Tensor:
    """Exact top-k of ``q @ vᵀ`` streamed over column blocks of at most
    ``_SCORE_BLOCK_BYTES`` of f32 scores, so [Q, N] never materializes.
    Rows with ``valid`` False score -inf (``valid=None``: all rows valid).

    Returns the packed [Q, 2k'] f32 buffer ``[values | row ids as f32]``
    (ids exact below 2^24). ``k' = min(k, nb·min(k, _BLOCK))`` with ``nb``
    the ``_BLOCK``s covering N: the reference's width over its padded
    index, whose pad rows appear here as (-inf, N), (-inf, N + 1), ...
    when N < k'."""
    qn, n = q.shape[0], v.shape[0]
    kw = min(k, -(-n // _BLOCK) * min(k, _BLOCK))
    width = min(n, max(1, _SCORE_BLOCK_BYTES // (4 * max(qn, 1))))
    best_v = best_i = None
    for c0 in range(0, n, width):
        # Every block is one product of the same shape: the last one ends at
        # N and skips the columns its predecessor covered. A narrower block
        # could take another product kernel that sums in another order, and
        # split an exact tie between a row there and its duplicate elsewhere.
        lo = min(c0, n - width)
        s = _scores(q, v[lo : lo + width])
        if valid is not None:
            s.masked_fill_(~valid[lo : lo + width], float("-inf"))
        bv, bi = _exact_topk(s, min(kw, n - c0, width), skip=c0 - lo)
        del s
        bi += lo
        if best_v is None:
            best_v, best_i = bv, bi
            continue
        # Earlier blocks hold lower rows: a stable sort of [best | block]
        # keeps the lower row first among equal scores.
        best_v, order = torch.sort(torch.cat([best_v, bv], 1), dim=1, descending=True, stable=True)
        best_v = best_v[:, :kw]
        best_i = torch.cat([best_i, bi], 1).gather(1, order[:, :kw])
    short = kw - best_v.shape[1]
    if short > 0:
        best_v = torch.cat([best_v, best_v.new_full((qn, short), float("-inf"))], 1)
        pad = torch.arange(n, n + short, device=q.device).expand(qn, short)
        best_i = torch.cat([best_i, pad], 1)
    return torch.cat([best_v, best_i.float()], 1)


def _rescore_pairs(v: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Exact full-dim cosine (f32) of candidate pairs (embeddings are
    unit-norm), in chunks that bound the two [chunk, d] f32 gathers."""
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=v.device)
    for s in range(0, rows.shape[0], _RESCORE_CHUNK):
        e = min(s + _RESCORE_CHUNK, rows.shape[0])
        out[s:e] = (v[rows[s:e]].float() * v[cols[s:e]].float()).sum(1)
    return out


def _project(v: torch.Tensor, out_dim: int, projection: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fixed Gaussian random projection [N, out_dim], re-normalized: it
    keeps cosine ranking well enough for CANDIDATES (edges are re-scored
    exactly afterwards). ``projection``: the [d, out_dim] Gaussian to use;
    by default drawn on the CPU from ``torch.Generator`` seeded 7."""
    if projection is None:
        projection = torch.randn((v.shape[1], out_dim), generator=torch.Generator().manual_seed(7))
    r = projection.to(v.device, torch.float32) / math.sqrt(out_dim)
    p = torch.empty((v.shape[0], out_dim), dtype=torch.float32, device=v.device)
    chunk = 1 << 16
    for s in range(0, v.shape[0], chunk):
        p[s : s + chunk] = v[s : s + chunk].float() @ r
    return p / p.norm(dim=1, keepdim=True).clamp_min(1e-12)


def _as_tensor(vecs, device) -> torch.Tensor:
    """[N, d] rows on their device (a tensor) or on ``device`` (numpy).
    bf16 stays bf16 on the card (its values are exact in f32); everything
    else is f32."""
    if isinstance(vecs, torch.Tensor):
        if vecs.dtype == torch.bfloat16 and vecs.device.type == "cuda":
            return vecs
        return vecs.float()
    return torch.from_numpy(np.ascontiguousarray(vecs, dtype=np.float32)).to(resolve_device(device))


@contextmanager
def _timed(stats: Optional[dict], name: str, device: torch.device):
    """Record a stage's wall in ``stats[name + "_ms"]``, the device
    synchronized on both sides, and on the card its CUDA-event time in
    ``stats[name + "_device_ms"]``. With ``stats=None``, nothing."""
    if stats is None:
        yield
        return
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
    t = time.perf_counter()
    yield
    if cuda:
        ev[1].record()
        torch.cuda.synchronize()
        stats[f"{name}_device_ms"] = ev[0].elapsed_time(ev[1])
    stats[f"{name}_ms"] = (time.perf_counter() - t) * 1e3


def _edges(v, kk, threshold, exact, projection, stats) -> Tuple[np.ndarray, np.ndarray]:
    """(rows, cols) int64 of the union-kNN candidate edges with cosine ≥
    threshold: self-edges and -inf scores dropped; candidates of the
    projected rows re-scored at full dim."""
    n = v.shape[0]
    with _timed(stats, "project", v.device):
        vc = v if exact else _project(v, _MINE_DIM, projection)
    with _timed(stats, "sweep", v.device):
        packed = torch.cat([_block_topk(vc[s : s + _QBLOCK], vc, None, kk) for s in range(0, n, _QBLOCK)])
    kk_eff = packed.shape[1] // 2  # ≤ kk when the index is tiny
    sims = packed[:, :kk_eff].reshape(-1)
    cols = packed[:, kk_eff:].long().reshape(-1)
    rows = torch.arange(n, device=v.device).repeat_interleave(kk_eff)
    keep = (cols != rows) & torch.isfinite(sims)
    rows, cols, sims = rows[keep], cols[keep], sims[keep]
    if stats is not None:
        stats["candidates"] = rows.shape[0]
    if not exact:
        with _timed(stats, "rescore", v.device):
            sims = _rescore_pairs(v, rows, cols)
    keep = sims >= threshold
    return rows[keep].cpu().numpy(), cols[keep].cpu().numpy()


def build_knn_edges(
    vecs, *, k: Optional[int] = None, threshold: float = 0.6, force_projection: bool = False,
    projection: Optional[torch.Tensor] = None, device=None, stats: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(rows, cols) of the symmetric-union kNN graph restricted to exact
    cosine ≥ threshold (k defaults to ``_KNN_K``). One blocked sweep;
    O(N·k) edges out.

    ``force_projection`` takes the projection tier below its natural
    ``_EXACT_SWEEP_MAX`` switch-over (the recall tests use it at small
    sizes). ``vecs``: a tensor (runs on its device) or numpy (runs on
    ``device``, the card by default). ``stats``: a dict that receives each
    stage's wall (see :func:`_timed`)."""
    v = _as_tensor(vecs, device)
    n, d = v.shape
    k = _KNN_K if k is None else k
    kk = min(k + 1, n)  # +1: each row's own top-1 is itself
    exact = (n <= _EXACT_SWEEP_MAX or d <= _MINE_DIM) and not (force_projection and d > _MINE_DIM)
    return _edges(v, kk, threshold, exact, projection, stats)


def _sparse_components(n: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Connected components over an edge list; labels = min member index."""
    g = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n))
    _, comp = connected_components(g, directed=False)
    mins = np.full(comp.max() + 1 if len(comp) else 0, np.iinfo(np.int64).max)
    np.minimum.at(mins, comp, np.arange(n))
    return mins[comp].astype(np.int32)


def cluster_embeddings(
    vecs, threshold: float = 0.6, *, knn_k: Optional[int] = None, force_projection: bool = False,
    projection: Optional[torch.Tensor] = None, device=None, stats: Optional[dict] = None,
) -> np.ndarray:
    """Connected-component labels for L2-normalized embeddings [N, d].

    Returns int32 labels [N]; rows in the same component share a label
    (the smallest member index). The dense tier uses the same graph family
    as the sweep — union-top-k edges above the threshold, not the raw
    threshold graph, which chains boilerplate-heavy corpora into one giant
    component — so the degree cap is part of the clustering's semantics at
    every size. Arguments as :func:`build_knn_edges`.
    """
    v = _as_tensor(vecs, device)
    n = v.shape[0]
    if n == 0:
        return np.zeros(0, np.int32)
    knn_k = _KNN_K if knn_k is None else knn_k
    if n <= _DENSE_MAX and not force_projection:
        rows, cols = _edges(v, min(knn_k + 1, n), threshold, True, None, stats)
    else:
        rows, cols = build_knn_edges(
            v, k=knn_k, threshold=threshold, force_projection=force_projection,
            projection=projection, stats=stats,
        )
    with _timed(stats, "components", v.device):
        labels = _sparse_components(n, rows, cols)
    if stats is not None:
        stats["edges"] = len(rows)
    return labels
