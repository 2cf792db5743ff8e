"""Incremental streaming cluster state for pattern mining.

Port of ``kakveda_tpu/ops/incremental.py``. ``ops/clustering.py`` answers
"what are the clusters?" with one O(N²·d) sweep of the whole corpus; this
module makes clustering pay for the delta:

* :func:`delta_topk_sparse` / :func:`delta_topk_dense` — ONE device
  dispatch of a new batch against the resident index, ``_block_topk`` with
  the batch as queries: O(ΔN·N·d) per batch. The packed result is copied
  to pinned host memory without blocking and a CUDA event is recorded
  behind the copy; :func:`unpack_topk` waits on that event. Ingest never
  waits for the delta: the copy drains when mining reads it.
* :class:`ClusterState` — the host-side streaming mirror of the sweep's
  union-kNN graph: per-row top-k above-threshold neighbour lists,
  maintained under insertion (a new row stores its candidates AND is
  offered to each neighbour's list, evicting that list's worst entry).
  Unions are lazy: ``labels()`` runs connected components over the
  maintained edge set (+ the seeded base partition), so an early candidate
  that later rows crowd out never merges anything. Labels follow
  ``cluster_embeddings``' convention (smallest member index), so a refresh
  is directly comparable to a full sweep.

Graph equivalence: whenever every row's above-threshold degree is ≤ k, no
list ever evicts, every above-threshold pair is recorded when the later
row arrives, and the maintained graph IS the threshold graph — the
incremental partition equals the full sweep's exactly. Rows with more
neighbours keep their k best, the degree cap ``cluster_embeddings``
applies too. After a :meth:`ClusterState.seed` the base partition is
carried as edges, so components never split until the next full sweep.

``ClusterState``, :func:`collapse_groups` and :func:`centroids_from_sparse`
are numpy-only copies of the reference's, behaving bit for bit the same;
the state's lock is the reference's named ``ClusterState._lock``
(``core/sanitize.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kakveda_tpu_torch.core import sanitize
from kakveda_tpu_torch.ops.clustering import _block_topk, _sparse_components
from kakveda_tpu_torch.ops.knn import batch_bucket, densify, to_device

__all__ = [
    "ClusterState",
    "PendingTopk",
    "delta_topk_sparse",
    "delta_topk_dense",
    "unpack_topk",
    "centroids_from_sparse",
    "collapse_groups",
]


def collapse_groups(
    labels, min_size: int, exclude: Iterable[int] = ()
) -> List[Tuple[int, List[int]]]:
    """Turn a label partition into duplicate-collapse work items.

    Groups slots by cluster label, drops excluded members (already
    tombstoned), and returns ``(exemplar, victims)`` pairs for every
    cluster with at least ``min_size`` LIVE members. The exemplar is the
    smallest live slot, matching the min-member label convention (and the
    oldest record — stable across repeated collapse rounds). Deterministic
    in label order."""
    excluded = set(int(s) for s in exclude)
    groups: Dict[int, List[int]] = {}
    for slot, lab in enumerate(np.asarray(labels).tolist()):
        if slot in excluded:
            continue
        groups.setdefault(int(lab), []).append(slot)
    out: List[Tuple[int, List[int]]] = []
    for lab in sorted(groups):
        members = groups[lab]  # appended in slot order → members[0] is min
        if len(members) < max(2, min_size):
            continue
        out.append((members[0], members[1:]))
    return out


def centroids_from_sparse(labels, rows_fn, dim: int, chunk: int = 1 << 14):
    """Export a label partition as coarse-quantizer state: one
    L2-normalized centroid per cluster, built from sparse member rows.

    ``rows_fn(slots) -> (idx [B, K] int32, val [B, K] f32)`` supplies the
    sparse rows (pad idx == ``dim``). Returns ``(centroids [C, dim] f32,
    counts [C] int64, lists, assign [n] int32)`` where ``assign`` maps each
    row to its dense centroid id and ``lists[c]`` are the member slots.
    Chunked so no dense [n, dim] ever materializes.
    """
    labels = np.asarray(labels)
    n = len(labels)
    uniq, assign = np.unique(labels, return_inverse=True)
    c = len(uniq)
    sums = np.zeros((c, dim), np.float32)
    counts = np.bincount(assign, minlength=c).astype(np.int64)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        idx, val = rows_fn(np.arange(s, e, dtype=np.int64))
        keep = idx < dim
        rows_lab = np.broadcast_to(assign[s:e, None], idx.shape)[keep]
        np.add.at(sums, (rows_lab, idx[keep]), val[keep])
    norms = np.linalg.norm(sums, axis=1, keepdims=True)
    cents = np.divide(sums, norms, out=np.zeros_like(sums), where=norms > 0)
    lists: list = [[] for _ in range(c)]
    for slot, a in enumerate(assign.tolist()):
        lists[a].append(slot)
    return cents, counts, lists, assign.astype(np.int32)


# ---------------------------------------------------------------------------
# delta top-k dispatch (device)
# ---------------------------------------------------------------------------


@dataclass
class PendingTopk:
    """A packed ``[B, 2k']`` top-k on its way to the host: ``host`` is the
    pinned destination of a non-blocking copy from the card and ``event``
    the CUDA event recorded behind it (``None`` on the CPU, where ``host``
    is the result itself)."""

    host: torch.Tensor
    event: Optional[torch.cuda.Event]

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _to_host_async(packed: torch.Tensor) -> PendingTopk:
    if packed.device.type != "cuda":
        return PendingTopk(packed, None)
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return PendingTopk(host, event)


def delta_topk_sparse(
    emb: torch.Tensor, valid: torch.Tensor, idx: np.ndarray, val: np.ndarray, k: int
) -> PendingTopk:
    """Dispatch one delta top-k of a sparse-encoded batch against the index
    ``emb`` [capacity, dim] (rows with ``valid`` False score -inf); the
    queries are densified on the device and cast to the index dtype. The
    batch pads to a power-of-two bucket (pad rows carry ``idx == dim``, an
    all-zero query). Returns with the host copy started: fetch with
    :func:`unpack_topk`."""
    b, dim = idx.shape[0], emb.shape[1]
    bb = batch_bucket(max(b, 1))
    if b != bb:
        pad_i = np.full((bb, idx.shape[1]), dim, np.int32)
        pad_v = np.zeros((bb, val.shape[1]), np.float32)
        pad_i[:b] = idx
        pad_v[:b] = val
        idx, val = pad_i, pad_v
    q = densify(to_device(idx, np.int32, emb.device), to_device(val, np.float32, emb.device), dim)
    return _to_host_async(_block_topk(q.to(emb.dtype), emb, valid, k))


def delta_topk_dense(q: torch.Tensor, v: torch.Tensor, n_valid: int, k: int) -> PendingTopk:
    """Dense-query delta dispatch (the streaming arm of a benchmark): rows
    ``[0, n_valid)`` of ``v`` are live, the rest score -inf."""
    valid = torch.arange(v.shape[0], device=v.device) < n_valid
    return _to_host_async(_block_topk(q.to(v.dtype), v, valid, k))


def unpack_topk(pending: PendingTopk, b: int) -> Tuple[np.ndarray, np.ndarray]:
    """(scores [b, k'], row indices [b, k'] int64) of a dispatched delta,
    waiting for its host copy."""
    host = pending.wait()[:b]
    kk = host.shape[1] // 2
    return host[:, :kk], host[:, kk:].astype(np.int64)


# ---------------------------------------------------------------------------
# streaming cluster state (host)
# ---------------------------------------------------------------------------


class ClusterState:
    """Streaming mirror of the union-kNN clustering graph.

    Per-row state: the k best above-threshold neighbours seen so far (ids +
    sims, evict-worst on overflow) plus optional pattern metadata (failure
    type / id / apps). ``labels()`` materializes labels by running
    connected components over every stored edge plus the seeded base
    partition, caches them, and tracks which clusters changed since the
    last :meth:`pop_dirty` — the set ``mine_patterns`` re-emits.

    ``stale`` latches when the state can no longer be trusted (attach
    fault, replayed rows it never saw) — the owner falls back to ONE full
    sweep and re-seeds via :meth:`seed`. Never serve labels from a stale
    state.
    """

    _GROW = 1024

    def __init__(self, threshold: float = 0.6, k: int = 32):
        self.threshold = float(threshold)
        self.k = int(k)
        self._lock = sanitize.named_lock("ClusterState._lock", kind="rlock")
        self._n = 0
        self._ids = np.full((0, self.k), -1, np.int64)
        self._sims = np.full((0, self.k), -np.inf, np.float32)
        # Base partition from the last full sweep: rows [0, len) carry an
        # implicit edge to their base label.
        self._base = np.zeros(0, np.int32)
        self._ftype: List[Optional[str]] = []
        self._fid: List[Optional[str]] = []
        self._apps: List[set] = []
        self._touched: set = set()
        self._dirty_labels: set = set()
        self._cached_labels: Optional[np.ndarray] = None
        self._prev_labels = np.zeros(0, np.int32)
        self.stale = False
        self.stale_reason: Optional[str] = None
        self.attached = 0
        self.evictions = 0
        self.merges = 0

    # --- mutation --------------------------------------------------------

    @property
    def n_rows(self) -> int:
        return self._n

    @property
    def n_clusters(self) -> int:
        with self._lock:
            return int(len(np.unique(self._labels_locked())))

    def mark_stale(self, reason: str) -> None:
        with self._lock:
            self.stale = True
            self.stale_reason = reason

    def _grow_to(self, n: int) -> None:
        if n <= len(self._ids):
            return
        cap = max(n, len(self._ids) + self._GROW, 2 * len(self._ids))
        ids = np.full((cap, self.k), -1, np.int64)
        sims = np.full((cap, self.k), -np.inf, np.float32)
        ids[: len(self._ids)] = self._ids
        sims[: len(self._sims)] = self._sims
        self._ids, self._sims = ids, sims

    def add_row(
        self,
        slot: int,
        failure_type: Optional[str] = None,
        failure_id: Optional[str] = None,
        apps: Iterable[str] = (),
    ) -> None:
        """Register a new slot. Slots must arrive in order (the GFKB
        appends them densely); a gap means the caller missed rows and the
        state is no longer trustworthy."""
        with self._lock:
            if slot < self._n:
                return  # idempotent re-add
            if slot != self._n:
                self.mark_stale(f"non-contiguous slot {slot} (have {self._n})")
                return
            self._grow_to(slot + 1)
            self._n = slot + 1
            self._ftype.append(failure_type)
            self._fid.append(failure_id)
            self._apps.append(set(apps))
            self._touched.add(slot)
            self._cached_labels = None

    def note_apps(self, slot: int, apps: Iterable[str]) -> None:
        """A version update widened a record's affected apps — membership
        is unchanged, the cluster aggregate isn't."""
        with self._lock:
            if slot >= self._n:
                return
            new = set(apps) - self._apps[slot]
            if new:
                self._apps[slot] |= new
                self._touched.add(slot)

    def attach(self, slot: int, neigh: Sequence[int], sims: Sequence[float]) -> int:
        """Record ``slot``'s above-threshold candidates (its delta top-k,
        best-first): they become its neighbour list, and ``slot`` is offered
        to each neighbour's list (replacing that list's worst entry when
        better — the streaming analogue of the sweep's per-row degree
        cap). Returns edges stored."""
        stored = 0
        with self._lock:
            if slot >= self._n:
                return 0
            ids, sims_a = self._ids, self._sims
            row_i, row_s = ids[slot], sims_a[slot]
            # One vectorized pass drops the candidates below the threshold;
            # survivor order is preserved for the evict-worst walk.
            neigh_a = np.asarray(neigh, np.int64)
            sims_f = np.asarray(sims, np.float32)
            keep = (
                np.isfinite(sims_f)
                & (sims_f >= self.threshold)
                & (neigh_a != slot)
                & (neigh_a >= 0)
                & (neigh_a < self._n)
            )
            for j, s in zip(neigh_a[keep].tolist(), sims_f[keep].tolist()):
                # slot's own list (candidates arrive best-first)
                w = int(np.argmin(row_s))
                if s > row_s[w]:
                    if row_i[w] >= 0:
                        self.evictions += 1
                    row_i[w], row_s[w] = j, s
                    stored += 1
                # reverse offer into j's list
                nb_i, nb_s = ids[j], sims_a[j]
                w = int(np.argmin(nb_s))
                if s > nb_s[w]:
                    if nb_i[w] >= 0:
                        self.evictions += 1
                        self._touched.add(j)
                    nb_i[w], nb_s[w] = slot, s
            self.attached += 1
            self._touched.add(slot)
            self._cached_labels = None
        return stored

    def seed(
        self,
        labels: np.ndarray,
        meta: Optional[Sequence[Tuple[str, str, Iterable[str]]]] = None,
        threshold: Optional[float] = None,
    ) -> None:
        """Reset the state from a full-sweep result: the labels become the
        base partition (carried as edges), neighbour lists clear, dirty
        clears — a full sweep just emitted everything."""
        labels = np.asarray(labels, np.int32)
        with self._lock:
            n = len(labels)
            self._n = n
            self._ids = np.full((n, self.k), -1, np.int64)
            self._sims = np.full((n, self.k), -np.inf, np.float32)
            self._base = labels.copy()
            self._ftype = [None] * n
            self._fid = [None] * n
            self._apps = [set() for _ in range(n)]
            if meta is not None:
                for i, (ftype, fid, apps) in enumerate(meta):
                    self._ftype[i] = ftype
                    self._fid[i] = fid
                    self._apps[i] = set(apps)
            self._touched = set()
            self._dirty_labels = set()
            self._prev_labels = labels.copy()
            self._cached_labels = labels.copy()
            if threshold is not None:
                self.threshold = float(threshold)
            self.stale = False
            self.stale_reason = None

    # --- refresh / read --------------------------------------------------

    def _labels_locked(self) -> np.ndarray:
        if self._cached_labels is not None:
            return self._cached_labels
        n = self._n
        live = self._ids[:n]
        mask = live >= 0
        rows = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], live.shape)[mask]
        cols = live[mask]
        nb = len(self._base)
        if nb:
            rows = np.concatenate([rows, np.arange(nb, dtype=np.int64)])
            cols = np.concatenate([cols, self._base.astype(np.int64)])
        labels = _sparse_components(n, rows, cols)
        # dirty = clusters holding any touched row, under BOTH the old and
        # the new labelling (a merge dirties the surviving cluster; rows
        # whose label flipped dirty their new home)
        m = min(len(self._prev_labels), n)
        changed = set(int(r) for r in self._touched if r < n)
        if m:
            changed.update(int(r) for r in np.flatnonzero(labels[:m] != self._prev_labels[:m]))
            # clusters whose old root lost its identity merged into another
            prev_roots = np.unique(self._prev_labels[:m])
            self.merges += int(np.count_nonzero(labels[prev_roots] != prev_roots))
        self._dirty_labels.update(int(labels[r]) for r in changed)
        self._prev_labels = labels
        self._touched = set()
        self._cached_labels = labels
        return labels

    def labels(self) -> np.ndarray:
        """Materialized int32 labels [n_rows], min-member convention —
        byte-comparable with ``cluster_embeddings`` output. Cached until the
        next mutation; the refresh is one connected-components pass over
        O(N·k) edges, never a device sweep."""
        with self._lock:
            return self._labels_locked().copy()

    def pop_dirty(self) -> List[dict]:
        """Aggregate snapshots (apps / type counts / failure ids / member
        count) of every cluster touched since the last call; clears the
        dirty set. Aggregates are built only for dirty clusters."""
        with self._lock:
            labels = self._labels_locked()
            dirty = sorted(
                d for d in self._dirty_labels if d < self._n and labels[d] == d
            )
            self._dirty_labels = set()
            if not dirty:
                return []
            sel = np.flatnonzero(np.isin(labels, np.asarray(dirty, labels.dtype)))
            groups: Dict[int, List[int]] = {}
            for r in sel:
                groups.setdefault(int(labels[r]), []).append(int(r))
            out = []
            for lbl in dirty:
                members = groups.get(lbl)
                if not members:
                    continue
                apps: set = set()
                types: Dict[str, int] = {}
                fids: set = set()
                for r in members:
                    apps |= self._apps[r]
                    ft = self._ftype[r]
                    if ft is not None:
                        types[ft] = types.get(ft, 0) + 1
                    if self._fid[r]:
                        fids.add(self._fid[r])
                out.append(
                    {
                        "label": lbl,
                        "apps": sorted(apps),
                        "types": types,
                        "fids": sorted(fids),
                        "n": len(members),
                    }
                )
            return out

    def n_clusters_cached(self) -> Optional[int]:
        """Cluster count without forcing a refresh (None when labels are
        not currently cached)."""
        with self._lock:
            if self._cached_labels is None:
                return None
            return int(len(np.unique(self._cached_labels)))

    def info(self) -> dict:
        with self._lock:
            return {
                "rows": self._n,
                "clusters": self.n_clusters_cached(),
                "dirty": len(self._dirty_labels) + len(self._touched),
                "attached": self.attached,
                "evictions": self.evictions,
                "merges": self.merges,
                "stale": self.stale,
                "stale_reason": self.stale_reason,
                "threshold": self.threshold,
                "k": self.k,
            }
