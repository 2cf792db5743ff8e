"""Tiered GFKB storage hierarchy: card-hot / host-warm / disk-cold.

Port of ``kakveda_tpu/index/tiers.py``, kept in numpy on the host as the
reference keeps it, so the port's router, candidate lists and host scores
equal the reference's bit for bit on the same inputs. Nothing of the tiers
runs on the card.

* **card-hot**: the GFKB's ``[capacity, dim]`` index on the card, exact
  top-k by ``fused_topk``, capped at ``KAKVEDA_GFKB_HOT_ROWS`` logical
  slots (default 2^20). The GFKB owns those tensors; this module only
  knows the boundary.
* **host-warm** (:class:`WarmTier`): slot-indexed fixed-width sparse
  (idx, val) row arrays in host RAM, plus the lazily built inverted index.
  Every row lands here, the hot ones included: degraded mode, the overflow
  match, the snapshot of overflow rows and the exact oracle read the same
  rows through the same scorer.
* **disk-cold** (:class:`ColdTier`): append-only ``np.memmap`` sparse row
  shards under ``KAKVEDA_GFKB_COLD_DIR`` (or ``<data_dir>/cold``). Rows
  past the warm budget (``KAKVEDA_GFKB_WARM_ROWS``, default 2^22) land
  here; candidate gathers page only the candidate rows in, and recently
  paged rows stay in a bounded LRU.

Tier membership is a pure function of the append slot: ``[0, hot)`` on the
card (and mirrored warm for degraded mode), ``[hot, warm_budget)`` warm,
``[warm_budget, N)`` cold, so there is no migration bookkeeping to
snapshot or desynchronize.

Routing is IVF-style (:class:`CoarseRouter`): coarse centroids over the
corpus (an online spawn below cosine 0.30 and a running-mean update, ONE
vectorized assignment per ingest batch), a 2-means split of a list past
``KAKVEDA_GFKB_MAX_LIST``, a re-seed from the mining labels after a full
mine; at query time the ``KAKVEDA_GFKB_NPROBE`` nearest lists give the
candidate slots, and the top-k is exact over them.

Failure contract (fault sites ``gfkb.tier_spill`` / ``gfkb.tier_route`` /
``native.score``): a spill fault keeps the row warm (over budget, never
lost, never a failed ingest); a routing fault serves that query from the
exact full scan (slower, never a wrong-but-confident verdict); a scoring
fault takes the numpy path. ``KAKVEDA_GFKB_TIERED=0`` turns off the hot
cap, the router and the cold tier (the pre-tiered exact behaviour) while
the warm mirror keeps serving degraded mode.

The reference's metric families (``kakveda_native_score_seconds``,
``kakveda_native_fallback_total``, ``kakveda_gfkb_tier_*``,
``kakveda_gfkb_route_candidates``) move at the reference's call sites;
each object also keeps its own counts (``NativeScorer.calls`` /
``.fallbacks``, ``TieredIndex.route_counts`` / ``.spill_counts`` /
``.promotions``). Thread-safety: one named RLock per
:class:`TieredIndex`; the GFKB serializes its mutations under its own lock
as well.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from collections import OrderedDict
from pathlib import Path
from time import perf_counter
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from kakveda_tpu_torch import native as _native
from kakveda_tpu_torch.core import faults as _faults
from kakveda_tpu_torch.core import metrics as _metrics
from kakveda_tpu_torch.core import sanitize

log = logging.getLogger("kakveda.tiers")

__all__ = [
    "TierConfig",
    "NativeScorer",
    "WarmTier",
    "ColdTier",
    "CoarseRouter",
    "TieredIndex",
    "TierSpillError",
]

# Below this corpus size a routed match gains nothing over the exact
# inverted-index walk: route only past it.
_ROUTE_MIN_ROWS = 4096
# Cosine floor under which a new row spawns its own centroid instead of
# joining its best match — keeps lists coherent without a knob.
_SPAWN_SIM = 0.30
_SPLIT_ITERS = 6
_COLD_SHARD_ROWS = 1 << 18


class TierSpillError(RuntimeError):
    """A cold-tier write failed (disk full, injected fault). Internal —
    the spill path catches it and keeps the row warm; it must never
    surface to an ingest caller."""


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _topk_desc(scores: np.ndarray, k: int) -> np.ndarray:
    """Top-k indices by descending score: O(m) partition + O(k log k)
    sort of the survivors, vs the full argsort's O(m log m). Tie order
    among exactly-equal scores can differ from a full argsort — native
    paths only; the numpy fallback keeps the historical argsort."""
    if k >= len(scores):
        return np.argsort(-scores)
    part = np.argpartition(-scores, k)[:k]
    return part[np.argsort(-scores[part])]


class TierConfig:
    """The tier knobs, resolved once (an argument overrides its env var)."""

    def __init__(
        self,
        *,
        tiered: Optional[bool] = None,
        hot_rows: Optional[int] = None,
        warm_rows: Optional[int] = None,
        nprobe: Optional[int] = None,
        cold_dir: Optional[Path] = None,
        max_list: Optional[int] = None,
        promote_cache: Optional[int] = None,
    ):
        self.tiered = (
            os.environ.get("KAKVEDA_GFKB_TIERED", "1") != "0"
            if tiered is None else tiered
        )
        self.hot_rows = _env_int("KAKVEDA_GFKB_HOT_ROWS", 1 << 20) if hot_rows is None else hot_rows
        self.warm_rows = _env_int("KAKVEDA_GFKB_WARM_ROWS", 1 << 22) if warm_rows is None else warm_rows
        self.nprobe = _env_int("KAKVEDA_GFKB_NPROBE", 8) if nprobe is None else nprobe
        self.max_list = _env_int("KAKVEDA_GFKB_MAX_LIST", 4096) if max_list is None else max_list
        self.promote_cache = (
            _env_int("KAKVEDA_GFKB_PROMOTE_CACHE", 4096)
            if promote_cache is None else promote_cache
        )
        if cold_dir is not None:
            self.cold_dir: Optional[Path] = Path(cold_dir)
        else:
            env = os.environ.get("KAKVEDA_GFKB_COLD_DIR", "")
            self.cold_dir = Path(env) if env else None
        if not self.tiered:
            # Pre-tiered semantics: no hot cap (device grows), no cold
            # spill, no routing. The warm mirror still exists for
            # degraded mode — that part predates tiering.
            self.hot_rows = 1 << 62
            self.warm_rows = 1 << 62
            self.cold_dir = None


# ---------------------------------------------------------------------------
# native scoring seam
# ---------------------------------------------------------------------------


class NativeScorer:
    """The one gate between host-tier scoring and the C++ library.

    Every method returns scores or ``None``: None means "run the numpy
    path", so ``KAKVEDA_NATIVE=0``, a missing library, a failed call and an
    armed ``native.score`` fault all give the numpy results. A scoring
    problem is never a failed warn, except under ``KAKVEDA_NATIVE=require``,
    where a library that does not load and a native call that fails raise
    (as the featurizer's do) instead of falling back; the armed fault site
    still takes the numpy path there. ``calls`` counts native calls by path
    (warm = the warm exact scan, cold = a cold-shard exact scan, ivf =
    routed candidate scoring); ``fallbacks`` counts numpy fallbacks by
    reason (unavailable = the library is off or absent, fault = the
    ``native.score`` site, error = the native call failed)."""

    def __init__(self) -> None:
        self.require = _native._mode() == "require"
        self.enabled = _native.load() is not None  # raises under require
        self.min_rows = _native.score_min_rows()
        self._fault = _faults.site("native.score")
        self.calls = {p: 0 for p in ("warm", "cold", "ivf")}
        self.fallbacks = {r: 0 for r in ("unavailable", "fault", "error")}
        reg = _metrics.get_registry()
        h = reg.histogram(
            "kakveda_native_score_seconds",
            "Native host-tier scoring call duration by path (warm = warm "
            "exact scan, cold = cold-shard exact scan, ivf = routed "
            "candidate scoring)", ("path",),
        )
        self._h = {p: h.labels(path=p) for p in ("warm", "cold", "ivf")}
        c = reg.counter(
            "kakveda_native_fallback_total",
            "Host-tier scoring calls served by the numpy fallback by reason "
            "(unavailable = library off/absent, fault = chaos site "
            "native.score, error = native call failed)", ("reason",),
        )
        self._c_fb = {r: c.labels(reason=r) for r in ("unavailable", "fault", "error")}

    def _admit(self, total_rows: int) -> bool:
        """Common gate: tiny scans stay numpy (no fallback counted — a
        policy choice, not a degradation); disabled/armed/failed calls
        count their reason."""
        if total_rows < self.min_rows:
            return False
        if not self.enabled:
            if self.require:
                raise RuntimeError("KAKVEDA_NATIVE=require but the native scorer is unavailable")
            self.fallbacks["unavailable"] += 1
            self._c_fb["unavailable"].inc()
            return False
        try:
            self._fault.fire()
        except Exception:  # noqa: BLE001 — FaultInjected → numpy, never a failed warn
            self.fallbacks["fault"] += 1
            self._c_fb["fault"].inc()
            return False
        return True

    def _failed(self, what: str) -> None:
        if self.require:
            raise RuntimeError(f"KAKVEDA_NATIVE=require but {what} failed")
        self.fallbacks["error"] += 1
        self._c_fb["error"].inc()

    def score_block(
        self, qdense: np.ndarray, idx: np.ndarray, val: np.ndarray,
        dim: int, path: str,
    ) -> Optional[np.ndarray]:
        b = qdense.shape[0] if qdense.ndim == 2 else 1
        if not self._admit(b * idx.shape[0]):
            return None
        t0 = perf_counter()
        out = _native.score_block(qdense, idx, val, dim)
        if out is None:
            self._failed("kkv_score_block")
            return None
        self.calls[path] += 1
        self._h[path].observe(perf_counter() - t0)
        return out

    def score_candidates(
        self, qdense: np.ndarray, idx: np.ndarray, val: np.ndarray,
        offsets: np.ndarray, dim: int,
    ) -> Optional[np.ndarray]:
        if not self._admit(int(offsets[-1])):
            return None
        t0 = perf_counter()
        out = _native.score_candidates(qdense, idx, val, offsets, dim)
        if out is None:
            self._failed("kkv_score_candidates")
            return None
        self.calls["ivf"] += 1
        self._h["ivf"].observe(perf_counter() - t0)
        return out

    def score_gather_segments(
        self, qdense: np.ndarray,
        segments: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        dim: int,
    ) -> Optional[List[np.ndarray]]:
        """One query against row ids gathered in place from several base
        arrays (warm arrays + one per cold shard) — the zero-copy routed
        scoring plan. Admission once over the total row count; any
        segment failing falls the whole query back to the materialized
        path (never a partial result)."""
        if not self._admit(sum(len(s[2]) for s in segments)):
            return None
        t0 = perf_counter()
        outs: List[np.ndarray] = []
        for idx, val, rows in segments:
            res = _native.score_gather(qdense, idx, val, rows, dim)
            if res is None:
                self._failed("kkv_score_gather")
                return None
            outs.append(res)
        self.calls["ivf"] += 1
        self._h["ivf"].observe(perf_counter() - t0)
        return outs


# ---------------------------------------------------------------------------
# host-warm tier
# ---------------------------------------------------------------------------


class WarmTier:
    """Slot-indexed sparse rows in host RAM + the degraded-mode inverted
    index.

    Rows live in fixed-width ``idx [cap, K] int32`` / ``val [cap, K] f32``
    arrays (pad idx == ``dim``, the same drop sentinel the device scatter
    uses) so candidate gathers are one fancy-index read, not a dict walk.
    ``K`` grows to the widest row seen (power of two) — rows are stored
    EXACTLY, never truncated, because the degraded mode's top-1 parity
    contract depends on it. The inverted index (feature → slot/val
    postings) is built lazily on the first exact scan and extended by
    watermark."""

    _GROW = 1 << 12

    def __init__(self, dim: int, scorer: Optional[NativeScorer] = None):
        self.dim = dim
        self.k = 64  # matches the sparse encoders' starting width
        self.scorer = scorer
        self._idx = np.full((0, self.k), dim, np.int32)
        self._val = np.zeros((0, self.k), np.float32)
        # rows [0, n) are present except slots the owner never stored
        # (pure-cold rows); absent rows keep the all-pad sentinel.
        self.n = 0
        self._inv: Optional[dict] = None
        self._inv_n = 0

    def _grow(self, n: int, k: int) -> None:
        if n <= len(self._idx) and k <= self.k:
            return
        new_k = self.k
        while new_k < k:
            new_k <<= 1
        cap = len(self._idx)
        if n > cap:
            cap = max(n, cap + self._GROW, 2 * cap)
        idx = np.full((cap, new_k), self.dim, np.int32)
        val = np.zeros((cap, new_k), np.float32)
        idx[: len(self._idx), : self.k] = self._idx
        val[: len(self._val), : self.k] = self._val
        self._idx, self._val, self.k = idx, val, new_k

    def store(self, slots: np.ndarray, sp_idx: np.ndarray, sp_val: np.ndarray) -> None:
        slots = np.asarray(slots, np.int64)
        if len(slots) == 0:
            return
        self._grow(int(slots.max()) + 1, sp_idx.shape[1])
        k = sp_idx.shape[1]
        self._idx[slots, :k] = sp_idx
        self._idx[slots, k:] = self.dim
        self._val[slots, :k] = sp_val
        self._val[slots, k:] = 0.0
        self.n = max(self.n, int(slots.max()) + 1)

    def row(self, slot: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(idx, val) trimmed of padding, or None when not resident."""
        if slot >= len(self._idx):
            return None
        keep = self._idx[slot] < self.dim
        if not keep.any():
            return None
        return self._idx[slot][keep].copy(), self._val[slot][keep].copy()

    def rows_block(self, slots: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-width gather for candidate scoring ([B, K] idx/val).
        Slots never stored (or past the arrays) gather as all-pad rows
        that score 0 — same semantics as an embed still pending."""
        in_range = slots < len(self._idx)
        if in_range.all():
            return self._idx[slots], self._val[slots]
        idx = np.full((len(slots), self.k), self.dim, np.int32)
        val = np.zeros((len(slots), self.k), np.float32)
        if in_range.any():
            idx[in_range] = self._idx[slots[in_range]]
            val[in_range] = self._val[slots[in_range]]
        return idx, val

    # -- exact scoring ----------------------------------------------------

    def _extend_inv(self, upto: int) -> dict:
        if self._inv is None:
            self._inv = {}
            self._inv_n = 0
        inv = self._inv
        s = self._inv_n
        upto = min(upto, self.n)
        while s < upto:
            keep = self._idx[s] < self.dim
            if not keep.any():
                s += 1
                continue
            for f, v in zip(self._idx[s][keep].tolist(), self._val[s][keep].tolist()):
                ent = inv.get(f)
                if ent is None:
                    ent = inv[f] = ([], [])
                ent[0].append(s)
                ent[1].append(v)
            s += 1
        self._inv_n = s
        return inv

    def score_all(self, q_idx: np.ndarray, q_val: np.ndarray, n: int) -> np.ndarray:
        """Exact scores [n] for one sparse query over every resident row.

        Native path: one SIMD sparse-dot sweep over the fixed-width row
        arrays (O(n·K), the degraded-window warn cost). Fallback (and the
        ``KAKVEDA_NATIVE=0`` bit-for-bit contract): the inverted-index
        walk (O(query nnz · postings)). Slots past the stored range
        (pure-cold rows) score 0 on both paths."""
        sc = self.scorer
        if sc is not None and n > 0:
            m = min(n, self.n, len(self._idx))
            if m > 0:
                qd = np.zeros(self.dim + 1, np.float32)
                np.add.at(qd, np.minimum(q_idx, self.dim), q_val)
                qd[self.dim] = 0.0
                out = sc.score_block(qd, self._idx[:m], self._val[:m], self.dim, "warm")
                if out is not None:
                    if m < n:
                        out = np.concatenate([out, np.zeros(n - m, np.float32)])
                    return out
        inv = self._extend_inv(n)
        scores = np.zeros(n, np.float32)
        keep = q_idx < self.dim
        for f, v in zip(q_idx[keep].tolist(), q_val[keep].tolist()):
            ent = inv.get(f)
            if ent is not None:
                sl = np.asarray(ent[0])
                m = sl < n
                # add.at, not fancy +=: a row holding the same feature
                # twice posts two entries for the same slot, and buffered
                # fancy indexing would drop all but one — silently
                # undercounting vs the dense-gather semantics every other
                # scoring path (hot scan, routed candidates, native) uses.
                np.add.at(scores, sl[m], v * np.asarray(ent[1], np.float32)[m])
        return scores


# ---------------------------------------------------------------------------
# disk-cold tier
# ---------------------------------------------------------------------------


class ColdTier:
    """Append-only sparse row shards on disk, paged in on demand.

    Each shard is a pair of raw memmaps (``idx-…`` int32 / ``val-…`` f32,
    ``[_COLD_SHARD_ROWS, K]``) plus a tiny JSON meta; ``K`` is fixed per
    shard, so a wider row simply seals the current shard and opens the
    next at the wider width. Row address = (slot - base) → shard, row.
    Reads touch only the candidate rows (mmap pages fault in on demand);
    a bounded LRU (:attr:`promoted`) keeps recently paged rows hot."""

    def __init__(self, root: Path, dim: int, base_slot: int, promote_cache: int,
                 scorer: Optional[NativeScorer] = None):
        self.root = Path(root)
        self.dim = dim
        self.base = base_slot
        self.scorer = scorer
        self.n = 0  # rows appended (slot s ↔ cold row s - base)
        self._shards: List[dict] = []  # {k, rows, idx(memmap), val(memmap)}
        self._promote_max = promote_cache
        self.promoted: "OrderedDict[int, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()
        self.root.mkdir(parents=True, exist_ok=True)
        self._load_meta()

    # -- persistence ------------------------------------------------------

    def _meta_path(self) -> Path:
        return self.root / "cold.json"

    def _load_meta(self) -> None:
        mp = self._meta_path()
        if not mp.exists():
            return
        try:
            meta = json.loads(mp.read_text())
            if meta.get("dim") != self.dim or meta.get("base") != self.base:
                raise ValueError("cold meta does not match this index")
            for s in meta["shards"]:
                self._open_shard(int(s["k"]), int(s["rows"]), s["name"])
            self.n = int(meta["n"])
        except Exception as e:  # noqa: BLE001 — cold is derived, rebuildable
            log.warning(
                "cold tier meta unreadable (%s: %s); discarding cold shards "
                "(owner re-spills from the log)", type(e).__name__, e,
            )
            self._shards = []
            self.n = 0
            for p in self.root.iterdir():
                if p.name != "cold.json":
                    p.unlink(missing_ok=True)
            mp.unlink(missing_ok=True)

    def _flush_meta(self) -> None:
        meta = {
            "dim": self.dim,
            "base": self.base,
            "n": self.n,
            "shards": [
                {"k": s["k"], "rows": s["rows"], "name": s["name"]}
                for s in self._shards
            ],
        }
        tmp = self._meta_path().with_suffix(".tmp")
        tmp.write_text(json.dumps(meta))
        os.replace(tmp, self._meta_path())

    def _open_shard(self, k: int, rows: int, name: str) -> dict:
        ip = self.root / f"idx-{name}.mm"
        vp = self.root / f"val-{name}.mm"
        mode = "r+" if ip.exists() else "w+"
        shard = {
            "k": k,
            "rows": rows,
            "name": name,
            "idx": np.memmap(ip, np.int32, mode, shape=(_COLD_SHARD_ROWS, k)),
            "val": np.memmap(vp, np.float32, mode, shape=(_COLD_SHARD_ROWS, k)),
        }
        if mode == "w+":
            shard["idx"][:] = self.dim  # pad sentinel everywhere
        self._shards.append(shard)
        return shard

    # -- append / read ----------------------------------------------------

    def append(self, sp_idx: np.ndarray, sp_val: np.ndarray) -> None:
        """Append a batch of rows at the current tail (slots are assigned
        by the caller in order — cold row r holds slot base + r). Raises
        :class:`TierSpillError` on any IO failure; the caller keeps the
        rows warm instead."""
        try:
            b, k = sp_idx.shape
            done = 0
            while done < b:
                if not self._shards or self._shards[-1]["rows"] >= _COLD_SHARD_ROWS \
                        or self._shards[-1]["k"] < k:
                    if self._shards:
                        self._shards[-1]["idx"].flush()
                        self._shards[-1]["val"].flush()
                    self._open_shard(max(k, 64), 0, f"{len(self._shards):05d}")
                sh = self._shards[-1]
                room = _COLD_SHARD_ROWS - sh["rows"]
                take = min(room, b - done)
                r0 = sh["rows"]
                sh["idx"][r0 : r0 + take, :k] = sp_idx[done : done + take]
                sh["val"][r0 : r0 + take, :k] = sp_val[done : done + take]
                sh["rows"] += take
                done += take
            self.n += b
            self._flush_meta()
        except (OSError, ValueError) as e:
            raise TierSpillError(f"cold append failed: {e}") from e

    def _locate(self, slot: int) -> Tuple[dict, int]:
        r = slot - self.base
        off = 0
        for sh in self._shards:
            if r < off + sh["rows"]:
                return sh, r - off
            off += sh["rows"]
        raise KeyError(slot)

    def row(self, slot: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        hit = self.promoted.get(slot)
        if hit is not None:
            self.promoted.move_to_end(slot)
            return hit
        try:
            sh, r = self._locate(slot)
        except KeyError:
            return None
        keep = sh["idx"][r] < self.dim
        row = (np.asarray(sh["idx"][r][keep]), np.asarray(sh["val"][r][keep]))
        if self._promote_max > 0:
            self.promoted[slot] = row
            while len(self.promoted) > self._promote_max:
                self.promoted.popitem(last=False)
        return row

    def rows_block(self, slots: np.ndarray, k_out: int) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-width gather of cold rows via a coalesced read plan.

        Candidates are grouped per shard, sorted, and split into
        contiguous runs; each run is ONE basic-slice memmap read (a single
        large pread through the page cache) scattered back into position.
        IVF lists extend in slot-append order, so routed candidate lists
        are dominated by long runs — the pathological per-row fancy-index
        paging this replaces only survives as the fallback for genuinely
        scattered gathers (mean run < 4 rows), where run reads degenerate
        to the same row-by-row cost plus Python loop overhead."""
        idx = np.full((len(slots), k_out), self.dim, np.int32)
        val = np.zeros((len(slots), k_out), np.float32)
        r = slots - self.base
        off = 0
        for sh in self._shards:
            rows = sh["rows"]
            sel = (r >= off) & (r < off + rows)
            if sel.any():
                pos = np.flatnonzero(sel)
                rr = (r[pos] - off).astype(np.int64)
                k = min(sh["k"], k_out)
                order = np.argsort(rr, kind="stable")
                rs, ps = rr[order], pos[order]
                cut = np.flatnonzero(np.r_[True, np.diff(rs) != 1])
                if len(rs) >= 4 * len(cut):
                    bounds = np.r_[cut, len(rs)]
                    for a, z in zip(bounds[:-1], bounds[1:]):
                        r0 = int(rs[a])
                        blk_i = np.asarray(sh["idx"][r0 : r0 + (z - a), :k])
                        blk_v = np.asarray(sh["val"][r0 : r0 + (z - a), :k])
                        idx[ps[a:z], :k] = blk_i
                        val[ps[a:z], :k] = blk_v
                else:
                    idx[pos, :k] = np.asarray(sh["idx"][rr][:, :k])
                    val[pos, :k] = np.asarray(sh["val"][rr][:, :k])
            off += rows
        return idx, val

    def score_all(self, qdense: np.ndarray) -> np.ndarray:
        """Exact scores [n] over EVERY cold row (the oracle /
        degraded-exact path; routed queries never pay this). Native path:
        one threaded sweep per shard reading straight through the memmap
        (no RAM copy — the shard slice is already contiguous); fallback
        chunk-streams through numpy exactly as before."""
        out = np.zeros(self.n, np.float32)
        off = 0
        for sh in self._shards:
            rows = sh["rows"]
            if self.scorer is not None and rows:
                res = self.scorer.score_block(
                    qdense, sh["idx"][:rows], sh["val"][:rows], self.dim, "cold"
                )
                if res is not None:
                    out[off : off + rows] = res
                    off += rows
                    continue
            for c0 in range(0, rows, 1 << 14):
                c1 = min(rows, c0 + (1 << 14))
                idx = np.asarray(sh["idx"][c0:c1])
                val = np.asarray(sh["val"][c0:c1])
                out[off + c0 : off + c1] = (qdense[idx] * val).sum(axis=1)
            off += rows
        return out


# ---------------------------------------------------------------------------
# IVF coarse router
# ---------------------------------------------------------------------------


class CoarseRouter:
    """Coarse quantizer over the corpus: centroids + per-centroid slot
    lists + per-slot assignment.

    Maintenance is streaming: each ingest batch gets ONE vectorized
    assignment (O(B·C·nnz) host work), new rows below :data:`_SPAWN_SIM`
    spawn their own centroid, running sums keep centroids the mean of
    their members, and a list past ``max_list`` is split by a short
    2-means pass. :meth:`seed_from_labels` rebuilds the partition from
    the incremental mining state's labels (``ClusterState.labels()``) —
    the coarse structure mining already maintains."""

    def __init__(self, dim: int, max_list: int):
        self.dim = dim
        self.max_list = max_list
        self.c = 0
        self._cent = np.zeros((0, dim), np.float32)   # L2-normalized
        self._sums = np.zeros((0, dim), np.float32)   # running member sums
        self._counts = np.zeros(0, np.int64)
        self._lists: List[List[int]] = []
        self._assign = np.full(0, -1, np.int32)       # slot -> centroid
        self._n = 0          # 1 + highest slot seen
        self._assigned = 0   # rows actually assigned (no holes ⟺ == _n)
        self.splits = 0

    @property
    def n_rows(self) -> int:
        return self._n

    def covers(self, n: int) -> bool:
        """Does the partition cover every slot in [0, n)? A faulted
        delta update leaves holes — a router with holes must NEVER serve
        a routed match (silent misses are wrong-but-confident verdicts);
        callers fall back to the exact scan until a reseed/rebuild."""
        return self._n >= n and self._assigned >= n

    def _grow_c(self, c: int) -> None:
        if c <= len(self._cent):
            return
        cap = max(c, 2 * len(self._cent), 64)
        cent = np.zeros((cap, self.dim), np.float32)
        sums = np.zeros((cap, self.dim), np.float32)
        counts = np.zeros(cap, np.int64)
        cent[: self.c] = self._cent[: self.c]
        sums[: self.c] = self._sums[: self.c]
        counts[: self.c] = self._counts[: self.c]
        self._cent, self._sums, self._counts = cent, sums, counts

    def _grow_assign(self, n: int) -> None:
        if n <= len(self._assign):
            return
        a = np.full(max(n, 2 * len(self._assign), 1024), -1, np.int32)
        a[: len(self._assign)] = self._assign
        self._assign = a

    def _scores(self, sp_idx: np.ndarray, sp_val: np.ndarray) -> np.ndarray:
        """[B, C] centroid similarities for sparse rows — O(B·C·nnz),
        never a dense [B, dim]. Batches take the scipy CSR × dense path
        (a compiled sparse gemm — the per-ingest-batch assignment cost)
        when scipy is present; single queries and the fallback use a
        column gather over the centroid matrix."""
        b, k = sp_idx.shape
        cent = self._cent[: self.c]
        # pad entries point at col dim-1 with val 0 — they contribute 0
        idx_safe = np.minimum(sp_idx, self.dim - 1)
        if b == 1:
            g = cent[:, idx_safe[0]]                 # [C, K]
            return (g * sp_val[0][None, :]).sum(axis=1)[None, :]
        try:
            from scipy import sparse as _sp

            csr = _sp.csr_matrix(
                (
                    sp_val.ravel(),
                    idx_safe.ravel().astype(np.int64),
                    np.arange(0, (b + 1) * k, k, dtype=np.int64),
                ),
                shape=(b, self.dim),
            )
            return np.asarray(csr @ cent.T, dtype=np.float32)
        except ImportError:
            out = np.empty((b, self.c), np.float32)
            centT = np.ascontiguousarray(cent.T)     # [dim, C]
            step = max(1, (1 << 24) // max(1, self.c * k))
            for s in range(0, b, step):
                e = min(b, s + step)
                g = centT[idx_safe[s:e]]             # [Bc, K, C]
                out[s:e] = np.matmul(sp_val[s:e, None, :], g)[:, 0, :]
            return out

    def _renorm(self, cids: Sequence[int]) -> None:
        for c in set(int(c) for c in cids):
            nrm = float(np.linalg.norm(self._sums[c]))
            self._cent[c] = self._sums[c] / nrm if nrm > 0 else 0.0

    def _spawn(self, sp_i: np.ndarray, sp_v: np.ndarray) -> int:
        self._grow_c(self.c + 1)
        c = self.c
        self.c += 1
        self._lists.append([])
        keep = sp_i < self.dim
        self._sums[c] = 0.0
        np.add.at(self._sums[c], sp_i[keep], sp_v[keep])
        # the spawning row is folded in here (sums AND count) — batch
        # commit skips spawned rows.
        self._counts[c] = 1
        self._renorm([c])
        return c

    def add_batch(
        self,
        slots: Sequence[int],
        sp_idx: np.ndarray,
        sp_val: np.ndarray,
        rows_fn: Optional[Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]] = None,
    ) -> None:
        """Assign one ingest batch (the per-batch delta update). One
        vectorized similarity pass assigns the whole batch; per-row work
        happens only at centroid spawns (a new failure shape), where the
        not-yet-assigned tail is re-scored against the one new centroid
        so same-batch siblings join it. ``rows_fn`` supplies member rows
        for an oversized-list split; splits are skipped without it."""
        slots_arr = np.asarray(slots, np.int64)
        if len(slots_arr) == 0:
            return
        self._grow_assign(int(slots_arr.max()) + 1)
        new = self._assign[slots_arr] < 0  # idempotent re-add (replay overlap)
        if not new.all():
            if not new.any():
                return
            slots_arr = slots_arr[new]
            sp_idx, sp_val = sp_idx[new], sp_val[new]
        b = len(slots_arr)
        if self.c:
            sims = self._scores(sp_idx, sp_val)
            best = sims.argmax(axis=1).astype(np.int64)
            best_sim = sims[np.arange(b), best]
        else:
            best = np.zeros(b, np.int64)
            best_sim = np.full(b, -np.inf, np.float32)
        labels = np.empty(b, np.int64)
        spawned = np.zeros(b, np.bool_)
        touched: set = set()
        idx_safe = np.minimum(sp_idx, self.dim - 1)
        keep_all = sp_idx < self.dim
        start = 0
        while start < b:
            low = np.flatnonzero(best_sim[start:] < _SPAWN_SIM)
            stop = start + (int(low[0]) if len(low) else b - start)
            if stop > start:
                labels[start:stop] = best[start:stop]
                touched.update(np.unique(best[start:stop]).tolist())
            if stop < b:
                c_new = self._spawn(sp_idx[stop], sp_val[stop])
                labels[stop] = c_new
                spawned[stop] = True
                touched.add(c_new)
                if stop + 1 < b:
                    # the tail may join the freshly spawned centroid
                    rest = slice(stop + 1, b)
                    cvec = self._cent[c_new]
                    s_new = np.where(
                        keep_all[rest], cvec[idx_safe[rest]] * sp_val[rest], 0.0
                    ).sum(axis=1)
                    upd = s_new > best_sim[rest]
                    best_sim[rest] = np.where(upd, s_new, best_sim[rest])
                    best[rest] = np.where(upd, c_new, best[rest])
                start = stop + 1
            else:
                start = b
        # bulk commit: spawned rows were folded into their centroid by
        # _spawn; everything else lands in one grouped scatter-add.
        ns = ~spawned
        if ns.any():
            lab_b = np.broadcast_to(labels[:, None], sp_idx.shape)
            sel = keep_all & ns[:, None]
            np.add.at(self._sums, (lab_b[sel], sp_idx[sel]), sp_val[sel])
            self._counts[: self.c] += np.bincount(
                labels[ns], minlength=self.c
            )[: self.c]
        order = np.argsort(labels, kind="stable")
        sl_sorted, lab_sorted = slots_arr[order], labels[order]
        bounds = np.flatnonzero(np.r_[True, lab_sorted[1:] != lab_sorted[:-1], True])
        for a, z in zip(bounds[:-1], bounds[1:]):
            self._lists[int(lab_sorted[a])].extend(sl_sorted[a:z].tolist())
        self._assign[slots_arr] = labels
        self._n = max(self._n, int(slots_arr.max()) + 1)
        self._assigned += b
        self._renorm(touched)
        if rows_fn is not None:
            for c in touched:
                if len(self._lists[c]) > self.max_list:
                    self._split(c, rows_fn)

    def _split(self, c: int, rows_fn) -> None:
        """2-means split of one oversized list (short, host-side)."""
        members = np.asarray(self._lists[c], np.int64)
        m_idx, m_val = rows_fn(members)
        if len(members) < 4:
            return
        # seeds: first member + the member least similar to it
        q = np.zeros(self.dim + 1, np.float32)
        np.add.at(q, m_idx[0], m_val[0])
        sims0 = (q[np.minimum(m_idx, self.dim)] * m_val).sum(axis=1)
        seeds = [0, int(np.argmin(sims0))]
        cents = np.zeros((2, self.dim), np.float32)
        for j, s in enumerate(seeds):
            keep = m_idx[s] < self.dim
            np.add.at(cents[j], m_idx[s][keep], m_val[s][keep])
            n = np.linalg.norm(cents[j]) or 1.0
            cents[j] /= n
        lab = np.zeros(len(members), np.int64)
        for _ in range(_SPLIT_ITERS):
            g = cents[:, np.minimum(m_idx, self.dim - 1)]       # [2, M, K]
            sims = np.einsum("cmk,mk->mc", g, m_val)
            new_lab = np.argmax(sims, axis=1)
            if np.array_equal(new_lab, lab):
                break
            lab = new_lab
            for j in (0, 1):
                sel = lab == j
                cents[j] = 0.0
                if sel.any():
                    np.add.at(cents[j], m_idx[sel].ravel()[m_idx[sel].ravel() < self.dim],
                              m_val[sel].ravel()[m_idx[sel].ravel() < self.dim])
                    n = np.linalg.norm(cents[j]) or 1.0
                    cents[j] /= n
        if not lab.any() or lab.all():
            return  # degenerate split — keep the list as-is
        new_c = self._spawn(np.full(1, self.dim, np.int32), np.zeros(1, np.float32))
        moved = members[lab == 1]
        stay = members[lab == 0]
        self._lists[c] = stay.tolist()
        self._lists[new_c] = moved.tolist()
        self._assign[moved] = new_c
        # rebuild sums for both halves from member rows (exact means)
        for cid, sel in ((c, lab == 0), (new_c, lab == 1)):
            self._sums[cid] = 0.0
            flat_i = m_idx[sel].ravel()
            flat_v = m_val[sel].ravel()
            keep = flat_i < self.dim
            np.add.at(self._sums[cid], flat_i[keep], flat_v[keep])
            self._counts[cid] = int(sel.sum())
        self._renorm([c, new_c])
        self.splits += 1

    def route(self, q_idx: np.ndarray, q_val: np.ndarray, nprobe: int) -> np.ndarray:
        """Candidate slots for one sparse query: the members of its
        ``nprobe`` nearest centroid lists."""
        if self.c == 0:
            return np.zeros(0, np.int64)
        sims = self._scores(q_idx[None, :], q_val[None, :])[0]
        order = np.argsort(-sims)[: max(1, nprobe)]
        cands: List[int] = []
        for c in order.tolist():
            cands.extend(self._lists[c])
        return np.asarray(cands, np.int64)

    def seed_from_labels(
        self,
        labels: np.ndarray,
        rows_fn: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]],
    ) -> None:
        """Rebuild the partition from mining labels: one centroid per
        cluster, exact member means — the incremental ``ClusterState``
        (ops/incremental.py) exported as the coarse quantizer."""
        from kakveda_tpu_torch.ops.incremental import centroids_from_sparse

        n = len(labels)
        cents, counts, lists, assign = centroids_from_sparse(
            labels, rows_fn, self.dim
        )
        self.c = len(cents)
        self._cent = cents
        self._sums = cents * counts[:, None].astype(np.float32)
        self._counts = counts
        self._lists = lists
        self._grow_assign(n)
        self._assign[:n] = assign
        self._n = max(self._n, n)
        self._assigned = int((self._assign[: self._n] >= 0).sum())

    # -- snapshot ---------------------------------------------------------

    def export_state(self) -> Tuple[np.ndarray, np.ndarray]:
        """(centroids [C, dim] f32, assignment [n] int32) — everything a
        restore needs (lists/counts/sums re-derive from the assignment)."""
        return self._cent[: self.c].copy(), self._assign[: self.n_rows].copy()

    def restore_state(self, cent: np.ndarray, assign: np.ndarray) -> None:
        n, c = len(assign), len(cent)
        if c and (cent.shape[1] != self.dim or assign.max(initial=-1) >= c):
            raise ValueError("router state shape mismatch")
        self.c = c
        self._cent = cent.astype(np.float32).copy()
        self._counts = np.bincount(assign[assign >= 0], minlength=c).astype(np.int64)
        self._sums = self._cent * np.maximum(self._counts, 1)[:, None].astype(np.float32)
        self._lists = [[] for _ in range(c)]
        for s, a in enumerate(assign.tolist()):
            if a >= 0:
                self._lists[a].append(s)
        self._assign = assign.astype(np.int32).copy()
        self._n = n
        self._assigned = int((assign >= 0).sum())


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------


class TieredIndex:
    """The one host-side abstraction the GFKB talks to.

    Owns the warm tier, the optional cold tier and the router; the card-hot
    tier stays in the GFKB (it owns the tensors on the card): this class
    only knows the hot boundary, so a routed match can leave out the slots
    the card already answered exactly."""

    def __init__(self, dim: int, config: Optional[TierConfig] = None,
                 data_dir: Optional[Path] = None):
        self.cfg = config or TierConfig()
        self.dim = dim
        self.lock = sanitize.named_lock("TieredIndex.lock", kind="rlock")
        self.scorer = NativeScorer()
        self.warm = WarmTier(dim, self.scorer)
        self._data_dir = Path(data_dir) if data_dir is not None else None
        self.cold: Optional[ColdTier] = None
        self.router = CoarseRouter(dim, self.cfg.max_list) if self.cfg.tiered else None
        self.n = 0  # total rows stored (dense slots [0, n))
        # Spill overflow that could not reach cold stays warm past the
        # budget; tracked so info()/gauges stay honest.
        self._warm_overflow = 0
        self._fault_spill = _faults.site("gfkb.tier_spill")
        self._fault_route = _faults.site("gfkb.tier_route")
        # Per-instance counts (info(), tests) beside the process-global
        # families below.
        self.route_counts = {m: 0 for m in ("routed", "exact", "fault_exact")}
        self.spill_counts = {o: 0 for o in ("cold", "warm_fallback")}
        self.promotions = 0
        self.candidates = 0  # candidate slots gathered over all routed queries
        reg = _metrics.get_registry()
        g_rows = reg.gauge(
            "kakveda_gfkb_tier_rows",
            "Rows resident per GFKB storage tier (hot = device, warm = "
            "host RAM, cold = disk shards)", ("tier",),
        )
        self._g_rows = {t: g_rows.labels(tier=t) for t in ("hot", "warm", "cold")}
        c_route = reg.counter(
            "kakveda_gfkb_tier_route_total",
            "Tiered match queries by serving mode (routed = IVF candidate "
            "lists, exact = full scan, fault_exact = routing fault degraded "
            "to the exact scan)", ("mode",),
        )
        self._c_route = {m: c_route.labels(mode=m) for m in ("routed", "exact", "fault_exact")}
        c_spill = reg.counter(
            "kakveda_gfkb_tier_spill_total",
            "Rows spilled past the warm budget by outcome (cold = landed "
            "on disk, warm_fallback = spill failed, row kept in RAM)",
            ("outcome",),
        )
        self._c_spill = {o: c_spill.labels(outcome=o) for o in ("cold", "warm_fallback")}
        self._c_promote = reg.counter(
            "kakveda_gfkb_tier_promote_total",
            "Cold rows paged in and promoted to the in-RAM LRU",
        )
        self._h_cands = reg.histogram(
            "kakveda_gfkb_route_candidates",
            "Candidate slots gathered per routed tiered query",
        )

    # -- tier boundaries --------------------------------------------------

    @property
    def hot_n(self) -> int:
        """Slots the device tier covers (the GFKB inserts [0, hot_rows))."""
        return min(self.n, self.cfg.hot_rows)

    def _cold_enabled(self) -> bool:
        return self.cfg.tiered and (
            self.cfg.cold_dir is not None or self._data_dir is not None
        )

    def _cold_root(self) -> Path:
        return self.cfg.cold_dir if self.cfg.cold_dir is not None \
            else self._data_dir / "cold"

    def _ensure_cold(self) -> Optional[ColdTier]:
        if self.cold is None and self._cold_enabled():
            self.cold = ColdTier(
                self._cold_root(), self.dim, self.cfg.warm_rows,
                self.cfg.promote_cache, self.scorer,
            )
        return self.cold

    # -- insert -----------------------------------------------------------

    def insert(
        self,
        slots: Sequence[int],
        sp_idx: np.ndarray,
        sp_val: np.ndarray,
        route: bool = True,
    ) -> None:
        """Store one ingest batch: warm (or cold past the warm budget) +
        one router delta update (``route=False`` skips it — snapshot
        restore installs the persisted router state instead). Never
        raises for spill/route trouble — ingest must not fail from the
        storage hierarchy's own paths."""
        with self.lock:
            slots_arr = np.asarray(slots, np.int64)
            if len(slots_arr) == 0:
                return
            W = self.cfg.warm_rows
            warm_sel = slots_arr < W
            cold_sel = ~warm_sel
            if warm_sel.any():
                self.warm.store(slots_arr[warm_sel], sp_idx[warm_sel], sp_val[warm_sel])
            if cold_sel.any():
                self._spill(slots_arr[cold_sel], sp_idx[cold_sel], sp_val[cold_sel])
            self.n = max(self.n, int(slots_arr.max()) + 1)
            if route and self.router is not None:
                try:
                    self._fault_route.fire()
                    self.router.add_batch(slots_arr, sp_idx, sp_val, self._rows_block)
                except Exception as e:  # noqa: BLE001 — routing is derived state
                    log.warning(
                        "router delta update failed (%s: %s); affected rows "
                        "route via the exact scan until reseeded",
                        type(e).__name__, e,
                    )
            self._set_gauges()

    def _spill(self, slots: np.ndarray, sp_idx: np.ndarray, sp_val: np.ndarray) -> None:
        """Cold-append overflow rows; on ANY failure keep them warm (over
        budget beats lost) and count the fallback."""
        cold = self._ensure_cold()
        try:
            self._fault_spill.fire()
            if cold is None:
                raise TierSpillError("no cold tier configured")
            # cold rows must land in slot order with no gaps; slots the
            # shards already hold (snapshot restore / log replay walking
            # over an existing cold store) are skipped idempotently.
            expected = cold.base + cold.n
            done = slots < expected
            if done.any():
                slots = slots[~done]
                sp_idx, sp_val = sp_idx[~done], sp_val[~done]
            if len(slots) == 0:
                return
            if int(slots[0]) != expected or not np.array_equal(
                slots, np.arange(slots[0], slots[0] + len(slots))
            ):
                raise TierSpillError(
                    f"non-contiguous cold append (slot {int(slots[0])}, "
                    f"expected {expected})"
                )
            cold.append(sp_idx, sp_val)
            self.spill_counts["cold"] += len(slots)
            self._c_spill["cold"].inc(len(slots))
        except Exception as e:  # noqa: BLE001 — never fail the ingest
            log.warning(
                "cold spill failed (%s: %s); keeping %d rows warm over "
                "budget", type(e).__name__, e, len(slots),
            )
            self.warm.store(slots, sp_idx, sp_val)
            self._warm_overflow += len(slots)
            self.spill_counts["warm_fallback"] += len(slots)
            self._c_spill["warm_fallback"].inc(len(slots))

    def _set_gauges(self) -> None:
        # warm = rows resident in host RAM (the hot tier's degraded-mode
        # mirror included — it IS the degraded serving capacity).
        cold_n = self.cold.n if self.cold is not None else 0
        self._g_rows["hot"].set(self.hot_n)
        self._g_rows["warm"].set(min(self.n, self.cfg.warm_rows) + self._warm_overflow)
        self._g_rows["cold"].set(cold_n)

    # -- row access -------------------------------------------------------

    def row(self, slot: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        r = self.warm.row(slot)
        if r is not None:
            return r
        if self.cold is not None and slot >= self.cold.base:
            r = self.cold.row(slot)
            if r is not None:
                self.promotions += 1
                self._c_promote.inc()
            return r
        return None

    def _rows_block(self, slots: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[B, K] fixed-width rows for arbitrary slots (router splits,
        candidate scoring). Warm rows gather in one fancy-index read;
        cold rows gather per shard through the memmap (pages fault in
        only for the candidate rows)."""
        warm_sel = slots < self.cfg.warm_rows
        if warm_sel.all():
            return self.warm.rows_block(slots)
        cold_k = max(
            (sh["k"] for sh in self.cold._shards), default=0
        ) if self.cold is not None else 0
        k = max(self.warm.k, cold_k)
        idx = np.full((len(slots), k), self.dim, np.int32)
        val = np.zeros((len(slots), k), np.float32)
        if warm_sel.any():
            wi, wv = self.warm.rows_block(slots[warm_sel])
            idx[warm_sel, : wi.shape[1]] = wi
            val[warm_sel, : wv.shape[1]] = wv
        rest = ~warm_sel
        if rest.any() and self.cold is not None:
            ci, cv = self.cold.rows_block(slots[rest], k)
            idx[rest] = ci
            val[rest] = cv
            # spill-fallback rows live warm ABOVE the budget; the cold
            # gather returned pads for them — patch from warm storage.
            if self._warm_overflow:
                miss = rest.copy()
                miss[rest] = (ci >= self.dim).all(axis=1)
                if miss.any():
                    wi, wv = self.warm.rows_block(slots[miss])
                    idx[miss, : wi.shape[1]] = wi
                    idx[miss, wi.shape[1] :] = self.dim
                    val[miss, : wv.shape[1]] = wv
                    val[miss, wv.shape[1] :] = 0.0
        return idx, val

    # -- match ------------------------------------------------------------

    def densify_query(self, q_idx: np.ndarray, q_val: np.ndarray) -> np.ndarray:
        """[dim + 1] dense query with a zero at the pad sentinel, so sparse
        gathers score pads as 0."""
        q = np.zeros(self.dim + 1, np.float32)
        np.add.at(q, q_idx, q_val)
        q[self.dim] = 0.0
        return q

    def match_host(
        self,
        q_idx: np.ndarray,
        q_val: np.ndarray,
        k: int,
        *,
        min_slot: int = 0,
        exact: Optional[bool] = None,
    ) -> Tuple[np.ndarray, np.ndarray, str]:
        """Host-tier top-k for ONE sparse query over slots ``[min_slot, n)``.

        Returns ``(scores, slots, mode)`` sorted best-first; ``mode`` is
        ``routed`` / ``exact`` / ``fault_exact`` (what actually served —
        the warn verdict's ``tier`` provenance). ``exact=None`` lets the
        policy decide: routed once the corpus is past :data:`_ROUTE_MIN_ROWS`
        and the router covers it, exact otherwise. A routing failure
        (chaos site ``gfkb.tier_route`` or a real fault) DEGRADES to the
        exact scan — slower, never wrong-but-confident."""
        with self.lock:
            n = self.n
            if n <= min_slot:
                return np.zeros(0, np.float32), np.zeros(0, np.int64), "exact"
            want_routed = (
                exact is False
                or (
                    exact is None
                    and self.router is not None
                    and n - min_slot > _ROUTE_MIN_ROWS
                    and self.router.covers(n)
                )
            )
            if want_routed and self.router is not None:
                try:
                    self._fault_route.fire()
                    cands = self.router.route(q_idx, q_val, self.cfg.nprobe)
                    cands = cands[cands >= min_slot]
                    self.candidates += len(cands)
                    self._h_cands.observe(float(len(cands)))
                    if len(cands):
                        scores, native = self._score_candidates(q_idx, q_val, cands)
                        order = (
                            _topk_desc(scores, k) if native
                            else np.argsort(-scores)[:k]
                        )
                        self.route_counts["routed"] += 1
                        self._c_route["routed"].inc()
                        return scores[order], cands[order], "routed"
                    # empty candidate set: fall through to exact (a
                    # confident empty answer would be a silent miss)
                except Exception as e:  # noqa: BLE001 — degrade, never lie
                    log.warning(
                        "tier routing failed (%s: %s); serving this query "
                        "from the exact scan", type(e).__name__, e,
                    )
                    scores, slots = self._exact_topk(q_idx, q_val, k, min_slot)
                    self.route_counts["fault_exact"] += 1
                    self._c_route["fault_exact"].inc()
                    return scores, slots, "fault_exact"
            scores, slots = self._exact_topk(q_idx, q_val, k, min_slot)
            self.route_counts["exact"] += 1
            self._c_route["exact"].inc()
            return scores, slots, "exact"

    def _gather_scores_native(self, qd: np.ndarray, cands: np.ndarray) -> Optional[np.ndarray]:
        """Native zero-copy candidate scoring: split candidate slots into
        (warm arrays, per-cold-shard) segments of in-range row ids and
        score them IN PLACE — no [B, K] materialization, cold pages fault
        in during the C scan. Candidates are sorted ONCE up front: tier/
        shard segmentation becomes O(shards) searchsorted cuts instead of
        per-shard boolean masks over the whole list, and the kernel walks
        each mapping monotonically (measurably faster than a random-order
        gather on a latency-bound sweep). None (→ the materialized path)
        when the scorer is off, a segment fails, or warm-overflow rows
        exist (they need the rows_block patch logic — a degraded/chaos
        condition where the routed hot path no longer matters)."""
        sc = self.scorer
        if sc is None or not sc.enabled or self._warm_overflow:
            return None
        m = len(cands)
        order = np.argsort(cands)
        srt = cands[order]
        out_sorted = np.zeros(m, np.float32)
        segments: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        spans: List[Tuple[int, int]] = []
        # warm segment: rows below the warm boundary AND present in the
        # store (not-yet-grown slots stay 0, like the materialized gather)
        n_warm = int(np.searchsorted(
            srt, min(self.cfg.warm_rows, len(self.warm._idx))
        ))
        if n_warm:
            segments.append((self.warm._idx, self.warm._val, srt[:n_warm]))
            spans.append((0, n_warm))
        if int(np.searchsorted(srt, self.cfg.warm_rows)) < m:
            if self.cold is None:
                return None  # cold-region slots with no cold tier: let rows_block decide
            base = self.cold.base
            off = 0
            for sh in self.cold._shards:
                a = int(np.searchsorted(srt, base + off))
                z = int(np.searchsorted(srt, base + off + sh["rows"]))
                if z > a:
                    segments.append(
                        (sh["idx"], sh["val"],
                         (srt[a:z] - (base + off)).astype(np.int64))
                    )
                    spans.append((a, z))
                off += sh["rows"]
            # slots past every shard (not yet spilled) stay 0 — the same
            # all-pad score the materialized gather returns for them
        outs = sc.score_gather_segments(qd, segments, self.dim)
        if outs is None:
            return None
        for (a, z), res in zip(spans, outs):
            out_sorted[a:z] = res
        out = np.empty(m, np.float32)
        out[order] = out_sorted
        return out

    def _score_candidates(self, q_idx, q_val, cands: np.ndarray) -> Tuple[np.ndarray, bool]:
        """Score routed candidates; returns ``(scores, native)``.

        ``native`` tells the caller whether a native path served — those
        callers may then take the cheaper partition top-k, while the
        numpy fallback keeps the historical full argsort so
        ``KAKVEDA_NATIVE=0`` ordering stays bit-for-bit."""
        qd = self.densify_query(q_idx, q_val)
        out = self._gather_scores_native(qd, cands)
        if out is not None:
            return out, True
        idx, val = self._rows_block(cands)
        out = self.scorer.score_block(qd, idx, val, self.dim, "ivf")
        if out is not None:
            return out, True
        return (
            (qd[np.minimum(idx, self.dim)] * val).sum(axis=1).astype(np.float32),
            False,
        )

    def match_host_batch(
        self,
        q_idx: np.ndarray,
        q_val: np.ndarray,
        k: int,
        *,
        min_slot: int = 0,
        exact: Optional[bool] = None,
    ) -> List[Tuple[np.ndarray, np.ndarray, str]]:
        """Batched :meth:`match_host`: one ``(scores, slots, mode)`` per
        query row, same per-query contract (mode provenance, routing
        fault degrades THAT query to the exact scan).

        The batch form exists for the shared scoring plan: all routed
        queries' candidate lists are deduplicated into ONE row gather
        (the cold tier's coalesced read plan runs once per batch, not per
        query) and ONE thread-pooled native scoring call over the
        concatenated candidates. The numpy fallback scores per query over
        the same gathered rows — identical values to the per-query path,
        so ``KAKVEDA_NATIVE=0`` keeps bit-for-bit parity."""
        b = q_idx.shape[0]
        with self.lock:
            n = self.n
            if n <= min_slot:
                return [
                    (np.zeros(0, np.float32), np.zeros(0, np.int64), "exact")
                ] * b
            want_routed = (
                exact is False
                or (
                    exact is None
                    and self.router is not None
                    and n - min_slot > _ROUTE_MIN_ROWS
                    and self.router.covers(n)
                )
            )
            results: List[Optional[Tuple[np.ndarray, np.ndarray, str]]] = [None] * b
            routed_q: List[int] = []
            cand_lists: List[np.ndarray] = []
            if want_routed and self.router is not None:
                for i in range(b):
                    try:
                        self._fault_route.fire()
                        cands = self.router.route(q_idx[i], q_val[i], self.cfg.nprobe)
                        cands = cands[cands >= min_slot]
                        self.candidates += len(cands)
                        self._h_cands.observe(float(len(cands)))
                        if len(cands):
                            routed_q.append(i)
                            cand_lists.append(cands)
                        # empty candidate set falls through to exact below
                    except Exception as e:  # noqa: BLE001 — degrade, never lie
                        log.warning(
                            "tier routing failed (%s: %s); serving this query "
                            "from the exact scan", type(e).__name__, e,
                        )
                        scores, slots = self._exact_topk(q_idx[i], q_val[i], k, min_slot)
                        self.route_counts["fault_exact"] += 1
                        self._c_route["fault_exact"].inc()
                        results[i] = (scores, slots, "fault_exact")
            if routed_q:
                # Native plan: zero-copy gather-scoring per query (the
                # shared materialized gather below exists for the numpy
                # fallback, where the row copy is the dominant cost worth
                # amortizing across the batch). All-or-nothing: a failed
                # query discards the native attempt so the fallback plan
                # runs over the whole batch unchanged.
                native_res: List[Tuple[np.ndarray, np.ndarray, str]] = []
                for j, i in enumerate(routed_q):
                    qd1 = self.densify_query(q_idx[i], q_val[i])
                    scores = self._gather_scores_native(qd1, cand_lists[j])
                    if scores is None:
                        native_res = []
                        break
                    order = _topk_desc(scores, k)
                    native_res.append(
                        (scores[order], cand_lists[j][order], "routed")
                    )
                if native_res:
                    for j, i in enumerate(routed_q):
                        self.route_counts["routed"] += 1
                        self._c_route["routed"].inc()
                        results[i] = native_res[j]
                    routed_q = []
            if routed_q:
                counts = np.asarray([len(c) for c in cand_lists], np.int64)
                offsets = np.zeros(len(cand_lists) + 1, np.int64)
                np.cumsum(counts, out=offsets[1:])
                flat = np.concatenate(cand_lists)
                uniq, inv = np.unique(flat, return_inverse=True)
                u_idx, u_val = self._rows_block(uniq)
                cat_idx, cat_val = u_idx[inv], u_val[inv]
                qd = np.stack(
                    [self.densify_query(q_idx[i], q_val[i]) for i in routed_q]
                )
                scores_flat = self.scorer.score_candidates(
                    qd, cat_idx, cat_val, offsets, self.dim
                )
                if scores_flat is None:
                    scores_flat = np.empty(int(offsets[-1]), np.float32)
                    for j in range(len(routed_q)):
                        sl = slice(int(offsets[j]), int(offsets[j + 1]))
                        scores_flat[sl] = (
                            qd[j][np.minimum(cat_idx[sl], self.dim)] * cat_val[sl]
                        ).sum(axis=1).astype(np.float32)
                for j, i in enumerate(routed_q):
                    sl = slice(int(offsets[j]), int(offsets[j + 1]))
                    scores = scores_flat[sl]
                    order = np.argsort(-scores)[:k]
                    self.route_counts["routed"] += 1
                    self._c_route["routed"].inc()
                    results[i] = (scores[order], cand_lists[j][order], "routed")
            for i in range(b):
                if results[i] is None:
                    scores, slots = self._exact_topk(q_idx[i], q_val[i], k, min_slot)
                    self.route_counts["exact"] += 1
                    self._c_route["exact"].inc()
                    results[i] = (scores, slots, "exact")
            return results  # type: ignore[return-value]

    def _exact_topk(self, q_idx, q_val, k: int, min_slot: int) -> Tuple[np.ndarray, np.ndarray]:
        n = self.n
        # Warm postings cover every warm-resident slot — including any
        # spill-fallback rows parked above the budget; cold-region slots
        # are all-pad in the warm arrays and score 0 there.
        scores = self.warm.score_all(q_idx, q_val, n)
        if self.cold is not None and self.cold.n:
            qd = self.densify_query(q_idx, q_val)
            b = self.cold.base
            scores[b : b + self.cold.n] = self.cold.score_all(qd)[: max(0, n - b)]
        if min_slot:
            scores[:min_slot] = -np.inf
        order = np.argsort(-scores)[:k]
        return scores[order].astype(np.float32), order.astype(np.int64)

    # -- mining export ----------------------------------------------------

    def reseed_router(self, labels: np.ndarray) -> bool:
        """Re-derive the coarse partition from mining labels (the
        ``ClusterState`` export). Failure leaves the old router — routing
        is derived state; it degrades, it never breaks ingest/match."""
        if self.router is None:
            return False
        with self.lock:
            if len(labels) < self.n:
                return False
            try:
                self.router.seed_from_labels(
                    np.asarray(labels[: self.n], np.int32), self._rows_block
                )
                return True
            except Exception as e:  # noqa: BLE001
                log.warning(
                    "router reseed from mining labels failed (%s: %s); "
                    "keeping the online partition", type(e).__name__, e,
                )
                return False

    # -- snapshot ---------------------------------------------------------

    def export_router_state(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if self.router is None or not self.router.covers(self.n):
            return None
        with self.lock:
            return self.router.export_state()

    def restore_router_state(self, cent: np.ndarray, assign: np.ndarray) -> None:
        if self.router is None:
            return
        with self.lock:
            self.router.restore_state(cent, assign)

    def rebuild_router(self, chunk: int = 1 << 14) -> None:
        """Re-assign every stored row from scratch (restore-degrade path
        after a centroid checksum mismatch). O(N·C·nnz) host work."""
        if self.router is None:
            return
        with self.lock:
            self.router = CoarseRouter(self.dim, self.cfg.max_list)
            for s in range(0, self.n, chunk):
                e = min(self.n, s + chunk)
                slots = np.arange(s, e, dtype=np.int64)
                idx, val = self._rows_block(slots)
                self.router.add_batch(slots, idx, val, self._rows_block)

    # -- lifecycle --------------------------------------------------------

    def recently_promoted_slots(self) -> set:
        """Global slots currently in the cold tier's promote-LRU — rows a
        recent query paged in from disk. This is the tiers' touch evidence:
        row aging (GFKB.age_rows) exempts these slots, because a record's
        ``updated_at`` only moves on WRITES and a cold row that live queries
        keep paging in is working set, whatever its timestamp says."""
        with self.lock:
            if self.cold is None:
                return set()
            return set(self.cold.promoted.keys())

    def reset(self) -> None:
        """Drop everything (GFKB.reload — the append log was rewritten;
        cold shards describe pre-rewrite slots and must go with it)."""
        with self.lock:
            self.warm = WarmTier(self.dim, self.scorer)
            self.router = CoarseRouter(self.dim, self.cfg.max_list) if self.cfg.tiered else None
            self.n = 0
            self._warm_overflow = 0
            if self.cold is not None:
                shutil.rmtree(self.cold.root, ignore_errors=True)
                self.cold = None
            self._set_gauges()

    def info(self) -> dict:
        with self.lock:
            cold_n = self.cold.n if self.cold is not None else 0
            return {
                "tiered": self.cfg.tiered,
                "native": self.scorer.enabled,
                "rows": self.n,
                "hot": self.hot_n,
                "warm": min(self.n, self.cfg.warm_rows) + self._warm_overflow,
                "cold": cold_n,
                "warm_overflow": self._warm_overflow,
                "centroids": self.router.c if self.router is not None else 0,
                "splits": self.router.splits if self.router is not None else 0,
                "nprobe": self.cfg.nprobe,
            }
