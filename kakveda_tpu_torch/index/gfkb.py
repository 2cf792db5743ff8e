"""Global Failure Knowledge Base over the port's device index.

Port of ``kakveda_tpu/index/gfkb.py``: append-only JSONL
persistence with versioning-by-append, dense ``F-%04d``/``FP-%04d`` id
minting, identity by ``(failure_type, signature_text)``, one embedding row
per canonical failure in a device-resident ``[capacity, dim]`` index, and a
top-k match of one ``fused_topk`` launch per query batch over the hot
rows. ``failures.jsonl``,
``patterns.jsonl`` and ``tombstones.jsonl`` are written in the JAX
package's line format through the native group-commit writer
(``native.AppendLog``, a Python file where the library is absent), flushed
once per public mutation.

Durability is the reference's: a v5 snapshot (``snapshot/``: sparse rows,
records, the mining labels, a manifest pinning the covered log prefix and
checksums) lets a restart restore the rows onto the card and replay only
the log tail; any mismatch degrades to a full replay, a bad label file to
one full re-mine. Tombstones (aging, duplicate collapse) are durable before
visible, zero the row on the card and resurrect on an organic upsert. The
compaction rewrites the failures log to the delta after a fresh snapshot,
fenced by the manifest so a crash at any byte replays to the pre- or the
post-compaction state (``index/crashsweep.py`` certifies it). A data dir
written by either package opens in the other, snapshot, tombstones and
compaction included.

Replication is the reference's: a batch applied with an ``event_id``
(:meth:`GFKB.apply_replication`, a peer's ``/replicate``) is a no-op when
that id was applied before, else its id appends to
``applied_events.jsonl`` after the row lines, so redelivery and DLQ
replay stay idempotent across restarts. The dedup set is bounded
(``KAKVEDA_GFKB_APPLIED_MAX``, FIFO) and the log is rewritten to it at
open (``KAKVEDA_GFKB_APPLIED_COMPACT=0`` opts out). A replicated row for
a tombstoned slot is fenced (dropped, counted); only an organic upsert
resurrects. Replicated rows take the organic path: the tiered insert,
the scatter onto the card and the mining attach. :meth:`GFKB.export_rows`
and :meth:`GFKB.shard_key_counts` serve the fleet's range migration and
``/readyz``.

Incremental mining rides the ingest path as in the reference: each new
record joins a streaming ``ClusterState`` (``ops/incremental.py``); after a
batch's scatter its new rows get their neighbours either from a recent
warn's match of the same signature (the match cache, no device work) or
from ONE delta top-k of the batch against the index, drained lazily when
mining reads the state. A fault there marks the state stale (one full
sweep at the next mine) and never fails an ingest. A snapshot restore seeds
the state from its labels; a full replay, or a tail with rows the snapshot
never saw, leaves it stale, so that first mine is a full sweep.

The host tiers are the reference's (``index/tiers.py``, numpy on the
host): every row lands in the host-warm mirror (the disk-cold shards past
``KAKVEDA_GFKB_WARM_ROWS``) before its scatter, and only slots below the
hot cap (``KAKVEDA_GFKB_HOT_ROWS``, default 2^20) go onto the card, whose
index grows no further. Past the cap a match merges the card's exact hot
top-k with the tiers' routed top-k over the overflow slots
(``tier="tiered"``); the mining attach of an overflow row takes its
neighbours from the tiers; a snapshot carries the overflow rows from the
tiers and the router (``centroids.npy``, ``tier_assign.npy``, the
``tiers`` section), which a restore installs instead of rebuilding. While
``core/admission.DeviceHealth`` is latched DEGRADED the warn path answers
from :meth:`GFKB.match_batch_fallback`, which touches no tensor on the
card. ``KAKVEDA_HOST_FALLBACK=0`` drops the tiers (no mirror, no cap, no
fallback).

The reference's lifecycle and mining families
(``kakveda_gfkb_compact_total``, ``kakveda_gfkb_tombstone_total``,
``kakveda_gfkb_tombstoned_rows``, ``kakveda_mine_*``,
``kakveda_warn_fallback_total``, ``kakveda_gfkb_replicate_apply_total``)
move at the reference's call sites. Two deviations: a capacity growth re-zeroes the tombstoned
rows it re-embeds (the reference's growth leaves them scoring, filtered
only at assembly), and records parse with pydantic's JSON parser (the same
records, several times faster).
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import shutil
import tempfile
import threading
import time
from collections import OrderedDict, deque
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kakveda_tpu_torch import native
from kakveda_tpu_torch.core import faults as _faults
from kakveda_tpu_torch.core import metrics as _metrics
from kakveda_tpu_torch.core import profiling
from kakveda_tpu_torch.core import sanitize
from kakveda_tpu_torch.core.schemas import (
    CanonicalFailureRecord,
    FailureMatch,
    PatternEntity,
    Severity,
    utcnow,
)
from kakveda_tpu_torch.index.tiers import TierConfig, TieredIndex
from kakveda_tpu_torch.ops.featurizer import HashedNGramFeaturizer
from kakveda_tpu_torch.ops.incremental import (
    ClusterState,
    collapse_groups,
    delta_topk_sparse,
    unpack_topk,
)
from kakveda_tpu_torch.ops.knn import MAX_CAPACITY, Knn, to_device

log = logging.getLogger("kakveda.gfkb")

_CHUNK = 1 << 16  # rows per bulk insert and per snapshot gather


class SnapshotError(RuntimeError):
    """Snapshot unavailable or aborted (persist=False, concurrent reload):
    a caller-side condition, distinct from device and runtime failures."""


class HostFallbackDisabled(RuntimeError):
    """Degraded-mode matching asked for with the host tiers disabled
    (``KAKVEDA_HOST_FALLBACK=0``): a configuration condition, typed so the
    warn path never mistakes it for a device failure."""


_fallback_lock = threading.Lock()
_fallback_total = 0  # warns served by the host fallback, process-wide


def fallback_total() -> int:
    """Warn queries every GFKB of this process served from its host tiers
    (degraded mode): 0 on a healthy path."""
    return _fallback_total


def _parse_record(line: str) -> CanonicalFailureRecord:
    """One JSONL record (a log line or a snapshot row), parsed and validated
    by pydantic's JSON parser: the records the reference gets from
    ``model_validate(json.loads(...))`` or ``model_construct``, several
    times faster than either."""
    return CanonicalFailureRecord.model_validate_json(line)


def _stack_sparse(parts, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Row-stack per-chunk (idx, val) pairs at their common width, padded
    with (dim, 0): what one ``dense_rows_to_sparse`` call over all the rows
    gives (the reference's snapshot payload)."""
    if not parts:
        return np.full((0, 64), dim, np.int32), np.zeros((0, 64), np.float32)
    k = max(p[0].shape[1] for p in parts)
    n = sum(p[0].shape[0] for p in parts)
    idx = np.full((n, k), dim, np.int32)
    val = np.zeros((n, k), np.float32)
    r = 0
    for pi, pv in parts:
        idx[r : r + len(pi), : pi.shape[1]] = pi
        val[r : r + len(pv), : pv.shape[1]] = pv
        r += len(pi)
    return idx, val


class GFKB:
    """Failure + pattern store with a device-resident similarity index."""

    def __init__(
        self,
        data_dir: str | Path = "data",
        capacity: int = 1 << 14,
        dim: int = 2048,
        top_k: int = 5,
        featurizer: Optional[HashedNGramFeaturizer] = None,
        persist: bool = True,
        device: str | torch.device | None = None,
        tier_config: Optional[TierConfig] = None,
    ):
        self.data_dir = Path(data_dir)
        self.persist = persist
        if persist:
            self.data_dir.mkdir(parents=True, exist_ok=True)
        self.failures_path = self.data_dir / "failures.jsonl"
        self.patterns_path = self.data_dir / "patterns.jsonl"
        # Lifecycle side-log: {"op": "tomb"|"live", "id", "reason", "ts"}
        # lines. Tombstoned slots keep their records, ids and keys (dense id
        # minting and replay latest-wins depend on slot stability); they are
        # zeroed on the card and dropped from every match assembly.
        self.tombstones_path = self.data_dir / "tombstones.jsonl"
        self._tombstoned: Dict[int, str] = {}  # slot -> reason
        # Replication idempotency: the ids of applied bus events, bounded
        # (KAKVEDA_GFKB_APPLIED_MAX, FIFO) and logged on their own.
        self.applied_path = self.data_dir / "applied_events.jsonl"
        self._applied_events: "OrderedDict[str, bool]" = OrderedDict()
        self._applied_max = int(os.environ.get("KAKVEDA_GFKB_APPLIED_MAX", "65536"))
        self._tomb_view: Optional[frozenset] = frozenset()  # None: rebuild at the next match
        # Compaction posture (the manifest's "compact" section); the age
        # trigger counts from the open when the store never compacted.
        self._opened_ts = time.time()
        self._last_compact_ts = 0.0
        self._compact_generation = 0
        self._compact_inflight = False
        self._compact_bytes = int(os.environ.get("KAKVEDA_GFKB_COMPACT_BYTES", "0"))
        self._compact_age_s = float(os.environ.get("KAKVEDA_GFKB_COMPACT_AGE_S", "0"))
        # Reentrant: compact() snapshots and swaps under one critical section.
        self._snapshot_write_lock = sanitize.named_lock("GFKB._snapshot_write_lock", kind="rlock")
        # Bumped by reload(); a snapshot that sees it change aborts, and
        # in-flight embeds and mining deltas of the old generation drop.
        self._generation = 0
        # What the last restore and snapshot did (rows, walls by stage).
        self._restore_info: Optional[dict] = None
        self._snapshot_info: Optional[dict] = None

        self.featurizer = featurizer or HashedNGramFeaturizer(dim=dim)
        self.top_k = top_k
        self._knn = Knn(capacity, dim, k=top_k, device=device)
        self.device = self._knn.device
        self._emb, self._valid = self._knn.alloc()
        self._types = self._knn.alloc_i32()
        self._type_ids: Dict[str, int] = {}

        # Host metadata: one entry per canonical failure, slot-aligned.
        self._records: List[CanonicalFailureRecord] = []
        self._slot_by_key: Dict[Tuple[str, str], int] = {}
        self._slot_by_id: Dict[str, int] = {}
        # Per-type aggregates maintained at upsert (pattern detection reads
        # them O(1)).
        self._ids_by_type: Dict[str, List[str]] = {}
        self._apps_by_type: Dict[str, set] = {}
        # Pattern store: set-backed state per name; the log is delta-append
        # (each line carries only the members new in that upsert).
        self._pattern_state: Dict[str, dict] = {}
        self._lock = sanitize.named_lock("GFKB._lock")
        # Records appended whose rows are not scattered yet: snapshot() and
        # records_and_embeddings wait for them.
        self._pending_embeds = 0
        self._embeds_cv = threading.Condition(self._lock)
        self._logs: Dict[Path, native.AppendLog] = {}
        # A torn final line tolerated at replay: truncate back to this
        # offset before the next append to that file.
        self._truncate_pending: Dict[Path, int] = {}
        # Chaos sites (core/faults.py), the reference's names.
        self._fault_append = _faults.site("gfkb.append")
        self._fault_snapshot = _faults.site("gfkb.snapshot")
        self._fault_mine = _faults.site("gfkb.mine_state")
        self._fault_compact_delta = _faults.site("gfkb.compact_delta")
        self._fault_compact_fence = _faults.site("gfkb.compact_fence")
        self._fault_compact_swap = _faults.site("gfkb.compact_swap")
        self._fault_tombstone = _faults.site("gfkb.tombstone")
        # The device-loss drill, shared with DeviceHealth's probe: armed,
        # every match dispatch fails as a dead card's does.
        self._fault_device = _faults.site("device.unavailable")

        # The host tiers (index/tiers.py): the warm mirror of every row,
        # the cold shards past the warm budget, the router; the card holds
        # the slots below the hot cap. KAKVEDA_HOST_FALLBACK=0 opts out (no
        # mirror, no cap, no degraded warn).
        self._tiers: Optional[TieredIndex] = None
        if os.environ.get("KAKVEDA_HOST_FALLBACK", "1") != "0":
            self._tiers = TieredIndex(
                self.featurizer.dim, tier_config or TierConfig(), self.data_dir if persist else None
            )
        self.fallback_warns = 0  # warn queries this store served degraded
        reg = _metrics.get_registry()
        self._m_warn_fallback = reg.counter(
            "kakveda_warn_fallback_total",
            "Warn verdicts served by the host-side fallback index while "
            "the backend is degraded",
        )
        rep = reg.counter(
            "kakveda_gfkb_replicate_apply_total",
            "Bus-replicated ingest events applied to this GFKB by outcome "
            "(applied|dedup; fenced counts individual tombstoned ROWS "
            "dropped by the lifecycle fence)", ("outcome",),
        )
        self._m_rep_applied = rep.labels(outcome="applied")
        self._m_rep_dedup = rep.labels(outcome="dedup")
        self._m_rep_fenced = rep.labels(outcome="fenced")
        # Lifecycle families, children resolved before _replay() (the
        # applied log's start-up compaction counts into them).
        _cmp = reg.counter(
            "kakveda_gfkb_compact_total",
            "Durable-log compactions by store and outcome (ok|skipped|"
            "error|stale_tmp; stale_tmp = leftover temp file from a "
            "crashed rewrite, removed before the next attempt)",
            ("store", "outcome"),
        )
        self._m_compact = {
            (st, oc): _cmp.labels(store=st, outcome=oc)
            for st in ("failures", "applied", "tombstones")
            for oc in ("ok", "skipped", "error", "stale_tmp")
        }
        _tmb = reg.counter(
            "kakveda_gfkb_tombstone_total",
            "Row lifecycle transitions by reason (aged = TTL demotion, "
            "collapsed = near-duplicate fold, resurrected = organic "
            "re-upsert of a tombstoned signature)",
            ("reason",),
        )
        self._m_tombstone = {r: _tmb.labels(reason=r) for r in ("aged", "collapsed", "resurrected")}
        self._g_tombstoned = reg.gauge(
            "kakveda_gfkb_tombstoned_rows",
            "Currently tombstoned (resident but never matched) GFKB rows",
        )
        self._m_mine_update = reg.histogram(
            "kakveda_mine_update_seconds",
            "Incremental cluster-state update wall per drained delta batch",
        )
        self._m_mine_clusters = reg.gauge(
            "kakveda_mine_clusters",
            "Live clusters in the incremental mining state",
        )
        _attach = reg.counter(
            "kakveda_mine_attach_total",
            "Rows attached to the incremental cluster state by neighbor source",
            ("source",),
        )
        self._m_mine_attach = {src: _attach.labels(source=src) for src in ("delta", "reused", "tier")}
        self._m_mine_merges = reg.counter(
            "kakveda_mine_merges_total",
            "Cluster merges performed by incremental attachment",
        )
        self._mine_merges_seen = 0

        # Incremental mining state (KAKVEDA_MINE_INCREMENTAL=0: no state,
        # no cache, no extra device dispatches — every mine is a full sweep).
        self._mine: Optional[ClusterState] = None
        # Dispatched delta top-ks not yet folded in:
        # (capacity, slots, pending, generation).
        self._mine_pending: deque = deque()
        self._mine_pending_max = int(os.environ.get("KAKVEDA_MINE_PENDING_MAX", "256"))
        # signature_text -> (scores, slots, generation): a warn's fetched
        # neighbours, reused to attach the same signature at ingest.
        self._match_cache: "OrderedDict[str, tuple]" = OrderedDict()
        self._match_cache_max = int(os.environ.get("KAKVEDA_MINE_MATCH_CACHE", "4096"))
        self.mine_delta_dispatches = 0
        self.mine_tier_attaches = 0  # overflow rows attached from the host tiers
        if os.environ.get("KAKVEDA_MINE_INCREMENTAL", "1") != "0":
            self._mine = ClusterState(
                threshold=float(os.environ.get("KAKVEDA_MINE_THRESHOLD", "0.6")),
                k=int(os.environ.get("KAKVEDA_MINE_K", "32")),
            )
        if persist:
            self._replay()
        self._mine_after_replay()

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def _append_jsonl(self, path: Path, obj: dict) -> None:
        self._append_line(path, json.dumps(obj, ensure_ascii=False))

    def _append_line(self, path: Path, line: str) -> None:
        """Buffer one pre-serialized record; public mutations flush once."""
        if not self.persist:
            return
        self._fault_append.fire()
        pend = self._truncate_pending.pop(path, None)
        if pend is not None:
            f = self._logs.pop(path, None)
            if f is not None:
                f.close()
            try:
                os.truncate(path, pend)
                log.warning("truncated torn tail of %s to %d bytes", path, pend)
            except OSError as e:
                log.error("could not truncate torn tail of %s: %s", path, e)
                self._truncate_pending[path] = pend
                raise
        alog = self._logs.get(path)
        if alog is None:
            alog = self._logs[path] = native.AppendLog(path)
        alog.append((line + "\n").encode("utf-8"))

    def _flush_logs(self) -> None:
        for f in self._logs.values():
            f.flush()

    def close(self) -> None:
        """Flush and close the append logs (safe to call repeatedly)."""
        with self._lock:
            self._close_locked()

    def _close_locked(self) -> None:
        for f in self._logs.values():
            f.close()
        self._logs.clear()

    def _sync(self) -> None:
        """Wait for the card (stage walls of a snapshot or a restore)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _iter_log_lines(self, path: Path, offset: int, parse):
        """Yield ``parse(line)`` per JSONL line of ``path`` from byte
        ``offset``, tolerating one torn FINAL line (a crash mid-append:
        warn, truncate on the next append); a bad record with data after it
        is mid-file corruption and raises."""
        with path.open("rb") as f:
            if offset:
                f.seek(offset)
            pos = f.tell()
            for raw in f:
                line_start = pos
                pos += len(raw)
                try:
                    text = raw.decode("utf-8").strip()
                    if not text:
                        continue
                    parsed = parse(text)
                except Exception as e:  # noqa: BLE001 — decode OR parse failure
                    if f.read().strip():
                        raise ValueError(
                            f"corrupt record mid-file in {path} at byte {line_start} "
                            f"({type(e).__name__}: {e}); refusing to replay past it"
                        ) from e
                    log.warning("tolerating torn final line of %s at byte %d", path, line_start)
                    self._truncate_pending[path] = line_start
                    return
                yield parsed

    def _replay(self) -> None:
        """Rebuild host metadata and the device index: restore a valid
        snapshot, then replay the failures log from its offset (a tail line
        for a snapshotted key replaces that record in place; new keys append
        in first-seen order, latest version wins), then the patterns log,
        then the tombstones (whose rows are zeroed again)."""
        if self.failures_path.exists():
            tail_offset = self._restore_snapshot()
            latest: Dict[Tuple[str, str], CanonicalFailureRecord] = {}
            order: List[Tuple[str, str]] = []
            for rec in self._iter_log_lines(self.failures_path, tail_offset, _parse_record):
                key = (rec.failure_type, rec.signature_text)
                slot = self._slot_by_key.get(key)
                if slot is not None:  # a snapshot row updated in the tail
                    self._records[slot] = rec
                    self._apps_by_type.setdefault(rec.failure_type, set()).update(rec.affected_apps)
                    if self._mine is not None:
                        # Membership is unchanged; the cluster's app span may widen.
                        self._mine.note_apps(slot, rec.affected_apps)
                    continue
                if key not in latest:
                    order.append(key)
                latest[key] = rec
            if order:
                base = len(self._records)
                for i, key in enumerate(order):
                    rec = latest[key]
                    self._records.append(rec)
                    self._slot_by_key[key] = base + i
                    self._slot_by_id[rec.failure_id] = base + i
                    self._ids_by_type.setdefault(rec.failure_type, []).append(rec.failure_id)
                    self._apps_by_type.setdefault(rec.failure_type, set()).update(rec.affected_apps)
                if min(len(self._records), self._hot_cap()) > self._knn.capacity:
                    # Grow with the rows before the tail; the tail's insert
                    # below lands it in the tiers and on the card.
                    self._rebuild(self._records[:base], rows=len(self._records))
                tail = self._records[base:]
                self._insert_texts_chunked(
                    [r.signature_text for r in tail],
                    np.arange(base, len(self._records), dtype=np.int32),
                    np.asarray([self._type_id(r.failure_type) for r in tail], np.int32),
                )
        if self.patterns_path.exists():
            for p in self._iter_log_lines(
                self.patterns_path, 0, lambda t: PatternEntity.model_validate(json.loads(t))
            ):
                self._merge_pattern_line(p)
        if self.applied_path.exists():
            # The dedup set replays whole (ids only) with the same torn-tail
            # tolerance; a torn final id replays that event once more, an
            # occurrence bump and never a duplicate record.
            n_lines = 0
            for rec in self._iter_log_lines(self.applied_path, 0, json.loads):
                n_lines += 1
                eid = rec.get("id") if isinstance(rec, dict) else None
                if isinstance(eid, str):
                    self._applied_note_locked(eid)
            self._compact_applied_log(n_lines)
        if self.tombstones_path.exists():
            # Net tombstone state replays from byte 0 (compact() rewrites
            # the log to net state). Unknown ids skip with a warning: the
            # failures log can be rewritten or truncated independently.
            for rec in self._iter_log_lines(self.tombstones_path, 0, json.loads):
                if not isinstance(rec, dict):
                    log.warning("non-object tombstone line skipped")
                    continue
                fid = rec.get("id")
                slot = self._slot_by_id.get(fid) if isinstance(fid, str) else None
                if slot is None:
                    log.warning("tombstone line for unknown id %r skipped", fid)
                    continue
                if rec.get("op") == "tomb":
                    self._tombstoned[slot] = str(rec.get("reason", "aged"))
                else:
                    self._tombstoned.pop(slot, None)
            self._tomb_view = None
            if self._tombstoned:
                # The replay above embedded every row; re-zero the tombstoned ones.
                self._zero_device_rows_locked(sorted(self._tombstoned))
            self._g_tombstoned.set(len(self._tombstoned))

    def _compact_applied_log(self, n_lines: int) -> None:
        """Rewrite ``applied_events.jsonl`` to the retained dedup tail, at
        open (single-threaded, no append handle yet): write a temp, then an
        atomic replace, so a crash leaves the old log whole. A temp
        stranded by an earlier crash is removed first."""
        if not self.persist:
            return
        tmp = self.applied_path.with_suffix(".tmp")
        if tmp.exists():
            try:
                tmp.unlink()
                self._m_compact[("applied", "stale_tmp")].inc()
            except OSError as e:
                log.warning("stale %s could not be removed: %s", tmp, e)
        if n_lines <= len(self._applied_events):
            return
        if os.environ.get("KAKVEDA_GFKB_APPLIED_COMPACT", "1") == "0":
            self._m_compact[("applied", "skipped")].inc()
            return
        # The rewrite keeps only fully parsed ids: a torn tail needs no cut.
        self._truncate_pending.pop(self.applied_path, None)
        try:
            with tmp.open("w", encoding="utf-8") as f:
                for eid in self._applied_events:
                    f.write(json.dumps({"id": eid}) + "\n")
            os.replace(tmp, self.applied_path)
            self._m_compact[("applied", "ok")].inc()
            log.info("compacted %s: %d -> %d ids", self.applied_path, n_lines, len(self._applied_events))
        except OSError as e:  # disk trouble: keep the uncompacted log
            log.warning("applied-log compaction skipped: %s", e)
            self._m_compact[("applied", "error")].inc()
            tmp.unlink(missing_ok=True)

    def _bulk_insert_chunked(
        self, sparsify, slots: np.ndarray, tids: np.ndarray, route: bool = True, tiers: bool = True
    ) -> None:
        """Insert rows in 64k chunks; ``sparsify(i, j)`` yields the sparse
        (idx, val) pair of rows [i, j). The rows land in the host tiers
        first (``tiers=False``: a growth's re-embed, which the tiers
        already hold); only slots below the hot cap go onto the card.
        ``route=False`` skips the router's assignment (a restore installs
        the snapshot's router instead)."""
        hot = self._hot_cap()
        for i in range(0, len(slots), _CHUNK):
            j = min(i + _CHUNK, len(slots))
            sp_i, sp_v = sparsify(i, j)
            if tiers:
                self._store_tier_rows(slots[i:j], sp_i, sp_v, route=route)
            dev = slots[i:j] < hot
            if dev.any():
                self._knn.insert_sparse(
                    self._emb, self._valid, self._types, sp_i[dev], sp_v[dev], slots[i:j][dev], tids[i:j][dev]
                )

    def _insert_texts_chunked(
        self, texts: List[str], slots: np.ndarray, tids: np.ndarray, tiers: bool = True
    ) -> None:
        """Signature texts (replay, growth): encoded sparse per chunk."""
        self._bulk_insert_chunked(
            lambda i, j: self.featurizer.encode_batch_sparse(texts[i:j]), slots, tids, tiers=tiers
        )

    def _mine_after_replay(self) -> None:
        """The cluster state must cover exactly the replayed rows or be
        stale: a full replay, or a tail with rows the snapshot never saw,
        leaves a gap that only a full sweep closes."""
        m = self._mine
        if m is None:
            return
        if self._records and m.n_rows != len(self._records):
            m.mark_stale("replayed rows not covered by restored cluster state")
        nc = m.n_clusters_cached()
        if nc is not None:
            self._m_mine_clusters.set(nc)

    # --- snapshot / restore --------------------------------------------

    # The reference's format: v2 sparse rows, v3 the payload checksum, v4
    # the mining labels (clusters.npy, own checksum: a bad file costs one
    # full re-mine), v5 the tier router (centroids.npy + tier_assign.npy +
    # a "tiers" section with its own checksum: a bad file costs one router
    # rebuild from the restored rows). Other versions replay in full.
    _SNAPSHOT_VERSION = 5
    _TAIL_HASH_BYTES = 4096
    _SNAPSHOT_PAYLOAD = ("sparse_idx.npy", "sparse_val.npy", "records.jsonl")

    @classmethod
    def _snapshot_checksum(cls, sd: Path) -> str:
        """sha256 over the payload files in manifest order: the content
        checksum both snapshot() and _restore_snapshot() compute."""
        h = hashlib.sha256()
        for name in cls._SNAPSHOT_PAYLOAD:
            with (sd / name).open("rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            h.update(b"\x00")
        return h.hexdigest()

    def _snapshot_dir(self) -> Path:
        return self.data_dir / "snapshot"

    def _log_prefix_hash(self, offset: int) -> str:
        """sha256 of the last ≤4KB of failures.jsonl before ``offset``: the
        log the snapshot covered is still the same log."""
        start = max(0, offset - self._TAIL_HASH_BYTES)
        with self.failures_path.open("rb") as f:
            f.seek(start)
            return hashlib.sha256(f.read(offset - start)).hexdigest()

    def snapshot(self) -> Path:
        """Write an atomic point-in-time snapshot: slot-ordered sparse rows
        (no re-embed on restore; the hot rows from the card, the overflow
        rows from the host tiers), the records as ``model_dump_json`` lines,
        the mining labels, the tier router, and a manifest pinning the
        covered failures.jsonl byte range. A consistent view (records, an
        on-card copy of the hot rows, the labels, the router) is taken
        under the data lock; the host transfer and the disk write run
        outside it. Walls by stage land in
        ``lifecycle_info()["snapshot"]``."""
        if not self.persist:
            raise SnapshotError("snapshot requires a persistent GFKB (persist=True)")
        with self._snapshot_write_lock:
            t0 = time.perf_counter()
            with self._lock:
                self._drain_pending_embeds()
                # Fold pending deltas in: the labels must cover exactly the
                # persisted rows.
                self._mine_drain_locked()
                self._flush_logs()
                records = list(self._records)
                n = len(records)
                mine_labels = mine_threshold = None
                m = self._mine
                if m is not None and not m.stale and m.n_rows == n:
                    mine_labels = m.labels()
                    mine_threshold = m.threshold
                offset = self.failures_path.stat().st_size if self.failures_path.exists() else 0
                log_hash = self._log_prefix_hash(offset) if offset else ""
                generation = self._generation
                hot_n = min(n, self._hot_cap())
                router_state = self._tiers.export_router_state() if self._tiers is not None else None
                knn = self._knn
                tc = time.perf_counter()
                emb_copy = knn.device_copy(self._emb, hot_n)
            self._sync()
            t1 = time.perf_counter()
            # Sparsified on the device, 64k rows at a time: only the
            # (idx, val) pairs cross to the host.
            parts = [knn.sparse_rows(emb_copy, i, min(i + _CHUNK, hot_n)) for i in range(0, hot_n, _CHUNK)]
            del emb_copy
            if n > hot_n:
                # Overflow rows never reached the card: their pairs come
                # from the host tiers (warm RAM or cold shards).
                parts.append(self._tiers._rows_block(np.arange(hot_n, n, dtype=np.int64)))
            t2 = time.perf_counter()
            sp_idx, sp_val = _stack_sparse(parts, knn.dim)
            del parts
            t3 = time.perf_counter()
            sd = self._snapshot_dir()
            tmp = Path(tempfile.mkdtemp(dir=self.data_dir, prefix=".snapshot-"))
            old = self.data_dir / f".snapshot-old-{os.getpid()}-{id(tmp)}"
            try:
                np.save(tmp / "sparse_idx.npy", sp_idx)
                np.save(tmp / "sparse_val.npy", sp_val)
                with (tmp / "records.jsonl").open("w", encoding="utf-8") as f:
                    f.writelines(r.model_dump_json() + "\n" for r in records)
                # A fault here exercises the except path: tmp goes, the
                # previous snapshot stays installed.
                self._fault_snapshot.fire()
                manifest = {
                    "version": self._SNAPSHOT_VERSION,
                    "n": n,
                    "dim": knn.dim,
                    "log_offset": offset,
                    "log_hash": log_hash,
                    "checksum": self._snapshot_checksum(tmp),
                    "compact": {
                        "generation": self._compact_generation,
                        "ts": self._last_compact_ts,
                    },
                }
                if mine_labels is not None:
                    np.save(tmp / "clusters.npy", mine_labels.astype(np.int32))
                    manifest["mine"] = {
                        "n": n,
                        "threshold": mine_threshold,
                        "checksum": hashlib.sha256((tmp / "clusters.npy").read_bytes()).hexdigest(),
                    }
                if router_state is not None:
                    cent, assign = router_state
                    np.save(tmp / "centroids.npy", cent.astype(np.float32))
                    np.save(tmp / "tier_assign.npy", assign.astype(np.int32))
                    h = hashlib.sha256((tmp / "centroids.npy").read_bytes())
                    h.update((tmp / "tier_assign.npy").read_bytes())
                    manifest["tiers"] = {"n": n, "hot": hot_n, "checksum": h.hexdigest()}
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                # Swap by renames under the data lock (serialized with
                # reload()); a crash mid-swap leaves at worst no snapshot.
                with self._lock:
                    if self._generation != generation:
                        raise SnapshotError(
                            "GFKB was reloaded during snapshot; snapshot aborted — retry"
                        )
                    if sd.exists():
                        sd.rename(old)
                    tmp.rename(sd)
                shutil.rmtree(old, ignore_errors=True)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                if old.exists() and not sd.exists():
                    old.rename(sd)  # restore the previous snapshot
                raise
            t4 = time.perf_counter()
            self._snapshot_info = {
                "rows": n,
                "bytes": sum(p.stat().st_size for p in sd.iterdir()),
                "seconds": {
                    "capture": tc - t0, "device_copy": t1 - tc, "sparse_gather": t2 - t1,
                    "stack": t3 - t2, "write": t4 - t3, "total": t4 - t0,
                },
            }
            return sd

    def _restore_snapshot(self) -> int:
        """Load a valid snapshot; returns the failures.jsonl byte offset to
        replay from (0 = no usable snapshot, full replay). Every row of the
        payload goes into the host tiers, in 64k-row chunks, and the rows
        below the hot cap onto the card; then the router is installed."""
        sd = self._snapshot_dir()
        manifest_path = sd / "manifest.json"
        if not manifest_path.exists():
            return 0

        def refuse(reason: str) -> int:
            log.warning("snapshot at %s not restored (%s); replaying the full log", sd, reason)
            self._restore_info = {"rows": 0, "reason": reason}
            return 0

        t0 = time.perf_counter()
        try:
            manifest = json.loads(manifest_path.read_text())
            if manifest.get("version") != self._SNAPSHOT_VERSION:
                return refuse(f"version {manifest.get('version')}")
            if manifest.get("dim") != self._knn.dim:
                return refuse(f"dim {manifest.get('dim')}")
            offset = int(manifest.get("log_offset", 0))
            size = self.failures_path.stat().st_size if self.failures_path.exists() else 0
            if size < offset:
                return refuse("log shorter than the snapshot's offset")
            if offset and self._log_prefix_hash(offset) != manifest.get("log_hash"):
                return refuse("log rewritten under the snapshot")
            if self._snapshot_checksum(sd) != manifest.get("checksum"):
                return refuse("content checksum mismatch")
            t1 = time.perf_counter()
            cm = manifest.get("compact") or {}
            self._compact_generation = int(cm.get("generation", 0))
            self._last_compact_ts = float(cm.get("ts", 0.0) or 0.0)
            n = int(manifest["n"])
            with (sd / "records.jsonl").open("r", encoding="utf-8") as f:
                records = [_parse_record(line) for line in f if line.strip()]
            if len(records) != n:
                return refuse(f"{len(records)} records for n={n}")
            t2 = time.perf_counter()
            sp_idx = np.load(sd / "sparse_idx.npy")
            sp_val = np.load(sd / "sparse_val.npy")
            if (
                sp_idx.shape != sp_val.shape
                or sp_idx.shape[0] != n
                or sp_idx.dtype != np.int32
                or sp_val.dtype != np.float32
            ):
                return refuse("payload shape or dtype")
        except Exception as e:  # noqa: BLE001 — any corruption ⇒ full replay
            return refuse(f"{type(e).__name__}: {e}")
        t3 = time.perf_counter()
        # Grow before installing the records: a growth re-embeds the
        # current records, which is the work the snapshot skips.
        if min(n, self._hot_cap()) > self._knn.capacity:
            self._rebuild([], rows=n)
        self._records = records
        self._slot_by_key = {(r.failure_type, r.signature_text): i for i, r in enumerate(records)}
        self._slot_by_id = {r.failure_id: i for i, r in enumerate(records)}
        for r in records:
            self._ids_by_type.setdefault(r.failure_type, []).append(r.failure_id)
            self._apps_by_type.setdefault(r.failure_type, set()).update(r.affected_apps)
        if n:
            tids = np.asarray([self._type_id(r.failure_type) for r in records], np.int32)
            # route=False: the snapshot's router installs after the rows.
            self._bulk_insert_chunked(
                lambda i, j: (sp_idx[i:j], sp_val[i:j]), np.arange(n, dtype=np.int32), tids,
                route=False,
            )
            self._sync()
        t4 = time.perf_counter()
        self._mine_restore(sd, manifest)
        t5 = time.perf_counter()
        router = self._restore_tiers(sd, manifest)
        t6 = time.perf_counter()
        self._restore_info = {
            "rows": n,
            "hot": min(n, self._hot_cap()),
            "log_offset": offset,
            "router": router,
            "seconds": {
                "verify": t1 - t0, "records": t2 - t1, "payload": t3 - t2,
                "insert": t4 - t3, "labels": t5 - t4, "router": t6 - t5,
            },
        }
        log.info("restored a snapshot of %d rows from %s; replaying the log from byte %d",
                 n, sd, offset)
        return offset

    def _restore_tiers(self, sd: Path, manifest: dict) -> Optional[str]:
        """Install the snapshot's router state; returns "restored",
        "rebuilt" or None (no router). Never trusts an unverified
        partition: a missing section, a checksum mismatch or a shape error
        costs one router rebuild from the restored rows (routing is derived
        state), never a full log replay and never a silent misroute."""
        t = self._tiers
        if t is None or t.router is None:
            return None
        try:
            mf = manifest.get("tiers")
            if not mf:
                raise ValueError("snapshot carries no tier state")
            h = hashlib.sha256((sd / "centroids.npy").read_bytes())
            h.update((sd / "tier_assign.npy").read_bytes())
            if h.hexdigest() != mf.get("checksum"):
                raise ValueError("tier-state checksum mismatch")
            cent = np.load(sd / "centroids.npy")
            assign = np.load(sd / "tier_assign.npy")
            if len(assign) != len(self._records) or int(mf.get("n", -1)) != len(assign):
                raise ValueError("tier-state shape mismatch")
            t.restore_router_state(cent, assign)
            return "restored"
        except Exception as e:  # noqa: BLE001 — degrade, never desync
            log.warning(
                "tier-router restore failed (%s: %s); rebuilding the coarse partition "
                "from the restored rows", type(e).__name__, e,
            )
            t.rebuild_router()
            return "rebuilt"

    def _mine_restore(self, sd: Path, manifest: dict) -> None:
        """Seed the cluster state from the snapshot's labels. Never installs
        unverified labels: a missing or mismatched field, a checksum failure
        or an injected fault leaves the state stale (one full re-mine)."""
        m = self._mine
        if m is None:
            return
        try:
            self._fault_mine.fire()
            mf = manifest.get("mine")
            if not mf:
                m.mark_stale("snapshot carries no cluster state")
                return
            raw = (sd / "clusters.npy").read_bytes()
            if hashlib.sha256(raw).hexdigest() != mf.get("checksum"):
                raise ValueError("cluster-state checksum mismatch")
            labels = np.load(io.BytesIO(raw))
            if (
                labels.shape != (len(self._records),)
                or labels.dtype != np.int32
                or int(mf.get("n", -1)) != len(self._records)
            ):
                raise ValueError("cluster-state shape mismatch")
            if float(mf.get("threshold", -1.0)) != m.threshold:
                m.mark_stale("snapshot threshold differs from configured")
                return
            m.seed(
                labels,
                [(r.failure_type, r.failure_id, r.affected_apps) for r in self._records],
            )
        except Exception as e:  # noqa: BLE001 — degrade, never desync
            log.warning(
                "cluster-state restore failed (%s: %s); first mine will run a full sweep",
                type(e).__name__, e,
            )
            m.mark_stale(f"restore failed: {type(e).__name__}")

    def reload(self) -> None:
        """Drop all in-memory and device state and replay the logs: needed
        after an external rewrite of the JSONL files. The snapshot describes
        the old state and is deleted; an in-flight snapshot sees the
        generation bump at its swap and aborts."""
        with self._lock:
            self._generation += 1
            shutil.rmtree(self._snapshot_dir(), ignore_errors=True)
            # An external rewrite may have replaced the files (new inodes).
            self._close_locked()
            self._emb, self._valid = self._knn.alloc()
            self._types = self._knn.alloc_i32()
            self._type_ids = {}
            self._records = []
            self._slot_by_key = {}
            self._slot_by_id = {}
            self._pattern_state = {}
            self._ids_by_type = {}
            self._apps_by_type = {}
            self._tombstoned = {}
            self._tomb_view = frozenset()
            self._truncate_pending = {}
            # The tiers (cold shards included) describe pre-rewrite slots.
            if self._tiers is not None:
                self._tiers.reset()
            if self._mine is not None:
                self._mine = ClusterState(threshold=self._mine.threshold, k=self._mine.k)
            self._mine_pending.clear()
            self._match_cache.clear()
            if self.persist:
                self._replay()
            self._mine_after_replay()

    # ------------------------------------------------------------------
    # failures
    # ------------------------------------------------------------------

    @property
    def count(self) -> int:
        return len(self._records)

    def list_failures(self) -> List[CanonicalFailureRecord]:
        with self._lock:
            return list(self._records)

    def list_failures_page(
        self, offset: int = 0, limit: int = 50, newest_first: bool = True
    ) -> List[CanonicalFailureRecord]:
        """A page of records without copying the whole list."""
        with self._lock:
            n = len(self._records)
            if newest_first:
                hi = max(0, n - offset)
                lo = max(0, hi - limit)
                return self._records[lo:hi][::-1]
            return self._records[offset : offset + limit]

    def records_and_embeddings(self) -> Tuple[List[CanonicalFailureRecord], torch.Tensor]:
        """Consistent (records, slot-aligned embedding rows), taken once
        every appended record's scatter has landed. Below the hot cap the
        rows are the index's own ``emb[:n]`` on the device (slot = row):
        only a lifecycle write (a tombstone zeroing, a resurrection) or a
        reload changes them. Past it the overflow rows, which the card never
        held, are densified from the host tiers onto the device (in the
        index's dtype, as an insert would store them) and appended."""
        with self._lock:
            self._drain_pending_embeds()
            records = list(self._records)
            hot_n = min(len(records), self._hot_cap())
            if len(records) == hot_n:
                return records, self._emb[:hot_n]
            o_idx, o_val = self._tiers._rows_block(np.arange(hot_n, len(records), dtype=np.int64))
            dense = self._knn.densify(
                to_device(o_idx, np.int32, self.device), to_device(o_val, np.float32, self.device)
            )
            return records, torch.cat([self._emb[:hot_n], dense.to(self._emb.dtype)])

    def _drain_pending_embeds(self) -> None:
        """Wait (the lock held, released while waiting) until no appended
        record is still awaiting its scatter."""
        while self._pending_embeds > 0:
            self._embeds_cv.wait(timeout=30.0)

    def get_failure(self, failure_id: str) -> Optional[CanonicalFailureRecord]:
        with self._lock:
            slot = self._slot_by_id.get(failure_id)
            return self._records[slot] if slot is not None else None

    def all_apps(self) -> List[str]:
        """Sorted union of affected apps."""
        with self._lock:
            out: set = set()
            for apps in self._apps_by_type.values():
                out |= apps
            return sorted(out)

    def type_aggregate(self, failure_type: str) -> Tuple[List[str], List[str]]:
        """(failure_ids in insertion order, sorted affected apps) for a type."""
        with self._lock:
            return (
                list(self._ids_by_type.get(failure_type, [])),
                sorted(self._apps_by_type.get(failure_type, set())),
            )

    def _type_id(self, failure_type: str) -> int:
        """Dense id for a failure type (assigned on first sight)."""
        tid = self._type_ids.get(failure_type)
        if tid is None:
            tid = self._type_ids[failure_type] = len(self._type_ids)
        return tid

    def _rebuild(self, records: Sequence[CanonicalFailureRecord], rows: int = 0) -> None:
        """Capacity growth: allocate an index of the doubled capacity (at
        least ``rows``, at most the hot cap's worth) that holds the hot
        ones of ``records`` (re-embedded in 64k chunks, tombstoned rows
        zeroed again) and swap it in. The host tiers already hold every
        row. Callers hold the lock or run single-threaded (start-up)."""
        hot = self._hot_cap()
        records = records[:hot]
        need = min(max(len(records), rows), hot)
        cap = self._knn.capacity
        while cap < need:
            cap *= 2
        if cap > MAX_CAPACITY:
            raise ValueError(f"GFKB of {need} hot records exceeds {MAX_CAPACITY} rows")
        if cap != self._knn.capacity:
            self._knn = Knn(cap, self._knn.dim, k=self.top_k, device=self.device)
        self._emb, self._valid = self._knn.alloc()
        self._types = self._knn.alloc_i32()
        self._insert_texts_chunked(
            [r.signature_text for r in records],
            np.arange(len(records), dtype=np.int32),
            np.asarray([self._type_id(r.failure_type) for r in records], np.int32),
            tiers=False,
        )
        if self._tombstoned:
            self._zero_device_rows_locked(sorted(self._tombstoned))

    def _embed_new_slots(self, slots: List[int], texts: List[str], tids: List[int], gen: int) -> None:
        """Embed new (or resurrected) records (host work, off the lock),
        scatter them in — growing the index when the records outran its
        capacity — then attach them to the mining state. A reload since the
        append (generation bump) makes the slots meaningless: its replay
        embedded every row. Callers counted the batch in
        ``_pending_embeds`` under the lock; it is released here."""
        try:
            sp_idx, sp_val = self.featurizer.encode_batch_sparse(texts)
            arr_slots = np.asarray(slots, np.int32)
            with self._lock:
                if self._generation != gen:
                    return
                # The host tiers first: a scatter that dies on a lost card
                # still leaves degraded-mode matching complete, and slots
                # past the hot cap live only there.
                self._store_tier_rows(arr_slots, sp_idx, sp_val)
                hot = self._hot_cap()
                if min(len(self._records), hot) > self._knn.capacity:
                    self._rebuild(self._records)  # re-embeds the hot ones of these rows too
                else:
                    dev = arr_slots < hot
                    if dev.any():
                        with profiling.annotate("gfkb.insert"):
                            self._knn.insert_sparse(
                                self._emb, self._valid, self._types, sp_idx[dev], sp_val[dev],
                                arr_slots[dev], np.asarray(tids, np.int32)[dev],
                            )
            self._mine_attach_new(slots, texts, sp_idx, sp_val, gen)
        finally:
            with self._lock:
                self._pending_embeds -= 1
                self._embeds_cv.notify_all()

    def _new_record_locked(self, item: dict, now, validate: bool) -> CanonicalFailureRecord:
        fields = dict(
            failure_id=f"F-{len(self._records) + 1:04d}",
            version=1,
            created_at=now,
            updated_at=now,
            failure_type=item["failure_type"],
            root_cause=item.get("root_cause"),
            context_signature=item.get("context_signature") or {},
            impact_severity=Severity(item["impact_severity"]),
            resolution=item.get("resolution"),
            occurrences=1,
            affected_apps=list(item.get("affected_apps") or [item["app_id"]]),
            signature_text=item["signature_text"],
        )
        rec = (
            CanonicalFailureRecord(**fields)
            if validate
            else CanonicalFailureRecord.model_construct(**fields)
        )
        slot = len(self._records)
        self._records.append(rec)
        self._slot_by_key[(rec.failure_type, rec.signature_text)] = slot
        self._slot_by_id[rec.failure_id] = slot
        self._ids_by_type.setdefault(rec.failure_type, []).append(rec.failure_id)
        self._apps_by_type.setdefault(rec.failure_type, set()).add(item["app_id"])
        if self._mine is not None and not self._mine.stale:
            self._mine.add_row(slot, rec.failure_type, rec.failure_id, list(rec.affected_apps))
        return rec

    def _bump_record_locked(self, slot: int, item: dict, now) -> CanonicalFailureRecord:
        rec = self._records[slot].model_copy(deep=True)
        rec.version += 1
        rec.updated_at = now
        rec.occurrences += 1
        apps = item.get("affected_apps") or [item["app_id"]]
        for app in apps:
            if app not in rec.affected_apps:
                rec.affected_apps.append(app)
            self._apps_by_type.setdefault(rec.failure_type, set()).add(app)
        if self._mine is not None:
            self._mine.note_apps(slot, apps)
        rec.root_cause = item.get("root_cause") or rec.root_cause
        rec.resolution = item.get("resolution") or rec.resolution
        rec.context_signature = item.get("context_signature") or rec.context_signature
        self._records[slot] = rec
        return rec

    def upsert_failure(
        self,
        *,
        failure_type: str,
        signature_text: str,
        app_id: str,
        impact_severity: Severity,
        context_signature: Optional[dict] = None,
        root_cause: Optional[str] = None,
        resolution: Optional[str] = None,
    ) -> Tuple[CanonicalFailureRecord, bool]:
        """Versioned upsert of one failure; returns (record, created). An
        update of a tombstoned record resurrects it (organic traffic)."""
        item = {
            "failure_type": failure_type,
            "signature_text": signature_text,
            "app_id": app_id,
            "impact_severity": Severity(impact_severity).value,
            "context_signature": context_signature,
            "root_cause": root_cause,
            "resolution": resolution,
        }
        with self._lock:
            now = utcnow()
            gen = self._generation
            slot = self._slot_by_key.get((failure_type, signature_text))
            created = slot is None
            revived = False
            if created:
                rec = self._new_record_locked(item, now, validate=True)
                slot = len(self._records) - 1
                tid = self._type_id(failure_type)
            else:
                rec = self._bump_record_locked(slot, item, now)
                if slot in self._tombstoned:
                    # Durable "live" line; the slot re-embeds below (its
                    # device row was zeroed at tombstone time).
                    self._resurrect_locked(slot, rec)
                    tid = self._type_id(failure_type)
                    revived = True
            need_embed = created or revived
            self._append_line(
                self.failures_path, json.dumps(rec.model_dump(mode="json"), ensure_ascii=False)
            )
            self._flush_logs()
            if need_embed:
                self._pending_embeds += 1
        if need_embed:
            self._embed_new_slots([slot], [signature_text], [tid], gen)
        return rec, created

    def _applied_note_locked(self, event_id: str) -> None:
        """Record an applied replication event id in the bounded dedup set
        (caller holds ``_lock``, or is the single-threaded open)."""
        self._applied_events[event_id] = True
        self._applied_events.move_to_end(event_id)
        while len(self._applied_events) > self._applied_max:
            self._applied_events.popitem(last=False)

    def apply_replication(self, rows: Sequence[dict], event_id: str) -> int:
        """Apply one bus-replicated ingest event through the organic insert
        path, idempotently by event id: redelivery and DLQ replay of an
        applied event are no-ops. Returns the rows applied (0 on dedup)."""
        out = self.upsert_failures_batch(rows, event_id=event_id)
        if out:
            self._m_rep_applied.inc()
        else:
            self._m_rep_dedup.inc()
        return len(out)

    @staticmethod
    def shard_key_of(rec: CanonicalFailureRecord) -> str:
        """A record's ownership shard key: the app that created it
        (``affected_apps[0]``), its signature when it has none. Agrees with
        ``fleet/ownership.shard_key_of_row``."""
        return rec.affected_apps[0] if rec.affected_apps else rec.signature_text

    def shard_key_counts(self) -> Dict[str, int]:
        """Resident rows per shard key (tombstoned rows excluded)."""
        out: Dict[str, int] = {}
        with self._lock:
            for slot, rec in enumerate(self._records):
                if slot in self._tombstoned:
                    continue
                k = self.shard_key_of(rec)
                out[k] = out.get(k, 0) + 1
        return out

    def export_rows(self, since: int = 0) -> Tuple[List[dict], int]:
        """The record range ``[since, count)`` as replication rows (with
        their full ``affected_apps``), plus the count at export time: the
        range migration ships the first call's rows, then drains from the
        returned watermark. Slots only append, so a slot range is a
        consistent delta cursor. Tombstoned rows are left out. Receivers
        re-featurize the signatures (deterministic), so no vectors ship."""
        with self._lock:
            recs = [r for i, r in enumerate(self._records[since:], start=since) if i not in self._tombstoned]
            count = len(self._records)
        rows = [
            {
                "failure_type": rec.failure_type,
                "root_cause": rec.root_cause,
                "context_signature": dict(rec.context_signature or {}),
                "impact_severity": rec.impact_severity.value
                if hasattr(rec.impact_severity, "value") else rec.impact_severity,
                "resolution": rec.resolution,
                "signature_text": rec.signature_text,
                "app_id": self.shard_key_of(rec),
                "affected_apps": list(rec.affected_apps),
            }
            for rec in recs
        ]
        return rows, count

    def upsert_failures_batch(
        self, items: Sequence[dict], event_id: Optional[str] = None
    ) -> List[Tuple[CanonicalFailureRecord, bool]]:
        """Batched upsert for the streaming-ingest path: new (and
        resurrected) signatures are embedded in one featurizer call and
        written in one device scatter. ``event_id`` (a replication apply):
        an applied id makes the batch a no-op; otherwise the id appends to
        its log after the row lines, so a crash between the two replays the
        rows on redelivery (an occurrence bump) rather than losing them.
        The size/age compaction trigger rides this cadence (on a background
        thread)."""
        out = self._upsert_failures_batch(items, event_id)
        self._maybe_auto_compact()
        return out

    def _upsert_failures_batch(
        self, items: Sequence[dict], event_id: Optional[str] = None
    ) -> List[Tuple[CanonicalFailureRecord, bool]]:
        out: List[Tuple[CanonicalFailureRecord, bool]] = []
        new_slots: List[int] = []
        new_texts: List[str] = []
        new_tids: List[int] = []
        with self._lock:
            if event_id is not None and event_id in self._applied_events:
                return []
            gen = self._generation
            now = utcnow()
            for item in items:
                slot = self._slot_by_key.get((item["failure_type"], item["signature_text"]))
                if slot is None:
                    rec = self._new_record_locked(item, now, validate=False)
                    new_slots.append(len(self._records) - 1)
                    new_texts.append(rec.signature_text)
                    new_tids.append(self._type_id(rec.failure_type))
                    out.append((rec, True))
                else:
                    if event_id is not None and slot in self._tombstoned:
                        # Lifecycle fence: a replicated row re-carrying a
                        # tombstoned signature drops; only an organic
                        # upsert resurrects.
                        self._m_rep_fenced.inc()
                        continue
                    rec = self._bump_record_locked(slot, item, now)
                    if slot in self._tombstoned:
                        self._resurrect_locked(slot, rec)
                        new_slots.append(slot)
                        new_texts.append(rec.signature_text)
                        new_tids.append(self._type_id(rec.failure_type))
                    out.append((rec, False))
                self._append_line(self.failures_path, rec.model_dump_json())
            if event_id is not None:
                self._applied_note_locked(event_id)
                self._append_line(self.applied_path, json.dumps({"id": event_id}))
            self._flush_logs()
            if new_slots:
                self._pending_embeds += 1
        if new_slots:
            self._embed_new_slots(new_slots, new_texts, new_tids, gen)
        return out

    # ------------------------------------------------------------------
    # lifecycle: row aging, duplicate collapse, log compaction
    # ------------------------------------------------------------------

    @staticmethod
    def _fsync_dir(path: Path) -> None:
        """fsync a directory so a completed rename is durable (best effort)."""
        try:
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass

    def _zero_device_rows_locked(self, slots) -> None:
        """Overwrite device rows with zeros (pad-only sparse rows: the
        scatter's set semantics wipe the row) and un-type them (tid -1), so
        a tombstoned row can neither score nor pass the type pre-filter.
        Caller holds ``_lock`` (or is the single-threaded replay)."""
        arr = np.asarray(sorted(int(s) for s in slots), np.int32)
        arr = arr[arr < min(self._knn.capacity, self._hot_cap())]
        if not len(arr):
            return
        sp_idx = np.full((len(arr), 1), self._knn.dim, np.int32)
        sp_val = np.zeros((len(arr), 1), np.float32)
        self._knn.insert_sparse(
            self._emb, self._valid, self._types, sp_idx, sp_val, arr,
            np.full(len(arr), -1, np.int32),
        )

    def _tombstone_rows_locked(self, slots, reason: str, now: Optional[float] = None) -> List[int]:
        """Durable "tomb" line first, then the state flip, per slot: a
        crash between rows leaves each completed transition replayable and
        the rest not taken. Returns the slots tombstoned (already-tombstoned
        ones are skipped). Caller holds ``_lock`` and zeroes the device
        rows afterwards."""
        wrote: List[int] = []
        ts = now if now is not None else time.time()
        for slot in slots:
            slot = int(slot)
            if slot in self._tombstoned or not 0 <= slot < len(self._records):
                continue
            try:
                self._fault_tombstone.fire()
                self._append_jsonl(
                    self.tombstones_path,
                    {"op": "tomb", "id": self._records[slot].failure_id, "reason": reason, "ts": ts},
                )
            except (OSError, _faults.FaultInjected) as e:
                # Durable before visible: a transition that never hit the
                # disk never happened; the row stays live and the pass
                # stops (IO trouble is file-wide).
                log.warning("tombstone write failed after %d rows (%s: %s)",
                            len(wrote), type(e).__name__, e)
                break
            self._tombstoned[slot] = reason
            self._m_tombstone[reason].inc()
            wrote.append(slot)
        if wrote:
            self._tomb_view = None
            self._flush_logs()
            self._g_tombstoned.set(len(self._tombstoned))
        return wrote

    def _resurrect_locked(self, slot: int, rec: CanonicalFailureRecord) -> None:
        """An organic upsert of a tombstoned slot brings it back: durable
        "live" line, then the state flip. Caller holds ``_lock`` and
        re-embeds the slot."""
        self._append_jsonl(
            self.tombstones_path, {"op": "live", "id": rec.failure_id, "ts": time.time()}
        )
        self._tombstoned.pop(slot, None)
        self._tomb_view = None
        self._m_tombstone["resurrected"].inc()
        self._g_tombstoned.set(len(self._tombstoned))

    def age_rows(self, ttl_s: Optional[float] = None, now: Optional[float] = None) -> dict:
        """TTL demotion: tombstone every live row whose last version write
        predates ``now - ttl_s`` (``KAKVEDA_GFKB_AGE_TTL_S``; 0 = off).
        Tombstoning is terminal but resident (slots, ids and keys stay);
        reclaiming log bytes is :meth:`compact`'s job. ``now`` is
        injectable. Slots in the cold tier's promote-LRU are exempt: live
        queries paged them in recently, which a record's ``updated_at``
        (moved only by writes) does not show."""
        if ttl_s is None:
            ttl_s = float(os.environ.get("KAKVEDA_GFKB_AGE_TTL_S", "0"))
        if ttl_s <= 0:
            return {"tombstoned": 0, "ttl_s": ttl_s}
        ts = now if now is not None else time.time()
        with self._lock:
            exempt = self._tiers.recently_promoted_slots() if self._tiers is not None else set()
            victims = [
                slot
                for slot, rec in enumerate(self._records)
                if slot not in self._tombstoned
                and slot not in exempt
                and ts - rec.updated_at.timestamp() > ttl_s
            ]
            wrote = self._tombstone_rows_locked(victims, "aged", now=ts)
            if wrote:
                self._zero_device_rows_locked(wrote)
        return {"tombstoned": len(wrote), "ttl_s": ttl_s, "exempt": len(exempt)}

    def collapse_duplicates(self, min_cluster: Optional[int] = None) -> dict:
        """Near-duplicate collapse over the mining clusters: each cluster
        with ≥ ``min_cluster`` live members (``KAKVEDA_GFKB_DUP_COLLAPSE``)
        keeps its smallest live slot, folds the others' occurrences and
        apps into it by a version-bump log line, and tombstones them. A
        stale or behind state collapses nothing."""
        if min_cluster is None:
            min_cluster = int(os.environ.get("KAKVEDA_GFKB_DUP_COLLAPSE", "0"))
        out = {"collapsed": 0, "clusters": 0, "min_cluster": min_cluster}
        if min_cluster <= 1:
            return out
        with self._lock:
            m = self._mine
            if m is None:
                out["reason"] = "incremental mining disabled"
                return out
            self._mine_drain_locked()
            if m.stale or m.n_rows != len(self._records):
                out["reason"] = "mine state stale or behind"
                return out
            now = utcnow()
            for exemplar, victims in collapse_groups(m.labels(), min_cluster, exclude=self._tombstoned):
                ex = self._records[exemplar].model_copy(deep=True)
                ex.version += 1
                ex.updated_at = now
                for v in victims:
                    vr = self._records[v]
                    ex.occurrences += vr.occurrences
                    for app in vr.affected_apps:
                        if app not in ex.affected_apps:
                            ex.affected_apps.append(app)
                self._apps_by_type.setdefault(ex.failure_type, set()).update(ex.affected_apps)
                m.note_apps(exemplar, list(ex.affected_apps))
                self._records[exemplar] = ex
                self._append_line(self.failures_path, ex.model_dump_json())
                wrote = self._tombstone_rows_locked(victims, "collapsed")
                if wrote:
                    self._zero_device_rows_locked(wrote)
                out["collapsed"] += len(wrote)
                out["clusters"] += 1
            self._flush_logs()
        return out

    def compact(self) -> dict:
        """Checkpoint+delta rewrite of the failures log: a fresh snapshot,
        then failures.jsonl rewritten to only the bytes after it, and the
        tombstone log to net state. The swap is fenced by the manifest
        (log_offset 0, generation bump), which swaps by temp + fsync +
        rename before the log does, so a crash at any byte leaves a
        (manifest, log) pair that replays to the pre- or post-compaction
        state: before the manifest swap the old manifest covers the old log;
        between the swaps offset 0 replays the full old log over the
        snapshot (latest-wins converges); after, it replays the delta.
        ``KAKVEDA_GFKB_COMPACT=0`` refuses (append-only, bit for bit)."""
        if not self.persist:
            raise SnapshotError("compaction requires a persistent GFKB (persist=True)")
        if os.environ.get("KAKVEDA_GFKB_COMPACT", "1") == "0":
            self._m_compact[("failures", "skipped")].inc()
            return {"compacted": False, "reason": "KAKVEDA_GFKB_COMPACT=0"}
        stale = self.failures_path.with_suffix(".compact-tmp")
        if stale.exists():
            # A crash between the delta write and the swap strands it; it is
            # never valid input.
            try:
                stale.unlink()
                self._m_compact[("failures", "stale_tmp")].inc()
            except OSError as e:
                log.warning("stale %s could not be removed: %s", stale, e)
        with self._snapshot_write_lock:
            try:
                self.snapshot()
                out = self._compact_swap_locked()
            except SnapshotError:
                self._m_compact[("failures", "skipped")].inc()
                raise
            except (OSError, _faults.FaultInjected) as e:
                self._m_compact[("failures", "error")].inc()
                log.error("failures-log compaction failed: %s", e)
                raise
        self._m_compact[("failures", "ok")].inc()
        log.info("compacted %s: %d -> %d bytes (generation %d)",
                 self.failures_path, out["bytes_before"], out["bytes_after"], out["generation"])
        return out

    def _compact_swap_locked(self) -> dict:
        """The fenced swap: the caller holds the snapshot-write lock with
        the fresh snapshot installed; ``_lock`` is taken so no append lands
        between the tail read and the log replace. The append handles are
        closed around the replaces (a held handle appends to the replaced
        inode) and reopen at the next append."""
        with self._lock:
            sd = self._snapshot_dir()
            manifest_path = sd / "manifest.json"
            manifest = json.loads(manifest_path.read_text())
            offset = int(manifest.get("log_offset", 0))
            self._close_locked()
            size = self.failures_path.stat().st_size if self.failures_path.exists() else 0
            with self.failures_path.open("rb") as f:
                f.seek(offset)
                tail = f.read()
            # A torn final line tolerated at replay must not survive into
            # the new log.
            pend = self._truncate_pending.get(self.failures_path)
            if pend is not None and pend >= offset:
                tail = tail[: pend - offset]
            tmp = self.failures_path.with_suffix(".compact-tmp")
            with tmp.open("wb") as f:
                f.write(tail)
                f.flush()
                os.fsync(f.fileno())
            self._fault_compact_delta.fire()
            gen = self._compact_generation + 1
            manifest["log_offset"] = 0
            manifest["log_hash"] = ""
            manifest["compact"] = {"generation": gen, "ts": time.time()}
            mtmp = sd / "manifest.json.tmp"
            with mtmp.open("w", encoding="utf-8") as f:
                f.write(json.dumps(manifest))
                f.flush()
                os.fsync(f.fileno())
            os.replace(mtmp, manifest_path)
            self._fsync_dir(sd)
            # THE FENCE: from here replay starts at byte 0 of whichever file
            # is live at failures.jsonl; both reach the post-state.
            self._fault_compact_fence.fire()
            os.replace(tmp, self.failures_path)
            self._fsync_dir(self.data_dir)
            self._fault_compact_swap.fire()
            self._close_locked()
            self._truncate_pending.pop(self.failures_path, None)
            self._compact_generation = gen
            self._last_compact_ts = time.time()
            n_tomb = self._compact_tombstones_locked()
        return {
            "compacted": True,
            "generation": gen,
            "bytes_before": size,
            "bytes_after": len(tail),
            "checkpoint_rows": int(manifest.get("n", 0)),
            "tombstone_lines": n_tomb,
        }

    def _compact_tombstones_locked(self) -> int:
        """Rewrite the tombstone log to net state (one "tomb" line per
        tombstoned slot) by temp + fsync + rename; a crash mid-rewrite
        keeps the old log, which replays to the same state."""
        if not self._tombstoned and not self.tombstones_path.exists():
            return 0
        lg = self._logs.pop(self.tombstones_path, None)
        if lg is not None:
            lg.close()
        tmp = self.tombstones_path.with_suffix(".compact-tmp")
        try:
            with tmp.open("w", encoding="utf-8") as f:
                for slot in sorted(self._tombstoned):
                    f.write(json.dumps({
                        "op": "tomb",
                        "id": self._records[slot].failure_id,
                        "reason": self._tombstoned[slot],
                        "ts": self._last_compact_ts,
                    }) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.tombstones_path)
            self._truncate_pending.pop(self.tombstones_path, None)
            self._m_compact[("tombstones", "ok")].inc()
        except OSError as e:
            log.warning("tombstone-log compaction skipped: %s", e)
            tmp.unlink(missing_ok=True)
            self._m_compact[("tombstones", "error")].inc()
        return len(self._tombstoned)

    def _maybe_auto_compact(self) -> None:
        """Size/age trigger (``KAKVEDA_GFKB_COMPACT_BYTES`` / ``_AGE_S``,
        0 = off), checked after each ingest batch; the compaction runs on a
        daemon thread, one at a time."""
        if not self.persist or self._compact_inflight:
            return
        if self._compact_bytes <= 0 and self._compact_age_s <= 0:
            return
        if os.environ.get("KAKVEDA_GFKB_COMPACT", "1") == "0":
            return
        try:
            size = self.failures_path.stat().st_size
        except OSError:
            return
        due = self._compact_bytes > 0 and size >= self._compact_bytes
        if not due and self._compact_age_s > 0 and size > 0:
            last = self._last_compact_ts or self._opened_ts
            due = (time.time() - last) >= self._compact_age_s
        if not due:
            return
        with self._lock:
            if self._compact_inflight:
                return
            self._compact_inflight = True

        def _run() -> None:
            try:
                self.compact()
            except Exception as e:  # noqa: BLE001 — never fail or abort ingest
                log.warning("auto-compaction failed (%s: %s)", type(e).__name__, e)
            finally:
                self._compact_inflight = False

        threading.Thread(target=_run, name="kakveda-gfkb-compact", daemon=True).start()

    def lifecycle_info(self) -> dict:
        """Durability posture: tombstone counts by reason, compaction
        generation and time, the failures log's size; and (the port's own
        keys) what the open's snapshot restore and the last snapshot did:
        ``restore`` is None without a snapshot, ``{"rows": 0, "reason"}``
        when one was refused (full replay), else its rows, log offset and
        walls by stage."""
        with self._lock:
            by_reason: Dict[str, int] = {}
            for r in self._tombstoned.values():
                by_reason[r] = by_reason.get(r, 0) + 1
            size = 0
            if self.persist:
                try:
                    size = self.failures_path.stat().st_size
                except OSError:
                    size = 0
            return {
                "tombstoned": len(self._tombstoned),
                "by_reason": by_reason,
                "compact_generation": self._compact_generation,
                "last_compact_ts": self._last_compact_ts,
                "failures_log_bytes": size,
                "restore": self._restore_info,
                "snapshot": self._snapshot_info,
            }

    # ------------------------------------------------------------------
    # host tiers (overflow, degraded mode, restore: one hierarchy)
    # ------------------------------------------------------------------

    def _hot_cap(self) -> int:
        """Logical slots the card's hot tier may hold: unbounded without
        the host tiers (nothing could take an overflow) or with tiering off."""
        if self._tiers is None:
            return 1 << 62
        return self._tiers.cfg.hot_rows

    def _store_tier_rows(self, slots, sp_idx: np.ndarray, sp_val: np.ndarray, route: bool = True) -> None:
        """Land rows in the host tiers (warm RAM, or the cold shards past
        the warm budget) and feed the router's per-batch update
        (``route=False``: a restore installs the persisted router)."""
        if self._tiers is None:
            return
        self._tiers.insert(np.asarray(slots, np.int64), sp_idx, sp_val, route=route)

    def tiers_info(self) -> dict:
        """Residency and routing of the tiers, the warm tier's host bytes
        and the warn queries served degraded (``fallback``)."""
        if self._tiers is None:
            return {"enabled": False, "fallback": self.fallback_warns}
        t = self._tiers
        info = t.info()
        with t.lock:
            warm_bytes = t.warm._idx.nbytes + t.warm._val.nbytes
            cold_bytes = 0
            if t.cold is not None:
                cold_bytes = sum(sh["idx"].nbytes + sh["val"].nbytes for sh in t.cold._shards)
        info.update(
            enabled=True, hot_rows=t.cfg.hot_rows, warm_rows=t.cfg.warm_rows, warm_k=t.warm.k,
            warm_bytes=warm_bytes, cold_bytes=cold_bytes, fallback=self.fallback_warns,
        )
        return info

    def match_batch_fallback(
        self,
        signature_texts: Sequence[str],
        failure_type: Optional[str] = None,
    ) -> Tuple[List[List[FailureMatch]], dict]:
        """Top-k from the host tiers alone: the degraded-mode path. It
        touches no tensor on the card (after a sticky CUDA error every call
        into the context fails). Small corpora take the exact scan; past
        the routing floor each query scores only its ``nprobe`` routed
        candidate lists, exactly; a routing fault serves that query from the
        exact scan. Returns ``(matches, info)`` with the serving ``tier``
        ("warm" or "warm_routed") and ``nprobe``. ``failure_type`` filters
        after the top-k, as :meth:`match_batch` does."""
        global _fallback_total
        if self._tiers is None:
            raise HostFallbackDisabled("host fallback disabled (KAKVEDA_HOST_FALLBACK=0)")
        q_idx, q_val = self.featurizer.encode_batch_sparse(list(signature_texts))
        with self._lock:
            records, n = self._records, len(self._records)  # no copy: see match_batch_info
            if self._tomb_view is None:
                self._tomb_view = frozenset(self._tombstoned)
            tomb = self._tomb_view
        if n == 0:
            return [[] for _ in signature_texts], {"tier": "warm", "nprobe": None}
        out: List[List[FailureMatch]] = []
        routed = False
        # One batched host match: the candidate dedup, the cold tier's
        # coalesced reads and the native scoring run once per warn batch.
        batch = self._tiers.match_host_batch(q_idx, q_val, max(self.top_k, 1))
        for scores, slots, mode in batch:
            routed = routed or mode == "routed"
            row: List[FailureMatch] = []
            for s, slot in zip(scores.tolist(), slots.tolist()):
                if s <= 0.0 or slot >= n or slot in tomb:
                    continue  # padding and tombstoned rows never surface
                rec = records[slot]
                if failure_type and rec.failure_type != failure_type:
                    continue
                row.append(
                    FailureMatch(
                        failure_id=rec.failure_id,
                        version=rec.version,
                        score=min(1.0, max(-1.0, float(s))),
                        failure_type=rec.failure_type,
                        suggested_mitigation=rec.resolution,
                    )
                )
            out.append(row)
        with _fallback_lock:
            self.fallback_warns += len(signature_texts)
            _fallback_total += len(signature_texts)
        self._m_warn_fallback.inc(len(signature_texts))
        info = {
            "tier": "warm_routed" if routed else "warm",
            "nprobe": self._tiers.cfg.nprobe if routed else None,
        }
        return out, info

    # ------------------------------------------------------------------
    # match
    # ------------------------------------------------------------------

    def match(
        self, signature_text: str, failure_type: Optional[str] = None, type_filter: str = "post"
    ) -> List[FailureMatch]:
        return self.match_batch([signature_text], failure_type, type_filter)[0]

    def match_batch(
        self,
        signature_texts: Sequence[str],
        failure_type: Optional[str] = None,
        type_filter: str = "post",
    ) -> List[List[FailureMatch]]:
        return self.match_batch_info(signature_texts, failure_type, type_filter)[0]

    def match_batch_info(
        self,
        signature_texts: Sequence[str],
        failure_type: Optional[str] = None,
        type_filter: str = "post",
    ) -> Tuple[List[List[FailureMatch]], dict]:
        """Top-k matches for a batch of queries (one kernel launch over the
        hot rows), plus serving provenance (``tier``, ``nprobe``).
        ``type_filter="post"`` filters by type after the top-k (the
        reference's behaviour); ``"pre"`` ANDs the per-slot type id into the
        valid mask before it. Tombstoned rows (zero on the card, so they
        never outrank a real match) are dropped at assembly.

        Past the hot cap each query also takes the host tiers' routed (or
        exact-degraded) top-k over the overflow slots, merged with the
        card's by score: ``tier`` "tiered" when every query routed,
        "tiered_exact" / "tiered_fault" when one took the exact scan. A
        device error (at the launch or, as CUDA reports it, at the fetch)
        propagates: the warn path classifies it."""
        q_idx, q_val = self.featurizer.encode_batch_sparse(list(signature_texts))
        b = q_idx.shape[0]
        info = {"tier": "hot", "nprobe": None}
        tid = None
        with self._lock:
            records = self._records
            n = len(records)
            if n == 0:
                return [[] for _ in signature_texts], info
            if self._tomb_view is None:
                self._tomb_view = frozenset(self._tombstoned)
            tomb = self._tomb_view
            valid = self._valid
            if type_filter == "pre" and failure_type is not None:
                tid = self._type_ids.get(failure_type)
                if tid is None:
                    return [[] for _ in signature_texts], info
            with profiling.annotate("gfkb.match.dispatch"):
                # The device-loss drill: armed, the dispatch dies as a lost
                # card's does, and the warn path's degraded mode takes over.
                self._fault_device.fire()
                if tid is not None:
                    valid = self._knn.mask_valid(valid, self._types, tid)
                packed = self._knn.topk_async_sparse(self._emb, valid, q_idx, q_val)
            # No copy of the records (18 ms at 2^20 + 2^18 of them): the list
            # is only appended to or has a slot replaced by a newer version
            # of the same failure, and a reload swaps in a new list, so slots
            # below n read outside the lock are this query's failures.
            gen = self._generation
        with profiling.annotate("gfkb.match.fetch"):
            scores, slots = self._knn.topk_result(packed)

        hot = self._hot_cap()
        if n > hot and self._tiers is not None:
            # Overflow: the card's exact hot top-k merged with the tiers'
            # top-k over the slots the card does not hold (outside the lock).
            modes: set = set()
            m_scores, m_slots = [], []
            k = scores.shape[1]
            overflow = self._tiers.match_host_batch(q_idx, q_val, k, min_slot=hot)
            for i in range(b):
                o_s, o_sl, mode = overflow[i]
                modes.add(mode)
                if tid is not None and len(o_sl):
                    keep = np.asarray([records[int(s)].failure_type == failure_type for s in o_sl])
                    o_s, o_sl = o_s[keep], o_sl[keep]
                cs = np.concatenate([scores[i], o_s])
                csl = np.concatenate([slots[i], o_sl])
                order = np.argsort(-cs)[:k]
                m_scores.append(cs[order])
                m_slots.append(csl[order])
            scores = np.stack(m_scores)
            slots = np.stack(m_slots)
            if "fault_exact" in modes:
                info = {"tier": "tiered_fault", "nprobe": None}
            elif modes == {"routed"}:
                info = {"tier": "tiered", "nprobe": self._tiers.cfg.nprobe}
            else:
                info = {"tier": "tiered_exact", "nprobe": None}

        if self._mine is not None and self._match_cache_max > 0 and failure_type is None:
            # A pre-flight warn is usually followed by the SAME signature
            # being ingested when the trace fails: these neighbours make its
            # cluster attachment free (no delta dispatch).
            with self._lock:
                for i in range(b):
                    self._match_cache[signature_texts[i]] = (scores[i], slots[i], gen)
                    self._match_cache.move_to_end(signature_texts[i])
                while len(self._match_cache) > self._match_cache_max:
                    self._match_cache.popitem(last=False)

        out: List[List[FailureMatch]] = []
        for i in range(b):
            row: List[FailureMatch] = []
            for s, slot in zip(scores[i], slots[i]):
                if s <= -1.0 or slot >= n or int(slot) in tomb:
                    continue  # padding / invalid / tombstoned rows
                rec = records[int(slot)]
                if failure_type and rec.failure_type != failure_type:
                    continue
                row.append(
                    FailureMatch(
                        failure_id=rec.failure_id,
                        version=rec.version,
                        # f32 accumulation can nudge an exact self-match past 1.0.
                        score=min(1.0, max(-1.0, float(s))),
                        failure_type=rec.failure_type,
                        suggested_mitigation=rec.resolution,
                    )
                )
            out.append(row)
        return out, info

    # ------------------------------------------------------------------
    # incremental mining state
    # ------------------------------------------------------------------

    def _mine_attach_new(self, slots, texts, sp_idx, sp_val, gen: int) -> None:
        """Attach freshly inserted rows to the cluster state.

        Rows whose signature a recent warn already scored reuse those
        neighbours (zero device work); rows past the hot cap take theirs
        from ONE batched host match over the tiers (the card never held
        them); the rest share ONE delta top-k dispatch against the index —
        O(ΔN·N) per batch — whose host copy drains lazily (mining reads
        it), so ingest never waits for it. Any failure marks the state stale
        (one full sweep at the next mine): mining is derived state and never
        fails an ingest."""
        m = self._mine
        if m is None or m.stale:
            return
        try:
            self._fault_mine.fire()
            reused = []  # (slot, neighbour slots, sims)
            tier_attach = []  # overflow rows: neighbours from the host tiers
            hot = self._hot_cap()
            with self._lock:
                if self._generation != gen:
                    return
                delta_rows: List[int] = []
                for i, (s, t) in enumerate(zip(slots, texts)):
                    hit = self._match_cache.get(t)
                    if hit is not None and hit[2] == gen:
                        reused.append((s, hit[1], hit[0]))
                    else:
                        delta_rows.append(i)
                ovf = [j for j, i in enumerate(delta_rows) if int(slots[i]) >= hot]
                if ovf and self._tiers is not None:
                    d_idx, d_val = sp_idx[delta_rows], sp_val[delta_rows]
                    batch = self._tiers.match_host_batch(d_idx[ovf], d_val[ovf], m.k + 1)
                    for j, (nscores, nslots, _mode) in zip(ovf, batch):
                        tier_attach.append((int(slots[delta_rows[j]]), nslots, nscores))
                    ovf_set = set(ovf)
                    delta_rows = [i for j, i in enumerate(delta_rows) if j not in ovf_set]
                if delta_rows:
                    # Under the lock, like a match; +1 neighbour: each row's
                    # top-1 against the post-insert index is itself.
                    with profiling.annotate("gfkb.mine.delta"):
                        pending = delta_topk_sparse(
                            self._emb, self._valid, sp_idx[delta_rows], sp_val[delta_rows], m.k + 1
                        )
                    self.mine_delta_dispatches += 1
                    self._mine_pending.append((
                        self._knn.capacity,
                        np.asarray([slots[i] for i in delta_rows], np.int32),
                        pending,
                        gen,
                    ))
            for s, nslots, nsims in reused:
                m.attach(int(s), nslots, nsims)
                self._m_mine_attach["reused"].inc()
            for s, nslots, nsims in tier_attach:
                keep = np.isfinite(nsims) & (nsims >= m.threshold)
                m.attach(int(s), nslots[keep], nsims[keep])
                self._m_mine_attach["tier"].inc()
            self.mine_tier_attaches += len(tier_attach)
            if len(self._mine_pending) > self._mine_pending_max:
                with self._lock:
                    self._mine_drain_locked()
        except Exception as e:  # noqa: BLE001 — degrade, never fail ingest
            log.warning(
                "incremental mining attach failed (%s: %s); state marked "
                "stale — next mine runs a full sweep", type(e).__name__, e,
            )
            m.mark_stale(f"attach failed: {type(e).__name__}")
            with self._lock:
                self._mine_pending.clear()

    def _mine_drain_locked(self) -> int:
        """Fold every pending delta top-k into the cluster state (the lock
        held); each waits for its own host copy. Returns rows attached."""
        m = self._mine
        if m is None:
            return 0
        drained = 0
        while self._mine_pending:
            capacity, d_slots, pending, gen = self._mine_pending.popleft()
            if gen != self._generation or m.stale:
                continue
            t0 = time.perf_counter()
            try:
                self._fault_mine.fire()
                sims, rows = unpack_topk(pending, len(d_slots))
                for r in range(len(d_slots)):
                    keep = np.isfinite(sims[r]) & (sims[r] >= m.threshold) & (rows[r] < capacity)
                    m.attach(int(d_slots[r]), rows[r][keep], sims[r][keep])
                    self._m_mine_attach["delta"].inc()
                drained += len(d_slots)
            except Exception as e:  # noqa: BLE001 — degrade, never desync
                log.warning(
                    "incremental mining drain failed (%s: %s); state marked "
                    "stale — next mine runs a full sweep", type(e).__name__, e,
                )
                m.mark_stale(f"drain failed: {type(e).__name__}")
                self._mine_pending.clear()
                break
            self._m_mine_update.observe(time.perf_counter() - t0)
        nc = m.n_clusters_cached()
        if nc is not None:
            self._m_mine_clusters.set(nc)
        return drained

    def mine_drain(self) -> int:
        """Apply pending deltas; returns the number of rows attached."""
        with self._lock:
            return self._mine_drain_locked()

    def mine_state_info(self) -> dict:
        """Freshness view of the incremental state: enabled flag,
        row/cluster/dirty counts, staleness, the pending (not yet drained)
        delta batches and the dispatches made."""
        with self._lock:
            if self._mine is None:
                return {"enabled": False}
            info = self._mine.info()
            info.update(
                enabled=True,
                pending=len(self._mine_pending),
                covers_all_rows=self._mine.n_rows == len(self._records),
                delta_dispatches=self.mine_delta_dispatches,
                tier_attaches=self.mine_tier_attaches,
            )
            return info

    def mine_pop_dirty(self) -> List[dict]:
        """Aggregates of the clusters touched since the last call (pending
        deltas drained first, so 'dirty' is current)."""
        with self._lock:
            self._mine_drain_locked()
            m = self._mine
            if m is None or m.stale:
                return []
            out = m.pop_dirty()
            self._m_mine_merges.inc(m.merges - self._mine_merges_seen)
            self._mine_merges_seen = m.merges
            nc = m.n_clusters_cached()
            if nc is not None:
                self._m_mine_clusters.set(nc)
            return out

    def mine_usable(self, threshold: float) -> bool:
        """Can a mine be served incrementally? The state must be enabled,
        not stale, cover every record and be built for this threshold (a
        different threshold is a different graph)."""
        with self._lock:
            m = self._mine
            return (
                m is not None
                and not m.stale
                and m.n_rows == len(self._records)
                and m.threshold == float(threshold)
            )

    def mine_reseed(self, labels: np.ndarray, threshold: float, n_records: int) -> bool:
        """Install a full-sweep result as the new incremental baseline.
        ``n_records`` is the record count the sweep covered; rows appended
        during the sweep leave the state stale (the next sweep catches
        them) rather than silently uncovered."""
        with self._lock:
            m = self._mine
            if m is None:
                return False
            self._mine_pending.clear()
            if n_records != len(self._records) or len(labels) != n_records:
                m.mark_stale("records changed during the full sweep")
                return False
            m.seed(
                labels,
                [(r.failure_type, r.failure_id, r.affected_apps) for r in self._records],
                threshold=threshold,
            )
            nc = m.n_clusters_cached()
            if nc is not None:
                self._m_mine_clusters.set(nc)
            if self._tiers is not None:
                # A fresh full-sweep partition is the best coarse structure
                # at hand: re-seed the router's centroids from it (a failure
                # keeps the online partition).
                self._tiers.reseed_router(labels)
            return True

    # ------------------------------------------------------------------
    # patterns
    # ------------------------------------------------------------------

    def _merge_pattern_line(self, p: PatternEntity) -> None:
        """Union one log line (delta or full membership) into the state."""
        st = self._pattern_state.get(p.name)
        if st is None:
            self._pattern_state[p.name] = {
                "pattern_id": p.pattern_id,
                "name": p.name,
                "created_at": p.created_at,
                "fid_list": list(dict.fromkeys(p.failure_ids)),
                "fid_set": set(p.failure_ids),
                "app_list": list(dict.fromkeys(p.affected_apps)),
                "app_set": set(p.affected_apps),
                "description": p.description,
            }
            return
        for f in p.failure_ids:
            if f not in st["fid_set"]:
                st["fid_set"].add(f)
                st["fid_list"].append(f)
        for a in p.affected_apps:
            if a not in st["app_set"]:
                st["app_set"].add(a)
                st["app_list"].append(a)
        if p.description:
            st["description"] = p.description

    @staticmethod
    def _pattern_view(st: dict) -> PatternEntity:
        return PatternEntity.model_construct(
            pattern_id=st["pattern_id"],
            name=st["name"],
            created_at=st["created_at"],
            failure_ids=list(st["fid_list"]),
            affected_apps=list(st["app_list"]),
            description=st["description"],
        )

    def list_patterns(self) -> List[PatternEntity]:
        """Latest state per pattern."""
        with self._lock:
            return [self._pattern_view(st) for st in self._pattern_state.values()]

    def upsert_pattern(
        self,
        *,
        name: str,
        failure_ids: Sequence[str],
        affected_apps: Sequence[str],
        description: Optional[str] = None,
    ) -> Tuple[PatternEntity, bool]:
        """Identity-by-name pattern upsert with set-union merge; only the new
        members are appended to the log, and a no-op upsert appends nothing."""
        with self._lock:
            st = self._pattern_state.get(name)
            created = st is None
            if created:
                st = self._pattern_state[name] = {
                    "pattern_id": f"FP-{len(self._pattern_state) + 1:04d}",
                    "name": name,
                    "created_at": utcnow(),
                    "fid_list": [],
                    "fid_set": set(),
                    "app_list": [],
                    "app_set": set(),
                    "description": description,
                }
            new_f = [f for f in dict.fromkeys(failure_ids) if f not in st["fid_set"]]
            new_a = [a for a in dict.fromkeys(affected_apps) if a not in st["app_set"]]
            desc_changed = bool(description) and description != st["description"]
            if not created and not new_f and not new_a and not desc_changed:
                return self._pattern_view(st), False
            st["fid_list"].extend(new_f)
            st["fid_set"].update(new_f)
            st["app_list"].extend(new_a)
            st["app_set"].update(new_a)
            if description:
                st["description"] = description
            delta = PatternEntity.model_construct(
                pattern_id=st["pattern_id"],
                name=name,
                created_at=st["created_at"],
                failure_ids=new_f,
                affected_apps=new_a,
                description=st["description"],
            )
            self._append_line(self.patterns_path, delta.model_dump_json())
            self._flush_logs()
            return self._pattern_view(st), created
