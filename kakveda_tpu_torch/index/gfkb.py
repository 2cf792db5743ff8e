"""Global Failure Knowledge Base over the port's device index.

Port of ``kakveda_tpu/index/gfkb.py`` (hot tier only): append-only JSONL
persistence with versioning-by-append, dense ``F-%04d``/``FP-%04d`` id
minting, identity by ``(failure_type, signature_text)``, one embedding row
per canonical failure in a device-resident ``[capacity, dim]`` index, and a
top-k match of one ``fused_topk`` launch per query batch. ``failures.jsonl``
and ``patterns.jsonl`` are written in the JAX package's line format through
the native group-commit writer (``native.AppendLog``, a Python file where
the library is absent), flushed once per public mutation, and replayed at
start-up, so a data dir written by either package opens in the other.

Incremental mining rides the ingest path as in the reference: each new
record joins a streaming ``ClusterState`` (``ops/incremental.py``); after a
batch's scatter its new rows get their neighbours either from a recent
warn's match of the same signature (the match cache, no device work) or
from ONE delta top-k of the batch against the index, drained lazily when
mining reads the state. A fault there marks the state stale (one full
sweep at the next mine) and never fails an ingest. A replayed log leaves
the state stale, so the first mine after start-up is a full sweep.

Not yet ported (later slices): snapshots (and the cluster state they carry),
tombstones and compaction, applied-event dedup and replication, the host
tiers and degraded fallback (so no tier attachment and no router re-seed
from a mined partition).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from collections import OrderedDict, deque
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kakveda_tpu_torch import native
from kakveda_tpu_torch.core.schemas import (
    CanonicalFailureRecord,
    FailureMatch,
    PatternEntity,
    Severity,
    utcnow,
)
from kakveda_tpu_torch.ops.featurizer import HashedNGramFeaturizer
from kakveda_tpu_torch.ops.incremental import ClusterState, delta_topk_sparse, unpack_topk
from kakveda_tpu_torch.ops.knn import MAX_CAPACITY, Knn

log = logging.getLogger("kakveda.gfkb")


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
    ):
        self.data_dir = Path(data_dir)
        self.persist = persist
        if persist:
            self.data_dir.mkdir(parents=True, exist_ok=True)
        self.failures_path = self.data_dir / "failures.jsonl"
        self.patterns_path = self.data_dir / "patterns.jsonl"
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
        self._lock = threading.Lock()
        # Records appended whose rows are not scattered yet: the sweep's
        # records_and_embeddings waits for them.
        self._pending_embeds = 0
        self._embeds_cv = threading.Condition(self._lock)
        self._logs: Dict[Path, native.AppendLog] = {}
        # A torn final line tolerated at replay: truncate back to this
        # offset before the next append to that file.
        self._truncate_pending: Dict[Path, int] = {}

        # Incremental mining state (KAKVEDA_MINE_INCREMENTAL=0: no state,
        # no cache, no extra device dispatches — every mine is a full sweep).
        self._mine: Optional[ClusterState] = None
        # Dispatched delta top-ks not yet folded in: (capacity, slots, pending).
        self._mine_pending: deque = deque()
        self._mine_pending_max = int(os.environ.get("KAKVEDA_MINE_PENDING_MAX", "256"))
        # signature_text -> (scores, slots): a warn's fetched neighbours,
        # reused to attach the same signature at ingest with no dispatch.
        self._match_cache: "OrderedDict[str, tuple]" = OrderedDict()
        self._match_cache_max = int(os.environ.get("KAKVEDA_MINE_MATCH_CACHE", "4096"))
        self.mine_delta_dispatches = 0
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

    def _append_line(self, path: Path, line: str) -> None:
        """Buffer one pre-serialized record; public mutations flush once."""
        if not self.persist:
            return
        pend = self._truncate_pending.pop(path, None)
        if pend is not None:
            f = self._logs.pop(path, None)
            if f is not None:
                f.close()
            os.truncate(path, pend)
            log.warning("truncated torn tail of %s to %d bytes", path, pend)
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
            for f in self._logs.values():
                f.close()
            self._logs.clear()

    def _iter_log_lines(self, path: Path, parse):
        """Yield ``parse(line)`` per JSONL line, tolerating one torn FINAL
        line (a crash mid-append: warn, truncate on the next append); a bad
        record with data after it is mid-file corruption and raises."""
        with path.open("rb") as f:
            pos = 0
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
        """Rebuild host metadata and the device index from the append logs
        (latest version per key wins; slots in first-seen order)."""
        if self.failures_path.exists():
            latest: Dict[Tuple[str, str], CanonicalFailureRecord] = {}
            order: List[Tuple[str, str]] = []
            for rec in self._iter_log_lines(
                self.failures_path,
                lambda t: CanonicalFailureRecord.model_validate(json.loads(t)),
            ):
                key = (rec.failure_type, rec.signature_text)
                if key not in latest:
                    order.append(key)
                latest[key] = rec
            for slot, key in enumerate(order):
                rec = latest[key]
                self._records.append(rec)
                self._slot_by_key[key] = slot
                self._slot_by_id[rec.failure_id] = slot
                self._ids_by_type.setdefault(rec.failure_type, []).append(rec.failure_id)
                self._apps_by_type.setdefault(rec.failure_type, set()).update(rec.affected_apps)
            if self._records:
                self._rebuild(self._records)
        if self.patterns_path.exists():
            for p in self._iter_log_lines(
                self.patterns_path, lambda t: PatternEntity.model_validate(json.loads(t))
            ):
                self._merge_pattern_line(p)

    def _mine_after_replay(self) -> None:
        """The cluster state must cover exactly the replayed rows or be
        stale: a replayed log leaves a gap that only a full sweep closes."""
        m = self._mine
        if m is not None and self._records and m.n_rows != len(self._records):
            m.mark_stale("replayed rows not covered by restored cluster state")

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
        """Consistent (records, slot-aligned embedding rows): the rows are
        the index's own ``emb[:n]`` on the device (slot = row), taken once
        every appended record's scatter has landed. Rows below ``n`` never
        change (the store is append-only), so the view stays valid."""
        with self._lock:
            self._drain_pending_embeds()
            records = list(self._records)
            return records, self._emb[: len(records)]

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

    def _rebuild(self, records: Sequence[CanonicalFailureRecord]) -> None:
        """Capacity growth: allocate an index of the doubled capacity that
        holds ``records`` (re-embedded in 64k chunks) and swap it in.
        Callers hold the lock or run single-threaded (start-up)."""
        cap = self._knn.capacity
        while cap < len(records):
            cap *= 2
        if cap > MAX_CAPACITY:
            raise ValueError(f"GFKB of {len(records)} records exceeds {MAX_CAPACITY} rows")
        if cap != self._knn.capacity:
            self._knn = Knn(cap, self._knn.dim, k=self.top_k, device=self.device)
        emb, valid = self._knn.alloc()
        types = self._knn.alloc_i32()
        tids = np.asarray([self._type_id(r.failure_type) for r in records], np.int32)
        chunk = 1 << 16
        for i in range(0, len(records), chunk):
            batch = records[i : i + chunk]
            sp_i, sp_v = self.featurizer.encode_batch_sparse([r.signature_text for r in batch])
            slots = np.arange(i, i + len(batch), dtype=np.int32)
            self._knn.insert_sparse(emb, valid, types, sp_i, sp_v, slots, tids[i : i + chunk])
        self._emb, self._valid, self._types = emb, valid, types

    def _embed_new_slots(self, slots: List[int], texts: List[str], tids: List[int]) -> None:
        """Embed new records (host work, off the lock), scatter them in —
        growing the index when the records outran its capacity — then
        attach them to the mining state. Callers counted the batch in
        ``_pending_embeds`` under the lock; it is released here."""
        try:
            sp_idx, sp_val = self.featurizer.encode_batch_sparse(texts)
            with self._lock:
                if len(self._records) > self._knn.capacity:
                    self._rebuild(self._records)  # re-embeds these rows too
                else:
                    self._knn.insert_sparse(
                        self._emb, self._valid, self._types, sp_idx, sp_val,
                        np.asarray(slots, np.int32), np.asarray(tids, np.int32),
                    )
            self._mine_attach_new(slots, texts, sp_idx, sp_val)
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
        """Versioned upsert of one failure; returns (record, created)."""
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
            slot = self._slot_by_key.get((failure_type, signature_text))
            created = slot is None
            if created:
                rec = self._new_record_locked(item, now, validate=True)
                slot = len(self._records) - 1
                tid = self._type_id(failure_type)
            else:
                rec = self._bump_record_locked(slot, item, now)
            self._append_line(
                self.failures_path, json.dumps(rec.model_dump(mode="json"), ensure_ascii=False)
            )
            self._flush_logs()
            if created:
                self._pending_embeds += 1
        if created:
            self._embed_new_slots([slot], [signature_text], [tid])
        return rec, created

    def upsert_failures_batch(
        self, items: Sequence[dict]
    ) -> List[Tuple[CanonicalFailureRecord, bool]]:
        """Batched upsert for the streaming-ingest path: new signatures are
        embedded in one featurizer call and written in one device scatter."""
        out: List[Tuple[CanonicalFailureRecord, bool]] = []
        new_slots: List[int] = []
        new_texts: List[str] = []
        new_tids: List[int] = []
        with self._lock:
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
                    rec = self._bump_record_locked(slot, item, now)
                    out.append((rec, False))
                self._append_line(self.failures_path, rec.model_dump_json())
            self._flush_logs()
            if new_slots:
                self._pending_embeds += 1
        if new_slots:
            self._embed_new_slots(new_slots, new_texts, new_tids)
        return out

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
        """Top-k matches for a batch of queries (one kernel launch), plus
        serving provenance. ``type_filter="post"`` filters by type after the
        top-k (the reference's behaviour); ``"pre"`` ANDs the per-slot type
        id into the valid mask before it. A device error propagates."""
        q_idx, q_val = self.featurizer.encode_batch_sparse(list(signature_texts))
        b = q_idx.shape[0]
        info = {"tier": "hot", "nprobe": None}
        with self._lock:
            records = self._records
            n = len(records)
            if n == 0:
                return [[] for _ in signature_texts], info
            valid = self._valid
            if type_filter == "pre" and failure_type is not None:
                tid = self._type_ids.get(failure_type)
                if tid is None:
                    return [[] for _ in signature_texts], info
                valid = self._knn.mask_valid(valid, self._types, tid)
            packed = self._knn.topk_async_sparse(self._emb, valid, q_idx, q_val)
            records = list(records)
        scores, slots = self._knn.topk_result(packed)

        if self._mine is not None and self._match_cache_max > 0 and failure_type is None:
            # A pre-flight warn is usually followed by the SAME signature
            # being ingested when the trace fails: these neighbours make its
            # cluster attachment free (no delta dispatch).
            with self._lock:
                for i in range(b):
                    self._match_cache[signature_texts[i]] = (scores[i], slots[i])
                    self._match_cache.move_to_end(signature_texts[i])
                while len(self._match_cache) > self._match_cache_max:
                    self._match_cache.popitem(last=False)

        out: List[List[FailureMatch]] = []
        for i in range(b):
            row: List[FailureMatch] = []
            for s, slot in zip(scores[i], slots[i]):
                if s <= -1.0 or slot >= n:
                    continue  # padding / invalid rows
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

    def _mine_attach_new(self, slots, texts, sp_idx, sp_val) -> None:
        """Attach freshly inserted rows to the cluster state.

        Rows whose signature a recent warn already scored reuse those
        neighbours (zero device work); the rest share ONE delta top-k
        dispatch against the index — O(ΔN·N) per batch — whose host copy
        drains lazily (mining reads it), so ingest never waits for it. Any
        failure marks the state stale (one full sweep at the next mine):
        mining is derived state and never fails an ingest."""
        m = self._mine
        if m is None or m.stale:
            return
        try:
            reused = []  # (slot, neighbour slots, sims)
            with self._lock:
                delta_rows: List[int] = []
                for i, (s, t) in enumerate(zip(slots, texts)):
                    hit = self._match_cache.get(t)
                    if hit is not None:
                        reused.append((s, hit[1], hit[0]))
                    else:
                        delta_rows.append(i)
                if delta_rows:
                    # Under the lock, like a match; +1 neighbour: each row's
                    # top-1 against the post-insert index is itself.
                    pending = delta_topk_sparse(
                        self._emb, self._valid, sp_idx[delta_rows], sp_val[delta_rows], m.k + 1
                    )
                    self.mine_delta_dispatches += 1
                    self._mine_pending.append(
                        (self._knn.capacity, np.asarray([slots[i] for i in delta_rows], np.int32), pending)
                    )
            for s, nslots, nsims in reused:
                m.attach(int(s), nslots, nsims)
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
            capacity, d_slots, pending = self._mine_pending.popleft()
            if m.stale:
                continue
            try:
                sims, rows = unpack_topk(pending, len(d_slots))
                for r in range(len(d_slots)):
                    keep = np.isfinite(sims[r]) & (sims[r] >= m.threshold) & (rows[r] < capacity)
                    m.attach(int(d_slots[r]), rows[r][keep], sims[r][keep])
                drained += len(d_slots)
            except Exception as e:  # noqa: BLE001 — degrade, never desync
                log.warning(
                    "incremental mining drain failed (%s: %s); state marked "
                    "stale — next mine runs a full sweep", type(e).__name__, e,
                )
                m.mark_stale(f"drain failed: {type(e).__name__}")
                self._mine_pending.clear()
                break
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
            return m.pop_dirty()

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
