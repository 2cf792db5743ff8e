"""Pattern detection: recurring failures spanning multiple apps.

Port of ``kakveda_tpu/pipeline/patterns.py``. The reactor: on a
citation-hallucination failure, read the type's aggregates from the GFKB and
upsert the named pattern once at least ``min_apps`` apps are affected.

Mining: ``mine_patterns`` surfaces clusters of similar failures spanning
several apps as patterns. It is incremental by default: the GFKB streams
every inserted row into its cluster state (``ops/incremental.py``), so a
mine drains the pending deltas and re-emits only the dirty clusters; the
O(N²·d) device sweep (``ops/clustering.py``) is ``mode="full"`` — the audit
path, and the fallback whenever the streaming state cannot serve a call
(threshold change, stale state, ``KAKVEDA_MINE_INCREMENTAL=0``).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from kakveda_tpu_torch.core import metrics as _metrics
from kakveda_tpu_torch.core.schemas import FailureSignal, PatternEntity
from kakveda_tpu_torch.index.gfkb import GFKB
from kakveda_tpu_torch.ops.clustering import cluster_embeddings
from kakveda_tpu_torch.pipeline.classifier import HALLUCINATION_CITATION

_CITATION_PATTERN_NAME = "Citation hallucination without sources"
_CITATION_PATTERN_DESC = "Same prompt pattern causes hallucinated citations across apps"
MAX_PATTERN_FAILURE_IDS = 1000


class PatternDetector:
    def __init__(self, gfkb: GFKB, min_apps: int = 2):
        self.gfkb = gfkb
        self.min_apps = min_apps
        self._m_sweeps = _metrics.get_registry().counter(
            "kakveda_mine_sweeps_total", "Pattern-mining sweeps by mode", ("mode",)
        )

    def on_failure(self, failure: FailureSignal) -> Optional[PatternEntity]:
        """Reactor invoked on every failure.detected event."""
        out = self.on_failures_batch([failure])
        return out[0] if out else None

    def on_failures_batch(self, failures: List[FailureSignal]) -> List[PatternEntity]:
        """Batch reactor: at most one pattern upsert per distinct failure
        type in the batch, from the GFKB's O(1) type aggregates."""
        types = {f.failure_type for f in failures if f.failure_type == HALLUCINATION_CITATION}
        out: List[PatternEntity] = []
        for ftype in sorted(types):
            ids, affected = self.gfkb.type_aggregate(ftype)
            if len(affected) < self.min_apps:
                continue
            # The stored id list is capped; the full membership is
            # recoverable from the failures log by type.
            pattern, _ = self.gfkb.upsert_pattern(
                name=_CITATION_PATTERN_NAME,
                failure_ids=ids[-MAX_PATTERN_FAILURE_IDS:],
                affected_apps=affected,
                description=_CITATION_PATTERN_DESC,
            )
            out.append(pattern)
        return out

    @staticmethod
    def _pattern_fields(types_count: Dict[str, int], n_members: int):
        """(name, description) from a cluster's failure-type counts — shared
        by the full and incremental paths so both emit identical records."""
        types = sorted(types_count)
        dominant = max(types, key=lambda t: types_count[t])
        name = (
            _CITATION_PATTERN_NAME
            if dominant == HALLUCINATION_CITATION
            else f"Recurring {dominant.lower().replace('_', ' ')}"
        )
        desc = f"Cluster of {n_members} similar failures ({', '.join(types)})"
        return name, desc

    def mine_patterns(self, threshold: float = 0.6, mode: str = "auto") -> List[PatternEntity]:
        return self.mine_patterns_ex(threshold, mode)[0]

    def mine_patterns_ex(
        self, threshold: float = 0.6, mode: str = "auto"
    ) -> Tuple[List[PatternEntity], dict]:
        """Pattern mining over the GFKB; returns (patterns, freshness info).

        ``mode``:
          * ``"auto"`` — incremental when the streaming state can serve the
            call (enabled, not stale, covers every record, same threshold):
            drain the pending deltas and re-emit patterns ONLY for dirty
            clusters. Otherwise one full sweep, which re-seeds the state.
          * ``"full"`` — force the device sweep (audit, threshold change);
            re-seeds the state.
          * ``"incremental"`` — like auto, but reports the reason in
            ``info["fallback"]`` when a full sweep was needed.

        Clusters whose members span ≥ ``min_apps`` apps become (or refresh)
        a pattern named after the dominant failure type; member count is not
        a criterion (identical signatures canonicalize into one record).
        """
        if mode not in ("auto", "full", "incremental"):
            raise ValueError(f"unknown mine mode {mode!r} (auto|full|incremental)")
        t0 = time.perf_counter()
        if mode != "full" and self.gfkb.mine_usable(threshold):
            out, info = self._mine_incremental()
        else:
            out, info = self._mine_full(threshold)
            if mode == "incremental":
                st = self.gfkb.mine_state_info()
                info["fallback"] = (
                    "disabled" if not st.get("enabled")
                    else st.get("stale_reason") or "state not usable at this threshold"
                )
        self._m_sweeps.labels(mode=info["mode"]).inc()
        info["wall_ms"] = round((time.perf_counter() - t0) * 1000.0, 3)
        info.update(self.gfkb.mine_state_info())
        return out, info

    def _mine_incremental(self) -> Tuple[List[PatternEntity], dict]:
        """Drain pending deltas, re-emit only dirty clusters — the pattern
        log's delta-append makes this equal to a full emission (clean
        clusters would no-op their upsert)."""
        drained = self.gfkb.mine_drain()
        dirty = self.gfkb.mine_pop_dirty()
        out: List[PatternEntity] = []
        for cl in dirty:
            if len(cl["apps"]) < self.min_apps:
                continue
            name, desc = self._pattern_fields(cl["types"], cl["n"])
            pattern, _ = self.gfkb.upsert_pattern(
                name=name, failure_ids=cl["fids"], affected_apps=cl["apps"], description=desc
            )
            out.append(pattern)
        return out, {"mode": "incremental", "drained": drained, "dirty_clusters": len(dirty)}

    def _mine_full(self, threshold: float) -> Tuple[List[PatternEntity], dict]:
        """The whole-corpus sweep over the index's own rows (no re-embed);
        re-seeds the incremental baseline so later calls pay only for
        their deltas."""
        records, vecs = self.gfkb.records_and_embeddings()
        if not records:
            self.gfkb.mine_reseed(np.zeros(0, np.int32), threshold, 0)
            return [], {"mode": "full", "dirty_clusters": 0}
        labels = cluster_embeddings(vecs, threshold=threshold)

        groups: Dict[int, List[int]] = defaultdict(list)
        for i, lbl in enumerate(labels):
            groups[int(lbl)].append(i)

        out: List[PatternEntity] = []
        for members in groups.values():
            recs = [records[i] for i in members]
            apps = sorted({a for r in recs for a in r.affected_apps})
            if len(apps) < self.min_apps:
                continue
            types_count: Dict[str, int] = {}
            for r in recs:
                types_count[r.failure_type] = types_count.get(r.failure_type, 0) + 1
            name, desc = self._pattern_fields(types_count, len(recs))
            pattern, _ = self.gfkb.upsert_pattern(
                name=name,
                failure_ids=sorted({r.failure_id for r in recs}),
                affected_apps=apps,
                description=desc,
            )
            out.append(pattern)
        self.gfkb.mine_reseed(labels, threshold, len(records))
        return out, {"mode": "full", "dirty_clusters": len(groups)}
