"""Per-app health scoring over a rolling failure window.

Scoring math matches the reference exactly
(reference: services/health_scoring/app.py:58-108):

    weighted          = Σ severity_weight over the window (≤50 events)
    failure_rate      = min(1, n / 10)
    recurrent_penalty = Σ_type max(0, count-1) * 2.5
    avg_recovery      = 30 + 10 * recurrent_penalty   (placeholder metric)
    score             = max(0, base − 5·weighted − recurrent_penalty)

Severity weights and base come from hot-reloaded config
(reference: config/config.yaml:8-13). Points append to ``health.jsonl`` —
durable-by-append like every other store. ``on_failures_batch`` is the
streaming entry: one config read and one file append per batch.

A port of ``kakveda_tpu/pipeline/health_score.py``: host code, the same
math and the same ``health.jsonl`` lines.
"""

from __future__ import annotations

import json
import os
import threading
from collections import defaultdict, deque
from pathlib import Path
from typing import Deque, Dict, List, Optional

from kakveda_tpu_torch.core.config import ConfigStore
from kakveda_tpu_torch.core.schemas import FailureSignal, HealthPoint, utcnow

WINDOW = 50
EXECUTIONS_PER_WINDOW = 10.0
RECURRENCE_UNIT = 2.5
WEIGHT_SCALE = 5.0


class _AppWindow:
    """Rolling window with incrementally-maintained aggregates: the score
    math needs Σweight and per-type counts over the last ≤50 events, and
    recomputing those per event is the streaming path's hottest host loop."""

    __slots__ = ("events", "weighted", "counts")

    def __init__(self) -> None:
        self.events: Deque[dict] = deque()
        self.weighted: float = 0.0
        self.counts: Dict[str, int] = defaultdict(int)

    def push(self, event: dict) -> None:
        self.events.append(event)
        self.weighted += event["weight"]
        self.counts[str(event["failure_type"])] += 1
        if len(self.events) > WINDOW:
            old = self.events.popleft()
            self.weighted -= old["weight"]
            ft = str(old["failure_type"])
            self.counts[ft] -= 1
            if self.counts[ft] == 0:
                del self.counts[ft]


class HealthScorer:
    def __init__(
        self,
        data_dir: str | Path = "data",
        config: Optional[ConfigStore] = None,
        persist: bool = True,
    ):
        self.config = config or ConfigStore()
        self.persist = persist
        self.data_dir = Path(data_dir)
        if persist:
            self.data_dir.mkdir(parents=True, exist_ok=True)
        self.health_path = self.data_dir / "health.jsonl"
        self._windows: Dict[str, _AppWindow] = defaultdict(_AppWindow)
        self._lock = threading.Lock()

    def _append_all(self, points: List[HealthPoint]) -> None:
        if not self.persist or not points:
            return
        with self.health_path.open("a", encoding="utf-8") as f:
            # pydantic's C serializer straight to JSON — no intermediate dict
            # or Python json encoder on the streaming path.
            f.write("".join(p.model_dump_json() + "\n" for p in points))

    def _score_one(self, failure: FailureSignal, weights: Dict[str, float], base: float) -> HealthPoint:
        """Window update + score math; caller holds the lock and owns I/O."""
        w = float(weights.get(failure.severity.value, 1.0))
        window = self._windows[failure.app_id]
        window.push(
            {
                "severity": failure.severity.value,
                "weight": w,
                "failure_type": failure.failure_type,
            }
        )
        n = len(window.events)
        counts = window.counts
        # Σ_type max(0, count-1) over counts where every count ≥ 1 reduces
        # to (total events − distinct types).
        recurrent_penalty = (n - len(counts)) * RECURRENCE_UNIT
        score = max(0.0, base - window.weighted * WEIGHT_SCALE - recurrent_penalty)
        last = window.events[-1]

        # model_construct: fields are built here with correct types; skipping
        # validation keeps the streaming path off the pydantic hot loop.
        return HealthPoint.model_construct(
            ts=utcnow(),
            app_id=failure.app_id,
            score=score,
            failure_rate=min(1.0, n / EXECUTIONS_PER_WINDOW),
            recurrent_penalty=recurrent_penalty,
            avg_recovery_time_sec=30.0 + 10.0 * recurrent_penalty,
            notes={
                "window_failures": n,
                "weighted": window.weighted,
                "top_failure": max(counts, key=counts.get) if counts else None,
                "last_failure": last["failure_type"],
                "last_severity": last["severity"],
            },
        )

    def on_failure(self, failure: FailureSignal) -> HealthPoint:
        return self.on_failures_batch([failure])[0]

    def on_failures_batch(self, failures: List[FailureSignal]) -> List[HealthPoint]:
        """Streaming-path batch entry: one config read and one JSONL append
        for the whole batch, in order."""
        weights = self.config.severity_weights()
        base = self.config.base_score()
        with self._lock:
            points = [self._score_one(f, weights, base) for f in failures]
        self._append_all(points)
        return points

    def history(self, app_id: str, limit: int = 50) -> List[dict]:
        """Tail of the persisted health timeline for one app
        (reference: services/health_scoring/app.py:116-130).

        Reads the log BACKWARDS in fixed-size chunks and stops as soon as
        ``limit`` matching points are found — at streaming-ingest rates the
        file grows without bound, and the reference's read-everything
        approach makes every dashboard health view O(all points ever). Cost
        here is O(tail) for any app actively emitting points (worst case
        one full pass for an app absent from the log)."""
        if not self.health_path.exists():
            return []
        pts: List[dict] = []
        chunk_size = 1 << 16
        with self.health_path.open("rb") as f:
            f.seek(0, os.SEEK_END)
            pos = f.tell()
            carry = b""
            while pos > 0 and len(pts) < limit:
                step = min(chunk_size, pos)
                pos -= step
                f.seek(pos)
                block = f.read(step) + carry
                lines = block.split(b"\n")
                # The first piece may be a partial line continued in the
                # previous (earlier) chunk — carry it into the next read.
                carry = lines[0] if pos > 0 else b""
                start = 1 if pos > 0 else 0
                for line in reversed(lines[start:]):
                    if len(pts) >= limit:
                        break
                    if not line.strip():
                        continue
                    try:
                        obj = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if obj.get("app_id") == app_id:
                        pts.append(obj)
        pts.reverse()  # back to chronological order
        return pts
