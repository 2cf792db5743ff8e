"""The assembled intelligence core on PyTorch — one object, the whole loop.

Port of ``kakveda_tpu/platform.py`` (without replication):

    ingest(trace)  → publish trace.ingested
                   → classifier (rule, or rule + LLM judge)
                   → GFKB upsert (featurize + device insert
                     + mining attach: one delta top-k per batch)
                   → pattern detector → pattern upsert
                   → health scorer    → health point append
    warn(request)  → fused_topk match on the device → policy decision
    mine()         → incremental (dirty clusters) or full-sweep pattern mining

``ingest_batch`` is the streaming path: classify, embed and insert whole
batches with one device scatter. The index lives on ``device`` — the CUDA
card by default; ``None`` with no card raises. Without a ``classifier``,
``KAKVEDA_CLASSIFIER=tiered`` puts an LLM judge behind the rule tier, over
``get_runtime(device=...)``: the model (``KAKVEDA_MODEL_RUNTIME=torch``)
then lives on the index's device.
"""

from __future__ import annotations

import asyncio
import os
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from kakveda_tpu_torch.core.config import ConfigStore
from kakveda_tpu_torch.core.fingerprint import signature_text
from kakveda_tpu_torch.core.schemas import (
    FailureSignal,
    HealthPoint,
    PatternEntity,
    TracePayload,
    WarningRequest,
    WarningResponse,
)
from kakveda_tpu_torch.events.bus import TOPIC_FAILURE_DETECTED, TOPIC_TRACE_INGESTED, EventBus
from kakveda_tpu_torch.index.gfkb import GFKB
from kakveda_tpu_torch.models.runtime import get_runtime
from kakveda_tpu_torch.pipeline.classifier import RuleClassifier, TieredClassifier
from kakveda_tpu_torch.pipeline.health_score import HealthScorer
from kakveda_tpu_torch.pipeline.patterns import PatternDetector
from kakveda_tpu_torch.pipeline.warning import WarningPolicy


class Platform:
    """Wires bus + GFKB + classifier + patterns + warnings + health."""

    def __init__(
        self,
        data_dir: str | Path = "data",
        config: Optional[ConfigStore] = None,
        device: str | torch.device | None = None,
        capacity: int = 1 << 14,
        dim: Optional[int] = None,
        persist: bool = True,
        classifier=None,
    ):
        self.config = config or ConfigStore()
        self.data_dir = Path(data_dir)
        self.bus = EventBus()
        self.gfkb = GFKB(
            data_dir=self.data_dir,
            capacity=capacity,
            dim=dim or self.config.embedding_dim(),
            top_k=self.config.match_top_k(),
            persist=persist,
            device=device,
        )
        self.device = self.gfkb.device
        if classifier is None:
            if os.environ.get("KAKVEDA_CLASSIFIER", "rule") == "tiered":
                classifier = TieredClassifier(runtime=get_runtime(device=self.device))
            else:
                classifier = RuleClassifier()
        self.classifier = classifier
        self.patterns = PatternDetector(self.gfkb)
        self.warning_policy = WarningPolicy(self.gfkb, self.config)
        self.health = HealthScorer(self.data_dir, self.config, persist=persist)
        self.bus.subscribe(TOPIC_TRACE_INGESTED, self._on_trace_event)
        self.bus.subscribe(TOPIC_FAILURE_DETECTED, self._on_failure_event)

    # --- event reactors ----------------------------------------------------

    async def _on_trace_event(self, event: dict) -> None:
        await self._classify_and_record([TracePayload.model_validate(event)])

    async def _on_failure_event(self, event: dict) -> None:
        failure = FailureSignal.model_validate(event)
        self.patterns.on_failure(failure)
        self.health.on_failure(failure)

    # --- core flows --------------------------------------------------------

    async def _classify_and_record(self, traces: Sequence[TracePayload]) -> List[FailureSignal]:
        # Classification and the GFKB's featurize + insert run off the event
        # loop, so one ingest flood does not hold up concurrent handlers.
        loop = asyncio.get_running_loop()
        signals = await loop.run_in_executor(None, self.classifier.classify_batch, traces)
        found = [(t, s) for t, s in zip(traces, signals) if s is not None]
        if not found:
            return []
        rows = [
            {
                "failure_type": s.failure_type,
                "root_cause": s.root_cause,
                "context_signature": s.context_signature,
                "impact_severity": s.severity.value,
                "resolution": s.mitigation,
                "signature_text": signature_text(t.prompt, t.tools, t.env),
                "app_id": t.app_id,
            }
            for t, s in found
        ]
        await loop.run_in_executor(None, self.gfkb.upsert_failures_batch, rows)
        signals_found = [s for _, s in found]
        # Batch reactors run once per batch; the bus still delivers every
        # failure.detected to the other subscribers.
        self.patterns.on_failures_batch(signals_found)
        self.health.on_failures_batch(signals_found)
        exclude = (self._on_failure_event,)
        if self.bus.has_subscribers(TOPIC_FAILURE_DETECTED, exclude=exclude):
            await self.bus.publish_many(
                TOPIC_FAILURE_DETECTED,
                [s.model_dump(mode="json") for s in signals_found],
                exclude=exclude,
            )
        return signals_found

    async def ingest(self, trace: TracePayload) -> None:
        """POST /ingest semantics: publish trace.ingested."""
        await self.bus.publish(TOPIC_TRACE_INGESTED, trace.model_dump(mode="json"))

    async def ingest_batch(self, traces: Sequence[TracePayload]) -> List[FailureSignal]:
        """Streaming ingest: classify + embed + insert whole batches; other
        trace.ingested subscribers still see every trace."""
        exclude = (self._on_trace_event,)
        if self.bus.has_subscribers(TOPIC_TRACE_INGESTED, exclude=exclude):
            await self.bus.publish_many(
                TOPIC_TRACE_INGESTED, [t.model_dump(mode="json") for t in traces], exclude=exclude
            )
        return await self._classify_and_record(traces)

    def warn(self, req: WarningRequest) -> WarningResponse:
        return self.warning_policy.warn(req)

    def warn_batch(self, reqs: Sequence[WarningRequest]) -> List[WarningResponse]:
        return self.warning_policy.warn_batch(reqs)

    # --- views ---------------------------------------------------------------

    def failures(self):
        return self.gfkb.list_failures()

    def failures_page(self, offset: int = 0, limit: int = 50):
        return self.gfkb.list_failures_page(offset, limit)

    def get_failure(self, failure_id: str):
        return self.gfkb.get_failure(failure_id)

    def apps(self) -> List[str]:
        return self.gfkb.all_apps()

    def patterns_list(self) -> List[PatternEntity]:
        return self.gfkb.list_patterns()

    def mine(self, threshold: float = 0.6, mode: str = "auto"):
        """Pattern mining with freshness info: incremental (drain the
        streaming cluster state, re-emit dirty clusters) when possible, the
        full device sweep otherwise or on ``mode="full"``. Returns
        (patterns, info) — see ``PatternDetector.mine_patterns_ex``."""
        return self.patterns.mine_patterns_ex(threshold, mode)

    def health_history(self, app_id: str, limit: int = 50) -> List[dict]:
        return self.health.history(app_id, limit)

    def health_points(self, app_id: str) -> List[HealthPoint]:
        return [HealthPoint.model_validate(p) for p in self.health.history(app_id)]

    def close(self) -> None:
        self.gfkb.close()
