"""Pydantic data contracts for the failure-intelligence plane.

Capability parity with the reference's shared schemas
(reference: services/shared/models.py:10-120). These are the wire shapes for
traces, failures, patterns, pre-flight warnings and health points; every
subsystem (ingestion, classifier, GFKB, warning policy, health scoring,
dashboard) speaks these types.

A copy of ``kakveda_tpu/core/schemas.py``: the port imports nothing of the
JAX package, and the JSON these models dump must stay byte-identical
to the JAX package's so that data dirs cross-load.
"""

from __future__ import annotations

from datetime import datetime, timezone
from enum import Enum
from typing import Any, Dict, List, Optional

from pydantic import BaseModel, Field


def utcnow() -> datetime:
    return datetime.now(timezone.utc)


class Severity(str, Enum):
    low = "low"
    medium = "medium"
    high = "high"


class TracePayload(BaseModel):
    """One observed LLM execution: prompt in, response out, plus context."""

    trace_id: str
    ts: datetime
    app_id: str
    agent_id: Optional[str] = None

    prompt: str
    response: str

    model: Optional[str] = None
    temperature: Optional[float] = None

    tools: List[str] = Field(default_factory=list)
    env: Dict[str, Any] = Field(default_factory=dict)


class IngestRequest(BaseModel):
    trace: TracePayload


class IngestBatchRequest(BaseModel):
    """Batched ingest: the 10k-traces/sec HTTP surface. The reference only
    has per-trace POSTs (services/ingestion/app.py:15-21); per-trace HTTP
    framing caps throughput far below the device pipeline's rate."""

    traces: List[TracePayload]


class FailureSignal(BaseModel):
    """Classifier verdict for a single trace."""

    trace_id: str
    ts: datetime
    app_id: str

    failure_type: str
    severity: Severity

    root_cause: Optional[str] = None
    mitigation: Optional[str] = None

    context_signature: Dict[str, Any]


class CanonicalFailureRecord(BaseModel):
    """A canonical, versioned entry in the Global Failure Knowledge Base.

    Versioning is append-only: an update re-appends the record with
    ``version + 1`` (reference: services/gfkb/app.py:105-147). The device
    index keeps exactly one embedding row per canonical failure; the version
    history lives in the append log.
    """

    failure_id: str
    version: int
    created_at: datetime
    updated_at: datetime

    failure_type: str
    root_cause: Optional[str] = None
    context_signature: Dict[str, Any]

    impact_severity: Severity
    resolution: Optional[str] = None

    occurrences: int = 0
    affected_apps: List[str] = Field(default_factory=list)

    signature_text: str


class FailureMatchRequest(BaseModel):
    signature_text: str
    failure_type: Optional[str] = None
    top_k: int = 5


class FailureMatch(BaseModel):
    failure_id: str
    version: int
    score: float
    failure_type: str
    suggested_mitigation: Optional[str] = None


class FailureMatchResponse(BaseModel):
    matches: List[FailureMatch]


class PatternEntity(BaseModel):
    """A recurring failure shape spanning multiple apps."""

    pattern_id: str
    name: str
    created_at: datetime
    failure_ids: List[str]
    affected_apps: List[str]
    description: Optional[str] = None


class WarningRequest(BaseModel):
    """Pre-flight check: 'has something like this failed before?'"""

    app_id: str
    agent_id: Optional[str] = None
    prompt: str
    tools: List[str] = Field(default_factory=list)
    env: Dict[str, Any] = Field(default_factory=dict)


class WarningResponse(BaseModel):
    action: str  # block | warn | silent
    confidence: float
    pattern_id: Optional[str] = None
    references: List[FailureMatch] = Field(default_factory=list)
    message: str
    # True when the verdict was served by the host-side warm/cold tiers
    # because the accelerator backend is latched DEGRADED (device-loss
    # mode, docs/robustness.md) — still a real verdict, just slower.
    degraded: bool = False
    # Serving provenance from the tiered GFKB (index/tiers.py): which
    # storage tier answered ("hot" = exact device scan, "tiered" = device
    # + routed overflow, "warm"/"warm_routed" = host tiers while
    # degraded, "*_exact"/"*_fault" = routing degraded to the exact
    # scan), and the IVF nprobe used when the answer was routed.
    tier: Optional[str] = None
    nprobe: Optional[int] = None


class HealthPoint(BaseModel):
    ts: datetime
    app_id: str
    score: float
    failure_rate: float
    recurrent_penalty: float
    avg_recovery_time_sec: float
    notes: Dict[str, Any] = Field(default_factory=dict)
