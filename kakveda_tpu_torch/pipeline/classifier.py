"""Rule classification of ingested traces.

Port of ``kakveda_tpu/pipeline/classifier.py`` (rule tier only; the LLM
judge tier needs the model plane): a trace whose prompt asks for citations
and whose response contains citation markers is a ``HALLUCINATION_CITATION``
of medium severity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from kakveda_tpu_torch.core.fingerprint import detect_citation_markers, prompt_intent_tags
from kakveda_tpu_torch.core.schemas import FailureSignal, Severity, TracePayload

HALLUCINATION_CITATION = "HALLUCINATION_CITATION"

_ROOT_CAUSE = "Model produced citations without provided sources"
_MITIGATION = "Ask model to explicitly say 'no sources available' when none are provided"


def _wants_citations(prompt: str) -> bool:
    return "intent:citations_required" in prompt_intent_tags(prompt)


def classify_trace(trace: TracePayload) -> Optional[FailureSignal]:
    """Single-trace rule classification; None when the trace looks healthy."""
    if not (
        _wants_citations(trace.prompt)
        and detect_citation_markers(trace.response).has_citation_markers
    ):
        return None
    return FailureSignal.model_construct(
        trace_id=trace.trace_id,
        ts=trace.ts,
        app_id=trace.app_id,
        failure_type=HALLUCINATION_CITATION,
        severity=Severity.medium,
        root_cause=_ROOT_CAUSE,
        mitigation=_MITIGATION,
        context_signature={
            "prompt_shape": trace.prompt[:200],
            "model": trace.model,
            "tools": trace.tools,
            "env": trace.env,
        },
    )


@dataclass
class RuleClassifier:
    """Batch rule classifier for the streaming ingest path."""

    def classify_batch(self, traces: Sequence[TracePayload]) -> List[Optional[FailureSignal]]:
        return [classify_trace(t) for t in traces]
