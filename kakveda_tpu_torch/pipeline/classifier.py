"""Failure classification of ingested traces.

Port of ``kakveda_tpu/pipeline/classifier.py``. The rule tier: a trace whose
prompt asks for citations and whose response contains citation markers is a
``HALLUCINATION_CITATION`` of medium severity. The tiered classifier adds an
LLM judge over the ambiguous rest (citations asked for, no marker found),
run by any model runtime (``models/runtime.py``): the in-tree Llama on the
card beside the GFKB index, the stub, or Ollama.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from kakveda_tpu_torch.core.fingerprint import detect_citation_markers, prompt_intent_tags
from kakveda_tpu_torch.core.schemas import FailureSignal, Severity, TracePayload
from kakveda_tpu_torch.models.runtime import generate_batch

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


_JUDGE_PROMPT = (
    "You are a failure auditor for LLM applications. The user asked:\n"
    "---\n{prompt}\n---\n"
    "The model answered:\n---\n{response}\n---\n"
    "The user's request called for citations. Did the model FABRICATE "
    "citations or references that were not provided to it? Answer with "
    "exactly one word, YES or NO."
)


def parse_judge_verdict(text: str) -> Optional[bool]:
    """First YES/NO token of a judge reply; None when there is none (the
    stub's canned reply, so the hermetic runtime never adds a failure)."""
    for tok in text.upper().replace(".", " ").replace(",", " ").split():
        if tok == "YES":
            return True
        if tok == "NO":
            return False
    return None


@dataclass
class TieredClassifier:
    """Rule tier first; an LLM judge re-checks the ambiguous remainder.

    Ambiguous: the prompt asks for citations but the marker regex found
    none, the case the rule tier passes although the response may fabricate
    sources in an unmarked form. The judge only adds failures: a rule
    verdict is never overridden. All ambiguous traces of a batch go to the
    runtime in one ``generate_batch`` call (one ``generate`` each when the
    runtime has none), after the template's fixed head is registered as a
    serving prefix once, best-effort."""

    runtime: "object"  # ModelRuntime protocol (generate())
    max_judge_chars: int = 2000
    _prefix_registered: bool = False

    def _register_judge_prefix(self) -> None:
        if self._prefix_registered:
            return
        reg = getattr(self.runtime, "register_prefix", None)
        if callable(reg):
            try:
                reg(_JUDGE_PROMPT.split("{prompt}")[0])
            except Exception:  # noqa: BLE001 — registration is an optimization only
                pass
        self._prefix_registered = True

    def classify_batch(self, traces: Sequence[TracePayload]) -> List[Optional[FailureSignal]]:
        out = RuleClassifier().classify_batch(traces)
        ambiguous = [
            i
            for i, (trace, sig) in enumerate(zip(traces, out))
            if sig is None and _wants_citations(trace.prompt)
        ]
        if not ambiguous:
            return out
        judge_prompts = [
            _JUDGE_PROMPT.format(
                prompt=traces[i].prompt[: self.max_judge_chars],
                response=traces[i].response[: self.max_judge_chars],
            )
            for i in ambiguous
        ]
        self._register_judge_prefix()
        verdicts = generate_batch(self.runtime, judge_prompts, max_tokens=4)
        for i, judge in zip(ambiguous, verdicts):
            if not parse_judge_verdict(judge.text):
                continue
            trace = traces[i]
            out[i] = FailureSignal(
                trace_id=trace.trace_id,
                ts=trace.ts,
                app_id=trace.app_id,
                failure_type=HALLUCINATION_CITATION,
                severity=Severity.medium,
                root_cause=_ROOT_CAUSE + " (LLM-judged, unmarked format)",
                mitigation=_MITIGATION,
                context_signature={
                    "prompt_shape": trace.prompt[:200],
                    "model": trace.model,
                    "tools": trace.tools,
                    "env": trace.env,
                    "judge": {"provider": judge.meta.get("provider"), "verdict": "YES"},
                },
            )
        return out
