"""Pre-flight warning policy — 'has something like this failed before?'

Port of ``kakveda_tpu/pipeline/warning.py``: build the signature text,
match it against the GFKB (one kernel launch per batch over the hot rows,
merged with the host tiers' top-k past the hot cap), compare the best score
to the configured threshold (default 0.8), attach the citation pattern when
the matched failure has its type, and answer block|warn|silent with a
confidence.

Device-loss degraded mode (``core/admission.DeviceHealth``): while the card
is latched DEGRADED the match never dispatches; the GFKB's host tiers
answer (``match_batch_fallback``) and every verdict says ``degraded=True``.
A fresh backend error (a CUDA error, an armed ``device.unavailable``)
latches the mode and takes the same fallback, so the request that finds
the outage still gets a verdict. Any other error propagates.

Each batch observes ``kakveda_warn_batch_seconds`` (the match's wall) and
counts its verdicts on ``kakveda_warn_requests_total{action}``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

from kakveda_tpu_torch.core import admission as _admission
from kakveda_tpu_torch.core import metrics as _metrics
from kakveda_tpu_torch.core.config import ConfigStore
from kakveda_tpu_torch.core.fingerprint import signature_text
from kakveda_tpu_torch.core.schemas import WarningRequest, WarningResponse
from kakveda_tpu_torch.index.gfkb import GFKB
from kakveda_tpu_torch.pipeline.classifier import HALLUCINATION_CITATION

_CITATION_PATTERN_NAME = "Citation hallucination without sources"


class WarningPolicy:
    def __init__(self, gfkb: GFKB, config: Optional[ConfigStore] = None):
        self.gfkb = gfkb
        self.config = config or ConfigStore()
        reg = _metrics.get_registry()
        self._m_batch = reg.histogram(
            "kakveda_warn_batch_seconds",
            "Device kNN match wall per warn batch",
        )
        self._m_verdicts = reg.counter(
            "kakveda_warn_requests_total",
            "Pre-flight warn verdicts by action", ("action",),
        )

    def warn(self, req: WarningRequest) -> WarningResponse:
        return self.warn_batch([req])[0]

    def warn_batch(self, reqs: Sequence[WarningRequest]) -> List[WarningResponse]:
        t0 = time.perf_counter()
        threshold = self.config.similarity_threshold()
        default_action = self.config.default_action()
        sigs = [signature_text(r.prompt, r.tools, r.env) for r in reqs]
        health = _admission.get_device_health()
        degraded = False
        if health.degraded:
            all_matches, tier_info = self.gfkb.match_batch_fallback(sigs)
            degraded = True
        else:
            try:
                all_matches, tier_info = self.gfkb.match_batch_info(sigs)
            except Exception as e:  # noqa: BLE001 — classify, maybe degrade
                if not health.note_failure(e, where="gfkb.match"):
                    raise  # a software fault, not a lost card
                all_matches, tier_info = self.gfkb.match_batch_fallback(sigs)
                degraded = True
        self._m_batch.observe(time.perf_counter() - t0)
        patterns = self.gfkb.list_patterns()

        out: List[WarningResponse] = []
        for matches in all_matches:
            best = matches[0] if matches else None
            score = best.score if best else 0.0
            pattern_id = None
            if best and best.failure_type == HALLUCINATION_CITATION:
                for p in patterns:
                    if p.name == _CITATION_PATTERN_NAME:
                        pattern_id = p.pattern_id
                        break
            common = dict(
                confidence=score,
                pattern_id=pattern_id,
                degraded=degraded,
                tier=tier_info.get("tier"),
                nprobe=tier_info.get("nprobe"),
            )
            if best and score >= threshold:
                out.append(
                    WarningResponse(
                        action=default_action,
                        references=[best],
                        message=(
                            f"This execution matches past failure type {best.failure_type} "
                            f"(failure_id={best.failure_id}, similarity={score:.2f}). "
                            f"Suggested mitigation: {best.suggested_mitigation or 'n/a'}"
                        ),
                        **common,
                    )
                )
            else:
                out.append(
                    WarningResponse(
                        action="silent" if default_action == "silent" else "warn",
                        references=[],
                        message="No high-similarity match found in GFKB.",
                        **common,
                    )
                )
        for r in out:
            self._m_verdicts.labels(action=r.action).inc()
        return out
