"""Pre-flight warning policy — 'has something like this failed before?'

Port of ``kakveda_tpu/pipeline/warning.py`` without the degraded-mode
fallback: build the signature text, match it against the GFKB (one kernel
launch per batch), compare the best score to the configured threshold
(default 0.8), attach the citation pattern when the matched failure has its
type, and answer block|warn|silent with a confidence. A device error
propagates to the caller.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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

    def warn(self, req: WarningRequest) -> WarningResponse:
        return self.warn_batch([req])[0]

    def warn_batch(self, reqs: Sequence[WarningRequest]) -> List[WarningResponse]:
        threshold = self.config.similarity_threshold()
        default_action = self.config.default_action()
        sigs = [signature_text(r.prompt, r.tools, r.env) for r in reqs]
        all_matches, tier_info = self.gfkb.match_batch_info(sigs)
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
        return out
