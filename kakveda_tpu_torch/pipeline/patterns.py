"""Pattern detection: recurring failures spanning multiple apps.

Port of ``kakveda_tpu/pipeline/patterns.py`` (the reactor; pattern mining
comes with a later slice): on a citation-hallucination failure, read the
type's aggregates from the GFKB and upsert the named pattern once at least
``min_apps`` apps are affected.
"""

from __future__ import annotations

from typing import List, Optional

from kakveda_tpu_torch.core.schemas import FailureSignal, PatternEntity
from kakveda_tpu_torch.index.gfkb import GFKB
from kakveda_tpu_torch.pipeline.classifier import HALLUCINATION_CITATION

_CITATION_PATTERN_NAME = "Citation hallucination without sources"
_CITATION_PATTERN_DESC = "Same prompt pattern causes hallucinated citations across apps"
MAX_PATTERN_FAILURE_IDS = 1000


class PatternDetector:
    def __init__(self, gfkb: GFKB, min_apps: int = 2):
        self.gfkb = gfkb
        self.min_apps = min_apps

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
