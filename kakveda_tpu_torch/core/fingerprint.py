"""Deterministic failure fingerprinting.

Produces an app-agnostic ``signature_text`` for every execution — the string
that gets embedded into the GFKB index and matched against at pre-flight
time — plus a short sha256 fingerprint and a citation-marker detector used by
the rule classifier.

Semantics are behaviour-compatible with the reference
(reference: services/shared/fingerprint.py:16-87): identical intent-tag
vocabulary, identical signature layout, identical hash derivation. This
determinism is load-bearing — the e2e scenario tests and the pre-flight
similarity calibration depend on stable tags being the dominant signal.

A copy of ``kakveda_tpu/core/fingerprint.py``: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Dict, Iterable, List

_WS_RE = re.compile(r"\s+")

# Markers that indicate the response *contains* citations: bracketed numeric
# refs, author-year parentheticals, DOIs, or a References/Bibliography section
# (reference: services/shared/fingerprint.py:9-13,79-87).
_CITATION_MARKER_RES = [
    re.compile(r"\[[0-9]+\]"),
    re.compile(r"\([A-Za-z]+,\s*\d{4}\)"),
    re.compile(r"doi:\s*\S+"),
]

_CITATION_KEYWORDS = (
    "citation",
    "citations",
    "reference",
    "references",
    "sources",
    "bibliography",
)

_SUMMARIZATION_KEYWORDS = ("summarize", "summary", "tl;dr")
_EXPLANATION_KEYWORDS = ("explain", "explanation", "describe")


def normalize_prompt(prompt: str) -> str:
    """Lowercase and collapse whitespace."""
    return _WS_RE.sub(" ", prompt.strip().lower())


def prompt_intent_tags(prompt: str) -> List[str]:
    """Coarse, app-agnostic prompt "shape" tags.

    Prompts that carry the same failure risk share tags even when the wording
    differs, which keeps similarity matching deterministic across apps.
    Tag vocabulary matches the reference exactly
    (reference: services/shared/fingerprint.py:22-48).
    """
    # Cache only prompts of bounded size: the entry count is capped but the
    # keys are untrusted strings, and 64k × multi-KB prompts would pin
    # gigabytes for the process lifetime.
    if len(prompt) > _TAG_CACHE_MAX_PROMPT_LEN:
        return list(_intent_tags_compute(prompt))
    return list(_intent_tags_cached(prompt))


_TAG_CACHE_MAX_PROMPT_LEN = 2048


# The streaming path tags every prompt twice (classifier + signature_text);
# the cache collapses that, and repeated prompts in production hit it too.
def _intent_tags_compute(prompt: str) -> tuple:
    p = normalize_prompt(prompt)
    tags: List[str] = []

    wants_citations = any(k in p for k in _CITATION_KEYWORDS)
    if wants_citations:
        tags.append("intent:citations_required")

    if any(k in p for k in _SUMMARIZATION_KEYWORDS):
        tags.append("task:summarization")
    if any(k in p for k in _EXPLANATION_KEYWORDS):
        tags.append("task:explanation")

    if "even if not provided" in p or "even if none" in p:
        tags.append("constraint:no_sources_provided")
    if "include" in p and wants_citations:
        tags.append("instruction:include_references")

    return tuple(sorted(set(tags)))


_intent_tags_cached = lru_cache(maxsize=65536)(_intent_tags_compute)


def signature_text(prompt: str, tools: Iterable[str], env: Dict[str, Any]) -> str:
    """Build the canonical match string for an execution.

    Deliberately app-agnostic (no app_id / trace_id). Intent tags lead so
    they dominate the embedding; the raw prompt contributes only an 80-char
    hint (reference: services/shared/fingerprint.py:51-66).
    """
    tags = prompt_intent_tags(prompt)
    pshort = normalize_prompt(prompt)[:80]
    parts = [
        f"intent_tags:{','.join(tags)}",
        f"prompt_hint:{pshort}",
        f"tools:{','.join(sorted(set(tools)))}",
        f"env_keys:{','.join(sorted(env.keys()))}",
    ]
    return " | ".join(parts)


def fingerprint(prompt: str, tools: Iterable[str], env: Dict[str, Any]) -> str:
    """16-hex-char stable id of the signature text."""
    sig = signature_text(prompt, tools, env)
    return hashlib.sha256(sig.encode("utf-8")).hexdigest()[:16]


@dataclass(frozen=True)
class CitationCheck:
    has_citation_markers: bool


def detect_citation_markers(text: str) -> CitationCheck:
    """Does the text *look like* it contains citations?

    Regex markers first, then the crude "References"/"Bibliography" section
    heuristic (reference: services/shared/fingerprint.py:79-87).
    """
    t = text or ""
    if any(rx.search(t) for rx in _CITATION_MARKER_RES):
        return CitationCheck(True)
    low = t.lower()
    if "references" in low or "bibliography" in low:
        return CitationCheck(True)
    return CitationCheck(False)
