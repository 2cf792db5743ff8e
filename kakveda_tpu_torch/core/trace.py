"""The in-process causal-tracing spine: spans, W3C context, span rings.

The port's own copy of ``kakveda_tpu/core/trace.py`` (it imports nothing
of the JAX package). One warn crosses the HTTP tier, admission, the
micro-batcher and the card's ``fused_topk``; one generation request
crosses the serving engine's queue, its slots and the flash kernel. This
module ties each such path into one tree: dependency-free (no
opentelemetry import — the optional bridge lives in core/otel.py), one
process-global tracer (:func:`get_tracer`; tests build private
instances), and cheap enough for the warn hot path (an unsampled span is
one object allocation + two counter bumps; ``KAKVEDA_TRACE_SAMPLE=0``
records nothing unless the outcome is bad).

Three layers:

* **Context** — trace_id (32 hex) / span_id (16 hex) / parent span, carried
  across process boundaries as a W3C ``traceparent`` header
  (``00-<trace>-<span>-<flags>``; :func:`parse_traceparent` /
  :func:`format_traceparent`) and across ``await`` points via a
  contextvar (:func:`current_span`). Context does not follow work into an
  executor thread or the engine's loop thread; such work carries the
  ``traceparent`` string by value. The service middleware FOLDS the
  request id into the trace: ``ensure_request_id`` mints 32 lowercase
  hex, so an unheadered request's rid IS its trace id.
* **Sampling** — head-based and DETERMINISTIC in the trace id
  (``KAKVEDA_TRACE_SAMPLE`` ∈ [0,1]; the first 8 hex digits thresholded),
  so every process makes the SAME keep/drop decision for one trace
  without coordination. Spans whose outcome is ``error``/``shed``/
  ``degraded`` are ALWAYS recorded — failure intelligence must not sample
  away its failures.
* **Ring** — a bounded per-process list of finished spans
  (``KAKVEDA_TRACE_N``, default 512), dumped at ``GET /trace`` and
  ``GET /trace/{id}``.

Contract (same as core/otel.py): tracing NEVER raises into the request
path. :meth:`Tracer.start_span` and every :class:`Span` method swallow
their own failures; the ``trace.record`` fault site proves it — an armed
recorder drops the span, bumps ``dropped``, and the warn still answers.
Orphan accounting: every started span must end in exactly ONE outcome
bucket, so ``plane()["orphaned"]`` (= started − ended) stays zero.

Knobs: ``KAKVEDA_TRACE_N`` — span-ring capacity per process (default 512;
0 disables recording but keeps propagation and the dump endpoints).
``KAKVEDA_TRACE_SAMPLE`` — head sampling rate in [0,1] (default 1; bad
outcomes record regardless).
"""

from __future__ import annotations

import contextvars
import os
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional, Tuple

from kakveda_tpu_torch.core import faults as _faults
from kakveda_tpu_torch.core import sanitize

__all__ = [
    "Span",
    "Tracer",
    "get_tracer",
    "current_span",
    "current_traceparent",
    "parse_traceparent",
    "format_traceparent",
    "assemble_tree",
    "render_trace",
    "TRACEPARENT_HEADER",
    "ALWAYS_RECORD_OUTCOMES",
]

TRACEPARENT_HEADER = "traceparent"

# Outcomes that bypass head sampling: a dropped failure trace is exactly
# the telemetry this platform exists to keep.
ALWAYS_RECORD_OUTCOMES = ("error", "shed", "degraded")

# Resolved ONCE at import (fault-site contract, core/faults.py): armed
# chaos makes record() drop the span — never raise into the request path.
_FAULT_RECORD = _faults.site("trace.record")

_HEX = frozenset("0123456789abcdef")
_ZERO_TRACE = "0" * 32
_ZERO_SPAN = "0" * 16

_CURRENT: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "kakveda_trace_span", default=None
)


# ---------------------------------------------------------------------------
# W3C wire format


def parse_traceparent(value: Any) -> Optional[Tuple[str, str, bool]]:
    """``00-<32hex>-<16hex>-<2hex>`` → ``(trace_id, span_id, sampled)``,
    or None for anything malformed (never raises — wire input)."""
    if not isinstance(value, str):
        return None
    parts = value.strip().lower().split("-")
    if len(parts) < 4:
        return None
    ver, tid, sid, flags = parts[0], parts[1], parts[2], parts[3]
    # version "ff" is forbidden by the W3C spec; other unknown versions
    # parse forward-compatibly as long as the id fields fit.
    if len(ver) != 2 or set(ver) - _HEX or ver == "ff":
        return None
    if len(tid) != 32 or len(sid) != 16:
        return None
    if set(tid) - _HEX or set(sid) - _HEX:
        return None
    if tid == _ZERO_TRACE or sid == _ZERO_SPAN:
        return None
    try:
        sampled = bool(int(flags, 16) & 1)
    except ValueError:
        return None
    return tid, sid, sampled


def format_traceparent(trace_id: str, span_id: str, sampled: bool) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def _valid_trace_id(s: Any) -> bool:
    return (
        isinstance(s, str) and len(s) == 32
        and not set(s) - _HEX and s != _ZERO_TRACE
    )


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


# ---------------------------------------------------------------------------
# spans


class Span:
    """One timed unit of work. Never raises from any method — tracing is
    telemetry, not control flow. Use as a context manager to both activate
    it (contextvar) and end it with an exception-aware outcome."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "ts", "dur_ms",
        "outcome", "attrs", "sampled", "_tracer", "_t0", "_token", "_ended",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        sampled: bool,
        attrs: Dict[str, Any],
    ) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled
        self.attrs = attrs
        self.ts = time.time()
        self._t0 = time.perf_counter()
        self.dur_ms = 0.0
        self.outcome = "ok"
        self._token: Optional[contextvars.Token] = None
        self._ended = False

    # -- context propagation ----------------------------------------------

    def traceparent(self) -> str:
        """Wire form naming THIS span as the parent of the next hop."""
        return format_traceparent(self.trace_id, self.span_id, self.sampled)

    def activate(self) -> None:
        """Make this span the contextvar-current parent for child spans
        started in the same task/thread context."""
        try:
            self._token = _CURRENT.set(self)
        except Exception:  # noqa: BLE001 — never raise into the request path
            pass

    def deactivate(self) -> None:
        try:
            if self._token is not None:
                _CURRENT.reset(self._token)
                self._token = None
        except Exception:  # noqa: BLE001 — never raise into the request path
            pass

    # -- annotation / completion ------------------------------------------

    def set(self, **attrs: Any) -> "Span":
        try:
            self.attrs.update(attrs)
        except Exception:  # noqa: BLE001 — never raise into the request path
            pass
        return self

    def end(self, outcome: str = "ok", **attrs: Any) -> None:
        """Close the span into exactly ONE outcome bucket and hand it to
        the tracer ring. Idempotent: the first end() wins."""
        try:
            if self._ended:
                return
            self._ended = True
            self.dur_ms = round((time.perf_counter() - self._t0) * 1000, 3)
            if attrs:
                self.attrs.update(attrs)
            self.outcome = outcome
            self._tracer._finish(self)
        except Exception:  # noqa: BLE001 — never raise into the request path
            pass

    def __enter__(self) -> "Span":
        self.activate()
        return self

    def __exit__(self, exc_type, exc, _tb) -> bool:
        self.deactivate()
        if exc_type is not None and self.outcome == "ok":
            self.set(error=getattr(exc_type, "__name__", str(exc_type)))
            self.end("error")
        else:
            self.end(self.outcome)
        return False  # never swallow the caller's exception

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "ts": self.ts,
            "dur_ms": self.dur_ms,
            "outcome": self.outcome,
            "attrs": dict(self.attrs),
        }


class _NullSpan:
    """Inert stand-in returned when span creation itself fails — keeps the
    caller's code path identical (attrs/end/with all no-op, direct
    attribute writes like ``span.outcome = ...`` absorbed)."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = None
    name = ""
    sampled = False
    outcome = "ok"
    attrs: Dict[str, Any] = {}

    def traceparent(self) -> str:
        return ""

    def activate(self) -> None:
        pass

    def deactivate(self) -> None:
        pass

    def set(self, **_attrs: Any) -> "_NullSpan":
        return self

    def __setattr__(self, _name: str, _value: Any) -> None:
        pass  # writes no-op: callers may assign .outcome directly

    def end(self, _outcome: str = "ok", **_attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *_a) -> bool:
        return False


NULL_SPAN = _NullSpan()


# ---------------------------------------------------------------------------
# tracer


class Tracer:
    """Process-global span factory + bounded finished-span ring.

    Counter contract (``plane()``): ``started`` and ``ended`` count EVERY
    span (sampled or not) so ``orphaned = started - ended`` certifies that
    each span terminated in exactly one bucket; ``recorded`` counts ring
    appends; ``dropped`` counts ring evictions + chaos-injected record
    failures (``trace.record``)."""

    def __init__(
        self,
        capacity: Optional[int] = None,
        sample: Optional[float] = None,
    ) -> None:
        if capacity is None:
            capacity = int(os.environ.get("KAKVEDA_TRACE_N", "512") or 0)
        if sample is None:
            sample = float(os.environ.get("KAKVEDA_TRACE_SAMPLE", "1") or 0.0)
        self.capacity = max(0, int(capacity))
        self.sample = min(1.0, max(0.0, float(sample)))
        self.service = ""  # replica id; stamped by the service app
        self._lock = sanitize.named_lock("Tracer._lock")
        self._spans: List[Dict[str, Any]] = []
        self._started = 0
        self._ended = 0
        self._recorded = 0
        self._dropped = 0

    # -- sampling ----------------------------------------------------------

    def sample_decision(self, trace_id: str) -> bool:
        """Deterministic head decision: pure in (trace_id, rate) so every
        process agrees without coordination."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        try:
            return int(trace_id[:8], 16) < self.sample * 0x100000000
        except (ValueError, TypeError):
            return False

    # -- span lifecycle ----------------------------------------------------

    def start_span(
        self,
        name: str,
        *,
        parent: Optional[Span] = None,
        traceparent: Optional[str] = None,
        trace_id: Optional[str] = None,
        **attrs: Any,
    ) -> Span:
        """Start a span, resolving its parent in precedence order: explicit
        ``parent`` span → ``traceparent`` wire header → contextvar-current
        span → new root. ``trace_id`` (e.g. the folded request id, 32 hex)
        seeds a NEW root's id only. Never raises: on any internal failure
        the caller gets :data:`NULL_SPAN` and proceeds untraced."""
        try:
            pid: Optional[str] = None
            sampled: Optional[bool] = None
            tid: Optional[str] = None
            if parent is not None and getattr(parent, "trace_id", ""):
                tid, pid, sampled = parent.trace_id, parent.span_id, parent.sampled
            elif traceparent:
                ctx = parse_traceparent(traceparent)
                if ctx is not None:
                    tid, pid, sampled = ctx
            if tid is None:
                cur = _CURRENT.get()
                if cur is not None and cur.trace_id:
                    tid, pid, sampled = cur.trace_id, cur.span_id, cur.sampled
            if tid is None:  # new root — fold the request id when it fits
                tid = trace_id if _valid_trace_id(trace_id) else new_trace_id()
                sampled = self.sample_decision(tid)
            if sampled is None:
                sampled = self.sample_decision(tid)
            span = Span(self, name, tid, new_span_id(), pid, sampled, dict(attrs))
            with self._lock:
                self._started += 1
            return span
        except Exception:  # noqa: BLE001 — never raise into the request path
            return NULL_SPAN  # type: ignore[return-value]

    def record_completed(
        self,
        name: str,
        *,
        traceparent: Optional[str] = None,
        ts: Optional[float] = None,
        dur_ms: float = 0.0,
        outcome: str = "ok",
        **attrs: Any,
    ) -> Optional[Dict[str, Any]]:
        """Record an already-finished timeline as one span — for work whose
        timing is assembled after the fact (serving-engine request
        timelines). Returns the recorded
        dict, or None when unsampled/dropped. Never raises."""
        try:
            span = self.start_span(name, traceparent=traceparent, **attrs)
            if ts is not None:
                span.ts = ts
            span.dur_ms = round(float(dur_ms), 3)
            # end() would overwrite dur_ms from the wall clock; finish the
            # span through the ring path directly.
            span._ended = True
            span.outcome = outcome
            self._finish(span)
            return span.to_dict()
        except Exception:  # noqa: BLE001 — never raise into the request path
            return None

    def _finish(self, span: Span) -> None:
        """Ring-append a finished span when sampled or the outcome demands
        it. The ``trace.record`` chaos site proves the failure contract:
        an armed site drops the span (counted), the request path never
        sees an exception."""
        with self._lock:
            self._ended += 1
        if self.capacity <= 0:
            return
        if not span.sampled and span.outcome not in ALWAYS_RECORD_OUTCOMES:
            return
        try:
            _FAULT_RECORD.fire()
            d = span.to_dict()
            if self.service:
                d["service"] = self.service
            with self._lock:
                self._spans.append(d)
                self._recorded += 1
                over = len(self._spans) - self.capacity
                if over > 0:
                    del self._spans[:over]
                    self._dropped += over
            # OTel bridge (KAKVEDA_OTEL_ENABLED): recorded spans also
            # export through the best-effort SDK tracer — one None check
            # when off, never a new hard dependency.
            from kakveda_tpu_torch.core import otel as _otel

            if _otel.get_tracer() is not None:
                _otel.export_native_span(d)
        except Exception:  # noqa: BLE001 — a failing recorder drops the span, nothing else
            with self._lock:
                self._dropped += 1

    # -- collection --------------------------------------------------------

    def dump(
        self, trace_id: Optional[str] = None, limit: Optional[int] = None
    ) -> List[Dict[str, Any]]:
        """Finished spans, oldest→newest; optionally one trace only."""
        with self._lock:
            spans = list(self._spans)
        if trace_id is not None:
            spans = [s for s in spans if s.get("trace_id") == trace_id]
        if limit is not None and limit >= 0:
            spans = spans[-limit:]
        return spans

    def plane(self) -> Dict[str, Any]:
        """The ring and orphan counters: one dict, cheap, lock-consistent."""
        with self._lock:
            started, ended = self._started, self._ended
            recorded, dropped = self._recorded, self._dropped
            ring = len(self._spans)
        return {
            "started": started,
            "ended": ended,
            "orphaned": started - ended,
            "recorded": recorded,
            "dropped": dropped,
            "ring": ring,
            "capacity": self.capacity,
            "sample": self.sample,
        }

    def reset(self) -> None:
        """Zero the ring and counters (tests, smoke phases)."""
        with self._lock:
            del self._spans[:]
            self._started = self._ended = 0
            self._recorded = self._dropped = 0


# ---------------------------------------------------------------------------
# process-global default + context helpers

_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def current_span() -> Optional[Span]:
    try:
        return _CURRENT.get()
    except Exception:  # noqa: BLE001 — never raise into the request path
        return None


def current_traceparent() -> str:
    """Wire form of the contextvar-current span ('' when untraced) — the
    one-liner boundary code uses to stamp outgoing envelopes/headers."""
    span = current_span()
    return span.traceparent() if span is not None else ""


# ---------------------------------------------------------------------------
# tree assembly / rendering


def assemble_tree(spans: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Merge span dicts (possibly from several processes, possibly with
    duplicates) into root-first trees: each node is
    the span dict plus a ``children`` list sorted by start ts. Spans whose
    parent is missing from the set are roots (partial traces render rather
    than vanish)."""
    by_id: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        sid = s.get("span_id")
        if not sid or sid in by_id:
            continue
        by_id[sid] = dict(s, children=[])
    roots: List[Dict[str, Any]] = []
    for node in by_id.values():
        parent = by_id.get(node.get("parent_id") or "")
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    def _sort(nodes: List[Dict[str, Any]]) -> None:
        nodes.sort(key=lambda n: (n.get("ts") or 0.0, n.get("span_id") or ""))
        for n in nodes:
            _sort(n["children"])
    _sort(roots)
    return roots


def _render_node(node: Dict[str, Any], prefix: str, last: bool,
                 out: List[str]) -> None:
    branch = "└─ " if last else "├─ "
    svc = f" [{node['service']}]" if node.get("service") else ""
    attrs = node.get("attrs") or {}
    extras = " ".join(f"{k}={attrs[k]}" for k in sorted(attrs))
    out.append(
        f"{prefix}{branch}{node.get('name', '?')}{svc} "
        f"{node.get('dur_ms', 0.0):.1f}ms {node.get('outcome', '?')}"
        + (f"  {extras}" if extras else "")
    )
    children = node.get("children") or []
    child_prefix = prefix + ("   " if last else "│  ")
    for i, child in enumerate(children):
        _render_node(child, child_prefix, i == len(children) - 1, out)


def render_trace(spans: Iterable[Dict[str, Any]]) -> str:
    """ASCII tree of one trace — one line per span with service,
    duration, outcome, and sorted attrs."""
    spans = list(spans)
    if not spans:
        return "(no spans)"
    roots = assemble_tree(spans)
    tid = spans[0].get("trace_id", "?")
    out = [f"trace {tid} ({len({s.get('span_id') for s in spans})} spans)"]
    for i, root in enumerate(roots):
        _render_node(root, "", i == len(roots) - 1, out)
    return "\n".join(out)
