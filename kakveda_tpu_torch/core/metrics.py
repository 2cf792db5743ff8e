"""The in-process metrics plane: registry, Prometheus exposition, flight
recorders.

The port's own copy of ``kakveda_tpu/core/metrics.py`` (it imports nothing
of the JAX package): the same registry, exposition text and flight
recorder, so a scrape of the port reads like a scrape of the reference.

* **Registry** (:class:`MetricsRegistry`): counters, gauges, histograms
  with fixed log-spaced buckets, label support, thread-safe updates and a
  consistent :meth:`~MetricsRegistry.snapshot`. One process-global default
  (:func:`get_registry`); tests build private instances. A hot path
  resolves its bound label child once and keeps it, so an update is one
  lock and one add.
* **Exposition**: :meth:`MetricsRegistry.render` emits Prometheus text
  format (``# HELP``/``# TYPE``, escaped labels, cumulative ``_bucket``
  series ending in ``+Inf``), served at ``GET /metrics``
  (``kakveda_tpu_torch/service/app.py``).
* **Flight recorder** (:class:`FlightRecorder`): a bounded ring of recent
  request timelines and engine events per serving engine, dumped as JSON
  by ``GET /flightrecorder`` and into the log when an engine loop dies.

The catalog pre-declares the families of the planes the port reports
from: the serving engine's, the fault sites', the two admission
families the engine's ``submit`` moves, and the model router's two HBM
gauges (``models/runtime.MultiModelRuntime``). The other planes' families come
with their slices (ROADMAP Queue 1 item 5), as do fleet federation
(``parse_prometheus_text``, ``federate_renders``), ``device_block`` and the
stall watchdog that names each lock.

Knobs: ``KAKVEDA_METRICS_RECORDER`` — flight-recorder ring capacity per
engine (default 256; 0 disables recording but keeps the dump endpoints).
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "FlightRecorder",
    "get_registry",
    "dump_recorders",
    "TIME_BUCKETS",
    "RATE_BUCKETS",
    "PROMETHEUS_CONTENT_TYPE",
]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Fixed log-spaced buckets (1-2.5-5 per decade). TIME_BUCKETS spans 100 µs
# (a cheap host hop) to 100 s (a wedged remote dispatch); RATE_BUCKETS spans
# 1 tok/s (a struggling solo decode) to 100k tok/s (a saturated pool).
TIME_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
)
RATE_BUCKETS: Tuple[float, ...] = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 25000.0, 50000.0, 100000.0,
)


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats via repr."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_exemplar(ex: Optional[Tuple[str, float, float]]) -> str:
    """OpenMetrics exemplar suffix for a bucket line: a trace id linking
    the bucket to one recent observation ('' when the bucket has none)."""
    if not ex:
        return ""
    trace_id, v, ts = ex
    return f' # {{trace_id="{_escape_label(trace_id)}"}} {_fmt(v)} {ts:.3f}'


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


class _Family:
    """One named metric family: shared lock, labelnames, label children.

    Children are created on first :meth:`labels` call and cached — hot
    paths resolve their bound child once and keep it, so a per-event
    update is a lock + an add, never a dict lookup over label tuples.
    """

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _child_cls(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(kv)}, wants {sorted(self.labelnames)}"
            )
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._child_cls()(self)
                self._children[key] = child
        return child

    def _default(self):
        """The no-label child — lets `reg.counter(...).inc()` work for
        label-free families without an empty labels() call."""
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}; use .labels()")
        return self.labels()

    def _series(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())

    def _label_str(self, key: Tuple[str, ...], extra: str = "") -> str:
        parts = [
            f'{n}="{_escape_label(v)}"' for n, v in zip(self.labelnames, key)
        ]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""


class _CounterChild:
    __slots__ = ("_lock", "value")

    def __init__(self, family: "_Family"):
        self._lock = family._lock
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v


class Counter(_Family):
    kind = "counter"

    def _child_cls(self):
        return _CounterChild

    def inc(self, v: float = 1.0) -> None:
        self._default().inc(v)


class _GaugeChild:
    __slots__ = ("_lock", "value")

    def __init__(self, family: "_Family"):
        self._lock = family._lock
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)


class Gauge(_Family):
    kind = "gauge"

    def _child_cls(self):
        return _GaugeChild

    def set(self, v: float) -> None:
        self._default().set(v)

    def inc(self, v: float = 1.0) -> None:
        self._default().inc(v)

    def dec(self, v: float = 1.0) -> None:
        self._default().dec(v)


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "counts", "sum", "count", "exemplars")

    def __init__(self, family: "Histogram"):
        self._lock = family._lock
        self._bounds = family.buckets
        self.counts = [0] * (len(self._bounds) + 1)  # last = overflow (+Inf only)
        self.sum = 0.0
        self.count = 0
        # Bucket idx → (trace_id, value, ts): one exemplar per bucket,
        # last-write-wins — bounded by the bucket count, so "warn p95" is
        # one click from its worst recent trace without growing the child.
        self.exemplars: Dict[int, Tuple[str, float, float]] = {}

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        v = float(v)
        idx = bisect_left(self._bounds, v)
        with self._lock:
            self.counts[idx] += 1
            self.sum += v
            self.count += 1
            if exemplar:
                self.exemplars[idx] = (str(exemplar), v, time.time())


class Histogram(_Family):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Tuple[str, ...],
        buckets: Iterable[float] = TIME_BUCKETS,
    ):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        self.buckets = bs

    def _child_cls(self):
        return _HistogramChild

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        self._default().observe(v, exemplar=exemplar)


class MetricsRegistry:
    """Name → family store with get-or-create semantics: every subsystem
    calls ``counter/gauge/histogram`` with the same (name, labelnames) and
    gets the same family back — re-registration with a different shape is
    a programming error and raises."""

    def __init__(self, preregister: bool = True):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        if preregister:
            for kind, name, help, labels, buckets in _CORE_FAMILIES:
                if kind == "counter":
                    self.counter(name, help, labels)
                elif kind == "gauge":
                    self.gauge(name, help, labels)
                else:
                    self.histogram(name, help, labels, buckets=buckets or TIME_BUCKETS)

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Family:
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} re-registered as {cls.kind} {labelnames} "
                        f"but exists as {fam.kind} {fam.labelnames}"
                    )
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str, labelnames: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str, labelnames: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str,
        labelnames: Iterable[str] = (),
        buckets: Iterable[float] = TIME_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames, buckets=buckets)

    # --- exposition -----------------------------------------------------

    def render(self) -> str:
        """Prometheus text format. Families render in registration order;
        a family with no children still emits HELP/TYPE (the scrape is
        self-describing before the first event)."""
        with self._lock:
            fams = list(self._families.values())
        out: List[str] = []
        for fam in fams:
            out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam._series():
                if isinstance(child, _HistogramChild):
                    # Read a consistent view under the family lock; the
                    # cumulative sums are computed from that snapshot, so a
                    # concurrent observe can never break monotonicity.
                    with fam._lock:
                        counts = list(child.counts)
                        s, c = child.sum, child.count
                        exemplars = dict(child.exemplars)
                    acc = 0
                    for i, (bound, n) in enumerate(zip(fam.buckets, counts)):
                        acc += n
                        le = 'le="%s"' % _fmt(bound)
                        out.append(f"{fam.name}_bucket{fam._label_str(key, le)} {acc}"
                                   + _fmt_exemplar(exemplars.get(i)))
                    inf = 'le="+Inf"'
                    out.append(f"{fam.name}_bucket{fam._label_str(key, inf)} {c}"
                               + _fmt_exemplar(exemplars.get(len(fam.buckets))))
                    out.append(f"{fam.name}_sum{fam._label_str(key)} {_fmt(s)}")
                    out.append(f"{fam.name}_count{fam._label_str(key)} {c}")
                else:
                    out.append(f"{fam.name}{fam._label_str(key)} {_fmt(child.value)}")
        return "\n".join(out) + "\n"

    def snapshot(self, compact: bool = False) -> dict:
        """Plain-dict view for JSON embedding (bench lines, tests). With
        ``compact=True`` zero-valued series and empty families are dropped."""
        with self._lock:
            fams = list(self._families.values())
        snap: dict = {}
        for fam in fams:
            series: dict = {}
            for key, child in fam._series():
                label = ",".join(f"{n}={v}" for n, v in zip(fam.labelnames, key)) or ""
                if isinstance(child, _HistogramChild):
                    with fam._lock:
                        c, s = child.count, child.sum
                        exemplars = dict(child.exemplars)
                    if compact and c == 0:
                        continue
                    series[label] = {"count": c, "sum": round(s, 6)}
                    if exemplars:
                        # Latest exemplar only — the bench line wants "one
                        # click to the worst trace", not the full set.
                        tid, v, _ts = max(exemplars.values(), key=lambda e: e[2])
                        series[label]["exemplar"] = {
                            "trace_id": tid, "value": round(v, 6),
                        }
                else:
                    v = child.value
                    if compact and v == 0:
                        continue
                    series[label] = round(v, 6) if isinstance(v, float) else v
            if series or not compact:
                snap[fam.name] = {"type": fam.kind, "series": series}
        return snap


# --- the default registry + the pre-declared catalog -----------------------

# (kind, name, help, labelnames, buckets-or-None), the reference's entries
# for the planes the port reports from. Declared up front so a bare-process
# scrape already names the serving TTFT / tokens-per-second / gate-state
# families, and so there is one place the shapes live; the instrumentation
# sites get-or-create against these. The speculation families stay at a
# spec_k = 0 pool's values: the port serves no speculative chunks.
_CORE_FAMILIES = (
    ("histogram", "kakveda_serving_queue_wait_seconds",
     "Submit-to-admission wait in the serving engine queue", ("engine",), None),
    ("histogram", "kakveda_serving_prefill_seconds",
     "Admission prefill dispatch wall per request", ("engine",), None),
    ("histogram", "kakveda_serving_ttft_seconds",
     "Submit-to-first-token latency per request", ("engine",), None),
    ("histogram", "kakveda_serving_request_seconds",
     "Submit-to-completion wall per request", ("engine",), None),
    ("histogram", "kakveda_serving_tokens_per_second",
     "Per-request decode rate (tokens / request wall)", ("engine",), RATE_BUCKETS),
    ("histogram", "kakveda_serving_chunk_seconds",
     "Effective decode-chunk wall (dispatch to process, overlapped under "
     "pipelining)", ("engine", "flavor"), None),
    ("counter", "kakveda_serving_requests_total",
     "Serving requests by outcome", ("engine", "outcome"), None),
    ("counter", "kakveda_serving_tokens_total",
     "Decode tokens emitted to callers", ("engine",), None),
    ("counter", "kakveda_serving_spec_drafted_total",
     "Speculative draft tokens sent to verify chunks", ("engine",), None),
    ("counter", "kakveda_serving_spec_accepted_total",
     "Speculative draft tokens accepted by verify chunks", ("engine",), None),
    ("gauge", "kakveda_serving_spec_gate_state",
     "1 for the pool's current speculation gate state "
     "(disabled|warmup|on|off)", ("engine", "state"), None),
    ("counter", "kakveda_serving_gate_transitions_total",
     "Speculation auto-gate state transitions", ("engine", "from", "to"), None),
    ("gauge", "kakveda_serving_spec_k",
     "Pool verify width of the most recent speculative chunk", ("engine",), None),
    ("counter", "kakveda_serving_prefix_requests_total",
     "Admissions by prefix-cache result", ("engine", "result"), None),
    ("gauge", "kakveda_serving_active_slots",
     "Occupied slots in the continuous-batching pool", ("engine",), None),
    ("gauge", "kakveda_serving_slots",
     "Total slots in the continuous-batching pool", ("engine",), None),
    ("counter", "kakveda_serving_engine_errors_total",
     "Serving-engine loop deaths (flight recorder dumped on each)",
     ("engine",), None),
    ("counter", "kakveda_serving_engine_restarts_total",
     "Supervisor restarts of a serving-engine loop after a crash (bounded "
     "by KAKVEDA_SERVE_RESTARTS)", ("engine",), None),
    ("counter", "kakveda_faults_injected_total",
     "Injected faults by site (KAKVEDA_FAULTS chaos harness)", ("site",), None),
    ("counter", "kakveda_admission_shed_total",
     "Requests shed by admission control, by class and reason "
     "(queue_full|brownout|deadline|degraded|ratelimit)",
     ("klass", "reason"), None),
    ("histogram", "kakveda_admission_wait_seconds",
     "Observed downstream queue wait per admission class (feeds "
     "deadline-aware shedding)", ("klass",), None),
    ("gauge", "kakveda_hbm_budget_bytes",
     "Configured HBM weight+KV budget (0 = unbudgeted)", (), None),
    ("gauge", "kakveda_hbm_loaded_bytes",
     "Resident weight+KV bytes accounted by the model router", (), None),
)

_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


# --- flight recorder --------------------------------------------------------

# Every live recorder registers here so the dump endpoints can enumerate
# them without the HTTP layer knowing which engines exist. WeakSet: a
# closed engine's recorder disappears with it, no unregister protocol.
_RECORDERS: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()


class FlightRecorder:
    """Bounded ring of structured events (request timelines, gate/k
    transitions). Append is a lock + deque append; the ring survives any
    number of dumps and overwrites oldest-first at capacity
    (``KAKVEDA_METRICS_RECORDER``, default 256 events)."""

    def __init__(self, name: str, capacity: Optional[int] = None):
        if capacity is None:
            capacity = int(os.environ.get("KAKVEDA_METRICS_RECORDER", "256"))
        self.name = name
        self.capacity = max(0, capacity)
        self._lock = threading.Lock()
        self._events: List[dict] = []
        _RECORDERS.add(self)

    def record(self, kind: str, **fields) -> None:
        if self.capacity <= 0:
            return
        evt = {"kind": kind, "t": round(time.time(), 6), **fields}
        with self._lock:
            self._events.append(evt)
            if len(self._events) > self.capacity:
                del self._events[: len(self._events) - self.capacity]

    def dump(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._events]

    def dump_json(self) -> str:
        return json.dumps({"name": self.name, "events": self.dump()})


def dump_recorders() -> List[dict]:
    """Every live recorder's ring, oldest events first — the payload of
    ``GET /flightrecorder``."""
    recs = sorted(_RECORDERS, key=lambda r: r.name)
    return [{"name": r.name, "events": r.dump()} for r in recs]
