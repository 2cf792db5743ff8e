"""Overload protection + graceful degradation — the layer that keeps the
service ANSWERING when traffic or the card stops cooperating.

The port's own copy of ``kakveda_tpu/core/admission.py`` (it imports
nothing of the JAX package). Three cooperating controllers, one module:

* :class:`AdmissionController` — bounded per-class admission ahead of every
  real queue (warn micro-batcher, ingest pipeline, serving-engine pool).
  Classes are priority-ordered (``warn`` pre-flight > ``ingest`` >
  ``interactive`` generation > ``background`` batch/mine); each has its own
  in-flight bound so a flood of one class can never starve a higher one.
  Over the bound a request is SHED immediately with a typed
  :class:`OverloadError` whose ``retry_after`` derives from the observed
  per-class drain rate — the HTTP tier surfaces it as 429 + ``Retry-After``.
  Deadline-aware shedding rejects a request whose deadline cannot be met
  given the live queue-wait history instead of letting it burn a slot and
  expire anyway.
* :class:`BrownoutController` — under sustained pressure, step DOWN
  capability instead of falling over: disable speculation → clamp decode
  token budgets → shed the background class → shed interactive generation.
  Thresholds carry hysteresis (enter high, exit low, minimum dwell) so the
  ladder doesn't flap; every transition goes through ONE
  :meth:`_set_brownout_state` helper that moves the state gauge vector, the
  transition counter and the flight recorder together. The serving engine
  reads the ladder at submit (class sheds, the token cap) and before each
  chunk (the speculation veto).
* :class:`DeviceHealth` — the device-loss latch (the reference's, with
  CUDA's failure modes): a backend error on a device path latches
  DEGRADED, the warn path then answers from the GFKB's host tiers with
  ``degraded=True``, generation fails fast with
  :class:`DeviceUnavailableError`, and a probe thread un-latches when the
  card answers again.

Everything is process-global by default (:func:`get_admission`,
:func:`get_device_health`) — the HTTP tier, the serving engine and the
warn pipeline see ONE pressure picture. Tests build private instances
and/or call :func:`reset_for_tests`.

Per-tenant fairness: admission is also TENANT-aware — call sites that
know the requesting app key pass it as ``tenant=`` and the controller
enforces a per-tenant share quota INSIDE each class
(``KAKVEDA_TENANT_MAX_SHARE`` of the class bound, work-conserving: a lone
tenant may still use the whole class). Tenant state lives in ONE bounded
LRU table (``KAKVEDA_TENANT_TABLE`` rows, overflow folds into an ``other``
bucket that never quota-sheds — fail open, never wrong-but-confident) and
every mutation of it flows through the single-writer
:meth:`AdmissionController._set_tenant_state` helper (table + size gauge +
per-tenant shed counter + flight recorder move together). A quota shed
raises the same typed :class:`OverloadError` with ``reason=
"tenant_quota"`` and tenant provenance; its Retry-After derives from
THAT tenant's own drain rate when one has been observed. The
``admission.tenant_quota`` fault site fails OPEN: an armed fault skips
quota bookkeeping and admits on class capacity alone.
``KAKVEDA_TENANT_FAIR=0`` disables the whole tenant plane.

:meth:`AdmissionController.note_fleet_pressure` is ported as the
reference has it; nothing in the port feeds it until the fleet comes.

Knobs: ``KAKVEDA_ADMIT`` (0 disables shedding),
``KAKVEDA_ADMIT_WARN/_INGEST/_INTERACTIVE/_BACKGROUND`` per-class bounds,
``KAKVEDA_ADMIT_RA_JITTER``, ``KAKVEDA_ADMIT_OCC_WINDOW_S``,
``KAKVEDA_BROWNOUT`` (0 disables the ladder), ``KAKVEDA_BROWNOUT_ENTER`` /
``KAKVEDA_BROWNOUT_EXIT`` / ``KAKVEDA_BROWNOUT_DWELL`` /
``KAKVEDA_BROWNOUT_TOKEN_CAP``, ``KAKVEDA_DEGRADED_PROBE``,
``KAKVEDA_TENANT_FAIR`` / ``KAKVEDA_TENANT_TABLE`` /
``KAKVEDA_TENANT_MAX_SHARE`` / ``KAKVEDA_TENANT_TOPK``.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple

from kakveda_tpu_torch.core import faults as _faults
from kakveda_tpu_torch.core import metrics as _metrics
from kakveda_tpu_torch.core import sanitize

log = logging.getLogger("kakveda.admission")

__all__ = [
    "OverloadError",
    "DeviceUnavailableError",
    "AdmissionController",
    "BrownoutController",
    "DeviceHealth",
    "get_admission",
    "get_device_health",
    "reset_for_tests",
    "tenant_fair_enabled",
    "note_tenant_promotion",
    "tenant_promotions",
    "CLASSES",
]

# Priority order, highest first. The warn pre-flight check is the product's
# whole point and must survive everything below it; background batch work
# (full mines, snapshots) is the first thing a brownout sheds.
CLASSES: Tuple[str, ...] = ("warn", "ingest", "interactive", "background")

# Brownout ladder, mild → severe. Each step KEEPS every restriction of the
# steps before it.
BROWNOUT_STATES: Tuple[str, ...] = (
    "normal",            # full capability
    "no_spec",           # speculation off (verify-width FLOPs back to decode)
    "clamped",           # + decode token budgets clamped (shorter answers)
    "shed_background",   # + background class rejected outright
    "shed_interactive",  # + interactive generation rejected (warn/ingest live)
)


class OverloadError(Exception):
    """A request was shed by admission control or the brownout ladder.

    Deliberately NOT a RuntimeError: the serving paths treat RuntimeError
    as 'engine closed, fall back to a solo decode' — a shed request must
    NOT silently take the fallback path (that would defeat the shed), it
    must surface to the caller as 429 + Retry-After.
    """

    def __init__(self, message: str, retry_after: float = 1.0,
                 klass: str = "", reason: str = "", tenant: str = ""):
        super().__init__(message)
        self.retry_after = max(0.1, float(retry_after))
        self.klass = klass
        self.reason = reason
        # Tenant provenance: the app key whose traffic was shed (empty for
        # tenant-blind call sites). The HTTP tier reads it.
        self.tenant = tenant


class DeviceUnavailableError(Exception):
    """The card is latched DEGRADED (a sticky CUDA error, a lost device).
    Retryable: the probe un-latches when the card answers again, and
    ``retry_after`` hints when to come back. Not a RuntimeError, for the
    reason :class:`OverloadError` is not: the solo-decode fallback would hit
    the same dead device."""

    def __init__(self, message: str, retry_after: float = 5.0):
        super().__init__(message)
        self.retry_after = max(0.1, float(retry_after))


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


def tenant_fair_enabled() -> bool:
    """The ONE switch for the whole tenant plane (admission quotas, warn
    micro-batcher DRR, serving-slot weighted-fair). ``KAKVEDA_TENANT_FAIR=0``
    must keep every scheduler bit-for-bit FIFO — each consumer resolves
    this at construction, the same discipline as every other knob."""
    return os.environ.get("KAKVEDA_TENANT_FAIR", "1") != "0"


# Starvation-promotion accounting, shared across planes (the serving
# engine's max-wait promotion lives in models/serving.py but the tenant
# plane's observability surface — info() and /readyz — is here).
_PROMOTIONS_LOCK = threading.Lock()
_PROMOTIONS: Dict[str, int] = {}
_PROMOTIONS_CHILDREN: Dict[str, object] = {}


def note_tenant_promotion(plane: str) -> None:
    """Count one starvation promotion (a waiting item force-admitted after
    sitting out the max fair-scheduling rounds). ``plane`` is a bounded
    enum ("serving", …), never a tenant id — cardinality stays O(planes)."""
    with _PROMOTIONS_LOCK:
        _PROMOTIONS[plane] = _PROMOTIONS.get(plane, 0) + 1
        child = _PROMOTIONS_CHILDREN.get(plane)
        if child is None:
            child = _metrics.get_registry().counter(
                "kakveda_tenant_promotions_total",
                "Starvation promotions by fair schedulers (a waiting item "
                "admitted out of deficit order after max fair rounds)",
                ("plane",),
            ).labels(plane=plane)
            _PROMOTIONS_CHILDREN[plane] = child
    child.inc()


def tenant_promotions() -> Dict[str, int]:
    with _PROMOTIONS_LOCK:
        return dict(_PROMOTIONS)


class BrownoutController:
    """The capability ladder. Pressure in, capability restrictions out.

    Pressure is the max over classes of in-flight/limit (fed by the
    admission controller on every admit/release) combined with the recent
    interactive queue-wait. Hysteresis: a step is entered when pressure
    ≥ ``enter`` and left only when pressure ≤ ``exit`` AND the state has
    dwelled ``dwell_s`` — so one burst can't flap the ladder per request.
    The ladder moves ONE step per evaluation in either direction; severe
    states are reached by sustained pressure, not a single spike.
    """

    def __init__(
        self,
        *,
        enabled: Optional[bool] = None,
        enter: Optional[float] = None,
        exit: Optional[float] = None,
        dwell_s: Optional[float] = None,
        token_cap: Optional[int] = None,
        recorder: Optional[_metrics.FlightRecorder] = None,
    ):
        self.enabled = (
            os.environ.get("KAKVEDA_BROWNOUT", "1") != "0"
            if enabled is None else enabled
        )
        self.enter = _env_float("KAKVEDA_BROWNOUT_ENTER", 0.85) if enter is None else enter
        self.exit = _env_float("KAKVEDA_BROWNOUT_EXIT", 0.5) if exit is None else exit
        self.dwell_s = _env_float("KAKVEDA_BROWNOUT_DWELL", 5.0) if dwell_s is None else dwell_s
        self._token_cap = (
            _env_int("KAKVEDA_BROWNOUT_TOKEN_CAP", 32)
            if token_cap is None else token_cap
        )
        self.recorder = recorder
        self._lock = sanitize.named_lock("BrownoutController._lock", kind="rlock")
        self._step = 0
        self._entered_at = time.monotonic()
        # Time-in-state accounting (bench occupancy + postmortems).
        self._occupancy: Dict[str, float] = {s: 0.0 for s in BROWNOUT_STATES}
        reg = _metrics.get_registry()
        self._gauge = reg.gauge(
            "kakveda_brownout_state",
            "1 on the brownout ladder's current step "
            "(normal|no_spec|clamped|shed_background|shed_interactive)",
            ("state",),
        )
        self._transitions = reg.counter(
            "kakveda_brownout_transitions_total",
            "Brownout ladder step transitions", ("from", "to"),
        )
        for s in BROWNOUT_STATES:
            self._gauge.labels(state=s).set(1.0 if s == "normal" else 0.0)

    # -- reads -----------------------------------------------------------

    @property
    def step(self) -> int:
        return self._step

    @property
    def state(self) -> str:
        return BROWNOUT_STATES[self._step]

    def spec_allowed(self) -> bool:
        """Speculative decoding permitted? False from step 1 up."""
        return self._step < 1

    def token_cap(self) -> Optional[int]:
        """max_new_tokens clamp, or None when unclamped (below step 2)."""
        return self._token_cap if self._step >= 2 else None

    def class_shed(self, klass: str) -> bool:
        """Is this admission class currently shed outright by the ladder?"""
        if self._step >= 4 and klass == "interactive":
            return True
        if self._step >= 3 and klass == "background":
            return True
        return False

    def occupancy(self) -> Dict[str, float]:
        """Seconds spent in each ladder state (current state up to now)."""
        with self._lock:
            occ = dict(self._occupancy)
            occ[self.state] += time.monotonic() - self._entered_at
            return occ

    # -- transitions -----------------------------------------------------

    def _set_brownout_state(self, new_step: int, pressure: float) -> None:
        """ONE definition of a ladder transition: step, the state gauge
        vector, the transition counter, occupancy accounting and the
        flight recorder move together. Caller holds ``_lock``."""
        old_step = self._step
        if new_step == old_step:
            return
        now = time.monotonic()
        old, new = BROWNOUT_STATES[old_step], BROWNOUT_STATES[new_step]
        self._occupancy[old] += now - self._entered_at
        self._entered_at = now
        self._step = new_step
        self._gauge.labels(state=old).set(0.0)
        self._gauge.labels(state=new).set(1.0)
        self._transitions.labels(**{"from": old, "to": new}).inc()
        if self.recorder is not None:
            self.recorder.record(
                "brownout", **{"from": old, "to": new,
                               "pressure": round(pressure, 3)}
            )
        log.warning(
            "brownout %s -> %s (pressure %.2f)", old, new, pressure
        )

    def note_pressure(self, pressure: float) -> None:
        """Feed one pressure sample (max class load fraction) and move the
        ladder at most one step. Cheap — a lock and two compares."""
        if not self.enabled:
            return
        with self._lock:
            if pressure >= self.enter and self._step < len(BROWNOUT_STATES) - 1:
                # Escalate one step only after dwelling at the current one
                # (the first step is immediate — shedding FLOPs is cheap
                # and reversible; later steps need sustained pressure).
                if self._step == 0 or (
                    time.monotonic() - self._entered_at >= self.dwell_s
                ):
                    self._set_brownout_state(self._step + 1, pressure)
            elif pressure <= self.exit and self._step > 0:
                if time.monotonic() - self._entered_at >= self.dwell_s:
                    self._set_brownout_state(self._step - 1, pressure)

    def reset(self) -> None:
        with self._lock:
            self._set_brownout_state(0, 0.0)
            # Deliberate direct writes AFTER the single-writer helper ran:
            # reset() re-zeroes the occupancy HISTORY (tests, bench phase
            # boundaries) — not a ladder transition, which the helper above
            # already performed with full gauge/counter/recorder movement.
            self._occupancy = {s: 0.0 for s in BROWNOUT_STATES}  # kakveda: allow[single-writer]
            self._entered_at = time.monotonic()  # kakveda: allow[single-writer]


class AdmissionController:
    """Bounded per-class admission with typed shedding.

    ``admit(klass)`` either returns (the caller runs, then calls
    ``release``) or raises :class:`OverloadError` immediately — a shed
    costs microseconds, never a slot. The bound covers in-flight work
    INCLUDING whatever downstream queue the class drains through (warn
    micro-batcher, engine pool): the controller doesn't queue anything
    itself, it keeps the real queues from growing past what they can
    drain before callers time out.
    """

    _WAIT_WINDOW = 64  # recent queue-wait samples per class

    def __init__(
        self,
        limits: Optional[Dict[str, int]] = None,
        *,
        enabled: Optional[bool] = None,
        brownout: Optional[BrownoutController] = None,
        recorder: Optional[_metrics.FlightRecorder] = None,
    ):
        self.enabled = (
            os.environ.get("KAKVEDA_ADMIT", "1") != "0"
            if enabled is None else enabled
        )
        self.limits: Dict[str, int] = {
            "warn": _env_int("KAKVEDA_ADMIT_WARN", 256),
            "ingest": _env_int("KAKVEDA_ADMIT_INGEST", 64),
            "interactive": _env_int("KAKVEDA_ADMIT_INTERACTIVE", 32),
            "background": _env_int("KAKVEDA_ADMIT_BACKGROUND", 4),
        }
        if limits:
            self.limits.update(limits)
        self.recorder = recorder or _metrics.FlightRecorder("admission")
        self.brownout = brownout if brownout is not None else BrownoutController(
            recorder=self.recorder
        )
        self._lock = sanitize.named_lock("AdmissionController._lock")
        self._inflight: Dict[str, int] = {k: 0 for k in CLASSES}
        # Fleet pressure floor (the peer-gossip input, fed by
        # fleet/gossip.py and the service's /fleet/gossip): the max
        # live PEER occupancy with an expiry — while fresh, pressure() is
        # max(local, fleet) so the brownout ladder degrades fleet-wide.
        # This is an INPUT feed only: transitions still happen solely in
        # BrownoutController._set_brownout_state.
        self._fleet_pressure: Tuple[float, float] = (0.0, 0.0)  # (value, expires)
        # Per-class drain-rate estimate: (completions, window start) over a
        # sliding ~5 s window, plus recent observed queue waits — the two
        # inputs Retry-After and deadline shedding derive from.
        self._done_count: Dict[str, int] = {k: 0 for k in CLASSES}
        self._done_t0: Dict[str, float] = {k: time.monotonic() for k in CLASSES}
        self._drain_rate: Dict[str, float] = {k: 0.0 for k in CLASSES}
        # Bounded multiplicative Retry-After jitter fraction (see
        # retry_after): 0 disables, clamped to [0, 1).
        self._ra_jitter = min(0.99, max(
            0.0, _env_float("KAKVEDA_ADMIT_RA_JITTER", 0.25)
        ))
        self._waits: Dict[str, deque] = {k: deque(maxlen=self._WAIT_WINDOW) for k in CLASSES}
        # Peak-hold window for the EXPORTED local pressure (gossip/probe):
        # a flood of short-lived requests through a small class bound
        # (one 100 ms mine at a time through background=1) is real
        # sustained load, but point-in-time in-flight samples flicker
        # 1.0/0.0 and an autoscaler's dwell clock resets on every dip.
        # (ts, local) peaks recorded at admit time; local_pressure() is
        # the max over the window. 0 = instantaneous export.
        self._occ_window_s = max(
            0.0, _env_float("KAKVEDA_ADMIT_OCC_WINDOW_S", 3.0))
        self._occ_peaks: deque = deque(maxlen=1024)
        # --- tenant plane -----------------------------------------------
        # One bounded LRU table of per-tenant records; EVERY mutation goes
        # through _set_tenant_state (single-writer). A
        # record: per-class in-flight, admit/shed counts, and the same
        # drain-rate window the class keeps — the input to per-tenant
        # Retry-After. Overflow past the bound evicts the stalest idle
        # tenant, else folds into the aggregate "other" bucket, which
        # NEVER quota-sheds (no per-tenant resolution → fail open).
        self._tenant_fair = tenant_fair_enabled()
        self._tenant_table_max = max(2, _env_int("KAKVEDA_TENANT_TABLE", 512))
        self._tenant_share = min(1.0, max(
            0.01, _env_float("KAKVEDA_TENANT_MAX_SHARE", 0.5)))
        self._tenant_topk = max(1, _env_int("KAKVEDA_TENANT_TOPK", 16))
        self._tenants: "OrderedDict[str, dict]" = OrderedDict()
        # Fail-OPEN chaos site: armed → quota bookkeeping is skipped and
        # the request admits on class capacity alone (degraded fairness,
        # never a shed storm). Resolved once, like every site.
        self._fault_tenant = _faults.site("admission.tenant_quota")
        reg = _metrics.get_registry()
        self._g_tenant_table = reg.gauge(
            "kakveda_tenant_table_size",
            "Live per-tenant state-table rows per plane (bounded by "
            "KAKVEDA_TENANT_TABLE / KAKVEDA_RATELIMIT_MAX_KEYS)",
            ("plane",),
        ).labels(plane="admission")
        c_tenant_shed = reg.counter(
            "kakveda_admission_tenant_shed_total",
            "Requests shed per tenant label (top-K first-seen shed tenants; "
            "the rest aggregate under tenant=\"other\" — "
            "docs/observability.md cardinality policy)",
            ("tenant",),
        )
        self._c_tenant_shed = c_tenant_shed
        self._tenant_shed_children: Dict[str, object] = {}
        self._c_tenant_degraded = reg.counter(
            "kakveda_admission_tenant_quota_degraded_total",
            "Admissions where tenant-quota bookkeeping failed open "
            "(admission.tenant_quota fault site)",
        )
        g_inflight = reg.gauge(
            "kakveda_admission_inflight",
            "In-flight (admitted, not yet released) requests per admission "
            "class", ("klass",),
        )
        c_admitted = reg.counter(
            "kakveda_admission_admitted_total",
            "Requests admitted per admission class", ("klass",),
        )
        self._c_shed = reg.counter(
            "kakveda_admission_shed_total",
            "Requests shed by admission control, by class and reason "
            "(queue_full|brownout|deadline|degraded|ratelimit)",
            ("klass", "reason"),
        )
        h_wait = reg.histogram(
            "kakveda_admission_wait_seconds",
            "Observed downstream queue wait per admission class (feeds "
            "deadline-aware shedding)", ("klass",),
        )
        self._m_inflight = {k: g_inflight.labels(klass=k) for k in CLASSES}
        self._m_admitted = {k: c_admitted.labels(klass=k) for k in CLASSES}
        self._m_wait = {k: h_wait.labels(klass=k) for k in CLASSES}
        # Per-INSTANCE shed accounting (the metric family above is
        # process-global and shared by every controller): what
        # shed_counts() reports, so a private bench/test controller sees
        # only its own rejections.
        self._sheds: Dict[str, float] = {}

    # -- pressure --------------------------------------------------------

    def _local_locked(self) -> float:
        return max(
            self._inflight[k] / self.limits[k] if self.limits[k] > 0 else 0.0
            for k in CLASSES
        )

    def _pressure_locked(self) -> float:
        local = self._local_locked()
        fp, expires = self._fleet_pressure
        if fp > local and time.monotonic() < expires:
            return fp
        return local

    def pressure(self) -> float:
        with self._lock:
            return self._pressure_locked()

    def _note_peak_locked(self, now: float) -> None:
        if self._occ_window_s > 0.0:
            self._occ_peaks.append((now, self._local_locked()))

    def local_pressure(self) -> float:
        """Peak-held max class load from THIS replica's own in-flight
        work — the gossip/probe EXPORT. Two deliberate properties:

        * excludes the TTL'd fleet floor: publishing the combined
          ``pressure()`` echoes a peer's number back as this replica's
          own state, and two idle replicas then refresh each other's
          floor forever — a latched pressure rumor no real load backs,
          which pins the brownout ladder AND the autoscaler's scale-down
          signal. The floor stays an INPUT (``pressure()``), never an
          output.
        * holds admit-time peaks for ``KAKVEDA_ADMIT_OCC_WINDOW_S`` (3 s;
          0 = instantaneous): a flood of short requests through a small
          class bound is real sustained load, but point samples flicker
          1.0/0.0 between them and a dwell clock resets on every dip."""
        with self._lock:
            cur = self._local_locked()
            if self._occ_window_s <= 0.0:
                return cur
            horizon = time.monotonic() - self._occ_window_s
            while self._occ_peaks and self._occ_peaks[0][0] < horizon:
                self._occ_peaks.popleft()
            return max([cur] + [v for _, v in self._occ_peaks])

    def note_fleet_pressure(self, pressure: float, ttl_s: float = 5.0) -> None:
        """Gossip input: fold the fleet's worst live
        occupancy in as a pressure floor with an expiry — a silent peer
        stops contributing after ``ttl_s``, so a dead replica can't pin
        the whole fleet browned-out. Also re-evaluates the ladder, which
        is how an IDLE replica follows the fleet down (and back up)."""
        p = max(0.0, min(float(pressure), 2.0))
        with self._lock:
            self._fleet_pressure = (p, time.monotonic() + max(0.1, ttl_s))
            combined = self._pressure_locked()
        self.brownout.note_pressure(combined)

    def fleet_pressure(self) -> float:
        """The live (unexpired) fleet pressure floor, 0.0 when none."""
        with self._lock:
            fp, expires = self._fleet_pressure
            return fp if time.monotonic() < expires else 0.0

    # -- drain rate / retry-after ---------------------------------------

    def _note_done_locked(self, klass: str) -> None:
        now = time.monotonic()
        self._done_count[klass] += 1
        dt = now - self._done_t0[klass]
        if dt >= 5.0:
            # Fold the window into the EWMA-ish estimate and restart it.
            rate = self._done_count[klass] / dt
            prev = self._drain_rate[klass]
            self._drain_rate[klass] = rate if prev == 0.0 else 0.5 * prev + 0.5 * rate
            self._done_count[klass] = 0
            self._done_t0[klass] = now

    def retry_after(self, klass: str, tenant: str = "") -> float:
        """Seconds until the class's backlog plausibly drains: in-flight /
        observed drain rate, clamped to [0.5, 30], then spread by a bounded
        multiplicative jitter (±``KAKVEDA_ADMIT_RA_JITTER``, default 0.25).

        With a ``tenant`` whose drain rate has been observed, the estimate
        is THAT tenant's own backlog over its own rate instead — a
        quota-shed flooder is told when ITS slots free up, not when the
        class (which other tenants keep busy) does.

        The jitter is load-bearing, not cosmetic: without it every client
        shed in the same saturation window gets the SAME drain-derived
        hint, and the ones that honor it re-arrive in lockstep — a
        metastable retry storm that re-saturates the gate exactly one
        Retry-After later. Spreading the hint de-phases the retry wave.
        With no rate measured yet the base is a 1 s default — honest
        enough for a fresh process, and jittered for the same reason."""
        with self._lock:
            rate = self._drain_rate[klass]
            if rate <= 0.0:
                # Live window estimate before the first fold.
                dt = time.monotonic() - self._done_t0[klass]
                if self._done_count[klass] and dt > 0.05:
                    rate = self._done_count[klass] / dt
            backlog = self._inflight[klass]
            if self._tenant_fair and tenant:
                rec = self._tenants.get(tenant)
                if rec is not None:
                    trate = rec["rate"]
                    if trate <= 0.0:
                        dt = time.monotonic() - rec["t0"]
                        if rec["done"] and dt > 0.05:
                            trate = rec["done"] / dt
                    if trate > 0.0:
                        rate = trate
                        backlog = rec["inflight"].get(klass, 0)
        if rate <= 0.0:
            base = 1.0
        else:
            base = min(30.0, max(0.5, backlog / rate))
        if self._ra_jitter <= 0.0:
            return base
        # Uniform in [1-j, 1+j]: bounded (a client never waits more than
        # (1+j)x the honest estimate) and multiplicative (the spread scales
        # with the backlog it is de-phasing). Floor at the OverloadError
        # minimum so the typed 429 shape is unchanged.
        return max(0.1, base * (1.0 + self._ra_jitter * (2.0 * random.random() - 1.0)))

    def note_wait(self, klass: str, wait_s: float) -> None:
        """Feed one observed downstream queue wait (engine admission,
        micro-batcher drain) — the live histogram deadline shedding reads.
        Also re-evaluates the brownout ladder: warn traffic flows through
        the micro-batcher's own bounded queue, never try_admit/release, so
        without this a warn-only recovery tail produced ZERO pressure
        samples and the ladder froze at its storm step."""
        self._m_wait[klass].observe(wait_s)
        with self._lock:
            self._waits[klass].append(wait_s)
            pressure = self._pressure_locked()
        self.brownout.note_pressure(pressure)

    def predicted_wait(self, klass: str) -> float:
        """Pessimistic queue-wait estimate for a NEW request of ``klass``:
        ~p95 of recent observed waits, scaled by how full the class is.
        Zero until waits have been observed (never shed on no data)."""
        with self._lock:
            waits = sorted(self._waits[klass])
            if not waits:
                return 0.0
            p95 = waits[min(len(waits) - 1, int(0.95 * len(waits)))]
            load = self._inflight[klass] / max(1, self.limits[klass])
        return p95 * (1.0 + load)

    # -- tenant plane ----------------------------------------------------

    def _tenant_cap(self, klass: str) -> int:
        return max(1, int(self.limits[klass] * self._tenant_share))

    def _set_tenant_state(
        self,
        tenant: Optional[str],
        klass: Optional[str] = None,
        *,
        inflight_delta: int = 0,
        shed: bool = False,
        done: bool = False,
        retry_after: float = 0.0,
        clear: bool = False,
    ) -> Optional[dict]:
        """ONE definition of a tenant-table mutation: the bounded LRU table
        (touch / create / evict / overflow-fold), per-class in-flight and
        admit/shed/drain accounting, the table-size gauge, the capped
        per-tenant shed counter and the flight recorder all move together.
        Caller holds ``_lock``. Returns the (possibly "other") record."""
        if clear:
            self._tenants.clear()
            self._g_tenant_table.set(0.0)
            return None
        assert tenant
        now = time.monotonic()
        rec = self._tenants.get(tenant)
        if rec is None:
            if len(self._tenants) >= self._tenant_table_max:
                # Evict the stalest tenant with nothing in flight; if every
                # row is live (pathological), fold THIS tenant into the
                # aggregate bucket instead of growing.
                victim = None
                for k, r in self._tenants.items():  # LRU order, oldest first
                    if k != "other" and not any(r["inflight"].values()):
                        victim = k
                        break
                if victim is not None:
                    del self._tenants[victim]
                else:
                    tenant = "other"
                    rec = self._tenants.get("other")
            if rec is None:
                rec = {
                    "key": tenant,
                    "inflight": {},
                    "admits": 0,
                    "sheds": 0,
                    "done": 0,
                    "t0": now,
                    "rate": 0.0,
                }
                self._tenants[tenant] = rec
        self._tenants.move_to_end(tenant)
        self._g_tenant_table.set(float(len(self._tenants)))
        if inflight_delta:
            held = rec["inflight"].get(klass, 0) + inflight_delta
            rec["inflight"][klass] = max(0, held)
            if inflight_delta > 0:
                rec["admits"] += 1
        if done:
            # Same fold-at-5s drain-rate window the class keeps — the
            # per-tenant Retry-After input.
            rec["done"] += 1
            dt = now - rec["t0"]
            if dt >= 5.0:
                rate = rec["done"] / dt
                prev = rec["rate"]
                rec["rate"] = rate if prev == 0.0 else 0.5 * prev + 0.5 * rate
                rec["done"] = 0
                rec["t0"] = now
        if shed:
            rec["sheds"] += 1
            label = tenant if (
                tenant in self._tenant_shed_children
                or len(self._tenant_shed_children) < self._tenant_topk
            ) else "other"
            child = self._tenant_shed_children.get(label)
            if child is None:
                child = self._c_tenant_shed.labels(tenant=label)
                self._tenant_shed_children[label] = child
            child.inc()
            if self.recorder is not None:
                self.recorder.record(
                    "tenant_shed", tenant=tenant, klass=klass or "",
                    retry_after=round(retry_after, 2),
                )
        return rec

    def _tenant_quota_locked(self, klass: str, tenant: str) -> Optional[Tuple[int, int]]:
        """None → admit; (held, cap) → quota shed. Caller holds ``_lock``
        and has already established class capacity. The quota is
        WORK-CONSERVING: it only binds while OTHER tenants hold in-flight
        work in the class — a lone tenant may use the whole bound. The
        ``admission.tenant_quota`` site fails OPEN (skip quota, admit)."""
        if not (self._tenant_fair and tenant):
            return None
        try:
            self._fault_tenant.fire()
        except _faults.FaultInjected:
            self._c_tenant_degraded.inc()
            return None
        rec = self._set_tenant_state(tenant)
        if rec is None or rec["key"] == "other":
            return None
        held = rec["inflight"].get(klass, 0)
        cap = self._tenant_cap(klass)
        if held >= cap and held < self._inflight[klass]:
            return held, cap
        return None

    def tenants_info(self) -> dict:
        """The tenant-plane report for info() and /readyz:
        top shed tenants (with shed rate for the pinned-at-100% doctor
        check), live quota occupancy, table bound, promotions."""
        with self._lock:
            fair = self._tenant_fair
            size = len(self._tenants)
            rows = [
                {
                    "tenant": k,
                    "sheds": r["sheds"],
                    "admits": r["admits"],
                    "shed_rate": round(
                        r["sheds"] / max(1, r["sheds"] + r["admits"]), 4),
                    "inflight": {c: n for c, n in r["inflight"].items() if n},
                }
                for k, r in self._tenants.items()
            ]
        rows.sort(key=lambda r: (-r["sheds"], r["tenant"]))
        return {
            "fair": fair,
            "table_size": size,
            "table_max": self._tenant_table_max,
            "max_share": self._tenant_share,
            "top_shed": rows[:8],
            "promotions": tenant_promotions(),
        }

    # -- admit / release -------------------------------------------------

    def try_admit(self, klass: str, deadline_s: Optional[float] = None,
                  tenant: str = "") -> None:
        """Admit or raise :class:`OverloadError`. Callers MUST pair a
        successful return with :meth:`release` (use :meth:`slot`)."""
        if klass not in self._inflight:
            raise ValueError(f"unknown admission class {klass!r}")
        if not self.enabled:
            with self._lock:
                self._inflight[klass] += 1
                self._note_peak_locked(time.monotonic())
            self._m_inflight[klass].set(self._inflight[klass])
            self._m_admitted[klass].inc()
            return
        if self.brownout.class_shed(klass):
            self.shed(klass, "brownout", tenant=tenant)
        with self._lock:
            busy = self._inflight[klass] > 0
        if deadline_s is not None and busy:
            # Only with LIVE in-flight work: an idle class's wait history
            # describes a past storm, not this request's fate.
            predicted = self.predicted_wait(klass)
            if predicted > deadline_s:
                self.shed(
                    klass, "deadline",
                    detail=f"predicted queue wait {predicted:.2f}s exceeds "
                           f"deadline {deadline_s:.2f}s",
                    tenant=tenant,
                )
        quota: Optional[Tuple[int, int]] = None
        with self._lock:
            if self._inflight[klass] >= self.limits[klass]:
                # Shed-at-limit is peak load too: between two short-lived
                # admits the instantaneous in-flight reads 0, but demand
                # past the bound is exactly what the autoscaler must see.
                self._note_peak_locked(time.monotonic())
                pressure = self._pressure_locked()
            else:
                quota = self._tenant_quota_locked(klass, tenant)
                if quota is None:
                    self._inflight[klass] += 1
                    if self._tenant_fair and tenant:
                        self._set_tenant_state(tenant, klass, inflight_delta=1)
                    self._note_peak_locked(time.monotonic())
                    self._m_inflight[klass].set(self._inflight[klass])
                    self._m_admitted[klass].inc()
                    pressure = self._pressure_locked()
                    self.brownout.note_pressure(pressure)
                    return
                # Quota shed is tenant-local demand, not class pressure —
                # record the peak (real arriving load) but shed below.
                self._note_peak_locked(time.monotonic())
                pressure = self._pressure_locked()
        self.brownout.note_pressure(pressure)
        if quota is not None:
            held, cap = quota
            self.shed(
                klass, "tenant_quota",
                detail=f"tenant {tenant!r} holds {held}/{cap} {klass} slots "
                       "while other tenants wait",
                tenant=tenant,
            )
        self.shed(klass, "queue_full", tenant=tenant)

    def note_shed(self, klass: str, reason: str, retry_after: float = 1.0,
                  tenant: str = "") -> None:
        """Record a shed decided OUTSIDE the controller (token bucket,
        micro-batcher bound) so every rejection lands on one counter."""
        self._c_shed.labels(klass=klass, reason=reason).inc()
        key = f"{klass}/{reason}"
        with self._lock:
            self._sheds[key] = self._sheds.get(key, 0) + 1
            if self._tenant_fair and tenant:
                self._set_tenant_state(
                    tenant, klass, shed=True, retry_after=retry_after)
        if self.recorder is not None:
            self.recorder.record(
                "shed", klass=klass, reason=reason,
                retry_after=round(retry_after, 2),
                **({"tenant": tenant} if tenant else {}),
            )

    def shed(self, klass: str, reason: str, detail: str = "",
             tenant: str = "") -> None:
        """Record + raise: THE rejection path (429 + Retry-After at the
        HTTP tier)."""
        ra = self.retry_after(klass, tenant=tenant)
        self.note_shed(klass, reason, retry_after=ra, tenant=tenant)
        msg = f"{klass} request shed ({reason})"
        if detail:
            msg += f": {detail}"
        raise OverloadError(msg, retry_after=ra, klass=klass, reason=reason,
                            tenant=tenant)

    def release(self, klass: str, wait_s: Optional[float] = None,
                tenant: str = "") -> None:
        with self._lock:
            self._inflight[klass] = max(0, self._inflight[klass] - 1)
            self._note_done_locked(klass)
            if self._tenant_fair and tenant:
                self._set_tenant_state(tenant, klass, inflight_delta=-1,
                                       done=True)
            pressure = self._pressure_locked()
        self._m_inflight[klass].set(self._inflight[klass])
        if wait_s is not None:
            self.note_wait(klass, wait_s)
        self.brownout.note_pressure(pressure)

    def slot(self, klass: str, deadline_s: Optional[float] = None,
             tenant: str = "") -> "_Slot":
        """Context-manager admission: sheds on entry, releases on exit."""
        return _Slot(self, klass, deadline_s, tenant)

    def shed_counts(self) -> Dict[str, float]:
        """{"klass/reason": count} for THIS controller instance — bench +
        readyz surface (the metric family is process-global and would mix
        controllers)."""
        with self._lock:
            return dict(self._sheds)

    def info(self) -> dict:
        """Mode report for /readyz: per-class occupancy + ladder state."""
        occupancy = self.local_pressure()
        with self._lock:
            inflight = dict(self._inflight)
        return {
            "enabled": self.enabled,
            "classes": {
                k: {"inflight": inflight[k], "limit": self.limits[k]}
                for k in CLASSES
            },
            "brownout": self.brownout.state,
            "brownout_step": self.brownout.step,
            # LOCAL load only (local_pressure): the probe gossips this
            # into the autoscaler's view, and exporting the folded floor
            # instead would echo a peer's pressure back as this replica's
            # own state — a rumor latch. The floor is reported separately.
            "occupancy": round(occupancy, 4),
            "fleet_pressure": round(self.fleet_pressure(), 4),
            "tenants": self.tenants_info(),
            "sheds": self.shed_counts(),
        }

    def reset(self) -> None:
        """Zero the live occupancy/wait state (tests, bench phases).
        Counters are cumulative and stay."""
        with self._lock:
            self._sheds.clear()
            self._fleet_pressure = (0.0, 0.0)
            self._occ_peaks.clear()
            self._set_tenant_state(None, clear=True)
            for k in CLASSES:
                self._inflight[k] = 0
                self._waits[k].clear()
                self._done_count[k] = 0
                self._done_t0[k] = time.monotonic()
                self._drain_rate[k] = 0.0
        for k in CLASSES:
            self._m_inflight[k].set(0)
        self.brownout.reset()


class _Slot:
    __slots__ = ("_adm", "_klass", "_deadline", "_tenant", "_t0")

    def __init__(self, adm: AdmissionController, klass: str, deadline_s,
                 tenant: str = ""):
        self._adm, self._klass, self._deadline = adm, klass, deadline_s
        self._tenant = tenant

    def __enter__(self):
        self._adm.try_admit(self._klass, self._deadline, tenant=self._tenant)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._adm.release(self._klass, tenant=self._tenant)
        return False


class DeviceHealth:
    """The device-loss latch and its recovery probe.

    ``degraded`` turns on when (a) the ``device.unavailable`` fault site is
    armed and fires on a device path, or (b) a real backend error (a CUDA
    error, an out-of-memory, a device-side assert) reaches
    :meth:`note_failure`. While latched:

    * device paths call :meth:`check` first and fail fast with
      :class:`DeviceUnavailableError` (microseconds, never a hang);
    * the warn path answers from the GFKB's host warm/cold tiers;
    * one daemon thread retries a tiny CUDA op every
      ``KAKVEDA_DEGRADED_PROBE`` seconds (default 5); success un-latches.

    A sticky error (an illegal address, a device-side assert) poisons the
    process's CUDA context, so its probe never succeeds: the latch then
    holds for the process's life, and only a restart brings the card back.
    An out-of-memory is not sticky, and there the probe un-latches.
    """

    # Substrings of an exception's text that mark a backend failure. The
    # reference's transport markers, with CUDA's in place of its ``tpu`` /
    # ``pjrt``; deliberately conservative: a shape mismatch or a plain
    # ValueError must not latch the platform.
    _BACKEND_MARKERS = (
        "unavailable", "deadline_exceeded", "failed to connect", "socket closed",
        "device or resource busy", "cuda error", "device-side assert",
        "illegal memory access", "unspecified launch failure", "cublas", "cudnn",
        "nccl", "uncorrectable ecc",
    )

    def __init__(self, probe_interval: Optional[float] = None, probe_fn=None):
        self.probe_interval = (
            _env_float("KAKVEDA_DEGRADED_PROBE", 5.0) if probe_interval is None else probe_interval
        )
        self._probe_fn = probe_fn or self._default_probe
        self._degraded = threading.Event()
        self._lock = sanitize.named_lock("DeviceHealth._lock")
        self._probe_thread: Optional[threading.Thread] = None
        self._since: Optional[float] = None
        self._reason = ""
        # Shared with the GFKB's match dispatch: while armed the probe keeps
        # failing, so disarming is what lets the platform recover, as the
        # end of a real outage does.
        self._fault = _faults.site("device.unavailable")
        # Latch transitions by target state and probe attempts by result,
        # per instance (``info()``), beside the process-global families.
        self.transitions: Dict[str, int] = {"degraded": 0, "healthy": 0}
        self.probes: Dict[str, int] = {"ok": 0, "fail": 0}
        reg = _metrics.get_registry()
        self._g_degraded = reg.gauge(
            "kakveda_device_degraded",
            "1 while the accelerator backend is latched DEGRADED "
            "(device-loss mode: host-fallback warn, fail-fast generation)",
        )
        self._c_transitions = reg.counter(
            "kakveda_device_degraded_transitions_total",
            "Degraded-mode latch transitions", ("to",),
        )
        self._c_probe = reg.counter(
            "kakveda_device_probe_total",
            "Backend recovery-probe attempts by result", ("result",),
        )
        self._g_degraded.set(0.0)
        self.recorder = _metrics.FlightRecorder("device-health")

    # -- classification --------------------------------------------------

    @classmethod
    def is_backend_error(cls, exc: BaseException) -> bool:
        """Does this exception look like the card going away (vs a plain
        software bug)? Injected ``device.unavailable`` faults count by
        construction; real ones match torch's accelerator and
        out-of-memory types or the marker list. A kernel that failed to
        build is a software fault and never latches."""
        if isinstance(exc, _faults.FaultInjected):
            return exc.site == "device.unavailable"
        from kakveda_tpu_torch.ops._build import KernelBuildError

        if isinstance(exc, KernelBuildError):
            return False
        import torch

        types = tuple(
            t for t in (getattr(torch, "AcceleratorError", None), getattr(torch, "OutOfMemoryError", None))
            if isinstance(t, type)
        )
        if types and isinstance(exc, types):
            return True
        text = str(exc).lower()
        return any(m in text for m in cls._BACKEND_MARKERS)

    # -- latch -----------------------------------------------------------

    @property
    def degraded(self) -> bool:
        return self._degraded.is_set()

    def check(self) -> None:
        """Fail fast while latched: a device path never dispatches into a
        dead or poisoned card."""
        if self._degraded.is_set():
            raise DeviceUnavailableError(
                f"accelerator backend degraded ({self._reason}); host-fallback paths only",
                retry_after=self.probe_interval,
            )

    def note_failure(self, exc: BaseException, where: str = "") -> bool:
        """Classify, and latch on a backend error. True when the platform
        is (now) degraded: the caller's cue to take its host fallback."""
        if self._degraded.is_set():
            return True
        if not self.is_backend_error(exc):
            return False
        with self._lock:
            if not self._degraded.is_set():
                self._reason = f"{type(exc).__name__} at {where or 'device path'}"
                self._since = time.time()
                self._degraded.set()
                self._g_degraded.set(1.0)
                self._c_transitions.labels(to="degraded").inc()
                self.transitions["degraded"] += 1
                self.recorder.record("degraded", where=where,
                                     error=f"{type(exc).__name__}: {exc}")
                log.error(
                    "accelerator backend latched DEGRADED (%s: %s); warn serves from the host "
                    "tiers, generation fails fast; probing every %.1fs",
                    self._reason, exc, self.probe_interval,
                )
                self._start_probe_locked()
        return True

    def _start_probe_locked(self) -> None:
        if self._probe_thread is not None and self._probe_thread.is_alive():
            return
        t = threading.Thread(target=self._probe_loop, daemon=True, name="device-health-probe")
        self._probe_thread = t
        t.start()

    def _default_probe(self) -> None:
        """One tiny op on the card, waited for. Raises while the card is
        gone (a poisoned context raises at every call); the armed fault
        site fires first, so an injected outage gates the probe as a real
        one does. A process without a card has nothing to probe."""
        self._fault.fire()
        import torch

        if torch.cuda.is_available():
            (torch.ones(8, device="cuda") + 1.0).sum()
            torch.cuda.synchronize()

    def _probe_loop(self) -> None:
        while self._degraded.is_set():
            time.sleep(self.probe_interval)
            if not self._degraded.is_set():
                return
            try:
                self._probe_fn()
            except Exception as e:  # noqa: BLE001 — any failure = still down
                self._c_probe.labels(result="fail").inc()
                self.probes["fail"] += 1
                log.warning("backend probe failed (%s: %s); still degraded", type(e).__name__, e)
                continue
            self._c_probe.labels(result="ok").inc()
            self.probes["ok"] += 1
            self.unlatch("probe succeeded")
            return

    def unlatch(self, why: str = "") -> None:
        with self._lock:
            if not self._degraded.is_set():
                return
            down_s = time.time() - (self._since or time.time())
            self._degraded.clear()
            self._g_degraded.set(0.0)
            self._c_transitions.labels(to="healthy").inc()
            self.transitions["healthy"] += 1
            self.recorder.record("recovered", why=why, down_s=round(down_s, 3))
            log.warning("accelerator backend recovered (%s) after %.1fs degraded", why or "manual", down_s)

    def info(self) -> dict:
        return {
            "degraded": self.degraded,
            "reason": self._reason if self.degraded else None,
            "since": self._since if self.degraded else None,
            "probe_interval_s": self.probe_interval,
            "transitions": dict(self.transitions),
            "probes": dict(self.probes),
        }


# --- process-global instances ----------------------------------------------

_GLOBAL_LOCK = sanitize.named_lock("admission._GLOBAL_LOCK")
_ADMISSION: Optional[AdmissionController] = None
_DEVICE_HEALTH: Optional[DeviceHealth] = None


def get_admission() -> AdmissionController:
    """The process-global admission/brownout controller — one pressure
    picture shared by the HTTP tier, the serving engine and the batcher."""
    global _ADMISSION
    if _ADMISSION is None:
        with _GLOBAL_LOCK:
            if _ADMISSION is None:
                _ADMISSION = AdmissionController()
    return _ADMISSION


def get_device_health() -> DeviceHealth:
    global _DEVICE_HEALTH
    if _DEVICE_HEALTH is None:
        with _GLOBAL_LOCK:
            if _DEVICE_HEALTH is None:
                _DEVICE_HEALTH = DeviceHealth()
    return _DEVICE_HEALTH


def reset_for_tests() -> None:
    """Drop the global controllers so the next accessor call rebuilds them
    from the current env. Tests that latch degraded mode or drive the
    brownout ladder MUST call this in teardown — tier-1 runs everything in
    one process and a leaked latch would poison unrelated tests."""
    global _ADMISSION, _DEVICE_HEALTH
    with _GLOBAL_LOCK:
        if _DEVICE_HEALTH is not None:
            _DEVICE_HEALTH.unlatch("reset_for_tests")
        if _ADMISSION is not None:
            _ADMISSION.reset()
        _ADMISSION = None
        _DEVICE_HEALTH = None
    with _PROMOTIONS_LOCK:
        _PROMOTIONS.clear()
