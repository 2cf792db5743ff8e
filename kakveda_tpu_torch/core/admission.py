"""Admission control for the port's service: bounded classes, typed sheds.

Port of the part of ``kakveda_tpu/core/admission.py`` that the service
uses. Four request classes, highest priority first — ``warn``, ``ingest``,
``interactive``, ``background`` — each with an in-flight bound
(``KAKVEDA_ADMIT_{WARN,INGEST,INTERACTIVE,BACKGROUND}``, defaults 256 / 64 /
32 / 4; ``KAKVEDA_ADMIT=0`` counts without shedding). Past the bound a
request is shed at once with a typed :class:`OverloadError`, which the HTTP
tier turns into 429 + ``Retry-After``; the hint is the class's in-flight
work over its observed drain rate, clamped to [0.5, 30] s and spread by a
bounded jitter (``KAKVEDA_ADMIT_RA_JITTER``, default 0.25) so shed clients
do not come back in lockstep. The warn micro-batcher's queue bound sheds
through :meth:`shed` too, so every rejection lands on one count.

:class:`DeviceHealth` is the device-loss latch (the reference's, with
CUDA's failure modes): a backend error on a device path latches DEGRADED,
the warn path then answers from the GFKB's host tiers with
``degraded=True``, generation fails fast with
:class:`DeviceUnavailableError`, and a probe thread un-latches when the
card answers again. :func:`get_device_health` is the process-global latch.

Left for the admission slice (ROADMAP Queue 1 item 7): the brownout
ladder, deadline shedding from the queue-wait history, tenant quotas
inside the controller (the micro-batcher's tenant-fair composition and
tenant-aware queue bound are ported), fleet pressure and the metric
families (the latch keeps its transition and probe counts as plain
integers; there is no flight recorder).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Dict, Optional, Tuple

from kakveda_tpu_torch.core import faults as _faults

log = logging.getLogger("kakveda.admission")

CLASSES: Tuple[str, ...] = ("warn", "ingest", "interactive", "background")


class OverloadError(Exception):
    """A request was shed by admission control.

    Deliberately NOT a RuntimeError: serving paths treat RuntimeError as
    'engine closed, fall back' — a shed must surface to the caller as
    429 + Retry-After.
    """

    def __init__(self, message: str, retry_after: float = 1.0,
                 klass: str = "", reason: str = "", tenant: str = ""):
        super().__init__(message)
        self.retry_after = max(0.1, float(retry_after))
        self.klass = klass
        self.reason = reason
        # The app key whose traffic was shed (empty for tenant-blind sheds).
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
    """The switch for the tenant plane (here: the warn micro-batcher's
    weighted-fair composition). ``KAKVEDA_TENANT_FAIR=0`` keeps it FIFO;
    consumers resolve it at construction."""
    return os.environ.get("KAKVEDA_TENANT_FAIR", "1") != "0"


class AdmissionController:
    """Bounded per-class admission with typed shedding.

    ``slot(klass)`` either admits (the body runs, the slot is released on
    exit) or raises :class:`OverloadError` at once — a shed costs
    microseconds, never a slot. The controller queues nothing itself.
    """

    _DRAIN_WINDOW_S = 5.0

    def __init__(self):
        self.enabled = os.environ.get("KAKVEDA_ADMIT", "1") != "0"
        self.limits: Dict[str, int] = {
            "warn": _env_int("KAKVEDA_ADMIT_WARN", 256),
            "ingest": _env_int("KAKVEDA_ADMIT_INGEST", 64),
            "interactive": _env_int("KAKVEDA_ADMIT_INTERACTIVE", 32),
            "background": _env_int("KAKVEDA_ADMIT_BACKGROUND", 4),
        }
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {k: 0 for k in CLASSES}
        # Per-class drain rate over a sliding ~5 s window: the input of
        # the Retry-After hint.
        now = time.monotonic()
        self._done_count: Dict[str, int] = {k: 0 for k in CLASSES}
        self._done_t0: Dict[str, float] = {k: now for k in CLASSES}
        self._drain_rate: Dict[str, float] = {k: 0.0 for k in CLASSES}
        self._ra_jitter = min(0.99, max(0.0, _env_float("KAKVEDA_ADMIT_RA_JITTER", 0.25)))
        self._sheds: Dict[str, int] = {}

    def try_admit(self, klass: str) -> None:
        """Take a slot of ``klass`` or raise :class:`OverloadError`."""
        if klass not in self._inflight:
            raise ValueError(f"unknown admission class {klass!r}")
        with self._lock:
            if not self.enabled or self._inflight[klass] < self.limits[klass]:
                self._inflight[klass] += 1
                return
        self.shed(klass, "queue_full")

    def release(self, klass: str) -> None:
        with self._lock:
            self._inflight[klass] = max(0, self._inflight[klass] - 1)
            self._note_done_locked(klass)

    def slot(self, klass: str) -> "_Slot":
        """Context-manager admission: sheds on entry, releases on exit."""
        return _Slot(self, klass)

    def _note_done_locked(self, klass: str) -> None:
        now = time.monotonic()
        self._done_count[klass] += 1
        dt = now - self._done_t0[klass]
        if dt >= self._DRAIN_WINDOW_S:
            rate = self._done_count[klass] / dt
            prev = self._drain_rate[klass]
            self._drain_rate[klass] = rate if prev == 0.0 else 0.5 * prev + 0.5 * rate
            self._done_count[klass] = 0
            self._done_t0[klass] = now

    def retry_after(self, klass: str) -> float:
        """Seconds until the class's backlog plausibly drains: in-flight
        over the observed drain rate, clamped to [0.5, 30] (1 s before any
        rate is known), times a uniform jitter in [1 - j, 1 + j]."""
        with self._lock:
            rate = self._drain_rate[klass]
            if rate <= 0.0:
                dt = time.monotonic() - self._done_t0[klass]
                if self._done_count[klass] and dt > 0.05:
                    rate = self._done_count[klass] / dt
            backlog = self._inflight[klass]
        base = 1.0 if rate <= 0.0 else min(30.0, max(0.5, backlog / rate))
        if self._ra_jitter <= 0.0:
            return base
        return max(0.1, base * (1.0 + self._ra_jitter * (2.0 * random.random() - 1.0)))

    def note_shed(self, klass: str, reason: str) -> None:
        """Count one rejection under ``klass/reason``."""
        key = f"{klass}/{reason}"
        with self._lock:
            self._sheds[key] = self._sheds.get(key, 0) + 1

    def shed(self, klass: str, reason: str, detail: str = "", tenant: str = "") -> None:
        """Record + raise: THE rejection path (429 + Retry-After at the
        HTTP tier)."""
        ra = self.retry_after(klass)
        self.note_shed(klass, reason)
        msg = f"{klass} request shed ({reason})"
        if detail:
            msg += f": {detail}"
        raise OverloadError(msg, retry_after=ra, klass=klass, reason=reason, tenant=tenant)

    def info(self) -> dict:
        """Mode report for /readyz: per-class occupancy and shed counts."""
        with self._lock:
            inflight = dict(self._inflight)
            sheds = dict(self._sheds)
        return {
            "enabled": self.enabled,
            "classes": {k: {"inflight": inflight[k], "limit": self.limits[k]} for k in CLASSES},
            "sheds": sheds,
        }


class _Slot:
    __slots__ = ("_adm", "_klass")

    def __init__(self, adm: AdmissionController, klass: str):
        self._adm, self._klass = adm, klass

    def __enter__(self):
        self._adm.try_admit(self._klass)
        return self

    def __exit__(self, *exc):
        self._adm.release(self._klass)
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
        self._lock = threading.Lock()
        self._probe_thread: Optional[threading.Thread] = None
        self._since: Optional[float] = None
        self._reason = ""
        # Shared with the GFKB's match dispatch: while armed the probe keeps
        # failing, so disarming is what lets the platform recover, as the
        # end of a real outage does.
        self._fault = _faults.site("device.unavailable")
        # The reference's metric families as counts: latch transitions by
        # target state, probe attempts by result.
        self.transitions: Dict[str, int] = {"degraded": 0, "healthy": 0}
        self.probes: Dict[str, int] = {"ok": 0, "fail": 0}

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
                self.transitions["degraded"] += 1
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
                self.probes["fail"] += 1
                log.warning("backend probe failed (%s: %s); still degraded", type(e).__name__, e)
                continue
            self.probes["ok"] += 1
            self.unlatch("probe succeeded")
            return

    def unlatch(self, why: str = "") -> None:
        with self._lock:
            if not self._degraded.is_set():
                return
            down_s = time.time() - (self._since or time.time())
            self._degraded.clear()
            self.transitions["healthy"] += 1
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


_GLOBAL_LOCK = threading.Lock()
_DEVICE_HEALTH: Optional[DeviceHealth] = None


def get_device_health() -> DeviceHealth:
    """The process-global latch, shared by the warn path, the serving
    engine and ``/readyz``."""
    global _DEVICE_HEALTH
    if _DEVICE_HEALTH is None:
        with _GLOBAL_LOCK:
            if _DEVICE_HEALTH is None:
                _DEVICE_HEALTH = DeviceHealth()
    return _DEVICE_HEALTH


def reset_for_tests() -> None:
    """Drop the global latch so the next :func:`get_device_health` builds
    one from the current env. Tests that latch degraded mode call this in
    teardown: one process runs every test, and a leaked latch would send
    unrelated warns down the host fallback."""
    global _DEVICE_HEALTH
    with _GLOBAL_LOCK:
        if _DEVICE_HEALTH is not None:
            _DEVICE_HEALTH.unlatch("reset_for_tests")
        _DEVICE_HEALTH = None
