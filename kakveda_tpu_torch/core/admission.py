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

Left for the admission slice (ROADMAP Queue 1 item 7): the brownout
ladder, deadline shedding from the queue-wait history, tenant quotas
inside the controller (the micro-batcher's tenant-fair composition and
tenant-aware queue bound are ported), fleet pressure, ``DeviceHealth`` and
the metric families.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, Tuple

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
