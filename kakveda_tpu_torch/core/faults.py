"""Deterministic fault injection: the chaos harness of the GFKB lifecycle.

Port of ``kakveda_tpu/core/faults.py`` (the port keeps its own copy; it
imports nothing of the JAX package). The site names are the reference's,
so one ``KAKVEDA_FAULTS`` / ``KAKVEDA_FAULTS_CRASH`` spec arms both
packages.

* A **fault site** is a named point in the code (``gfkb.append``,
  ``gfkb.compact_fence``, …). Components resolve their sites once via
  :func:`site` and keep the object; the hot-path call is ``site.fire()``,
  a single attribute check when nothing is armed.
* Arming is an env spec, ``KAKVEDA_FAULTS=site:prob:count,…`` (``prob``
  defaults to 1.0, ``count`` to 1, ``-1`` = unlimited), parsed at import,
  or :func:`arm` (tests). Arming mutates the existing site objects, so
  components built before ``arm()`` still inject. The RNG is seeded
  (``KAKVEDA_FAULTS_SEED``, default 0).
* An injection raises :class:`FaultInjected` and adds one to the site's
  ``injected`` count (kept across armings; the reference's metrics
  counter comes with the port's ``core/metrics.py``).
* **Crash points** (:func:`arm_crash` / ``KAKVEDA_FAULTS_CRASH=site:nth,…``)
  are the power-cut mode: the n-th pass through the site hard-kills the
  process with ``os._exit(137)`` — no exception, no ``finally``, no
  buffered-write flush. ``index/crashsweep.py`` arms these in a child
  process at every durable write seam of a compaction cycle.
  :func:`arm`/:func:`disarm` clear crash arming like any other.

Not ported yet: ``FaultSchedule``, ``schedule`` and
``KAKVEDA_FAULTS_TIMELINE`` (timed arming for the traffic plane).
"""

from __future__ import annotations

import logging
import os
import random
import threading
from typing import Dict, Optional

log = logging.getLogger("kakveda.faults")

__all__ = [
    "FaultInjected",
    "FaultSite",
    "site",
    "arm",
    "arm_crash",
    "disarm",
    "armed_sites",
]


class FaultInjected(RuntimeError):
    """An armed fault site fired. A RuntimeError subclass, so injected
    failures travel the error paths real device and IO failures travel."""

    def __init__(self, site_name: str):
        super().__init__(f"injected fault at {site_name} (KAKVEDA_FAULTS)")
        self.site = site_name


class FaultSite:
    """One named injection point. ``fire()`` is the hot-path call: a bare
    attribute check when unarmed, a lock and a seeded draw when armed."""

    __slots__ = ("name", "armed", "prob", "remaining", "fired", "crash_at", "passes", "injected")

    def __init__(self, name: str):
        self.name = name
        self.armed = False
        self.prob = 0.0
        self.remaining = 0  # -1 = unlimited
        self.fired = 0  # injections of the current arming
        self.crash_at = 0  # crash-point mode: kill the process at the n-th pass
        self.passes = 0
        self.injected = 0  # injections over the process's life

    def fire(self) -> None:
        if not self.armed:
            return
        _fire(self)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"FaultSite({self.name!r}, armed={self.armed}, prob={self.prob}, "
            f"remaining={self.remaining}, fired={self.fired})"
        )


_lock = threading.Lock()
_sites: Dict[str, FaultSite] = {}
_rng = random.Random(0)


def site(name: str) -> FaultSite:
    """Get-or-create the site object for ``name``: resolve once, keep the
    reference, ``fire()`` on the hot path."""
    with _lock:
        s = _sites.get(name)
        if s is None:
            s = _sites[name] = FaultSite(name)
        return s


def _fire(s: FaultSite) -> None:
    with _lock:
        if not s.armed:  # lost the race with disarm()
            return
        if s.crash_at:
            # A power cut: os._exit skips exception handlers, finally
            # blocks, atexit and buffered flushes, which is the point.
            s.passes += 1
            if s.passes >= s.crash_at:
                try:
                    os.write(2, f"kakveda crash point: {s.name} pass {s.passes}\n".encode())
                except OSError:  # pragma: no cover - stderr gone
                    pass
                os._exit(137)
            return  # passes below n fall through silently
        if s.prob < 1.0 and _rng.random() >= s.prob:
            return
        s.fired += 1
        s.injected += 1
        if s.remaining > 0:
            s.remaining -= 1
            if s.remaining == 0:
                s.armed = False
    log.warning("fault injected at %s (fired=%d)", s.name, s.fired)
    raise FaultInjected(s.name)


def _parse(spec: str, what: str, fields_fn):
    out = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        try:
            out.append((fields[0], *fields_fn(fields)))
        except ValueError as e:
            raise ValueError(f"bad {what} entry {part!r}: {e}") from e
    return out


def arm(spec: str, seed: Optional[int] = None) -> None:
    """Arm sites from a ``site:prob:count,…`` spec (prob defaults to 1.0,
    count to 1, count -1 = unlimited). Replaces the previous arming —
    unlisted sites disarm. ``seed`` reseeds the shared RNG (default: keep)."""
    parsed = _parse(
        spec, "KAKVEDA_FAULTS",
        lambda f: (
            float(f[1]) if len(f) > 1 and f[1] else 1.0,
            int(f[2]) if len(f) > 2 and f[2] else 1,
        ),
    )
    with _lock:
        if seed is not None:
            _rng.seed(seed)
        for s in _sites.values():
            s.armed = False
            s.prob = 0.0
            s.remaining = 0
            s.crash_at = 0
            s.passes = 0
        for name, prob, count in parsed:
            s = _sites.get(name)
            if s is None:
                s = _sites[name] = FaultSite(name)
            s.prob = prob
            s.remaining = count
            s.armed = count != 0
            s.fired = 0  # each arming is a fresh experiment
    if parsed:
        log.warning("fault sites armed: %s", ", ".join(p[0] for p in parsed))


def arm_crash(spec: str) -> None:
    """Arm crash points from a ``site:nth,…`` spec (``nth`` defaults to 1):
    the n-th ``fire()`` at the site calls ``os._exit(137)``. Replaces any
    previous crash arming and leaves probabilistic arming of other sites
    alone; :func:`arm`/:func:`disarm` clear it."""
    parsed = _parse(
        spec, "KAKVEDA_FAULTS_CRASH",
        lambda f: (max(1, int(f[1]) if len(f) > 1 and f[1] else 1),),
    )
    with _lock:
        for s in _sites.values():
            s.crash_at = 0
            s.passes = 0
        for name, nth in parsed:
            s = _sites.get(name)
            if s is None:
                s = _sites[name] = FaultSite(name)
            s.crash_at = nth
            s.passes = 0
            s.armed = True
    if parsed:
        log.warning("crash points armed: %s", ", ".join(f"{n}@{k}" for n, k in parsed))


def disarm() -> None:
    """Disarm every site (the counts survive for inspection)."""
    arm("")


def armed_sites() -> Dict[str, FaultSite]:
    with _lock:
        return {n: s for n, s in _sites.items() if s.armed}


# Env arming at import: a process started with KAKVEDA_FAULTS set injects
# from its first event; KAKVEDA_FAULTS_CRASH is how the crash sweep's
# parent arms a child.
_env_spec = os.environ.get("KAKVEDA_FAULTS", "")
if _env_spec:
    arm(_env_spec, seed=int(os.environ.get("KAKVEDA_FAULTS_SEED", "0")))
_env_crash = os.environ.get("KAKVEDA_FAULTS_CRASH", "")
if _env_crash:
    arm_crash(_env_crash)
