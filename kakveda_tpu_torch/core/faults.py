"""Deterministic fault injection: the chaos harness of the GFKB lifecycle
and the serving engine's supervisor.

Port of ``kakveda_tpu/core/faults.py`` (the port keeps its own copy; it
imports nothing of the JAX package). The site names are the reference's,
so one ``KAKVEDA_FAULTS`` / ``KAKVEDA_FAULTS_CRASH`` spec arms both
packages.

* A **fault site** is a named point in the code (``gfkb.append``,
  ``gfkb.compact_fence``, ``engine.dispatch``, ``engine.fetch``, …). Components resolve their sites once via
  :func:`site` and keep the object; the hot-path call is ``site.fire()``,
  a single attribute check when nothing is armed.
* Arming is an env spec, ``KAKVEDA_FAULTS=site:prob:count,…`` (``prob``
  defaults to 1.0, ``count`` to 1, ``-1`` = unlimited), parsed at import,
  or :func:`arm` (tests). Arming mutates the existing site objects, so
  components built before ``arm()`` still inject. The RNG is seeded
  (``KAKVEDA_FAULTS_SEED``, default 0).
* An injection raises :class:`FaultInjected`, adds one to the site's
  ``injected`` count (kept across armings) and increments
  ``kakveda_faults_injected_total{site=…}`` on the metrics plane.
* **Crash points** (:func:`arm_crash` / ``KAKVEDA_FAULTS_CRASH=site:nth,…``)
  are the power-cut mode: the n-th pass through the site hard-kills the
  process with ``os._exit(137)`` — no exception, no ``finally``, no
  buffered-write flush. ``index/crashsweep.py`` arms these in a child
  process at every durable write seam of a compaction cycle.
  :func:`arm`/:func:`disarm` clear crash arming like any other.

* **Timed arming** (:func:`schedule` / ``KAKVEDA_FAULTS_TIMELINE``): a
  chaos *timeline* applies full arm specs at scheduled offsets, so a
  process opens and closes an outage window on its own; the env form
  gives a child process the same schedule without any admin API.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Dict, Optional

from kakveda_tpu_torch.core import sanitize

log = logging.getLogger("kakveda.faults")

__all__ = [
    "FaultInjected",
    "FaultSchedule",
    "FaultSite",
    "site",
    "arm",
    "arm_crash",
    "disarm",
    "armed_sites",
    "schedule",
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


_lock = sanitize.named_lock("faults._lock")
_sites: Dict[str, FaultSite] = {}
_rng = random.Random(0)
_m_injected = None  # resolved at the first injection: importing faults loads no metrics


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
    global _m_injected
    if _m_injected is None:
        from kakveda_tpu_torch.core import metrics as _metrics

        _m_injected = _metrics.get_registry().counter(
            "kakveda_faults_injected_total",
            "Injected faults by site (KAKVEDA_FAULTS chaos harness)", ("site",),
        )
    _m_injected.labels(site=s.name).inc()
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


class FaultSchedule:
    """Timed arming — a chaos *timeline*: apply full :func:`arm` specs at
    scheduled offsets from ``start()``.

    Entries are ``{"t": offset_s, "spec": "site:prob:count,…"}`` dicts (or
    ``(t, spec)`` pairs), applied in offset order by a daemon thread. Each
    entry carries a COMPLETE arming state — :func:`arm` replaces, so an
    entry with ``spec=""`` is how an outage window closes (the same
    disarm-ends-the-outage shape as a manual chaos run). ``speed`` divides
    the offsets: a 2x replay runs its chaos timeline at 2x too.

    ``cancel()`` stops FUTURE entries only; it deliberately does not
    disarm — the caller owns terminal cleanup (tests use the standard
    ``faults.disarm()`` teardown)."""

    def __init__(self, entries, *, speed: float = 1.0, seed: Optional[int] = None):
        norm = []
        for e in entries:
            if isinstance(e, dict):
                t, spec = float(e["t"]), str(e.get("spec", ""))
            else:
                t, spec = float(e[0]), str(e[1])
            # Parse eagerly so a bad timeline fails at construction, not
            # mid-run inside a daemon thread nobody is watching.
            arm_spec_check(spec)
            norm.append((t, spec))
        self.entries = sorted(norm, key=lambda p: p[0])
        self.speed = max(1e-6, float(speed))
        self.seed = seed
        self.applied = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FaultSchedule":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="kakveda-fault-schedule", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        t0 = time.monotonic()
        if self.seed is not None:
            with _lock:
                _rng.seed(self.seed)
        for t, spec in self.entries:
            delay = t0 + t / self.speed - time.monotonic()
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set():
                return
            arm(spec)
            self.applied += 1

    def cancel(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def done(self) -> bool:
        return self._thread is not None and not self._thread.is_alive()


def arm_spec_check(spec: str) -> None:
    """Validate a ``site:prob:count,…`` spec without touching site state
    (schedule construction, timeline env parse)."""
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        try:
            float(fields[1]) if len(fields) > 1 and fields[1] else 1.0
            int(fields[2]) if len(fields) > 2 and fields[2] else 1
        except ValueError as e:
            raise ValueError(f"bad fault spec entry {part!r}: {e}") from e


def schedule(entries, *, speed: float = 1.0, seed: Optional[int] = None,
             start: bool = True) -> FaultSchedule:
    """Build (and by default start) a :class:`FaultSchedule`."""
    sched = FaultSchedule(entries, speed=speed, seed=seed)
    return sched.start() if start else sched


# Env arming at import: a process started with KAKVEDA_FAULTS set injects
# from its first event; KAKVEDA_FAULTS_CRASH is how the crash sweep's
# parent arms a child.
_env_spec = os.environ.get("KAKVEDA_FAULTS", "")
if _env_spec:
    arm(_env_spec, seed=int(os.environ.get("KAKVEDA_FAULTS_SEED", "0")))
_env_crash = os.environ.get("KAKVEDA_FAULTS_CRASH", "")
if _env_crash:
    arm_crash(_env_crash)

# Env chaos timeline: KAKVEDA_FAULTS_TIMELINE is a JSON array of
# {"t": offset_s, "spec": "site:prob:count,…"} entries, offsets relative to
# import. This is how a child process gets a mid-run outage window without
# an admin API: the parent sets the env, the child arms and disarms itself
# on schedule.
_env_timeline = os.environ.get("KAKVEDA_FAULTS_TIMELINE", "")
if _env_timeline:
    import json as _json

    schedule(
        _json.loads(_env_timeline),
        seed=int(os.environ.get("KAKVEDA_FAULTS_SEED", "0")),
    )
