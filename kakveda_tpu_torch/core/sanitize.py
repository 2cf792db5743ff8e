"""Runtime concurrency sanitizer: named-lock instrumentation + loop-stall
watchdog (``KAKVEDA_SANITIZE=1``).

The port's own copy of ``kakveda_tpu/core/sanitize.py`` (it imports
nothing of the JAX package). Every long-lived lock of the port is built
through :func:`named_lock` under the reference's stable ``ClassName._attr``
name, so one edge list reads the same in both packages.

Off by default the factory returns a plain ``threading.Lock``/``RLock`` —
zero overhead, zero behavior change, so the card's hot paths pay nothing.
With ``KAKVEDA_SANITIZE=1`` each lock is wrapped to record, per process:

* **acquisition-order edges** — for every acquire while other sanitized
  locks are held by the same thread, an (outer, inner) edge with a count
  and the first observed site;
* **hold times and contention** — wait time per acquire (contended past
  1 ms), total/max hold per lock.

The loop-stall watchdog (:class:`LoopStallWatchdog`) is the event-loop
analogue: an asyncio heartbeat task plus a checker daemon thread; when
the heartbeat goes stale past ``KAKVEDA_SANITIZE_STALL_MS`` the loop
thread's current stack is dumped to the ``sanitizer`` flight recorder
(served at ``GET /flightrecorder``) and recorded in
:func:`sanitizer_report` — machine-evidence for "something blocked the
event loop", with the offending frames attached.

Dependency-free by design (stdlib only; the flight recorder import is
lazy) so ``core/faults.py`` can import it.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Dict, Iterable, List, Optional, Tuple

_TRUTHY = frozenset({"1", "true", "yes", "on"})

# Waits past this count as contention (blocking on a held lock), below it
# as an uncontended fast path that merely paid the wrapper.
_CONTENDED_S = 0.001


def enabled() -> bool:
    """Is the sanitizer armed? Read per lock CONSTRUCTION (not per
    acquire): chaos tests set ``KAKVEDA_SANITIZE=1`` before building the
    objects under test; locks built earlier stay plain."""
    return os.environ.get("KAKVEDA_SANITIZE", "").strip().lower() in _TRUTHY


# ---------------------------------------------------------------------------
# process-global sanitizer state
# ---------------------------------------------------------------------------

# Guards the tables below. A raw lock ON PURPOSE: the sanitizer must never
# instrument itself (acquiring a sanitized lock inside _note_acquire would
# recurse) and never appear in its own edge graph.
_STATE_LOCK = threading.Lock()
# (outer, inner) -> {"count": n, "site": "thread-name"}
_EDGES: Dict[Tuple[str, str], Dict[str, object]] = {}
# name -> {"acquisitions", "contended", "wait_ms_total", "hold_ms_total", "hold_ms_max"}
_LOCK_STATS: Dict[str, Dict[str, float]] = {}
# Loop-stall events appended by any live watchdog.
_STALLS: List[dict] = []

_TLS = threading.local()

_RECORDER = None  # lazy FlightRecorder("sanitizer")


def _recorder():
    global _RECORDER
    if _RECORDER is None:
        from kakveda_tpu_torch.core import metrics as _metrics

        _RECORDER = _metrics.FlightRecorder("sanitizer")
    return _RECORDER


def _held() -> List[Tuple[str, Optional[float]]]:
    """This thread's stack of held sanitized locks: (name, t_acquired);
    ``t_acquired`` is None for reentrant re-acquisitions (no hold
    accounting, no self-edges)."""
    stack = getattr(_TLS, "held", None)
    if stack is None:
        stack = _TLS.held = []
    return stack


def _note_acquire(name: str, held_names: Iterable[str], wait_s: float) -> None:
    with _STATE_LOCK:
        st = _LOCK_STATS.setdefault(name, {
            "acquisitions": 0, "contended": 0, "wait_ms_total": 0.0,
            "hold_ms_total": 0.0, "hold_ms_max": 0.0,
        })
        st["acquisitions"] += 1
        st["wait_ms_total"] += wait_s * 1000.0
        if wait_s >= _CONTENDED_S:
            st["contended"] += 1
        for outer in held_names:
            if outer == name:
                continue
            e = _EDGES.setdefault((outer, name), {
                "count": 0, "site": threading.current_thread().name,
            })
            e["count"] += 1  # type: ignore[operator]


def _note_release(name: str, t_acquired: float) -> None:
    hold_ms = (time.monotonic() - t_acquired) * 1000.0
    with _STATE_LOCK:
        st = _LOCK_STATS.get(name)
        if st is not None:
            st["hold_ms_total"] += hold_ms
            if hold_ms > st["hold_ms_max"]:
                st["hold_ms_max"] = hold_ms


class SanitizedLock:
    """Lock wrapper recording order edges, waits and holds. Duck-types the
    ``threading.Lock``/``RLock`` surface the tree uses (``with``,
    ``acquire(blocking, timeout)``, ``release``, ``locked``) and stays
    ``threading.Condition``-compatible (Condition only needs
    acquire/release and probes ownership via ``acquire(False)``)."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held()
        reentrant = any(n == self.name for n, _ in held)
        t0 = time.monotonic()
        got = self._inner.acquire(blocking, timeout)
        if not got:
            return False
        if reentrant:
            # RLock re-entry: no new edges, hold attributed to the
            # outermost acquire only.
            held.append((self.name, None))
        else:
            _note_acquire(self.name, [n for n, _ in held], time.monotonic() - t0)
            held.append((self.name, time.monotonic()))
        return True

    def release(self) -> None:
        self._inner.release()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == self.name:
                _, t_acq = held.pop(i)
                if t_acq is not None:
                    _note_release(self.name, t_acq)
                return

    def __enter__(self) -> "SanitizedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        if locked is not None:
            return bool(locked())
        # RLock pre-3.12 has no locked(); probe like Condition does.
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


def named_lock(name: str, kind: str = "lock"):
    """Construct one of the tree's long-lived locks under a stable name.

    ``name`` MUST match the static analyzer's node id for the same lock
    (``ClassName._attr`` for instance locks, ``module._name`` for
    module-level ones) — that equality is what lets the runtime edge set
    cross-check against the static lock-order graph. Returns a plain
    ``threading.Lock``/``RLock`` unless ``KAKVEDA_SANITIZE`` is armed."""
    inner = threading.RLock() if kind == "rlock" else threading.Lock()
    if not enabled():
        return inner
    return SanitizedLock(name, inner)


# ---------------------------------------------------------------------------
# lock-order graph over the recorded edges
# ---------------------------------------------------------------------------


def find_cycles(edges: Iterable[Tuple[str, str]]) -> List[List[str]]:
    """Cycles in a directed edge set, each as the node path closing on its
    first node (``[a, b, a]``). Deterministic order; shared by the static
    lock-order rule and :func:`sanitizer_report`."""
    adj: Dict[str, set] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())
    color: Dict[str, int] = {}  # 0/absent=unvisited, 1=on stack, 2=done
    cycles: List[List[str]] = []

    def dfs(n: str, path: List[str]) -> None:
        color[n] = 1
        path.append(n)
        for m in sorted(adj.get(n, ())):
            c = color.get(m, 0)
            if c == 1:
                cycles.append(path[path.index(m):] + [m])
            elif c == 0:
                dfs(m, path)
        path.pop()
        color[n] = 2

    for n in sorted(adj):
        if color.get(n, 0) == 0:
            dfs(n, [])
    return cycles


def lock_order_edges() -> List[Tuple[str, str]]:
    """The distinct (outer, inner) acquisition-order edges observed so
    far, sorted."""
    with _STATE_LOCK:
        return sorted(_EDGES)


def record_stall(stall_ms: float, stack: str, where: str = "loop") -> None:
    evt = {
        "t": round(time.time(), 6), "stall_ms": round(stall_ms, 3),
        "where": where, "stack": stack,
    }
    with _STATE_LOCK:
        _STALLS.append(evt)
        if len(_STALLS) > 256:
            del _STALLS[0]
    try:
        _recorder().record("loop_stall", stall_ms=evt["stall_ms"],
                           where=where, stack=stack)
    except Exception:  # noqa: BLE001 — telemetry must never break the app
        pass


def sanitizer_report() -> dict:
    """Everything the sanitizer observed: per-lock stats, the order-edge
    graph (+ any cycles in it), and loop stalls. Read by ``chip_smoke.py``
    and the tests."""
    with _STATE_LOCK:
        locks = {k: dict(v) for k, v in _LOCK_STATS.items()}
        edges = [[a, b, int(v["count"])] for (a, b), v in sorted(_EDGES.items())]
        stalls = [dict(s) for s in _STALLS]
    return {
        "enabled": enabled(),
        "locks": locks,
        "edges": edges,
        "cycles": find_cycles([(a, b) for a, b, _ in edges]),
        "stalls": stalls,
    }


def reset() -> None:
    """Drop all recorded state (tests; the tables are process-global)."""
    with _STATE_LOCK:
        _EDGES.clear()
        _LOCK_STATS.clear()
        del _STALLS[:]


# ---------------------------------------------------------------------------
# asyncio loop-stall watchdog
# ---------------------------------------------------------------------------


class LoopStallWatchdog:
    """Heartbeat task + checker thread: detect event-loop stalls and dump
    the offending stack.

    A coroutine stamps ``monotonic()`` every ``interval``; a daemon thread
    watches the stamp age. When it exceeds the threshold
    (``KAKVEDA_SANITIZE_STALL_MS``, default 250) the loop thread's current
    frame is captured via ``sys._current_frames()`` — that stack IS the
    code blocking the loop — and recorded once per stall episode."""

    def __init__(self, threshold_ms: Optional[float] = None):
        if threshold_ms is None:
            threshold_ms = float(os.environ.get("KAKVEDA_SANITIZE_STALL_MS", "250"))
        self.threshold_s = max(0.01, threshold_ms / 1000.0)
        self._interval = self.threshold_s / 4.0
        self._last = time.monotonic()
        self._loop_tid: Optional[int] = None
        self._stop = threading.Event()
        self._task = None
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0

    async def start(self) -> None:
        """Call on the loop under watch."""
        import asyncio

        self._loop_tid = threading.get_ident()
        self._last = time.monotonic()
        self._task = asyncio.get_running_loop().create_task(self._beat())
        self._thread = threading.Thread(
            target=self._watch, name="sanitize-stall-watchdog", daemon=True)
        self._thread.start()

    async def _beat(self) -> None:
        import asyncio

        while not self._stop.is_set():
            self._last = time.monotonic()
            await asyncio.sleep(self._interval)

    def _watch(self) -> None:
        in_stall = False
        while not self._stop.wait(self._interval):
            age = time.monotonic() - self._last
            if age > self.threshold_s and not in_stall:
                in_stall = True
                self.stall_count += 1
                frame = sys._current_frames().get(self._loop_tid)
                stack = "".join(traceback.format_stack(frame)[-8:]) if frame else "<no frame>"
                record_stall(age * 1000.0, stack)
            elif age <= self._interval * 2:
                in_stall = False

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except BaseException:  # noqa: BLE001 — CancelledError et al.
                pass
            self._task = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
