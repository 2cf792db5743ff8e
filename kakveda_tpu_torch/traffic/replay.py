"""Open-loop replay + chaos-timeline executor.

Open-loop is the point: arrivals fire on the SCHEDULE (``t0 + t/speed``),
not when the previous response lands — a closed-loop client self-throttles
against a degrading server and hides exactly the metastable failure modes
this harness exists to catch. Concurrency is still bounded (the semaphore
is acquired INSIDE the spawned task, so admission sheds and slow responses
delay sends without deforming the arrival schedule; the resulting lateness
is measured and reported rather than hidden).

Every dispatch terminates in exactly one bucket:

* ``ok``        — 2xx.
* ``shed``      — 429 (typed OverloadError surfaced by the service tier).
* ``degraded``  — 503 (device-loss fail-fast path).
* ``error``     — any other status, connection error, or an armed
  ``traffic.dispatch`` fault (a replay client losing the request).
* ``hung``      — no terminal outcome within ``timeout_s``. The zero-hung
  SLO gate is the end-to-end SHED-NEVER-HANG check.

``run_chaos`` applies timeline actions at offsets (same clock + speed
factor as the replay): ``faults`` re-arms `core/faults.py` (empty spec
ends the outage window — disarm IS recovery), ``kill_replica`` /
``restart_replica`` drive a FleetSupervisor, ``crash_replica`` hard-kills
one (SIGKILL — the dead-owner drill; skipped with a warning when
``FleetSupervisor.may_hold_device_lease`` says the replica may hold a
device lease: False for the port's CUDA children unless
``KAKVEDA_FLEET_TPU_LEASE=1``), ``fleet_pressure`` feeds
``AdmissionController.note_fleet_pressure`` exactly as a peer's gossip
sample would, and ``scale_events`` snapshots the threaded autoscaler's
decision counters into the chaos log (a measurement, not a mutation).
Actions needing a handle the caller didn't provide are skipped with a
warning, never fatal — a single-process storm simply has no replicas to
kill.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Dict, List, Optional

from kakveda_tpu_torch.core import faults
from kakveda_tpu_torch.core import trace as _trace
from kakveda_tpu_torch.core.faults import FaultInjected

log = logging.getLogger("kakveda.traffic")

__all__ = ["ReplayResult", "replay", "run_chaos", "run_scenario"]

# Replay client losing a request before the send — the harness's own
# failure mode, threaded like every other failure path. Resolved once at
# import per the fault-site-once rule.
_SITE_DISPATCH = faults.site("traffic.dispatch")

_DEF_CONC = int(os.environ.get("KAKVEDA_TRAFFIC_MAX_CONC", "64"))
_DEF_TIMEOUT = float(os.environ.get("KAKVEDA_TRAFFIC_TIMEOUT_S", "15"))

PostFn = Callable[[str, dict], Awaitable[int]]
LocalFn = Callable[[dict], Awaitable[float]]


@dataclass
class ReplayResult:
    """Terminal accounting for one replay. ``records`` is one dict per
    dispatched event: klass/phase/status/latency_ms/late_ms."""

    records: List[dict] = field(default_factory=list)
    generated_counts: Dict[str, int] = field(default_factory=dict)
    skipped: Dict[str, int] = field(default_factory=dict)
    ttfts_ms: List[float] = field(default_factory=list)
    ladder_recovery_s: Optional[float] = None
    wall_s: float = 0.0
    # Caller-stuffed side facts (e.g. scatter-gather partial counts from
    # a custom post fn) — gates like SLO.max_partial_rate read these.
    notes: Dict[str, float] = field(default_factory=dict)

    def latencies_ms(self, klass: str, phase: Optional[str] = None) -> List[float]:
        return [r["latency_ms"] for r in self.records
                if r["klass"] == klass and r["status"] == "ok"
                and (phase is None or r["phase"] == phase)]

    def ttft_ms(self) -> List[float]:
        return list(self.ttfts_ms)

    def class_counts(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for r in self.records:
            out.setdefault(r["klass"], {})
            out[r["klass"]][r["status"]] = out[r["klass"]].get(r["status"], 0) + 1
        return out

    def tenant_counts(self, klass: Optional[str] = None) -> Dict[str, Dict[str, int]]:
        """Per-tenant terminal buckets: {app: {status: n}} over records that
        carry an app tag (events without one aggregate under ``""``). The
        input to the noisy-neighbor gates — who absorbed the shed."""
        out: Dict[str, Dict[str, int]] = {}
        for r in self.records:
            if klass is not None and r["klass"] != klass:
                continue
            app = r.get("app", "")
            out.setdefault(app, {})
            out[app][r["status"]] = out[app].get(r["status"], 0) + 1
        return out

    def tenant_latencies_ms(self, app: str, klass: str = "warn",
                            phase: Optional[str] = None) -> List[float]:
        """One tenant's ok-latency series (the victim-p95 gate input)."""
        return [r["latency_ms"] for r in self.records
                if r.get("app", "") == app and r["klass"] == klass
                and r["status"] == "ok"
                and (phase is None or r["phase"] == phase)]

    def generated(self, klass: str) -> int:
        # Skipped LOCAL events (no dispatcher provided) were never
        # generated INTO the system — they don't count as lost.
        return (self.generated_counts.get(klass, 0)
                - self.skipped.get(klass, 0))

    def late_p95_ms(self) -> float:
        from kakveda_tpu_torch.traffic.slo import percentile
        return round(percentile([r["late_ms"] for r in self.records], 95), 3)

    def to_dict(self) -> dict:
        return {
            "dispatched": len(self.records),
            "generated": dict(self.generated_counts),
            "skipped": dict(self.skipped),
            "class_counts": self.class_counts(),
            "late_p95_ms": self.late_p95_ms(),
            "ladder_recovery_s": self.ladder_recovery_s,
            "wall_s": round(self.wall_s, 3),
            **({"notes": dict(self.notes)} if self.notes else {}),
        }


async def _dispatch(e: dict, sched_t: float, sem: asyncio.Semaphore,
                    post: PostFn, extra: Dict[str, LocalFn],
                    timeout_s: float, result: ReplayResult) -> None:
    # "app" (tenant identity) + "t" (scheduled offset) feed the per-tenant
    # SLO gates (max_victim_shed_rate / victim_p95_x_baseline /
    # max_tenant_starvation_s) — untagged events simply leave them vacuous.
    rec = {"klass": e.get("klass", "warn"), "phase": e.get("phase", ""),
           "app": e.get("app_id", ""), "t": float(e.get("t", 0.0)),
           "status": "error", "latency_ms": 0.0, "late_ms": 0.0}
    loop = asyncio.get_running_loop()
    # One span per dispatch, ended in the SAME finally that buckets the
    # record — a dispatch span terminates in exactly one bucket, so the
    # storm drill's zero-orphan certification mirrors the zero-lost
    # accounting. The span is client-side only: the request body stays
    # byte-faithful for warn replay.
    span = _trace.get_tracer().start_span(
        "traffic.dispatch", klass=rec["klass"], path=e.get("path", ""),
        phase=rec["phase"])
    if span.trace_id:
        rec["trace"] = span.trace_id
    span.activate()
    try:
        async with sem:
            send_t = loop.time()
            rec["late_ms"] = round(max(0.0, send_t - sched_t) * 1e3, 3)
            if _SITE_DISPATCH.armed:
                _SITE_DISPATCH.fire()
            if e.get("method") == "LOCAL":
                fn = extra.get(e.get("path", ""))
                if fn is None:
                    rec["status"] = "skipped"
                    result.skipped[rec["klass"]] = (
                        result.skipped.get(rec["klass"], 0) + 1)
                    return
                ttft = await asyncio.wait_for(fn(e), timeout_s)
                rec["status"] = "ok"
                if ttft is not None:
                    result.ttfts_ms.append(round(float(ttft) * 1e3, 3))
            else:
                status = await asyncio.wait_for(
                    post(e["path"], e.get("body", {})), timeout_s)
                rec["status"] = ("ok" if 200 <= status < 300
                                 else "shed" if status == 429
                                 else "degraded" if status == 503
                                 else "error")
            rec["latency_ms"] = round((loop.time() - send_t) * 1e3, 3)
    except asyncio.TimeoutError:
        rec["status"] = "hung"
        rec["latency_ms"] = round(timeout_s * 1e3, 3)
    except FaultInjected as f:
        rec["status"] = "error"
        log.warning("traffic.dispatch fault dropped a request: %s", f)
    except asyncio.CancelledError:
        rec["status"] = "hung"
        raise
    except Exception as ex:
        rec["status"] = "error"
        log.warning("dispatch %s failed: %s: %s",
                    e.get("path"), type(ex).__name__, ex)
    finally:
        span.deactivate()
        span.end(rec["status"], late_ms=rec["late_ms"],
                 latency_ms=rec["latency_ms"])
        result.records.append(rec)


async def replay(events: List[dict], *, post: PostFn, speed: float = 1.0,
                 max_concurrency: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 extra_dispatch: Optional[Dict[str, LocalFn]] = None,
                 result: Optional[ReplayResult] = None) -> ReplayResult:
    """Drive ``events`` open-loop through ``post``. ``speed=2`` replays a
    10 s log in 5 s. Returns after every spawned dispatch terminated."""
    speed = max(1e-6, float(speed))
    sem = asyncio.Semaphore(max_concurrency or _DEF_CONC)
    timeout_s = _DEF_TIMEOUT if timeout_s is None else float(timeout_s)
    extra = extra_dispatch or {}
    res = result if result is not None else ReplayResult()
    for e in events:
        k = e.get("klass", "warn")
        res.generated_counts[k] = res.generated_counts.get(k, 0) + 1

    loop = asyncio.get_running_loop()
    t0 = loop.time()
    tasks: List[asyncio.Task] = []
    for e in sorted(events, key=lambda x: float(x.get("t", 0.0))):
        sched_t = t0 + float(e.get("t", 0.0)) / speed
        delay = sched_t - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(loop.create_task(
            _dispatch(e, sched_t, sem, post, extra, timeout_s, res)))
    if tasks:
        await asyncio.gather(*tasks, return_exceptions=True)
    res.wall_s = loop.time() - t0
    return res


async def run_chaos(timeline: List[dict], *, speed: float = 1.0,
                    supervisor=None, admission=None, autoscaler=None,
                    callbacks: Optional[Dict[str, Callable]] = None,
                    t0: Optional[float] = None) -> List[dict]:
    """Apply chaos actions at their offsets (``t0`` lets the caller share
    the replay's clock). Returns a log of applied/skipped actions.

    ``callbacks`` maps extra action kinds to handles the caller owns
    (e.g. ``{"rebalance": fn}`` for the rebalance-under-storm drill) —
    a coroutine function is awaited, a plain callable runs off the event
    loop. Still only existing seams: a missing handle skips-with-warning
    like any other unknown action."""
    speed = max(1e-6, float(speed))
    loop = asyncio.get_running_loop()
    base = loop.time() if t0 is None else t0
    applied: List[dict] = []
    for act in sorted(timeline, key=lambda a: float(a.get("t", 0.0))):
        delay = base + float(act.get("t", 0.0)) / speed - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        kind = act.get("action")
        entry = {"t": act.get("t"), "action": kind, "applied": True}
        try:
            if kind == "faults":
                spec = str(act.get("spec", ""))
                if spec:
                    faults.arm(spec, seed=int(act.get("seed", 0)))
                else:
                    faults.disarm()
            elif kind in ("kill_replica", "restart_replica"):
                if supervisor is None:
                    entry.update(applied=False, reason="no supervisor")
                else:
                    i = int(act.get("replica", 0))
                    # stop() waits out SIGTERM (its SIGKILL escalation
                    # honours the lease marker); keep that wait off the
                    # event loop.
                    fn = supervisor.stop if kind == "kill_replica" else supervisor.start
                    await loop.run_in_executor(None, fn, i)
            elif kind == "crash_replica":
                # Hard owner death (the replacement drill): SIGKILL with
                # zero grace so the replica cannot drain — UNLESS it may
                # hold a device lease (a killed lease holder wedges every
                # later backend init; the port's CUDA children hold none
                # unless KAKVEDA_FLEET_TPU_LEASE=1).
                if supervisor is None:
                    entry.update(applied=False, reason="no supervisor")
                else:
                    i = int(act.get("replica", 0))
                    if supervisor.may_hold_device_lease(i):
                        entry.update(applied=False,
                                     reason="replica may hold TPU lease")
                    else:
                        await loop.run_in_executor(
                            None,
                            lambda: supervisor.stop(
                                i, timeout_s=0.5, sig=signal.SIGKILL),
                        )
            elif kind == "scale_events":
                # Measurement-only: snapshot the autoscaler's decision
                # ledger into the chaos log at this offset.
                if autoscaler is None:
                    entry.update(applied=False, reason="no autoscaler")
                else:
                    entry["scale"] = {
                        "counts": autoscaler.decision_counts(),
                        "flaps": autoscaler.flap_count(),
                        "state": autoscaler.info().get("state"),
                    }
            elif kind == "fleet_pressure":
                if admission is None:
                    entry.update(applied=False, reason="no admission")
                else:
                    admission.note_fleet_pressure(
                        float(act.get("pressure", 0.0)),
                        ttl_s=float(act.get("ttl_s", 5.0)))
            elif callbacks and kind in callbacks:
                fn = callbacks[kind]
                if asyncio.iscoroutinefunction(fn):
                    await fn(act)
                else:
                    await loop.run_in_executor(None, fn, act)
            else:
                entry.update(applied=False, reason=f"unknown action {kind!r}")
        except Exception as ex:
            entry.update(applied=False, reason=f"{type(ex).__name__}: {ex}")
            log.warning("chaos action %r failed: %s", kind, ex)
        if not entry["applied"]:
            log.warning("chaos action skipped: %s", entry)
        applied.append(entry)
    return applied


async def _watch_recovery(result: ReplayResult, admission, storm_end_s: float,
                          speed: float, t0: float, horizon_s: float) -> None:
    """Poll the ladder after the storm window closes; record how long it
    takes to get back to ``normal`` (transitions themselves still move
    only through _set_brownout_state — this only READS the state)."""
    loop = asyncio.get_running_loop()
    end_t = t0 + storm_end_s / speed
    delay = end_t - loop.time()
    if delay > 0:
        await asyncio.sleep(delay)
    deadline = loop.time() + horizon_s / speed
    while loop.time() < deadline:
        if admission.brownout.state == "normal":
            result.ladder_recovery_s = (loop.time() - end_t) * speed
            return
        await asyncio.sleep(0.05)


async def run_scenario(scenario, *, post: PostFn, speed: float = 1.0,
                       max_concurrency: Optional[int] = None,
                       timeout_s: Optional[float] = None,
                       supervisor=None, admission=None, autoscaler=None,
                       callbacks: Optional[Dict[str, Callable]] = None,
                       extra_dispatch: Optional[Dict[str, LocalFn]] = None,
                       recovery_horizon_s: float = 30.0) -> ReplayResult:
    """Replay a Scenario with its chaos timeline on the same clock, then
    (when the scenario declares storm phases and an admission handle is
    given) measure ladder recovery after the storm window closes.

    An ``autoscaler`` handle enables the ``scale_events`` chaos action and
    stuffs ``notes["scale_flaps"]`` / ``notes["scale_decisions"]`` into
    the result for the ``max_scale_flaps`` SLO gate."""
    res = ReplayResult()
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    jobs = [replay(scenario.events, post=post, speed=speed,
                   max_concurrency=max_concurrency, timeout_s=timeout_s,
                   extra_dispatch=extra_dispatch, result=res)]
    if scenario.chaos:
        jobs.append(run_chaos(scenario.chaos, speed=speed, t0=t0,
                              supervisor=supervisor, admission=admission,
                              autoscaler=autoscaler, callbacks=callbacks))
    storm_end = scenario.notes.get("storm_end_s")
    if storm_end is not None and admission is not None:
        jobs.append(_watch_recovery(res, admission, float(storm_end),
                                    speed, t0, recovery_horizon_s))
    await asyncio.gather(*jobs)
    if autoscaler is not None:
        res.notes["scale_flaps"] = float(autoscaler.flap_count())
        res.notes["scale_decisions"] = float(
            sum(autoscaler.decision_counts().values()))
    return res
