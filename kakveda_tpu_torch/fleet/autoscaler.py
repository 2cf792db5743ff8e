"""Closed-loop elastic fleet — autoscaling with lossless drain + replacement.

Port of ``kakveda_tpu/fleet/autoscaler.py``: the same policy, decisions,
executors, ledger and metric families.

The policy loop runs in the ROUTER process (it owns the FleetSupervisor,
the probe state, and epoch writership) and consumes the same gossip
vocabulary the replicas publish: the router folds one gossip-shaped
sample per successful probe into its own :class:`~kakveda_tpu_torch.fleet.
gossip.FleetView` (occupancy, brownout rung, DEGRADED latch — the
occupancy export already folds the replica's TTL'd pressure floor), so
the autoscaler sees exactly what the fleet gossips, with the same seq/TTL
freshness discipline.

Three actions, all through existing seams:

* **scale-up** — sustained pressure ``>= KAKVEDA_SCALE_UP_OCC`` for the
  dwell window (enter/exit discipline mirrors the brownout ladder):
  spawn a replica (``FleetSupervisor.add_replica``), wait for /readyz,
  then ``Router.rebalance_to`` ships it its ranges and flips the epoch
  — the router stays the SINGLE epoch writer; the autoscaler requests,
  the router's probe loop re-affirms residual pushes.
* **lossless scale-down** — sustained idle ``<= KAKVEDA_SCALE_DOWN_OCC``:
  pick the least-loaded live replica, run the range-migration protocol
  (export → ship → flip → drain the watermark delta), remove it from the
  ring, THEN stop the process. Never stop-then-migrate. Bounded below by
  ``KAKVEDA_SCALE_MIN``; any :class:`MigrationError` aborts with the
  replica still serving.
* **replacement** — a replica dead/ejected past ``KAKVEDA_SCALE_REPLACE_S``
  is declared dead: the same index restarts (same id/url → same ring
  position), a fresh probe re-admits it, and its GFKB gap heals by
  snapshot-shipping its held arcs back from the surviving holders through
  the migration protocol (row-idempotent signature upserts) — plus the
  origins' DLQ auto-replay (``KAKVEDA_DLQ_AUTO_S``)
  for the replication events dead-lettered while it was down. An
  expo-backoff budget (``KAKVEDA_SCALE_REPLACE_BACKOFF_S`` doubling, at
  most ``KAKVEDA_SCALE_REPLACE_MAX`` attempts per replica) keeps a
  crash-looping binary from flapping the ring.

``decide`` is a PURE function of (snapshot, policy state, knobs, now) —
``policy_selftest()`` runs a canned decision table over it with no
processes. Every transition of the scale state machine goes through ONE
``_set_scale_state`` helper (gauge vector + transition counter + flight
recorder together — the same single-writer invariant as the brownout
ladder), and every decision lands as one typed :class:`ScaleDecision`
line in ``data/scale_log.jsonl``.

Knobs (``ScaleKnobs.from_env``, each with the reference's default):
``KAKVEDA_SCALE_UP_OCC`` 0.8, ``_DOWN_OCC`` 0.3, ``_DWELL_S`` 5,
``_COOLDOWN_S`` 15, ``_MIN`` 1, ``_MAX`` 8, ``_REPLACE_S`` 10,
``_REPLACE_BACKOFF_S`` 5, ``_REPLACE_MAX`` 3, ``_TICK_S`` 1 (floor 0.05),
``_READY_S`` 240.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from kakveda_tpu_torch.core import faults as _faults
from kakveda_tpu_torch.core import trace as _trace
from kakveda_tpu_torch.core import metrics as _metrics
from kakveda_tpu_torch.core import sanitize

log = logging.getLogger("kakveda.fleet")

__all__ = [
    "SCALE_STATES",
    "ScaleKnobs",
    "PolicyState",
    "ScaleDecision",
    "decide",
    "commit",
    "Autoscaler",
    "policy_selftest",
]

# Chaos seams (resolved once at import, no-ops unarmed). scale_spawn fires BEFORE any
# process is created or epoch touched: a faulted spawn retries next tick
# and never flips the epoch early. scale_drain fires BEFORE the drain
# migration starts: a faulted drain aborts with the replica still serving.
_FAULT_SPAWN = _faults.site("fleet.scale_spawn")
_FAULT_DRAIN = _faults.site("fleet.scale_drain")

# The scale state machine (gauge vector over these; transitions only via
# _set_scale_state): steady -> scale_up|drain|replace while an action
# executes -> cooldown on success -> steady when the cooldown expires.
SCALE_STATES = ("steady", "scale_up", "drain", "replace", "cooldown")


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_i(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass(frozen=True)
class ScaleKnobs:
    """Policy constants — env-resolved once at mount (KAKVEDA_SCALE_*)."""

    up_occ: float = 0.8
    down_occ: float = 0.3
    dwell_s: float = 5.0
    cooldown_s: float = 15.0
    min_replicas: int = 1
    max_replicas: int = 8
    replace_s: float = 10.0
    replace_backoff_s: float = 5.0
    replace_max: int = 3
    tick_s: float = 1.0
    ready_s: float = 240.0

    @classmethod
    def from_env(
        cls,
        min_replicas: Optional[int] = None,
        max_replicas: Optional[int] = None,
    ) -> "ScaleKnobs":
        return cls(
            up_occ=_env_f("KAKVEDA_SCALE_UP_OCC", 0.8),
            down_occ=_env_f("KAKVEDA_SCALE_DOWN_OCC", 0.3),
            dwell_s=_env_f("KAKVEDA_SCALE_DWELL_S", 5.0),
            cooldown_s=_env_f("KAKVEDA_SCALE_COOLDOWN_S", 15.0),
            min_replicas=(
                _env_i("KAKVEDA_SCALE_MIN", 1)
                if min_replicas is None else int(min_replicas)
            ),
            max_replicas=(
                _env_i("KAKVEDA_SCALE_MAX", 8)
                if max_replicas is None else int(max_replicas)
            ),
            replace_s=_env_f("KAKVEDA_SCALE_REPLACE_S", 10.0),
            replace_backoff_s=_env_f("KAKVEDA_SCALE_REPLACE_BACKOFF_S", 5.0),
            replace_max=_env_i("KAKVEDA_SCALE_REPLACE_MAX", 3),
            tick_s=max(0.05, _env_f("KAKVEDA_SCALE_TICK_S", 1.0)),
            ready_s=_env_f("KAKVEDA_SCALE_READY_S", 240.0),
        )


@dataclass
class PolicyState:
    """Mutable hysteresis state ``decide``/``commit`` evolve. Dwell
    tracking lives here (not in the FleetView) so the policy stays a pure
    function of (snapshot, state, knobs, now)."""

    high_since: Optional[float] = None
    low_since: Optional[float] = None
    cooldown_until: float = 0.0
    # Per-replica replacement bookkeeping: first-seen-dead stamp, attempt
    # count against the budget, and the expo-backoff next-eligible stamp.
    dead_since: Dict[str, float] = field(default_factory=dict)
    replace_counts: Dict[str, int] = field(default_factory=dict)
    replace_next_ok: Dict[str, float] = field(default_factory=dict)


@dataclass
class ScaleDecision:
    """One typed decision record — the scale_log.jsonl line format.
    ``outcome`` is stamped by the executor:
    ``ok`` | ``fault`` (armed chaos site; retried next tick) | ``error``
    | ``aborted`` (drain MigrationError — replica still serving) |
    ``noop`` for action "none"."""

    action: str  # none | scale_up | scale_down | replace
    reason: str
    pressure: float
    n: int  # live replica count at decision time
    target: Optional[str] = None
    outcome: str = "pending"
    ts: float = 0.0
    detail: str = ""

    def to_dict(self) -> dict:
        out = {
            "ts": round(self.ts, 3),
            "action": self.action,
            "outcome": self.outcome,
            "reason": self.reason,
            "pressure": round(self.pressure, 4),
            "n": self.n,
        }
        if self.target:
            out["target"] = self.target
        if self.detail:
            out["detail"] = self.detail
        return out


def _replica_index(rid: str) -> int:
    """Supervisor index from the fleet id convention (``r<i>``)."""
    try:
        return int(rid.lstrip("r"))
    except ValueError:
        return 1 << 30


def decide(
    snapshot: dict, state: PolicyState, knobs: ScaleKnobs, now: float
) -> ScaleDecision:
    """ONE policy evaluation — pure in (snapshot, state, knobs, now).

    ``snapshot`` is ``{"replicas": {rid: {"live", "occupancy",
    "dead_for_s"}}, "pressure": float}``. Mutates only the dwell stamps in
    ``state`` (deterministically); side effects belong to the executor.

    Ordering is deliberate: replacement first (healing a dead owner beats
    elasticity and ignores the scale cooldown — a hole in the ring is a
    correctness problem, not a capacity one), then the dwell+cooldown
    hysteresis for scale-up/down, one action per tick.
    """
    reps: Dict[str, dict] = snapshot.get("replicas", {})
    live = [r for r, s in reps.items() if s.get("live", True)]
    n = len(live)
    pressure = float(snapshot.get("pressure", 0.0))

    # 1) replacement — dead past the threshold, inside budget and backoff.
    for rid in sorted(reps, key=_replica_index):
        s = reps[rid]
        if s.get("live", True):
            continue
        dead_for = float(s.get("dead_for_s", 0.0))
        if dead_for < knobs.replace_s:
            continue
        if state.replace_counts.get(rid, 0) >= knobs.replace_max:
            continue  # budget exhausted: stop flapping the ring
        if now < state.replace_next_ok.get(rid, 0.0):
            continue  # expo backoff window still open
        return ScaleDecision(
            "replace",
            f"dead {dead_for:.1f}s >= replace_s {knobs.replace_s:g}s",
            pressure, n, target=rid,
        )

    # 2) dwell bookkeeping — the brownout ladder's enter/exit discipline:
    # a band crossing starts the clock, leaving the band resets it.
    if pressure >= knobs.up_occ:
        if state.high_since is None:
            state.high_since = now
        state.low_since = None
    elif pressure <= knobs.down_occ:
        if state.low_since is None:
            state.low_since = now
        state.high_since = None
    else:
        state.high_since = None
        state.low_since = None

    if now < state.cooldown_until:
        return ScaleDecision(
            "none", f"cooldown {state.cooldown_until - now:.1f}s left",
            pressure, n, outcome="noop",
        )

    if state.high_since is not None and now - state.high_since >= knobs.dwell_s:
        if n >= knobs.max_replicas:
            return ScaleDecision(
                "none", f"pressure high but at max ({knobs.max_replicas})",
                pressure, n, outcome="noop",
            )
        return ScaleDecision(
            "scale_up",
            f"pressure {pressure:.2f} >= {knobs.up_occ:g} "
            f"for {knobs.dwell_s:g}s",
            pressure, n,
        )

    if state.low_since is not None and now - state.low_since >= knobs.dwell_s:
        if n <= knobs.min_replicas:
            return ScaleDecision(
                "none", f"idle but at min ({knobs.min_replicas})",
                pressure, n, outcome="noop",
            )
        # Least-loaded live victim; ties break to the HIGHEST index (the
        # newest replica) so drained indices recycle last-in-first-out.
        victim = min(
            live,
            key=lambda r: (
                float(reps[r].get("occupancy", 0.0)),
                -_replica_index(r),
            ),
        )
        return ScaleDecision(
            "scale_down",
            f"pressure {pressure:.2f} <= {knobs.down_occ:g} "
            f"for {knobs.dwell_s:g}s",
            pressure, n, target=victim,
        )

    return ScaleDecision("none", "steady", pressure, n, outcome="noop")


def commit(
    state: PolicyState, dec: ScaleDecision, knobs: ScaleKnobs, now: float
) -> None:
    """Fold an EXECUTED decision back into the policy state.

    Only a terminal outcome arms the cooldown and resets the dwell
    clocks; a ``fault`` outcome (armed chaos site, nothing happened)
    leaves both so the very next tick retries — the contract behind the
    fleet.scale_spawn/scale_drain sites. A replacement bumps the
    per-replica attempt count and doubles its backoff window whatever the
    outcome: a target that keeps failing to come back IS the crash-loop
    the budget exists for.
    """
    if dec.action == "none":
        return
    if dec.action == "replace" and dec.target:
        cnt = state.replace_counts.get(dec.target, 0) + 1
        state.replace_counts[dec.target] = cnt
        state.replace_next_ok[dec.target] = (
            now + knobs.replace_backoff_s * (2 ** (cnt - 1))
        )
        if dec.outcome == "ok":
            state.dead_since.pop(dec.target, None)
    if dec.outcome == "fault":
        return  # retry next tick: dwell preserved, no cooldown
    state.high_since = None
    state.low_since = None
    if dec.outcome == "ok":
        state.cooldown_until = now + knobs.cooldown_s


class Autoscaler:
    """The policy loop: snapshot the router's fleet view, ``decide``,
    execute through the supervisor/router seams, ledger the outcome."""

    def __init__(
        self,
        router,
        supervisor,
        *,
        min_replicas: Optional[int] = None,
        max_replicas: Optional[int] = None,
        knobs: Optional[ScaleKnobs] = None,
        scale_log: Optional[str | Path] = None,
    ):
        self.router = router
        self.supervisor = supervisor
        self.knobs = knobs if knobs is not None else ScaleKnobs.from_env(
            min_replicas, max_replicas)
        self.state = PolicyState()
        self._lock = sanitize.named_lock("Autoscaler._lock", kind="rlock")
        self._scale_state = "steady"
        self._entered_at = time.monotonic()
        self._flaps = 0
        self._last_dir: Optional[str] = None
        self._counts: Dict[str, int] = {}
        self._recent: List[dict] = []
        self._log_path = (
            Path(scale_log) if scale_log is not None
            else Path(supervisor.root) / "data" / "scale_log.jsonl"
        )
        self.recorder = _metrics.FlightRecorder("fleet-scale")
        reg = _metrics.get_registry()
        self._m_state = reg.gauge(
            "kakveda_fleet_scale_state",
            "Scale state machine position (one-hot over "
            "steady|scale_up|drain|replace|cooldown)", ("state",),
        )
        for s in SCALE_STATES:
            self._m_state.labels(state=s).set(1.0 if s == "steady" else 0.0)
        self._m_transitions = reg.counter(
            "kakveda_fleet_scale_transitions_total",
            "Scale state transitions", ("from", "to"),
        )
        self._m_decisions = reg.counter(
            "kakveda_fleet_scale_decisions_total",
            "Executed scale decisions by action and outcome",
            ("action", "outcome"),
        )
        self._m_replicas = reg.gauge(
            "kakveda_fleet_scale_replicas",
            "Live replica count as seen by the autoscaler",
        )
        self._m_flaps = reg.counter(
            "kakveda_fleet_scale_flaps_total",
            "Scale direction reversals (up->down or down->up)",
        )

    # -- single-writer transition helper ---------------------------------

    def _set_scale_state(self, new_state: str, pressure: float,
                         detail: str = "") -> None:
        """THE one place the scale state machine moves: gauge vector +
        transition counter + flight-recorder event + log line together
        (single-writer invariant). Caller holds ``_lock``."""
        old = self._scale_state
        if new_state == old:
            return
        self._scale_state = new_state
        self._entered_at = time.monotonic()
        self._m_state.labels(state=old).set(0.0)
        self._m_state.labels(state=new_state).set(1.0)
        self._m_transitions.labels(**{"from": old, "to": new_state}).inc()
        self.recorder.record(
            "scale", **{"from": old, "to": new_state,
                        "pressure": round(pressure, 3), "detail": detail})
        log.warning("fleet scale %s -> %s (pressure %.2f)%s",
                    old, new_state, pressure,
                    f" [{detail}]" if detail else "")

    # -- observation ------------------------------------------------------

    def snapshot(self, now: Optional[float] = None) -> dict:
        """The policy input, from the router's probe-fed FleetView +
        liveness verdicts + the supervisor's process poll (a SIGKILLed
        child shows up here a probe interval before the ring notices)."""
        if now is None:
            now = time.monotonic()
        view = getattr(self.router, "fleet_view", None)
        occ = view.occupancies() if view is not None else {}
        pressure = view.fleet_pressure() if view is not None else 0.0
        liveness = self.router.liveness()
        dead_procs = {
            self.supervisor.replica_id(i)
            for i in self.supervisor.poll_dead()
        }
        replicas: Dict[str, dict] = {}
        for rid, alive in liveness.items():
            alive = bool(alive) and rid not in dead_procs
            if alive:
                self.state.dead_since.pop(rid, None)
                dead_for = 0.0
            else:
                first = self.state.dead_since.setdefault(rid, now)
                dead_for = now - first
            replicas[rid] = {
                "live": alive,
                "occupancy": float(occ.get(rid, 0.0)),
                "dead_for_s": dead_for,
            }
        return {"replicas": replicas, "pressure": pressure}

    # -- the loop ----------------------------------------------------------

    async def run(self) -> None:
        while True:
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — the loop must survive
                log.warning("autoscale tick failed: %s: %s",
                            type(e).__name__, e)
            await asyncio.sleep(self.knobs.tick_s)

    async def tick(self) -> ScaleDecision:
        now = time.monotonic()
        snap = self.snapshot(now)
        with self._lock:
            dec = decide(snap, self.state, self.knobs, now)
            self._m_replicas.set(float(dec.n))
            if dec.action == "none":
                if (self._scale_state == "cooldown"
                        and now >= self.state.cooldown_until):
                    self._set_scale_state("steady", dec.pressure)
                return dec
            self._set_scale_state(
                {"scale_up": "scale_up", "scale_down": "drain",
                 "replace": "replace"}[dec.action],
                dec.pressure, dec.target or "")
        try:
            if dec.action == "scale_up":
                await self._do_scale_up(dec)
            elif dec.action == "scale_down":
                await self._do_scale_down(dec)
            else:
                await self._do_replace(dec)
            dec.outcome = "ok"
        except _faults.FaultInjected as e:
            dec.outcome = "fault"
            dec.detail = str(e)
            log.warning("scale %s faulted (%s); retrying next tick",
                        dec.action, e)
        except Exception as e:  # noqa: BLE001 — ledger it, keep looping
            from kakveda_tpu_torch.fleet.ownership import MigrationError

            if dec.action == "scale_down" and isinstance(e, MigrationError):
                dec.outcome = "aborted"  # replica still serving
            else:
                dec.outcome = "error"
            dec.detail = f"{type(e).__name__}: {e}"
            log.warning("scale %s failed: %s", dec.action, dec.detail)
        with self._lock:
            commit(self.state, dec, self.knobs, time.monotonic())
            if dec.outcome == "ok" and dec.action in ("scale_up", "scale_down"):
                d = "up" if dec.action == "scale_up" else "down"
                if self._last_dir is not None and self._last_dir != d:
                    self._flaps += 1
                    self._m_flaps.inc()
                self._last_dir = d
            self._set_scale_state(
                "cooldown" if dec.outcome == "ok" else "steady",
                dec.pressure, dec.outcome)
        self._ledger(dec)
        return dec

    # -- executors ---------------------------------------------------------

    async def _do_scale_up(self, dec: ScaleDecision) -> None:
        """Spawn -> ready -> ring admission. The fault fires FIRST: a
        faulted spawn creates no process and never touches the epoch."""
        _FAULT_SPAWN.fire()
        loop = asyncio.get_running_loop()
        idx = await loop.run_in_executor(None, self.supervisor.add_replica)
        rid = self.supervisor.replica_id(idx)
        dec.target = rid
        # Wait on JUST the newcomer: an unrelated peer dying mid-spawn
        # must not fail this scale-up (replacement handles the peer).
        await loop.run_in_executor(
            None,
            lambda: self.supervisor.wait_ready(self.knobs.ready_s, only=(idx,)))
        if self.router.ownership is not None:
            members = dict(self.router.ownership.members)
            members[rid] = self.supervisor.url(idx)
            await self.router.rebalance_to(members)
        else:
            self.router.add_backend(rid, self.supervisor.url(idx))
        await self.router.probe_replica(rid)

    async def _do_scale_down(self, dec: ScaleDecision) -> None:
        """Migrate-then-stop, never the reverse: ship the victim's arcs
        (export -> ship -> epoch flip -> watermark-delta drain), drop it
        from the ring, THEN SIGTERM. The fault fires before the drain
        starts; any MigrationError aborts with the replica serving."""
        rid = dec.target or ""
        idx = _replica_index(rid)
        _FAULT_DRAIN.fire()
        if self.router.ownership is not None:
            members = {
                r: u for r, u in self.router.ownership.members.items()
                if r != rid
            }
            if not members:
                raise RuntimeError("refusing to drain the last owner")
            await self.router.rebalance_to(members)
        self.router.remove_backend(rid)
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, lambda: self.supervisor.stop(idx))
        self.supervisor.retire(idx)

    async def _do_replace(self, dec: ScaleDecision) -> None:
        """Reap -> respawn at the SAME index (same id/url/ring position)
        -> probe re-admission -> heal: snapshot-ship its held arcs back
        from the surviving holders (run_rebalance over view-without-it ->
        full-view@epoch+1; signature-keyed upserts make the re-ship
        row-idempotent), while the origins' DLQ replay covers replication
        events dead-lettered at them during the outage."""
        rid = dec.target or ""
        idx = _replica_index(rid)
        _FAULT_SPAWN.fire()
        loop = asyncio.get_running_loop()
        # Short grace: the process is already presumed dead; the stop
        # escalation policy (supervisor.stop) still refuses SIGKILL on a
        # lease-marked replica.
        await loop.run_in_executor(
            None, lambda: self.supervisor.stop(idx, timeout_s=5.0))
        await loop.run_in_executor(None, self.supervisor.start, idx)
        await loop.run_in_executor(
            None,
            lambda: self.supervisor.wait_ready(self.knobs.ready_s, only=(idx,)))
        await self.router.probe_replica(rid)
        await self.router.resync_member(rid)

    # -- ledger / introspection -------------------------------------------

    def _ledger(self, dec: ScaleDecision) -> None:
        dec.ts = time.time()
        rec = dec.to_dict()
        self._m_decisions.labels(action=dec.action, outcome=dec.outcome).inc()
        # Scale decisions trace against the ownership epoch that fenced
        # them — a mid-migration warn anomaly joins its scale event by
        # trace ring, not log archaeology. tick() skips _ledger for
        # action "none", so the ring only carries real actions.
        attrs = dict(
            action=dec.action, target=dec.target or "",
            decision=dec.outcome, pressure=round(dec.pressure, 4),
        )
        epoch = getattr(getattr(self.router, "ownership", None), "epoch", None)
        if epoch is not None:
            attrs["epoch"] = epoch
        _trace.get_tracer().record_completed(
            "fleet.scale", ts=dec.ts,
            outcome="ok" if dec.outcome in ("ok", "noop") else "error",
            **attrs)
        with self._lock:
            key = f"{dec.action}:{dec.outcome}"
            self._counts[key] = self._counts.get(key, 0) + 1
            self._recent.append(rec)
            del self._recent[:-32]
        try:
            self._log_path.parent.mkdir(parents=True, exist_ok=True)
            with open(self._log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError as e:
            log.warning("scale_log append failed: %s", e)

    def flap_count(self) -> int:
        with self._lock:
            return self._flaps

    def decision_counts(self) -> Dict[str, int]:
        """{"action:outcome": n} — the scale_events chaos action and the
        elastic drill read these."""
        with self._lock:
            return dict(self._counts)

    def info(self) -> dict:
        """Status block for the router's /readyz (``report()["autoscale"]``)."""
        now = time.monotonic()
        with self._lock:
            return {
                "state": self._scale_state,
                "min": self.knobs.min_replicas,
                "max": self.knobs.max_replicas,
                "flaps": self._flaps,
                "cooldown_left_s": round(
                    max(0.0, self.state.cooldown_until - now), 2),
                "counts": dict(self._counts),
                "last_decisions": list(self._recent[-8:]),
            }


def policy_selftest() -> int:
    """Canned decision table over the pure policy — no processes, no
    router, <1s. Raises AssertionError on the first divergence; returns
    the number of checks (a unit test holds it to the reference's)."""
    k = ScaleKnobs(
        up_occ=0.8, down_occ=0.3, dwell_s=5.0, cooldown_s=15.0,
        min_replicas=2, max_replicas=4, replace_s=10.0,
        replace_backoff_s=5.0, replace_max=2,
    )
    st = PolicyState()

    def snap(occs: Dict[str, float], dead: Dict[str, float] = {}):
        reps = {
            r: {"live": r not in dead, "occupancy": o,
                "dead_for_s": dead.get(r, 0.0)}
            for r, o in occs.items()
        }
        live = [o for r, o in occs.items() if r not in dead]
        return {"replicas": reps, "pressure": max(live, default=0.0)}

    checks = 0

    def expect(t, s, action, target=None, outcome=None):
        nonlocal checks
        d = decide(s, st, k, t)
        assert d.action == action, (
            f"t={t}: expected {action}, got {d.action} ({d.reason})")
        if target is not None:
            assert d.target == target, (
                f"t={t}: expected target {target}, got {d.target}")
        if outcome is not None:
            d.outcome = outcome
            commit(st, d, k, t)
        checks += 1
        return d

    # high pressure: dwell blocks the first evaluations...
    expect(0.0, snap({"r0": 0.9, "r1": 0.85}), "none")
    expect(3.0, snap({"r0": 0.9, "r1": 0.85}), "none")
    # ...a dip resets the dwell clock...
    expect(4.0, snap({"r0": 0.5, "r1": 0.4}), "none")
    expect(5.0, snap({"r0": 0.9, "r1": 0.9}), "none")
    # ...and sustained pressure past dwell_s scales up.
    expect(10.5, snap({"r0": 0.9, "r1": 0.9}), "scale_up", outcome="ok")
    # cooldown gates the next one even at full dwell (the dwell clock
    # keeps running — pressure sustained THROUGH the cooldown counts)...
    expect(20.0, snap({"r0": 0.95, "r1": 0.95, "r2": 0.9}), "none")
    # ...so the second scale-up fires as soon as the cooldown expires...
    expect(26.0, snap({"r0": 0.95, "r1": 0.95, "r2": 0.9}),
           "scale_up", outcome="ok")
    # ...but max_replicas clamps at 4.
    expect(52.0, snap({"r0": 0.95, "r1": 0.95, "r2": 0.9, "r3": 0.9}),
           "none")
    expect(58.0, snap({"r0": 0.95, "r1": 0.95, "r2": 0.9, "r3": 0.9}),
           "none")
    # idle: least-loaded live replica drains (tie -> highest index)...
    expect(70.0, snap({"r0": 0.1, "r1": 0.05, "r2": 0.05, "r3": 0.2}),
           "none")
    expect(75.5, snap({"r0": 0.1, "r1": 0.05, "r2": 0.05, "r3": 0.2}),
           "scale_down", target="r2", outcome="ok")
    # ...cooldown gates again, then min_replicas floors the fleet at 2.
    expect(80.0, snap({"r0": 0.1, "r1": 0.1, "r3": 0.05}), "none")
    expect(97.0, snap({"r0": 0.1, "r1": 0.1, "r3": 0.05}),
           "scale_down", target="r3", outcome="ok")
    expect(120.0, snap({"r0": 0.0, "r1": 0.0}), "none")
    expect(126.0, snap({"r0": 0.0, "r1": 0.0}), "none")
    # replacement: fires past replace_s, beats elasticity, ignores
    # cooldown; a mid-pressure snapshot still replaces first.
    st2 = PolicyState()
    s_dead = snap({"r0": 0.9, "r1": 0.9}, dead={"r1": 12.0})
    d = decide(s_dead, st2, k, 200.0)
    assert d.action == "replace" and d.target == "r1", d
    d.outcome = "fault"
    commit(st2, d, k, 200.0)
    checks += 1
    # a faulted replace still burns budget + backoff (crash-loop damping):
    # next attempt blocked until 200 + 5s...
    d = decide(s_dead, st2, k, 203.0)
    assert d.action != "replace", d
    checks += 1
    # ...allowed at 206, and the SECOND attempt doubles the window.
    d = decide(s_dead, st2, k, 206.0)
    assert d.action == "replace", d
    d.outcome = "ok"
    commit(st2, d, k, 206.0)
    assert st2.replace_next_ok["r1"] == 206.0 + 10.0, st2.replace_next_ok
    checks += 1
    # budget exhausted (replace_max=2): never again.
    s_dead2 = snap({"r0": 0.9, "r1": 0.9}, dead={"r1": 500.0})
    d = decide(s_dead2, st2, k, 1000.0)
    assert d.action != "replace", d
    checks += 1
    # a faulted scale-up preserves the dwell clock: retry is immediate.
    st3 = PolicyState()
    hot = snap({"r0": 0.9, "r1": 0.9})
    decide(hot, st3, k, 0.0)
    d = decide(hot, st3, k, 6.0)
    assert d.action == "scale_up", d
    d.outcome = "fault"
    commit(st3, d, k, 6.0)
    d = decide(hot, st3, k, 6.5)
    assert d.action == "scale_up", f"faulted spawn must retry next tick: {d}"
    checks += 1
    return checks
