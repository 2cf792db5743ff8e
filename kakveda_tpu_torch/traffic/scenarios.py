"""Seeded scenario generators — the load shapes that actually break systems.

Every generator is a pure function of ``(seed, knobs)``: arrivals come from
one ``random.Random(seed)`` drawing inter-arrival gaps, so the same seed
produces the identical arrival schedule and app-key sequence on every run,
and the same events as the JAX package's generators. Events are plain dicts the
replayer posts open-loop:

    {"t": offset_s, "method": "POST", "path": "/warn", "klass": "warn",
     "app_id": "app-3", "body": {…}, "phase": "baseline|storm|recovery"}

``method: "LOCAL"`` events (mixed contention's generate arm) dispatch
through a caller-provided callable instead of HTTP — the core service tier
has no generation route (that lives behind the serving engine), and the
harness must not pretend otherwise.

A scenario optionally carries a **chaos timeline**: actions applied at
offsets while the replay runs —

    {"t": 4.0, "action": "faults", "spec": "device.unavailable:1.0:-1"}
    {"t": 6.0, "action": "faults", "spec": ""}            ← outage ends
    {"t": 5.0, "action": "kill_replica", "replica": 1}
    {"t": 5.5, "action": "restart_replica", "replica": 1}
    {"t": 5.2, "action": "crash_replica", "replica": 1}   ← SIGKILL (dead-owner
                                                            drill; skipped when
                                                            the replica may hold
                                                            a device lease)
    {"t": 4.5, "action": "fleet_pressure", "pressure": 0.95, "ttl_s": 5.0}
    {"t": 7.0, "action": "scale_events"}                  ← snapshot autoscaler
                                                            counters (measurement)

``faults`` entries are full :func:`kakveda_tpu_torch.core.faults.arm` specs
(each REPLACES the arming — an empty spec closes the outage window, the
same disarm-ends-the-outage shape as a real recovery). ``fleet_pressure``
feeds :meth:`AdmissionController.note_fleet_pressure` — exactly what a
saturated peer's gossip sample does, so a single-process storm still
exercises the fleet pressure floor. Replica actions need a
FleetSupervisor handle at replay time.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from kakveda_tpu_torch.traffic.slo import SLO

__all__ = ["Scenario", "SCENARIOS", "make_scenario", "synth_traces"]

# Fixed epoch for synthesized trace timestamps: generation must be a pure
# function of the seed (same seed → byte-identical events), so wall clock
# is banned here. Replay stamps real time where it matters.
_TRACE_EPOCH = 1_700_000_000.0

_PROMPTS = (
    "Cite sources for claim {i} even if unavailable.",
    "Summarize document {i} and include references for every claim.",
    "Explain incident {i} adding citations even when none exist.",
    "Review change {i} and list supporting sources.",
)


def synth_traces(seed: int, app_id: str, n: int, *, near_dup: bool = False) -> List[dict]:
    """Deterministic ingest trace batch. ``near_dup=True`` emits variants
    of ONE template differing by a token — the adversarial shape for the
    incremental mining path (near-ties in similarity, cluster churn)."""
    rng = random.Random(seed)
    base = rng.randrange(1 << 30)
    traces = []
    for k in range(n):
        i = base if near_dup else base + k * 97
        prompt = _PROMPTS[0 if near_dup else (base + k) % len(_PROMPTS)].format(i=i)
        if near_dup:
            prompt += f" variant {k % 7}"
        traces.append({
            "trace_id": f"tr-{seed}-{app_id}-{k}",
            "ts": _TRACE_EPOCH + (seed % 100_000) + k,
            "app_id": app_id,
            "prompt": prompt,
            "response": "According to [Smith 2020] (fabricated).",
            "tools": [],
            "env": {"os": "linux"},
        })
    return traces


@dataclass
class Scenario:
    """One generated traffic run: events + chaos timeline + SLO + phase
    boundaries (``notes``: storm_start_s / storm_end_s / gossip_ttl_s)."""

    name: str
    seed: int
    duration_s: float
    events: List[dict]
    chaos: List[dict] = field(default_factory=list)
    slo: SLO = field(default_factory=SLO)
    notes: Dict[str, float] = field(default_factory=dict)

    def app_key_sequence(self) -> List[str]:
        return [e.get("app_id", "") for e in self.events]

    def arrival_schedule(self) -> List[float]:
        return [float(e["t"]) for e in self.events]


def _arrivals(rng: random.Random, duration_s: float,
              rate_fn: Callable[[float], float]) -> List[float]:
    """Seeded non-homogeneous arrivals by thinning: draw at the peak rate,
    keep each with p = rate(t)/peak. Deterministic given the rng."""
    peak = max(rate_fn(duration_s * i / 64.0) for i in range(65))
    peak = max(peak, 1e-6)
    out, t = [], 0.0
    while True:
        t += rng.expovariate(peak)
        if t >= duration_s:
            return out
        if rng.random() < rate_fn(t) / peak:
            out.append(round(t, 6))


def _pick_app(rng: random.Random, apps: int, hot_share: float) -> str:
    """App-key draw: ``hot_share`` of traffic lands on app-0."""
    if hot_share > 0.0 and rng.random() < hot_share:
        return "app-0"
    return f"app-{rng.randrange(1, max(2, apps))}"


def _warn_event(t: float, app: str, i: int, phase: str) -> dict:
    prompt = _PROMPTS[i % len(_PROMPTS)].format(i=i)
    return {
        "t": t, "method": "POST", "path": "/warn", "klass": "warn",
        "app_id": app, "phase": phase,
        "body": {"app_id": app, "prompt": prompt},
    }


# -- generators ----------------------------------------------------------


def diurnal_wave(seed: int = 0, *, duration_s: float = 10.0,
                 warn_rps: float = 40.0, depth: float = 0.7,
                 apps: int = 8) -> Scenario:
    """One compressed diurnal cycle: warn arrivals swell to
    ``(1+depth)×`` the mean mid-window and trough to ``(1-depth)×`` at the
    edges. The shape that catches drain-rate estimators calibrated on the
    trough being hit by the crest."""
    rng = random.Random(seed)
    rate = lambda t: warn_rps * (1.0 - depth * math.cos(2 * math.pi * t / duration_s))  # noqa: E731
    events = [
        _warn_event(t, _pick_app(rng, apps, 0.0), i, "wave")
        for i, t in enumerate(_arrivals(rng, duration_s, rate))
    ]
    return Scenario(
        name="diurnal", seed=seed, duration_s=duration_s, events=events,
        slo=SLO(shed_only=("interactive", "background"), zero_lost=("warn",)),
    )


def hot_key_skew(seed: int = 0, *, duration_s: float = 8.0,
                 warn_rps: float = 50.0, hot_share: float = 0.9,
                 apps: int = 8) -> Scenario:
    """One app produces ``hot_share`` (default 90%) of the warn traffic —
    the shard-imbalance shape the fleet router's hash ring must absorb and
    the per-app failure-rate trackers must not let starve the cold keys."""
    rng = random.Random(seed)
    events = [
        _warn_event(t, _pick_app(rng, apps, hot_share), i, "skew")
        for i, t in enumerate(_arrivals(rng, duration_s, lambda _t: warn_rps))
    ]
    return Scenario(
        name="hot_key", seed=seed, duration_s=duration_s, events=events,
        slo=SLO(shed_only=("interactive", "background"), zero_lost=("warn",)),
    )


def failure_storm(seed: int = 0, *, duration_s: float = 12.0,
                  warn_rps: float = 40.0, ingest_rps: float = 6.0,
                  storm_start_frac: float = 0.3, storm_len_frac: float = 0.4,
                  device_loss: bool = True) -> Scenario:
    """A failure wave: steady warn traffic, plus an ingest burst (apps
    suddenly reporting failures en masse) through a mid-run window that
    also opens a device-loss chaos window — warn must ride it out on the
    host tiers (degraded verdicts, never errors)."""
    rng = random.Random(seed)
    b = duration_s * storm_start_frac
    s = b + duration_s * storm_len_frac
    phase = lambda t: "baseline" if t < b else ("storm" if t < s else "recovery")  # noqa: E731
    events = [
        _warn_event(t, _pick_app(rng, 8, 0.0), i, phase(t))
        for i, t in enumerate(_arrivals(rng, duration_s, lambda _t: warn_rps))
    ]
    for j, t in enumerate(_arrivals(rng, duration_s,
                                    lambda t: ingest_rps if b <= t < s else ingest_rps / 8)):
        app = f"app-{j % 4}"
        events.append({
            "t": t, "method": "POST", "path": "/ingest/batch", "klass": "ingest",
            "app_id": app, "phase": phase(t),
            "body": {"traces": synth_traces(seed * 1009 + j, app, 8)},
        })
    events.sort(key=lambda e: e["t"])
    chaos = []
    if device_loss:
        storm_len = s - b
        chaos = [
            {"t": round(b + 0.2 * storm_len, 3), "action": "faults",
             "spec": "device.unavailable:1.0:-1"},
            {"t": round(b + 0.7 * storm_len, 3), "action": "faults", "spec": ""},
        ]
    return Scenario(
        name="failure_storm", seed=seed, duration_s=duration_s, events=events,
        chaos=chaos,
        slo=SLO(shed_only=("interactive", "background"),
                zero_lost=("warn",), warn_p95_x_baseline=50.0),
        notes={"storm_start_s": b, "storm_end_s": s},
    )


def adversarial_near_dup(seed: int = 0, *, duration_s: float = 8.0,
                         ingest_rps: float = 8.0, batch: int = 16,
                         warn_rps: float = 10.0) -> Scenario:
    """Near-duplicate ingest flood against the incremental mining path:
    every batch is variants of one template (near-tied similarities,
    maximal cluster churn per row), with background mine calls
    interleaved so the streaming state is being read WHILE it churns."""
    rng = random.Random(seed)
    events = [
        _warn_event(t, "app-dup", i, "flood")
        for i, t in enumerate(_arrivals(rng, duration_s, lambda _t: warn_rps))
    ]
    for j, t in enumerate(_arrivals(rng, duration_s, lambda _t: ingest_rps)):
        events.append({
            "t": t, "method": "POST", "path": "/ingest/batch", "klass": "ingest",
            "app_id": "app-dup", "phase": "flood",
            "body": {"traces": synth_traces(seed * 31 + j, "app-dup", batch,
                                            near_dup=True)},
        })
    for t in _arrivals(rng, duration_s, lambda _t: 0.5):
        events.append({
            "t": t, "method": "POST", "path": "/patterns/mine",
            "klass": "background", "app_id": "miner", "phase": "flood",
            "body": {"mode": "auto"},
        })
    events.sort(key=lambda e: e["t"])
    return Scenario(
        name="near_dup", seed=seed, duration_s=duration_s, events=events,
        slo=SLO(shed_only=("interactive", "background"), zero_lost=("warn",)),
    )


def mixed_contention(seed: int = 0, *, duration_s: float = 8.0,
                     warn_rps: float = 30.0, gen_rps: float = 4.0,
                     mine_rps: float = 1.0) -> Scenario:
    """Warn + generation contention: interactive generate events dispatch
    through a caller-provided callable (``method: "LOCAL"`` — the serving
    engine lives behind the dashboard, not this HTTP tier) while
    background mines burn executor/GIL time. The pre-flight class must
    hold its latency against both."""
    rng = random.Random(seed)
    events = [
        _warn_event(t, _pick_app(rng, 8, 0.0), i, "mixed")
        for i, t in enumerate(_arrivals(rng, duration_s, lambda _t: warn_rps))
    ]
    for j, t in enumerate(_arrivals(rng, duration_s, lambda _t: gen_rps)):
        events.append({
            "t": t, "method": "LOCAL", "path": "generate",
            "klass": "interactive", "app_id": f"gen-{j % 4}", "phase": "mixed",
            "body": {"prompt": f"Summarize incident {j}.", "max_new_tokens": 16},
        })
    for t in _arrivals(rng, duration_s, lambda _t: mine_rps):
        events.append({
            "t": t, "method": "POST", "path": "/patterns/mine",
            "klass": "background", "app_id": "miner", "phase": "mixed",
            "body": {"mode": "auto"},
        })
    events.sort(key=lambda e: e["t"])
    return Scenario(
        name="mixed", seed=seed, duration_s=duration_s, events=events,
        slo=SLO(shed_only=("interactive", "background"), zero_lost=("warn",),
                ttft_p95_ms=None),
    )


def storm(seed: int = 0, *, duration_s: float = 12.0, warn_rps: float = 40.0,
          hot_share: float = 0.9, apps: int = 8, bg_rps: float = 20.0,
          baseline_frac: float = 0.3, storm_frac: float = 0.4,
          device_loss: bool = True, kill_replica: Optional[int] = None,
          fleet_pressure: bool = True, gossip_ttl_s: float = 5.0,
          warn_p95_x: float = 50.0) -> Scenario:
    """THE storm drill's composition — hot-key skew + failure storm:

    * phase ``baseline`` ``[0, b)``: hot-key-skewed warn at capacity.
    * phase ``storm`` ``[b, s)``: same warn stream + a background flood
      (mine calls past the background bound — the SHEDDABLE excess) + the
      chaos timeline: a device-loss window (warn must degrade to host
      tiers, not fail), gossiped fleet pressure pinning the ladder up,
      and optionally one replica kill (fleet mode).
    * phase ``recovery`` ``[s, end)``: warn only; the pressure floor is
      refreshed at 0 by the next gossip tick (a live fleet's samples
      REPLACE, only a dead peer waits out the TTL) and the ladder must
      walk back to ``normal`` within ``gossip_ttl_s`` of storm end.

    ``warn_p95_x`` bounds the storm-phase warn p95 at a multiple of the
    same run's baseline p95. The default (50x) covers the device-loss
    window, where warn deliberately pays warm-tier host matching instead
    of failing — bounded degradation, against an unprotected stack whose
    warns time out (effectively unbounded). Size the warn class bound for
    DEGRADED throughput when driving this scenario: warn must never shed,
    so the queue has to absorb the warm-tier window's slower drain. The
    attached SLO is the acceptance contract the `storm` drill
    self-certifies (``cli traffic storm``)."""
    rng = random.Random(seed)
    b = round(duration_s * baseline_frac, 3)
    s = round(b + duration_s * storm_frac, 3)
    phase = lambda t: "baseline" if t < b else ("storm" if t < s else "recovery")  # noqa: E731
    events = [
        _warn_event(t, _pick_app(rng, apps, hot_share), i, phase(t))
        for i, t in enumerate(_arrivals(rng, duration_s, lambda _t: warn_rps))
    ]
    for t in _arrivals(rng, duration_s, lambda t: bg_rps if b <= t < s else 0.0):
        events.append({
            "t": t, "method": "POST", "path": "/patterns/mine",
            "klass": "background", "app_id": "miner", "phase": "storm",
            "body": {"mode": "auto"},
        })
    events.sort(key=lambda e: e["t"])

    storm_len = s - b
    chaos: List[dict] = []
    if device_loss:
        chaos += [
            {"t": round(b + 0.15 * storm_len, 3), "action": "faults",
             "spec": "device.unavailable:1.0:-1"},
            {"t": round(b + 0.65 * storm_len, 3), "action": "faults", "spec": ""},
        ]
    if kill_replica is not None:
        chaos.append({"t": round(b + 0.5 * storm_len, 3),
                      "action": "kill_replica", "replica": int(kill_replica)})
    if fleet_pressure:
        # A peer's gossip, tick by tick: pressure 0.95 samples through the
        # storm, then drained (0.0) samples through recovery — a live
        # peer's fresh sample REPLACES the floor (only a dead peer waits
        # out the TTL), and each recovery tick re-evaluates the ladder
        # exactly as GossipPublisher.tick_inputs does on an idle replica.
        t = b
        while t < s:
            chaos.append({"t": round(t, 3), "action": "fleet_pressure",
                          "pressure": 0.95, "ttl_s": gossip_ttl_s})
            t += 1.0
        t = s + 0.1
        while t < duration_s:
            chaos.append({"t": round(t, 3), "action": "fleet_pressure",
                          "pressure": 0.0, "ttl_s": gossip_ttl_s})
            t += 1.0
    chaos.sort(key=lambda c: c["t"])
    return Scenario(
        name="storm", seed=seed, duration_s=duration_s, events=events,
        chaos=chaos,
        slo=SLO(
            warn_p95_x_baseline=warn_p95_x,
            shed_only=("interactive", "background"),
            zero_hung=True,
            zero_lost=("warn",),
            recovery_s=gossip_ttl_s,
        ),
        notes={"storm_start_s": b, "storm_end_s": s,
               "gossip_ttl_s": gossip_ttl_s},
    )


def rebalance_storm(seed: int = 0, *, duration_s: float = 10.0,
                    warn_rps: float = 30.0, apps: int = 12,
                    hot_share: float = 0.5, rebalance_frac: float = 0.35,
                    kill_replica: Optional[int] = None,
                    kill_frac: float = 0.7, gossip_ttl_s: float = 5.0,
                    max_partial_rate: float = 0.1) -> Scenario:
    """Sharded-ownership drill (fleet/ownership.py): steady warn traffic
    while the fleet rebalances — and, optionally, an OWNER dies.

    * phase ``baseline`` ``[0, rb)``: warn across ``apps`` keys.
    * at ``rb`` the ``rebalance`` action fires — the driving test/drill
      supplies the handle via run_chaos ``callbacks`` (add a replica +
      run the range migration through the router's /fleet/rebalance);
      warn keeps flowing open-loop through the migration.
    * phase ``storm`` until ``kill``; at ``kill`` the named replica — an
      owner — gets SIGTERM'd (supervisor.stop, never SIGKILL). Scatter-
      gather must keep answering from standbys; the epoch push re-fences.
    * phase ``recovery`` to the end: the ladder must be back to normal
      within ``gossip_ttl_s``.

    Zero lost warns + zero hung + sheds confined to interactive/
    background + bounded partial-verdict rate IS the acceptance contract
    of the rebalance drill."""
    rng = random.Random(seed)
    rb = round(duration_s * rebalance_frac, 3)
    kl = round(duration_s * kill_frac, 3)
    phase = lambda t: "baseline" if t < rb else ("storm" if t < kl else "recovery")  # noqa: E731
    events = [
        _warn_event(t, _pick_app(rng, apps, hot_share), i, phase(t))
        for i, t in enumerate(_arrivals(rng, duration_s, lambda _t: warn_rps))
    ]
    events.sort(key=lambda e: e["t"])
    chaos: List[dict] = [{"t": rb, "action": "rebalance"}]
    if kill_replica is not None:
        chaos.append({"t": kl, "action": "kill_replica",
                      "replica": int(kill_replica)})
    return Scenario(
        name="rebalance_storm", seed=seed, duration_s=duration_s,
        events=events, chaos=chaos,
        slo=SLO(
            shed_only=("interactive", "background"),
            zero_hung=True,
            zero_lost=("warn",),
            recovery_s=gossip_ttl_s,
            max_partial_rate=max_partial_rate,
        ),
        notes={"storm_start_s": rb, "storm_end_s": kl,
               "gossip_ttl_s": gossip_ttl_s},
    )


def flash_crowd(seed: int = 0, *, baseline_s: float = 8.0,
                surge_s: float = 30.0, decay_s: float = 40.0,
                warn_rps: float = 10.0, surge_x: float = 5.0,
                bg_rps: float = 15.0, apps: int = 12,
                hot_share: float = 0.3,
                crash_replica: Optional[int] = None,
                gossip_ttl_s: float = 5.0, max_scale_flaps: int = 1,
                recovery_s: Optional[float] = None,
                mine_mode: str = "full") -> Scenario:
    """Elastic-fleet drill (fleet/autoscaler.py): flash crowd → dead owner.

    * phase ``baseline`` ``[0, b)``: warn at ``warn_rps`` — the fleet
      holds at ``KAKVEDA_SCALE_MIN`` replicas, occupancy well under the
      scale-up threshold.
    * phase ``storm`` ``[b, s)``: warn ramps to ``surge_x ×`` over the
      first fifth of the window and holds, plus a background mine flood
      (``bg_rps`` past the background class bound — the sheddable excess
      that pins occupancy at 1.0; ``mine_mode="full"`` by default so each
      admitted mine is a real O(N²) burn, not an empty-delta no-op the
      probe would sample as idle). Sustained pressure must carry the
      autoscaler through its dwell and spawn fresh replicas — size
      ``surge_s`` to cover dwell + replica cold-start (a torch import,
      a CUDA context and the index's allocation: ~10 s on the card).
    * at ``s`` (surge end) the optional ``crash_replica`` fires: one
      OWNER dies by SIGKILL — no drain, no goodbye gossip. The autoscaler
      must declare it dead past ``KAKVEDA_SCALE_REPLACE_S``, give a fresh
      replica its ring position, and heal its rows (snapshot-ship +
      DLQ replay) — replacement outranks elastic actions in the policy.
    * phase ``recovery`` ``[s, end)``: warn back at baseline rate long
      enough for the replacement AND the lossless scale-down drains
      (migrate-then-SIGTERM, never stop-then-migrate) to complete.

    The attached SLO is the elastic acceptance contract the elastic
    drill self-certifies: zero lost warns, zero hung, sheds confined
    to interactive/background, and at most ``max_scale_flaps`` direction
    reversals (a clean 2→4→2 cycle is exactly one flap — anything more is
    ring flapping). ``scale_events`` entries snapshot the autoscaler's
    decision ledger at each phase boundary for the chaos log."""
    rng = random.Random(seed)
    b = round(baseline_s, 3)
    s = round(baseline_s + surge_s, 3)
    duration_s = round(baseline_s + surge_s + decay_s, 3)
    phase = lambda t: "baseline" if t < b else ("storm" if t < s else "recovery")  # noqa: E731
    ramp = max(1e-6, 0.2 * surge_s)

    def warn_rate(t: float) -> float:
        if t < b or t >= s:
            return warn_rps
        return warn_rps * min(surge_x, 1.0 + (surge_x - 1.0) * (t - b) / ramp)

    events = [
        _warn_event(t, _pick_app(rng, apps, hot_share), i, phase(t))
        for i, t in enumerate(_arrivals(rng, duration_s, warn_rate))
    ]
    for t in _arrivals(rng, duration_s, lambda t: bg_rps if b <= t < s else 0.0):
        events.append({
            "t": t, "method": "POST", "path": "/patterns/mine",
            "klass": "background", "app_id": "miner", "phase": "storm",
            "body": {"mode": mine_mode},
        })
    events.sort(key=lambda e: e["t"])

    chaos: List[dict] = [
        {"t": b, "action": "scale_events"},
        {"t": round(b + 0.5 * surge_s, 3), "action": "scale_events"},
        {"t": s, "action": "scale_events"},
        {"t": round(duration_s - 0.5, 3), "action": "scale_events"},
    ]
    if crash_replica is not None:
        chaos.append({"t": s, "action": "crash_replica",
                      "replica": int(crash_replica)})
    chaos.sort(key=lambda c: c["t"])
    return Scenario(
        name="flash_crowd", seed=seed, duration_s=duration_s, events=events,
        chaos=chaos,
        slo=SLO(
            shed_only=("interactive", "background"),
            zero_hung=True,
            zero_lost=("warn",),
            recovery_s=recovery_s,
            max_scale_flaps=max_scale_flaps,
        ),
        notes={"storm_start_s": b, "storm_end_s": s,
               "gossip_ttl_s": gossip_ttl_s},
    )


def noisy_neighbor(seed: int = 0, *, duration_s: float = 10.0,
                   victims: int = 3, victim_rps: float = 15.0,
                   flood_rps: float = 150.0, flood_start_frac: float = 0.3,
                   flood_app: str = "app-flood",
                   max_victim_shed_rate: float = 0.05,
                   victim_p95_x: float = 3.0,
                   min_flood_shed_share: float = 0.9,
                   starvation_s: float = 2.0) -> Scenario:
    """THE tenant-isolation drill:
    well-behaved victim apps warm up alone, then ONE flooder opens up at
    many multiples of the warn drain rate and keeps firing to the end.

    * phase ``baseline`` ``[0, b)``: ``victims`` apps share ``victim_rps``
      of warn traffic — comfortably under capacity; this phase is the
      self-normalizing latency reference.
    * phase ``flood`` ``[b, end)``: the same victim stream continues
      unchanged while ``flood_app`` adds ``flood_rps`` on top — far past
      the drain rate, so the warn queue saturates and SOMEONE must shed.

    The SLO is the isolation contract: the shed lands on the flooder
    (``min_flood_shed_share``), victims keep their admission rate
    (``max_victim_shed_rate``) and near-baseline latency
    (``victim_p95_x_baseline``), and no victim starves longer than
    ``starvation_s`` of scheduled time without a success — the observed
    end-to-end counterpart of the weighted-fair promotion bound
    (``KAKVEDA_TENANT_PROMOTE_ROUNDS``). ``shed_only`` is cleared because
    warn sheds are EXPECTED here — the whole point is who absorbs them.
    The tenants drill self-certifies this SLO in-run; without
    tenant fairness (``KAKVEDA_TENANT_FAIR=0``) the flooder's backlog
    sheds victims indiscriminately and the gates fail."""
    rng = random.Random(seed)
    b = round(duration_s * flood_start_frac, 3)
    phase = lambda t: "baseline" if t < b else "flood"  # noqa: E731
    events = [
        _warn_event(t, f"app-v{rng.randrange(max(1, victims))}", i, phase(t))
        for i, t in enumerate(_arrivals(rng, duration_s, lambda _t: victim_rps))
    ]
    for j, t in enumerate(_arrivals(rng, duration_s,
                                    lambda t: flood_rps if t >= b else 0.0)):
        events.append(_warn_event(t, flood_app, j, "flood"))
    events.sort(key=lambda e: e["t"])
    return Scenario(
        name="noisy_neighbor", seed=seed, duration_s=duration_s,
        events=events,
        slo=SLO(
            shed_only=(),  # warn sheds are the scenario's point
            zero_hung=True,
            zero_lost=("warn",),
            flood_app=flood_app,
            max_victim_shed_rate=max_victim_shed_rate,
            victim_p95_x_baseline=victim_p95_x,
            max_tenant_starvation_s=starvation_s,
            min_flood_shed_share=min_flood_shed_share,
        ),
        notes={"flood_start_s": b},
    )


def aging(seed: int = 0, *, duration_s: float = 8.0,
          virtual_days: float = 28.0, cohorts: int = 4,
          warn_rps: float = 20.0, ingest_rps: float = 4.0,
          age_ttl_virtual_days: float = 14.0) -> Scenario:
    """A month of failure memory compressed into ``duration_s``: app
    cohorts arrive in weekly waves — cohort k ingests (and warns) only
    during its own week, then goes quiet forever. By the end of the run
    the oldest cohorts are past any ``age_ttl_virtual_days`` TTL while the
    young ones are fresh, which is exactly the differential the lifecycle
    tier must honor: aged cohorts tombstone, live cohorts keep answering,
    and resident/log bytes stay bound instead of growing with history.

    Pure in (seed, knobs) like every scenario — virtual time derives from
    the scheduled arrival offset (``t / compression``), never wall clock.
    ``notes`` carry the compression factor and TTL so a consumer (a
    recovery drill, a replay harness) can convert run time to virtual
    seconds and drive ``GFKB.age_rows(ttl_s=…, now=…)`` with an injected
    clock instead of waiting out real weeks."""
    rng = random.Random(seed)
    cohorts = max(1, cohorts)
    compression = (virtual_days * 86400.0) / duration_s
    week = duration_s / cohorts
    events = []
    for c in range(cohorts):
        lo, hi = c * week, (c + 1) * week
        in_week = lambda t: warn_rps / cohorts if lo <= t < hi else 0.0  # noqa: E731
        for i, t in enumerate(_arrivals(rng, duration_s, in_week)):
            events.append(_warn_event(t, f"app-c{c}-{i % 3}", i, f"week{c}"))
        for j, t in enumerate(_arrivals(rng, duration_s,
                                        lambda t: ingest_rps / cohorts
                                        if lo <= t < hi else 0.0)):
            app = f"app-c{c}-{j % 3}"
            events.append({
                "t": t, "method": "POST", "path": "/ingest/batch",
                "klass": "ingest", "app_id": app, "phase": f"week{c}",
                "body": {"traces": synth_traces(seed * 7919 + c * 97 + j,
                                                app, 6)},
            })
    events.sort(key=lambda e: e["t"])
    return Scenario(
        name="aging", seed=seed, duration_s=duration_s, events=events,
        slo=SLO(shed_only=("interactive", "background"), zero_lost=("warn",)),
        notes={"compression": compression,
               "virtual_days": virtual_days,
               "cohorts": float(cohorts),
               "age_ttl_virtual_s": age_ttl_virtual_days * 86400.0},
    )


SCENARIOS: Dict[str, Callable[..., Scenario]] = {
    "diurnal": diurnal_wave,
    "hot_key": hot_key_skew,
    "failure_storm": failure_storm,
    "near_dup": adversarial_near_dup,
    "mixed": mixed_contention,
    "storm": storm,
    "rebalance_storm": rebalance_storm,
    "flash_crowd": flash_crowd,
    "noisy_neighbor": noisy_neighbor,
    "aging": aging,
}


def make_scenario(name: str, seed: int = 0, **kw) -> Scenario:
    try:
        factory = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}"
        ) from None
    return factory(seed, **kw)
