"""Declarative SLO gates over a replay — the degradation CONTRACT.

An :class:`SLO` is a per-scenario set of bounds; :func:`evaluate` checks a
finished :class:`~kakveda_tpu_torch.traffic.replay.ReplayResult` against it and
returns a typed :class:`SLOReport` (one row per gate: observed value,
bound, pass/fail). ``None`` bounds are not evaluated — a scenario only
pays for the gates it declares.

Gates (the storm drill self-certifies all of them in-run):

* ``warn_p50_ms`` / ``warn_p95_ms`` — absolute warn latency bounds.
* ``warn_p95_x_baseline`` — warn p95 during/after the storm bounded at a
  multiple of the SAME run's baseline-phase p95 (self-normalizing: no
  machine-speed constant to rot).
* ``ttft_p95_ms`` — interactive time-to-first-token (LOCAL dispatch arm).
* ``max_shed_rate`` — per-class shed-rate ceilings, e.g. ``{"warn": 0.0}``.
* ``shed_only`` — sheds confined to these classes; a shed observed for
  any OTHER class (warn! ingest!) fails the gate outright.
* ``zero_hung`` — no request may still be in flight / timed out at the
  end: SHED-NEVER-HANG, end to end.
* ``zero_lost`` — for each named class, every event generated was
  terminally accounted (ok/shed/degraded/error — never silently dropped).
* ``recovery_s`` — the brownout ladder must be back at ``normal`` within
  this many seconds of ``storm_end_s`` (measured by the replayer).
* ``max_partial_rate`` — sharded ownership: ceiling on the share of ok
  warn verdicts whose scatter-gather merge was ``partial=true`` (a range
  had no answering holder). Fed from ``ReplayResult.notes["partial"]``.
* ``max_scale_flaps`` — elastic fleet: ceiling on autoscaler direction
  reversals (executed scale-up↔scale-down flips) during the run. Fed
  from ``ReplayResult.notes["scale_flaps"]`` (the replayer stuffs it
  when an autoscaler handle was threaded through ``run_scenario``).
* Tenant-isolation arm (``flood_app`` names the flooder; every gate is
  vacuous unless records carry app tags AND ``flood_app`` is set):
  ``max_victim_shed_rate`` — shed-rate ceiling over NON-flooder traffic;
  ``victim_p95_x_baseline`` — victim ok-p95 during the ``flood`` phase
  bounded at a multiple of the same victims' ``baseline``-phase p95;
  ``max_tenant_starvation_s`` — longest per-victim span of consecutive
  non-ok dispatches (the weighted-fair promotion bound, observed
  end-to-end); ``min_flood_shed_share`` — FLOOR on the fraction of all
  sheds that landed on the flooder (quotas must aim the pain at whoever
  owns the backlog).

Which scenario declares what: each generator's ``SLO`` in
``kakveda_tpu_torch/traffic/scenarios.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["SLO", "SLOReport", "evaluate", "percentile"]


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile; 0.0 on empty input (dependency-free —
    this module must import without torch/numpy, the metrics-plane rule)."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    i = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return float(xs[i])


@dataclass(frozen=True)
class SLO:
    name: str = "default"
    warn_p50_ms: Optional[float] = None
    warn_p95_ms: Optional[float] = None
    warn_p95_x_baseline: Optional[float] = None
    ttft_p95_ms: Optional[float] = None
    max_shed_rate: Dict[str, float] = field(default_factory=dict)
    shed_only: Tuple[str, ...] = ("interactive", "background")
    zero_hung: bool = True
    zero_lost: Tuple[str, ...] = ("warn",)
    recovery_s: Optional[float] = None
    # Sharded-ownership arm: ceiling on the fraction of ok warn verdicts
    # the scatter-gather merge flagged partial=true (missing range
    # coverage). Reads result.notes["partial"] — the caller's post fn
    # counts partials there; no notes at all leaves the gate vacuous.
    max_partial_rate: Optional[float] = None
    # Elastic-fleet arm: ceiling on executed scale-direction reversals
    # (a 2→4→2 flash-crowd cycle is exactly one flap). Reads
    # result.notes["scale_flaps"]; vacuous when no autoscaler ran.
    max_scale_flaps: Optional[int] = None
    # Tenant-isolation arm (noisy-neighbor drill). flood_app names the
    # flooder tenant; victims = records with a non-empty app tag that
    # isn't the flooder. All four gates are vacuous without app-tagged
    # records and a flood_app.
    flood_app: str = ""
    max_victim_shed_rate: Optional[float] = None
    victim_p95_x_baseline: Optional[float] = None
    max_tenant_starvation_s: Optional[float] = None
    min_flood_shed_share: Optional[float] = None


@dataclass
class Gate:
    gate: str
    ok: bool
    observed: object
    bound: object
    # Trace ids of the dispatches that broke the gate (slowest / hung /
    # shed offenders) — a failing gate is one `cli trace <id>` away from
    # its cross-process cause. Populated only on failure, only when the
    # replay tagged records with trace ids.
    exemplars: Optional[List[str]] = None

    def to_dict(self) -> dict:
        d = {"gate": self.gate, "ok": self.ok,
             "observed": self.observed, "bound": self.bound}
        if self.exemplars:
            d["exemplars"] = list(self.exemplars)
        return d


@dataclass
class SLOReport:
    slo: str
    ok: bool
    gates: List[Gate]

    def to_dict(self) -> dict:
        return {"slo": self.slo, "ok": self.ok,
                "gates": [g.to_dict() for g in self.gates]}

    def failures(self) -> List[Gate]:
        return [g for g in self.gates if not g.ok]

    def summary(self) -> str:
        if self.ok:
            return f"SLO {self.slo}: all {len(self.gates)} gates pass"
        bad = ", ".join(
            f"{g.gate} (observed {g.observed!r}, bound {g.bound!r})"
            for g in self.failures()
        )
        return f"SLO {self.slo}: FAILED — {bad}"


def _exemplar_traces(records, status=None, klass=None, n=3) -> List[str]:
    """Worst-offender trace ids for a failing gate: matching records,
    slowest first. Records without a trace tag (sampling off) drop out —
    exemplars are best-effort, never a gate input."""
    cand = [r for r in records if r.get("trace")
            and (status is None or r.get("status") == status)
            and (klass is None or r.get("klass") == klass)]
    cand.sort(key=lambda r: r.get("latency_ms", 0.0), reverse=True)
    return [r["trace"] for r in cand[:n]]


def _tenant_gates(slo: SLO, result, add) -> None:
    """The noisy-neighbor isolation gates. Victims are app-tagged records
    that aren't the flooder's; every gate passes vacuously when the replay
    carried no tenant accounting (untagged captures, flood_app unset)."""
    wants = (slo.max_victim_shed_rate is not None
             or slo.victim_p95_x_baseline is not None
             or slo.max_tenant_starvation_s is not None
             or slo.min_flood_shed_share is not None)
    if not wants:
        return
    records = getattr(result, "records", None) or []
    tagged = [r for r in records if r.get("app")]
    if not slo.flood_app or not tagged:
        reason = "no tenant accounting"
        if slo.max_victim_shed_rate is not None:
            add("max_victim_shed_rate", True, reason, slo.max_victim_shed_rate)
        if slo.victim_p95_x_baseline is not None:
            add("victim_p95_x_baseline", True, reason, slo.victim_p95_x_baseline)
        if slo.max_tenant_starvation_s is not None:
            add("max_tenant_starvation_s", True, reason,
                slo.max_tenant_starvation_s)
        if slo.min_flood_shed_share is not None:
            add("min_flood_shed_share", True, reason, slo.min_flood_shed_share)
        return
    victims = [r for r in tagged if r["app"] != slo.flood_app]

    if slo.max_victim_shed_rate is not None:
        shed = sum(1 for r in victims if r["status"] == "shed")
        rate = round(shed / len(victims), 4) if victims else 0.0
        add("max_victim_shed_rate", rate <= slo.max_victim_shed_rate,
            rate, slo.max_victim_shed_rate)

    if slo.victim_p95_x_baseline is not None:
        base = [r["latency_ms"] for r in victims
                if r["status"] == "ok" and r.get("phase") == "baseline"]
        flood = [r["latency_ms"] for r in victims
                 if r["status"] == "ok" and r.get("phase") == "flood"]
        if base and flood:
            ratio = round(percentile(flood, 95)
                          / max(percentile(base, 95), 1e-9), 3)
            add("victim_p95_x_baseline", ratio <= slo.victim_p95_x_baseline,
                ratio, slo.victim_p95_x_baseline)
        else:
            add("victim_p95_x_baseline", True, "no baseline/flood phases",
                slo.victim_p95_x_baseline)

    if slo.max_tenant_starvation_s is not None:
        # Longest per-victim stretch of consecutive non-ok dispatches,
        # measured in scheduled time ("t"): how long one tenant went
        # without a single success. The observed counterpart of the
        # KAKVEDA_TENANT_PROMOTE_ROUNDS starvation bound.
        worst = 0.0
        by_app: Dict[str, List[dict]] = {}
        for r in victims:
            by_app.setdefault(r["app"], []).append(r)
        for rows in by_app.values():
            rows.sort(key=lambda r: r.get("t", 0.0))
            run_start = None
            for r in rows:
                if r["status"] == "ok":
                    run_start = None
                    continue
                t = float(r.get("t", 0.0))
                if run_start is None:
                    run_start = t
                worst = max(worst, t - run_start)
        add("max_tenant_starvation_s", worst <= slo.max_tenant_starvation_s,
            round(worst, 3), slo.max_tenant_starvation_s)

    if slo.min_flood_shed_share is not None:
        sheds = [r for r in tagged if r["status"] == "shed"]
        if sheds:
            share = round(sum(1 for r in sheds
                              if r["app"] == slo.flood_app) / len(sheds), 4)
            add("min_flood_shed_share", share >= slo.min_flood_shed_share,
                share, slo.min_flood_shed_share)
        else:
            # Nothing shed at all: isolation is trivially intact.
            add("min_flood_shed_share", True, "no sheds",
                slo.min_flood_shed_share)


def evaluate(slo: SLO, result) -> SLOReport:
    """Check a finished ReplayResult against an SLO. Pure function of the
    result snapshot — safe to re-run, never mutates the replay state."""
    gates: List[Gate] = []

    def add(name, ok, observed, bound):
        gates.append(Gate(name, bool(ok), observed, bound))

    warn_all = result.latencies_ms("warn")
    if slo.warn_p50_ms is not None:
        p50 = round(percentile(warn_all, 50), 3)
        add("warn_p50_ms", p50 <= slo.warn_p50_ms, p50, slo.warn_p50_ms)
    if slo.warn_p95_ms is not None:
        p95 = round(percentile(warn_all, 95), 3)
        add("warn_p95_ms", p95 <= slo.warn_p95_ms, p95, slo.warn_p95_ms)

    if slo.warn_p95_x_baseline is not None:
        base = result.latencies_ms("warn", phase="baseline")
        rest = [x for ph in ("storm", "recovery")
                for x in result.latencies_ms("warn", phase=ph)]
        if base and rest:
            bp = percentile(base, 95)
            rp = percentile(rest, 95)
            ratio = round(rp / max(bp, 1e-9), 3)
            add("warn_p95_x_baseline", ratio <= slo.warn_p95_x_baseline,
                ratio, slo.warn_p95_x_baseline)
        else:
            # No phased traffic to compare — the gate is vacuous, not
            # failed (capture replays have a single "capture" phase).
            add("warn_p95_x_baseline", True,
                "no baseline/storm phases", slo.warn_p95_x_baseline)

    if slo.ttft_p95_ms is not None:
        ttft = result.ttft_ms()
        p95 = round(percentile(ttft, 95), 3)
        add("ttft_p95_ms", (not ttft) or p95 <= slo.ttft_p95_ms,
            p95, slo.ttft_p95_ms)

    counts = result.class_counts()
    for klass, ceil in sorted(slo.max_shed_rate.items()):
        c = counts.get(klass, {})
        total = sum(c.values())
        rate = round(c.get("shed", 0) / total, 4) if total else 0.0
        add(f"max_shed_rate[{klass}]", rate <= ceil, rate, ceil)

    if slo.shed_only:
        offenders = {k: c.get("shed", 0) for k, c in counts.items()
                     if c.get("shed", 0) and k not in slo.shed_only}
        add("shed_only", not offenders, offenders or "none",
            list(slo.shed_only))

    if slo.zero_hung:
        hung = sum(c.get("hung", 0) for c in counts.values())
        add("zero_hung", hung == 0, hung, 0)

    for klass in slo.zero_lost:
        c = counts.get(klass, {})
        lost = result.generated(klass) - sum(c.values())
        add(f"zero_lost[{klass}]", lost <= 0, lost, 0)

    if slo.max_partial_rate is not None:
        notes = getattr(result, "notes", {}) or {}
        if "partial" in notes:
            ok_warns = counts.get("warn", {}).get("ok", 0)
            rate = (round(float(notes["partial"]) / ok_warns, 4)
                    if ok_warns else 0.0)
            add("max_partial_rate", rate <= slo.max_partial_rate,
                rate, slo.max_partial_rate)
        else:
            add("max_partial_rate", True, "no partial accounting",
                slo.max_partial_rate)

    if slo.max_scale_flaps is not None:
        notes = getattr(result, "notes", {}) or {}
        if "scale_flaps" in notes:
            flaps = int(notes["scale_flaps"])
            add("max_scale_flaps", flaps <= slo.max_scale_flaps,
                flaps, slo.max_scale_flaps)
        else:
            add("max_scale_flaps", True, "no autoscaler accounting",
                slo.max_scale_flaps)

    _tenant_gates(slo, result, add)

    if slo.recovery_s is not None:
        rec = result.ladder_recovery_s
        if rec is None:
            add("recovery_s", False, "never recovered", slo.recovery_s)
        else:
            add("recovery_s", rec <= slo.recovery_s,
                round(rec, 3), slo.recovery_s)

    records = getattr(result, "records", None) or []
    for g in gates:
        if g.ok or not records:
            continue
        if g.gate.startswith(("warn_p", "ttft_")):
            g.exemplars = _exemplar_traces(records, status="ok") or None
        elif g.gate == "zero_hung":
            g.exemplars = _exemplar_traces(records, status="hung") or None
        elif g.gate.startswith("max_shed_rate["):
            klass = g.gate[len("max_shed_rate["):-1]
            g.exemplars = _exemplar_traces(
                records, status="shed", klass=klass) or None
        elif g.gate in ("shed_only", "max_victim_shed_rate",
                        "min_flood_shed_share"):
            g.exemplars = _exemplar_traces(records, status="shed") or None

    return SLOReport(slo=slo.name, ok=all(g.ok for g in gates), gates=gates)
