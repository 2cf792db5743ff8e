"""Gossiped control state — fleet-wide brownout from per-replica inputs.

Port of ``kakveda_tpu/fleet/gossip.py``, the same samples, folds and
freshness rules.

Each replica publishes one control sample per tick on the bus topic
``fleet.control`` (delivered to every peer's ``POST /fleet/gossip``):

    {"replica": "r0", "seq": 17, "ts": …, "occupancy": 0.42,
     "brownout": "normal", "brownout_step": 0, "degraded": false}

and folds the samples it receives into a :class:`FleetView`. The folded
view feeds the replica's OWN admission controller through
:meth:`AdmissionController.note_fleet_pressure` — a pressure *input*, so
the brownout ladder degrades fleet-wide (one saturated replica steps
every replica down) while every actual transition still goes through the
single-writer ``_set_brownout_state`` helper. The gossip path never
touches gate state directly, and a replica's DEGRADED latch stays local
(peer device loss is reported in the view, not latched here).

Freshness discipline (what makes DLQ replay and at-least-once redelivery
safe for this topic even though it is marked ephemeral): a sample is
folded only when its ``seq`` advances the sender's last-seen sequence AND
its ``ts`` is within the view TTL — replayed or reordered samples are
counted and dropped. Samples older than the TTL expire out of the view,
so a dead peer stops contributing pressure ~one TTL after it dies.

Knobs: ``KAKVEDA_FLEET_GOSSIP_S`` publish interval,
``KAKVEDA_FLEET_GOSSIP_TTL_S`` view/pressure TTL.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Dict, Optional

from kakveda_tpu_torch.core import metrics as _metrics
from kakveda_tpu_torch.core import sanitize
from kakveda_tpu_torch.events.bus import TOPIC_FLEET_CONTROL, EventBus

log = logging.getLogger("kakveda.fleet")


class FleetView:
    """Peer control samples, folded with seq/TTL freshness discipline.

    Thread-safe: folds arrive on the event loop, readers include the
    gossip tick and /readyz."""

    def __init__(self, ttl_s: float = 5.0):
        self.ttl_s = float(ttl_s)
        self._lock = sanitize.named_lock("FleetView._lock")
        # replica id -> (sample dict, folded-at monotonic ts)
        self._samples: Dict[str, tuple] = {}
        reg = _metrics.get_registry()
        self._m_gossip = reg.counter(
            "kakveda_fleet_gossip_total",
            "Gossip samples by result (sent|folded|stale)", ("result",),
        )
        self._m_sent = self._m_gossip.labels(result="sent")
        self._m_folded = self._m_gossip.labels(result="folded")
        self._m_stale = self._m_gossip.labels(result="stale")

    def note_sent(self) -> None:
        self._m_sent.inc()

    def fold(self, sample: dict) -> bool:
        """Fold one received sample; returns False (and counts ``stale``)
        for replays, reordering, or samples past the TTL."""
        replica = sample.get("replica")
        seq = sample.get("seq")
        ts = sample.get("ts")
        if not isinstance(replica, str) or not isinstance(seq, (int, float)):
            self._m_stale.inc()
            return False
        if isinstance(ts, (int, float)) and time.time() - ts > self.ttl_s:
            self._m_stale.inc()  # DLQ replay / long-delayed redelivery
            return False
        with self._lock:
            prev = self._samples.get(replica)
            if prev is not None and prev[0].get("seq", -1) >= seq:
                self._m_stale.inc()
                return False
            self._samples[replica] = (dict(sample), time.monotonic())
        self._m_folded.inc()
        return True

    def _live_locked(self) -> Dict[str, dict]:
        now = time.monotonic()
        return {
            r: s for r, (s, at) in self._samples.items() if now - at <= self.ttl_s
        }

    def peers(self) -> Dict[str, dict]:
        """Live (unexpired) samples with their age — the /readyz view."""
        with self._lock:
            now = time.monotonic()
            return {
                r: {**s, "age_s": round(now - at, 2)}
                for r, (s, at) in self._samples.items()
                if now - at <= self.ttl_s
            }

    # The router folds its probe/ejection liveness into the same view:
    # one synthetic sample per broadcast under this sender id, carrying
    # {"probe_verdicts": {rid: bool}}. One liveness world-view — the
    # pressure floor and the router's ejection decisions stop disagreeing.
    ROUTER_SENDER = "__router__"

    def probe_verdicts(self) -> Dict[str, bool]:
        """The router's latest per-replica liveness verdicts, {} when no
        fresh router sample has arrived (standalone replicas, old routers)."""
        with self._lock:
            live = self._live_locked()
        s = live.get(self.ROUTER_SENDER)
        v = s.get("probe_verdicts") if isinstance(s, dict) else None
        return {str(k): bool(b) for k, b in v.items()} if isinstance(v, dict) else {}

    def fleet_pressure(self) -> float:
        """Max peer occupancy among live samples — the ladder input the
        local admission controller folds in (note_fleet_pressure).

        Peers the router's probe verdict marks dead are skipped: a peer
        that died seconds after gossiping 0.9 occupancy would otherwise
        pin every survivor's brownout floor for a full TTL while the
        router already routes around it. No verdict (no router, or none
        yet) keeps the pure-TTL behavior."""
        verdicts = self.probe_verdicts()
        with self._lock:
            live = self._live_locked()
        return max(
            (
                float(s.get("occupancy", 0.0))
                for r, s in live.items()
                if r != self.ROUTER_SENDER and verdicts.get(r, True)
            ),
            default=0.0,
        )

    def occupancies(self) -> Dict[str, float]:
        """Per-replica occupancy from live samples (router sender
        excluded) — the autoscaler's least-loaded victim selection."""
        with self._lock:
            live = self._live_locked()
        return {
            r: float(s.get("occupancy", 0.0))
            for r, s in live.items()
            if r != self.ROUTER_SENDER
        }

    def any_degraded(self) -> bool:
        with self._lock:
            live = self._live_locked()
        return any(bool(s.get("degraded")) for s in live.values())

    def worst_brownout(self) -> Dict[str, object]:
        """The most-degraded live peer's ladder position (fleet mode for
        /readyz)."""
        with self._lock:
            live = self._live_locked()
        worst = {"state": "normal", "step": 0}
        for s in live.values():
            step = int(s.get("brownout_step", 0) or 0)
            if step > int(worst["step"]):
                worst = {"state": str(s.get("brownout", "?")), "step": step}
        return worst


def sample_from_ready(rid: str, seq: int, ready: dict) -> dict:
    """Synthesize a gossip-shaped control sample from a /readyz body.

    The router folds one per successful probe into its OWN FleetView, so
    the autoscaler consumes the same (occupancy, brownout rung, DEGRADED)
    vocabulary — with the same seq/TTL freshness discipline — whether the
    signal travelled by bus gossip or by probe. The replica's exported
    ``admission.occupancy`` is its LOCAL load only (local_pressure) —
    never the folded fleet floor, which would echo pressure rumors back
    into the view."""
    adm = ready.get("admission") or {}
    occ = adm.get("occupancy")
    if not isinstance(occ, (int, float)):
        # Older replicas without the export: approximate the LOCAL load
        # from per-class in-flight counts (never the gossiped floor —
        # folding it back in re-creates the echo the export avoids).
        classes = adm.get("classes") or {}
        loads = [
            c.get("inflight", 0) / c["limit"]
            for c in classes.values()
            if isinstance(c, dict) and c.get("limit")
        ]
        occ = max(loads, default=0.0)
    dev = ready.get("device") or {}
    out = {
        "replica": rid,
        "seq": int(seq),
        "ts": time.time(),
        "occupancy": round(float(occ), 4),
        "brownout": adm.get("brownout", "normal"),
        "brownout_step": int(adm.get("brownout_step", 0) or 0),
        "degraded": bool(dev.get("degraded")),
    }
    own = ready.get("ownership") or {}
    if isinstance(own.get("epoch"), int):
        out["ownership_epoch"] = own["epoch"]
    return out


class GossipPublisher:
    """The per-replica gossip tick: sample own admission/health state,
    publish on ``fleet.control``, and re-feed the folded fleet pressure
    into the local controller (so the ladder also re-evaluates — and can
    step back down — while the replica is idle)."""

    def __init__(
        self,
        bus: EventBus,
        admission,
        health,
        replica_id: str,
        view: FleetView,
        interval_s: float = 1.0,
        ownership=None,
    ):
        self.bus = bus
        self.admission = admission
        self.health = health
        self.replica_id = replica_id
        self.view = view
        self.interval_s = max(0.05, float(interval_s))
        # fleet.ownership.OwnershipState when KAKVEDA_FLEET_OWNERSHIP=1:
        # samples then carry the replica's acknowledged ownership epoch,
        # so peers detect stale ring views fleet-wide.
        self.ownership = ownership
        self._seq = 0
        self._m_pressure = _metrics.get_registry().gauge(
            "kakveda_fleet_pressure",
            "Folded fleet pressure input (max live peer occupancy) fed to "
            "the local admission controller",
        )

    def sample(self) -> dict:
        self._seq += 1
        brown = self.admission.brownout
        out = {
            "replica": self.replica_id,
            "seq": self._seq,
            "ts": time.time(),
            # LOCAL load only: publishing the combined pressure() would
            # echo a peer's gossiped floor back out as our own occupancy
            # and two replicas then refresh each other's floor forever —
            # the floor is an input (tick_inputs), never an output.
            "occupancy": round(self.admission.local_pressure(), 4),
            "brownout": brown.state,
            "brownout_step": brown.step,
            "degraded": bool(self.health.degraded),
        }
        if self.ownership is not None:
            out["ownership_epoch"] = self.ownership.view.epoch
        return out

    def tick_inputs(self) -> None:
        """Fold the current fleet view into the local controller — the
        ONLY admission-facing effect of the gossip path (an input; gate
        state moves solely through the controller's own helpers)."""
        p = self.view.fleet_pressure()
        self._m_pressure.set(p)
        self.admission.note_fleet_pressure(p, ttl_s=self.view.ttl_s)

    async def run(self) -> None:
        while True:
            try:
                await self.bus.publish(TOPIC_FLEET_CONTROL, self.sample())
                self.view.note_sent()
                self.tick_inputs()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — gossip must never kill the app
                log.warning("gossip tick failed: %s: %s", type(e).__name__, e)
            await asyncio.sleep(self.interval_s)
