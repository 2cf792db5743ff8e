"""Sharded ownership over the fleet hash ring — ranges, epochs, migration.

Port of ``kakveda_tpu/fleet/ownership.py``. The migration's export, ship
and flip are blocking JSON POSTs through the standard library
(``core/httpjson.py``) where the reference uses ``httpx``.

With ``KAKVEDA_FLEET_OWNERSHIP=1`` the blake2b ring stops being a pure
routing hint and becomes the fleet's data-placement authority: every key
(the ingest ``app_id``) has exactly R **holders** — the ring-preference
walk ``[owner, standby_1, …, standby_{R-1}]`` (``KAKVEDA_FLEET_REPLICATION``,
default 2) — and

* ingest replication is **range-scoped**: an origin publishes accepted rows
  only to the holders of each row's key, on per-peer bus topics
  (:func:`kakveda_tpu_torch.events.bus.replicate_topic`), keeping the existing
  at-least-once retry → breaker → DLQ machinery and the idempotent
  event-id apply;
* warn becomes a router-side **scatter-gather top-k merge** across live
  shards (fleet/router.py) with a typed partial-result contract;
* the **ownership epoch** (one fleet-wide int, the router is the single
  writer) fences stale ring views: every scoped replicate event carries the
  publisher's epoch, and a receiver that is no longer a holder of the
  rows' keys drops an OLDER-epoch event cleanly instead of resurrecting a
  migrated range (service/app.py ``/replicate``).

``KAKVEDA_FLEET_OWNERSHIP=0`` (the default) leaves the full-replication
fleet bit-for-bit untouched — this module is then never consulted.

Range migration (scale-out/in) is :func:`run_rebalance`: for a membership
change ``old → new`` it (1) snapshot-ships, from each responsible source,
the rows whose NEW holder set gained a member (deterministic event ids, so
re-runs and DLQ replay stay idempotent), (2) flips ownership atomically
per replica by pushing the new epoch'd view to every member and the
router, then (3) drains the delta — rows appended at the sources since the
export mark. Movement is bounded: only rows whose holder set changed ship.
An armed ``fleet.range_migrate`` fault aborts a ship batch cleanly BEFORE
the flip (ownership unchanged, no lost rows); a drain failure after the
flip is healed by re-running the rebalance (same ids → dedup) or DLQ
replay. Sources keep rows they no longer hold (copy-based migration; the
GFKB log is append-only) — residency bounds are enforced by ingest-time
scoping, and foreign rows age out on re-seed.

"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from kakveda_tpu_torch.core import faults as _faults
from kakveda_tpu_torch.core import httpjson
from kakveda_tpu_torch.fleet.hashring import HashRing

log = logging.getLogger("kakveda.fleet")

# Chaos site: armed, a migration ship batch fails —
# the rebalance aborts cleanly before the ownership flip (pre-flip) or
# leaves a re-runnable drain gap (post-flip); never a lost or
# double-counted row.
_FAULT_MIGRATE = _faults.site("fleet.range_migrate")


class MigrationError(RuntimeError):
    """A range migration failed mid-protocol. ``flipped`` says whether the
    ownership flip already happened: False → nothing changed, safe to
    retry from scratch; True → re-run the same rebalance (deterministic
    event ids dedup the re-ship) to close the drain gap."""

    def __init__(self, message: str, *, flipped: bool):
        super().__init__(message)
        self.flipped = flipped


def parse_members(spec: str) -> Dict[str, str]:
    """``"r0=http://h:p,r1=http://h:q"`` → ``{rid: url}`` (the
    ``KAKVEDA_FLEET_MEMBERS`` env format written by the supervisor)."""
    out: Dict[str, str] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        rid, url = part.split("=", 1)
        if rid.strip() and url.strip():
            out[rid.strip()] = url.strip().rstrip("/")
    return out


def shard_key_of_row(row: dict) -> str:
    """The ownership key of one replication/ingest row dict — the app that
    produced it, falling back to the signature for app-less rows. Must
    agree with :meth:`GFKB.shard_key_counts` so residency accounting and
    placement see the same key."""
    k = row.get("app_id")
    if isinstance(k, str) and k:
        return k
    sig = row.get("signature_text")
    return sig if isinstance(sig, str) else ""


class OwnershipView:
    """One immutable (members, replication, epoch) placement snapshot.

    Holders of a key are the ring-preference walk limited to R — element 0
    is the owner, the rest the warm standbys. "Ranges" are the ring's
    vnode arcs: coverage accounting (partial-result contract, the
    coverage-hole check) enumerates every arc's holder tuple rather than
    sampling keys, so a range with zero live holders is detected exactly.
    """

    def __init__(
        self,
        members: Dict[str, str],
        *,
        replication: int = 2,
        epoch: int = 1,
        vnodes: int = 64,
    ):
        if not members:
            raise ValueError("ownership view needs at least one member")
        self.members: Dict[str, str] = {
            rid: url.rstrip("/") for rid, url in sorted(members.items())
        }
        self.replication = max(1, min(int(replication), len(self.members)))
        self.epoch = int(epoch)
        self.vnodes = int(vnodes)
        self.ring = HashRing(list(self.members), vnodes=self.vnodes)
        # Every arc's distinct-holder walk, computed once: 64·N tuples.
        self._arcs: List[Tuple[str, ...]] = self.ring.arc_preferences(
            limit=self.replication
        )

    # -- placement -------------------------------------------------------

    def holders(self, key: str) -> List[str]:
        """``[owner, standby_1, …]`` for ``key`` — R distinct members."""
        return self.ring.preference(key, limit=self.replication)

    def owner(self, key: str) -> str:
        return self.holders(key)[0]

    def is_holder(self, rid: str, key: str) -> bool:
        return rid in self.holders(key)

    def role(self, rid: str, key: str) -> Optional[str]:
        h = self.holders(key)
        if not h or rid not in h:
            return None
        return "owner" if h[0] == rid else "standby"

    # -- range (arc) accounting -----------------------------------------

    def arcs(self) -> List[Tuple[str, ...]]:
        """Per-vnode-arc holder tuples (element 0 owns the arc)."""
        return list(self._arcs)

    def arc_counts(self, rid: str) -> Tuple[int, int]:
        """(owned arcs, standby arcs) for one member."""
        owned = sum(1 for a in self._arcs if a and a[0] == rid)
        standby = sum(1 for a in self._arcs if rid in a[1:])
        return owned, standby

    def coverage_holes(self, live: Iterable[str]) -> int:
        """Arcs whose ENTIRE holder set is outside ``live`` — key ranges
        no reachable replica can answer for. Zero in a healthy fleet; any
        positive count is an error and flips ``partial=true`` on a
        scatter-gather verdict."""
        alive = set(live)
        return sum(1 for a in self._arcs if not (set(a) & alive))

    # -- (de)serialization ----------------------------------------------

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "replication": self.replication,
            "vnodes": self.vnodes,
            "members": dict(self.members),
        }

    @classmethod
    def from_dict(cls, obj: dict) -> "OwnershipView":
        return cls(
            dict(obj["members"]),
            replication=int(obj.get("replication", 2)),
            epoch=int(obj.get("epoch", 1)),
            vnodes=int(obj.get("vnodes", 64)),
        )

    def with_members(
        self, members: Dict[str, str], *, epoch: Optional[int] = None
    ) -> "OwnershipView":
        return OwnershipView(
            members,
            replication=self.replication,
            epoch=self.epoch + 1 if epoch is None else epoch,
            vnodes=self.vnodes,
        )

    def with_epoch(self, epoch: int) -> "OwnershipView":
        return OwnershipView(
            self.members,
            replication=self.replication,
            epoch=epoch,
            vnodes=self.vnodes,
        )

    def save(self, path: Path) -> None:
        """Atomic persist — a replica restarted mid-topology-change must
        come back with the epoch it had acknowledged, not its spawn env."""
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.to_dict(), indent=2))
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: Path) -> Optional["OwnershipView"]:
        try:
            return cls.from_dict(json.loads(path.read_text()))
        except (OSError, ValueError, KeyError):
            return None


class OwnershipState:
    """The mutable per-process handle over the immutable view — platform
    publish, the /replicate fence and gossip all read ``state.view``, and
    the /fleet/ownership push swaps it atomically (one reference write)."""

    def __init__(self, view: OwnershipView, self_id: str):
        self.view = view
        self.self_id = self_id


def responsible_source(
    key: str, old: OwnershipView, sources: Sequence[str]
) -> Optional[str]:
    """Exactly ONE source ships each key during a rebalance: the first
    member of the OLD holder walk that is actually exportable (``sources``
    — scale-in removes dead members, which cannot export). R-way
    replication means any surviving holder has the rows."""
    for rid in old.holders(key):
        if rid in sources:
            return rid
    return None


def plan_targets(
    key: str, old: OwnershipView, new: OwnershipView
) -> List[str]:
    """Members that GAIN ``key`` under the new view — the bounded movement
    set (holders whose membership did not change never receive a copy)."""
    before = set(old.holders(key))
    return [rid for rid in new.holders(key) if rid not in before]


def run_rebalance(
    old: OwnershipView,
    new: OwnershipView,
    *,
    timeout_s: float = 30.0,
    batch: int = 256,
) -> dict:
    """Drive one membership change ``old → new`` over live replicas.

    Synchronous by design (runs in an executor from the router's
    /fleet/rebalance, or inline from drills and tests): export → ship →
    flip → drain, with deterministic event ids throughout so any retry —
    including a full re-run after a post-flip failure — applies
    idempotently. Returns movement stats; raises :class:`MigrationError`
    with ``flipped`` telling the caller whether ownership changed."""
    if new.epoch <= old.epoch:
        raise ValueError(
            f"new view epoch {new.epoch} must exceed old epoch {old.epoch}"
        )
    t0 = time.monotonic()
    moved = 0
    batches = 0
    sources = sorted(rid for rid in old.members if rid in new.members)
    if not sources:
        raise MigrationError(
            "no surviving member can export (old ∩ new is empty)", flipped=False
        )
    flipped = False

    def _ship(src: str, grouped: Dict[str, List[dict]], tag: str) -> None:
        nonlocal moved, batches
        for tgt in sorted(grouped):
            rows = grouped[tgt]
            url = new.members[tgt] + "/replicate"
            for bi in range(0, len(rows), batch):
                chunk = rows[bi : bi + batch]
                event_id = f"mig-{new.epoch}-{src}-{tgt}-{tag}-{bi // batch}"
                _FAULT_MIGRATE.fire()
                httpjson.post_json(
                    url,
                    {
                        "id": event_id,
                        "origin": src,
                        "ts": time.time(),
                        "epoch": new.epoch,
                        "migration": True,
                        "rows": chunk,
                    },
                    timeout=timeout_s,
                )
                moved += len(chunk)
                batches += 1

    def _export(src: str, since: int) -> Tuple[Dict[str, List[dict]], int]:
        body = httpjson.post_json(
            old.members[src] + "/fleet/export",
            {
                "old": old.to_dict(),
                "new": new.to_dict(),
                "sources": sources,
                "since": since,
            },
            timeout=timeout_s,
        ) or {}
        grouped = {
            str(t): list(rows)
            for t, rows in (body.get("rows") or {}).items()
            if rows
        }
        return grouped, int(body.get("count", 0))

    try:
        # 1) snapshot-ship each responsible source's gained ranges.
        marks: Dict[str, int] = {}
        for src in sources:
            grouped, marks[src] = _export(src, 0)
            _ship(src, grouped, "snap")
        # 2) atomic flip: push the epoch'd view to every member (old AND
        # new — a scale-in survivor must learn it lost ranges).
        urls = {**old.members, **new.members}
        for rid in sorted(urls):
            httpjson.post_json(urls[rid] + "/fleet/ownership", new.to_dict(), timeout=timeout_s)
        flipped = True
        # 3) drain the delta log: rows appended since the export mark.
        for src in sources:
            grouped, _ = _export(src, marks[src])
            _ship(src, grouped, "drain")
    except (OSError, ValueError, _faults.FaultInjected) as e:
        raise MigrationError(
            f"rebalance {old.epoch}->{new.epoch} failed "
            f"({'post' if flipped else 'pre'}-flip): {type(e).__name__}: {e}",
            flipped=flipped,
        ) from e
    return {
        "epoch": new.epoch,
        "rows_moved": moved,
        "batches": batches,
        "sources": sources,
        "wall_s": round(time.monotonic() - t0, 3),
    }
