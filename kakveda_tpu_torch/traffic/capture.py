"""Traffic capture: flight-recorder request timelines → replayable JSONL.

The service app's middleware-adjacent handlers record every warn/ingest
arrival into a bounded ``FlightRecorder("traffic")`` ring (service/app.py;
``KAKVEDA_TRAFFIC_CAPTURE=0`` disables, ``KAKVEDA_TRAFFIC_CAPTURE_N``
sizes the ring). ``cli traffic record`` pulls ``GET
/flightrecorder`` from a live server and this module converts that dump
into a traffic log the replayer can re-drive:

    {"kakveda_traffic_log": 1, "meta": {…}}          ← header line
    {"t": 0.0,  "method": "POST", "path": "/warn", "klass": "warn",
     "app_id": "app-3", "body": {…}, "phase": "capture"}
    {"t": 0.42, …}

Offsets are relative to the first captured event — a traffic log carries
the SHAPE of traffic (arrival schedule, class mix, app-key sequence,
payload skeletons), which is what the robustness layers react to. Ingest
bodies are re-synthesized deterministically at conversion time (the ring
records counts and keys, not multi-KB trace batches).

Reading is skip-with-warning per line (the bus subscription-replay
contract): a torn or hand-edited log replays what it
can instead of refusing the whole run.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

log = logging.getLogger("kakveda.traffic")

TRAFFIC_LOG_VERSION = 1


def write_log(path: str | Path, events: Iterable[dict],
              meta: Optional[dict] = None) -> int:
    """Write a traffic log (header + one event per line, offset-sorted).
    Returns the number of events written."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    evs = sorted(events, key=lambda e: float(e.get("t", 0.0)))
    tmp = path.with_suffix(path.suffix + ".tmp")
    with tmp.open("w", encoding="utf-8") as f:
        f.write(json.dumps(
            {"kakveda_traffic_log": TRAFFIC_LOG_VERSION, "meta": meta or {}},
            ensure_ascii=False,
        ) + "\n")
        for e in evs:
            f.write(json.dumps(e, ensure_ascii=False) + "\n")
    tmp.replace(path)
    return len(evs)


def read_log(path: str | Path) -> Tuple[dict, List[dict]]:
    """Read a traffic log → ``(meta, events)``. Malformed lines are
    skipped with a warning; a missing header is tolerated (every line is
    then an event)."""
    meta: dict = {}
    events: List[dict] = []
    with Path(path).open("r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                log.warning("traffic log %s:%d unparseable, skipped: %s",
                            path, lineno, e)
                continue
            if not isinstance(rec, dict):
                log.warning("traffic log %s:%d not an object, skipped", path, lineno)
                continue
            if "kakveda_traffic_log" in rec:
                meta = dict(rec.get("meta") or {})
                meta["version"] = rec["kakveda_traffic_log"]
                continue
            if "t" not in rec:
                log.warning("traffic log %s:%d has no offset, skipped", path, lineno)
                continue
            events.append(rec)
    events.sort(key=lambda e: float(e.get("t", 0.0)))
    return meta, events


def from_flightrecorder(payload: dict, *, seed: int = 0,
                        recorder: str = "traffic") -> List[dict]:
    """Convert a ``GET /flightrecorder`` dump into replayable events.

    Only the named recorder's ring is read (default the service tier's
    ``traffic`` ring). ``warn`` records replay byte-faithfully (app_id +
    prompt were captured); ``ingest`` records replay shape-faithfully —
    the batch is re-synthesized with the captured size and app key, seeded
    so the same dump always converts to the same log."""
    from kakveda_tpu_torch.traffic.scenarios import synth_traces

    # A real server has exactly one ring per name, but several service
    # apps can share one process (in-process fleet drills, tests) and
    # dump_recorders() reports every LIVE ring — pick the most recently
    # active one (events carry epoch t), never first-match: a stale
    # empty ring from a torn-down app must not shadow the live capture.
    ring: list = []
    ring_t = float("-inf")
    for rec in payload.get("recorders", []):
        if rec.get("name") != recorder:
            continue
        events = rec.get("events", [])
        t = max((float(e.get("t", 0.0)) for e in events), default=float("-inf"))
        if t > ring_t:
            ring, ring_t = events, t
    evs: List[dict] = []
    if not ring:
        return evs
    t0 = min(float(e.get("t", 0.0)) for e in ring)
    for i, e in enumerate(sorted(ring, key=lambda r: float(r.get("t", 0.0)))):
        kind = e.get("kind")
        t = round(float(e.get("t", t0)) - t0, 6)
        if kind == "warn":
            app = str(e.get("app_id", "app-0"))
            evs.append({
                "t": t, "method": "POST", "path": "/warn", "klass": "warn",
                "app_id": app, "phase": "capture",
                "body": {"app_id": app, "prompt": str(e.get("prompt", ""))},
            })
        elif kind == "ingest":
            app = str(e.get("app_id", "app-0"))
            n = max(1, int(e.get("n", 1)))
            evs.append({
                "t": t, "method": "POST", "path": "/ingest/batch",
                "klass": "ingest", "app_id": app, "phase": "capture",
                "body": {"traces": synth_traces(seed + i, app, n)},
            })
    return evs
