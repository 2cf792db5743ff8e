"""In-process asyncio event bus with the reference's pub/sub contract.

Port of ``kakveda_tpu/events/bus.py``. Topics fan out to local
subscribers (async or sync callables, each awaited with a delivery
timeout, sync ones in the executor; a failing one is logged and counted
as not delivered, never breaking the fan-out) and to HTTP callback URLs,
which get the reference's JSON POST. URL subscriptions are durable: with
a ``persist_path`` they append to a JSONL log and replay on construction.

Delivery to URL subscribers is **at-least-once**:

* each failed POST retries with exponential backoff and jitter
  (``KAKVEDA_BUS_RETRIES`` attempts, ``KAKVEDA_BUS_RETRY_BASE`` seconds);
  a non-2xx answer is a failed delivery;
* a per-URL **circuit breaker** opens after
  ``KAKVEDA_BUS_BREAKER_THRESHOLD`` consecutive failed events; while open,
  deliveries go straight to the dead-letter queue; after
  ``KAKVEDA_BUS_BREAKER_COOLDOWN`` seconds one half-open probe goes
  through (success closes the breaker, failure reopens it);
* events that exhaust their retries, or short-circuit, append to the
  **dead-letter queue** (``dlq.jsonl`` beside the subscription log) with
  the error and the attempt count; :meth:`EventBus.replay_dlq` and
  :func:`replay_dlq_file` re-deliver them and rewrite the file with what
  still fails; with ``KAKVEDA_DLQ_AUTO_S`` > 0 a breaker that re-closes
  schedules that replay by itself.

Ephemeral topics (:meth:`EventBus.mark_ephemeral`, the fleet's gossip)
keep the breaker but deliver once and never dead-letter. Local
subscribers keep single-attempt semantics. The async deliveries go
through aiohttp (imported at the first URL delivery, so the library half
of the port never loads the HTTP stack), the synchronous replay through
the standard library (``core/httpjson.py``). The ``bus.deliver`` fault
site fails a delivery as a transport error would, and the reference's
``kakveda_bus_*`` families move at its call sites.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import random
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Awaitable, Callable, Collection, Dict, List, Optional, Union

from kakveda_tpu_torch.core import faults as _faults
from kakveda_tpu_torch.core import httpjson
from kakveda_tpu_torch.core import metrics as _metrics
from kakveda_tpu_torch.core import sanitize

log = logging.getLogger("kakveda.events")

TOPIC_TRACE_INGESTED = "trace.ingested"
TOPIC_FAILURE_DETECTED = "failure.detected"
TOPIC_CHILD_SAFETY = "child_safety_alert"
# Fleet topics: ``gfkb.replicate`` is the ingest replication log (rows
# accepted by any replica, applied idempotently by event id on every
# peer); ``fleet.control`` is the gossiped control state, ephemeral by
# convention (each sample is superseded by the next tick).
TOPIC_GFKB_REPLICATE = "gfkb.replicate"
TOPIC_FLEET_CONTROL = "fleet.control"
# Range-scoped replication (KAKVEDA_FLEET_OWNERSHIP=1): one topic per
# peer, carrying only the rows that peer holds, so each destination has
# its own retry / breaker / DLQ lane.
TOPIC_GFKB_REPLICATE_PREFIX = TOPIC_GFKB_REPLICATE + ".to."


def replicate_topic(replica_id: str) -> str:
    """The per-peer range-scoped replication topic for one replica."""
    return TOPIC_GFKB_REPLICATE_PREFIX + replica_id


Handler = Callable[[dict], Union[Awaitable[Any], Any]]


def new_event_id() -> str:
    """Mint a bus event id (hex uuid4). Events applied idempotently under
    at-least-once delivery (``gfkb.replicate``) carry one in ``id``."""
    return uuid.uuid4().hex


class EventBus:
    """Topic → subscriber fan-out. Subscribers are async/sync callables or
    HTTP callback URLs."""

    # Cap on simultaneous in-flight deliveries per publish call: a
    # 512-trace batch with a URL subscriber must not open hundreds of
    # connections in one gather.
    MAX_CONCURRENT_DELIVERIES = 32

    def __init__(
        self,
        delivery_timeout: float = 3.0,
        persist_path: Optional[str | Path] = None,
        dlq_path: Optional[str | Path] = None,
    ):
        self._subs: Dict[str, List[Union[Handler, str]]] = {}
        self.delivery_timeout = delivery_timeout
        self._persist_path = Path(persist_path) if persist_path else None
        # The dead-letter log defaults beside the subscription log; a bus
        # with neither counts drops on the metrics plane only.
        if dlq_path is not None:
            self._dlq_path: Optional[Path] = Path(dlq_path)
        elif self._persist_path is not None:
            self._dlq_path = self._persist_path.parent / "dlq.jsonl"
        else:
            self._dlq_path = None
        self._dlq_lock = sanitize.named_lock("EventBus._dlq_lock")
        self._retries = max(1, int(os.environ.get("KAKVEDA_BUS_RETRIES", "3")))
        self._retry_base = float(os.environ.get("KAKVEDA_BUS_RETRY_BASE", "0.05"))
        self._breaker_threshold = max(1, int(os.environ.get("KAKVEDA_BUS_BREAKER_THRESHOLD", "5")))
        self._breaker_cooldown = float(os.environ.get("KAKVEDA_BUS_BREAKER_COOLDOWN", "30"))
        # DLQ auto-replay (KAKVEDA_DLQ_AUTO_S > 0): a breaker that re-closes
        # (the peer healed) re-delivers the DLQ after that many seconds.
        # Safe because replay is idempotent for subscribers by contract.
        self._dlq_auto_s = float(os.environ.get("KAKVEDA_DLQ_AUTO_S", "0"))
        self._dlq_auto_pending = False  # guarded by _breaker_lock
        self._dlq_auto_timer: Optional[threading.Timer] = None
        self._closed = False
        # url -> {"state": closed|open|half_open, "fails", "opened_at",
        # "probing"}. A threading lock: publish_sync runs private loops, so
        # two loops may touch this from different threads.
        self._breakers: Dict[str, dict] = {}
        self._breaker_lock = sanitize.named_lock("EventBus._breaker_lock")
        self._ephemeral_topics: set = set()
        if self._persist_path is not None:
            self._replay_subscriptions()
        self._fault_deliver = _faults.site("bus.deliver")
        reg = _metrics.get_registry()
        self._m_published = reg.counter(
            "kakveda_bus_events_published_total",
            "Events published on the in-process bus", ("topic",),
        )
        deliveries = reg.counter(
            "kakveda_bus_deliveries_total", "Bus deliveries by result", ("result",),
        )
        self._m_ok = deliveries.labels(result="ok")
        self._m_err = deliveries.labels(result="error")
        attempts = reg.counter(
            "kakveda_bus_delivery_attempts_total",
            "URL delivery attempts by result (ok|retry|failed|short_circuit)",
            ("result",),
        )
        self._m_att_ok = attempts.labels(result="ok")
        self._m_att_retry = attempts.labels(result="retry")
        self._m_att_failed = attempts.labels(result="failed")
        self._m_att_short = attempts.labels(result="short_circuit")
        self._m_breaker_trans = reg.counter(
            "kakveda_bus_breaker_transitions_total",
            "Bus circuit-breaker state transitions", ("to",),
        )
        self._m_breaker_open = reg.gauge(
            "kakveda_bus_breaker_open",
            "URL subscribers whose circuit breaker is currently open",
        )
        self._m_dlq = reg.counter(
            "kakveda_bus_dlq_total",
            "Events dead-lettered after retries were exhausted or the "
            "breaker short-circuited",
        )
        self._m_dlq_auto = reg.counter(
            "kakveda_bus_dlq_auto_total",
            "Automatic DLQ replays triggered by a breaker re-close "
            "(KAKVEDA_DLQ_AUTO_S), by result", ("result",),
        )
        self._m_inflight = reg.gauge(
            "kakveda_bus_inflight_deliveries", "Bus deliveries currently in flight",
        )

    # --- durable URL subscriptions -------------------------------------

    def _replay_subscriptions(self) -> None:
        path = self._persist_path
        if path is None or not path.exists():
            return
        for lineno, line in enumerate(path.read_text().splitlines(), start=1):
            if not line.strip():
                continue
            # One malformed record (a torn tail, a hand edit) is skipped
            # with a warning; the others still replay.
            try:
                rec = json.loads(line)
                topic, url = rec.get("topic"), rec.get("url")
                action = rec.get("action")
            except Exception as e:  # noqa: BLE001 — any bad record, not just bad JSON
                log.warning(
                    "skipping malformed subscription record %s:%d (%s: %s)",
                    path, lineno, type(e).__name__, e,
                )
                continue
            if not topic or not url:
                continue
            subs = self._subs.setdefault(topic, [])
            if action == "unsubscribe":
                if url in subs:
                    subs.remove(url)
            elif url not in subs:
                subs.append(url)

    def _persist(self, action: str, topic: str, url: str) -> None:
        if self._persist_path is None:
            return
        try:
            self._persist_path.parent.mkdir(parents=True, exist_ok=True)
            with self._persist_path.open("a") as f:
                f.write(json.dumps({"action": action, "topic": topic, "url": url}) + "\n")
        except OSError as e:
            log.warning("subscription persist failed: %s", e)

    def subscribe(self, topic: str, handler: Union[Handler, str]) -> int:
        subs = self._subs.setdefault(topic, [])
        if handler not in subs:
            subs.append(handler)
            if isinstance(handler, str):
                self._persist("subscribe", topic, handler)
        return len(subs)

    def unsubscribe(self, topic: str, handler: Union[Handler, str]) -> None:
        subs = self._subs.get(topic, [])
        if handler in subs:
            subs.remove(handler)
            if isinstance(handler, str):
                self._persist("unsubscribe", topic, handler)

    def topics(self) -> Dict[str, int]:
        """Topic → subscriber count."""
        return {k: len(v) for k, v in self._subs.items()}

    def url_subscribers(self, topic: str) -> List[str]:
        """The URL subscribers of a topic (fleet start-up prunes stale
        peer subscriptions with it)."""
        return [s for s in self._subs.get(topic, []) if isinstance(s, str)]

    def mark_ephemeral(self, topic: str) -> None:
        """URL deliveries on ``topic`` become single-attempt and never
        dead-letter (gossip: the next tick supersedes this one)."""
        self._ephemeral_topics.add(topic)

    def has_subscribers(self, topic: str, exclude: Collection[Handler] = ()) -> bool:
        return any(s not in exclude for s in self._subs.get(topic, []))

    # --- circuit breaker (URL subscribers) -----------------------------

    def _breaker_state(self, url: str) -> dict:
        return self._breakers.setdefault(
            url, {"state": "closed", "fails": 0, "opened_at": 0.0, "probing": False}
        )

    def _set_breaker(self, br: dict, to: str) -> None:
        """One breaker transition: state, transition counter and the
        open-breaker gauge move together. Caller holds ``_breaker_lock``."""
        if br["state"] == to:
            return
        br["state"] = to
        n_open = sum(1 for b in self._breakers.values() if b["state"] == "open")
        self._m_breaker_trans.labels(to=to).inc()
        self._m_breaker_open.set(n_open)
        log.warning("bus breaker -> %s (%d open)", to, n_open)

    def _breaker_allow(self, url: str) -> bool:
        """May a delivery to ``url`` go? An open breaker short-circuits
        until its cooldown ends, then admits ONE half-open probe at a time."""
        with self._breaker_lock:
            br = self._breaker_state(url)
            if br["state"] == "closed":
                return True
            if br["state"] == "open":
                if time.monotonic() - br["opened_at"] < self._breaker_cooldown:
                    return False
                self._set_breaker(br, "half_open")
                br["probing"] = True
                return True
            if not br["probing"]:  # half_open, probe slot free
                br["probing"] = True
                return True
            return False

    def _breaker_result(self, url: str, ok: bool) -> None:
        with self._breaker_lock:
            br = self._breaker_state(url)
            br["probing"] = False
            if ok:
                br["fails"] = 0
                # A RE-close means the peer healed: schedule the auto-replay.
                reclosed = br["state"] != "closed"
                self._set_breaker(br, "closed")
                if reclosed:
                    self._schedule_dlq_auto_locked()
                return
            if br["state"] == "half_open":
                br["opened_at"] = time.monotonic()
                self._set_breaker(br, "open")
                return
            br["fails"] += 1
            if br["fails"] >= self._breaker_threshold and br["state"] == "closed":
                br["opened_at"] = time.monotonic()
                self._set_breaker(br, "open")

    def breaker_states(self) -> Dict[str, str]:
        """url -> breaker state."""
        with self._breaker_lock:
            return {u: b["state"] for u, b in self._breakers.items()}

    # --- dead-letter queue ---------------------------------------------

    def _dead_letter(self, topic: str, url: str, event: dict, error: str, attempts: int) -> None:
        self._m_dlq.inc()
        if self._dlq_path is None:
            return
        rec = {
            "ts": time.time(), "topic": topic, "url": url, "event": event,
            "error": error, "attempts": attempts,
        }
        try:
            with self._dlq_lock:
                self._dlq_path.parent.mkdir(parents=True, exist_ok=True)
                with self._dlq_path.open("a", encoding="utf-8") as f:
                    f.write(json.dumps(rec, ensure_ascii=False) + "\n")
        except OSError as e:
            log.error("dead-letter append failed (event dropped): %s", e)

    def replay_dlq(self, timeout: Optional[float] = None) -> dict:
        """Re-deliver every dead-lettered event (blocking POSTs) and rewrite
        the DLQ with what still fails. A URL that accepted a replay gets
        its breaker closed."""
        if self._dlq_path is None:
            return {"replayed": 0, "failed": 0, "path": None}
        with self._dlq_lock:
            out = replay_dlq_file(self._dlq_path, timeout=timeout or self.delivery_timeout)
        with self._breaker_lock:
            for url in out.get("replayed_urls", ()):
                br = self._breakers.get(url)
                if br is not None:
                    br["fails"] = 0
                    br["probing"] = False
                    self._set_breaker(br, "closed")
        return out

    def _schedule_dlq_auto_locked(self) -> None:
        """Arm ONE delayed auto-replay after a breaker re-close (caller
        holds ``_breaker_lock``). A timer thread, not a loop task: breaker
        results also arrive from publish_sync's short-lived loops.
        Re-closes while one is pending coalesce."""
        if self._dlq_auto_s <= 0 or self._dlq_path is None:
            return
        if self._dlq_auto_pending or self._closed:
            return
        self._dlq_auto_pending = True
        self._m_dlq_auto.labels(result="scheduled").inc()
        timer = threading.Timer(self._dlq_auto_s, self._run_dlq_auto)
        timer.daemon = True
        timer.start()
        self._dlq_auto_timer = timer

    def close(self) -> None:
        """Cancel a pending DLQ auto-replay and stop new ones from arming.
        Idempotent; the bus still delivers afterwards."""
        with self._breaker_lock:
            self._closed = True
            timer, self._dlq_auto_timer = self._dlq_auto_timer, None
            self._dlq_auto_pending = False
        if timer is not None:
            timer.cancel()

    def _run_dlq_auto(self) -> None:
        with self._breaker_lock:
            if self._closed:
                return
            self._dlq_auto_pending = False
            self._dlq_auto_timer = None
        try:
            out = self.replay_dlq()
        except Exception as e:  # noqa: BLE001 — auto-replay must never kill the timer path
            log.warning("DLQ auto-replay failed: %s: %s", type(e).__name__, e)
            self._m_dlq_auto.labels(result="failed").inc()
            return
        result = "replayed" if out.get("replayed") else ("failed" if out.get("failed") else "empty")
        self._m_dlq_auto.labels(result=result).inc()
        if out.get("replayed") or out.get("failed"):
            log.info(
                "DLQ auto-replay after breaker re-close: %d replayed, %d still failing",
                out.get("replayed", 0), out.get("failed", 0),
            )

    # --- delivery -------------------------------------------------------

    async def _deliver_url(self, topic: str, url: str, event: dict, session=None) -> bool:
        """At-least-once URL delivery: breaker gate, bounded retries with
        backoff and jitter, dead-letter on exhaustion (ephemeral topics:
        the gate only)."""
        ephemeral = topic in self._ephemeral_topics
        if not self._breaker_allow(url):
            self._m_att_short.inc()
            if not ephemeral:
                self._dead_letter(topic, url, event, "circuit breaker open", 0)
            return False
        retries = 1 if ephemeral else self._retries
        for attempt in range(retries):
            ok = await self._deliver(url, event, session=session)
            if ok:
                self._m_att_ok.inc()
                self._breaker_result(url, True)
                return True
            if attempt + 1 < retries:
                self._m_att_retry.inc()
                await asyncio.sleep(self._retry_base * (2 ** attempt) * (0.5 + random.random()))
        self._m_att_failed.inc()
        self._breaker_result(url, False)
        if not ephemeral:
            self._dead_letter(topic, url, event, f"delivery failed after {retries} attempt(s)", retries)
        return False

    async def _post(self, session, url: str, event: dict) -> None:
        # A non-2xx answer IS a failed delivery: the subscriber did not
        # take the event (a crashed handler, a 429 shed), so the
        # at-least-once policy must retry or dead-letter it.
        async with session.post(url, json=event, allow_redirects=False) as r:
            await r.read()
            if not 200 <= r.status < 300:
                raise RuntimeError(f"HTTP {r.status} from {url}")

    async def _deliver(self, sub: Union[Handler, str], event: dict, session=None) -> bool:
        try:
            self._fault_deliver.fire()
            if isinstance(sub, str):
                if session is not None:
                    await self._post(session, sub, event)
                else:
                    import aiohttp

                    timeout = aiohttp.ClientTimeout(total=self.delivery_timeout)
                    async with aiohttp.ClientSession(timeout=timeout) as s:
                        await self._post(s, sub, event)
                return True
            if asyncio.iscoroutinefunction(sub):
                await asyncio.wait_for(sub(event), timeout=self.delivery_timeout)
            else:
                # Sync handlers run in the executor, with the same timeout.
                loop = asyncio.get_running_loop()
                result = await asyncio.wait_for(
                    loop.run_in_executor(None, sub, event), timeout=self.delivery_timeout
                )
                if asyncio.iscoroutine(result):  # a sync factory returning a coroutine
                    await asyncio.wait_for(result, timeout=self.delivery_timeout)
            return True
        except Exception as e:  # noqa: BLE001 — fan-out must not break on one subscriber
            log.warning("event delivery failed: %s -> %r: %s", type(e).__name__, sub, e)
            return False

    async def _fan_out(self, topic: str, pairs: List[tuple]) -> int:
        """Deliver (subscriber, event) pairs with bounded concurrency and
        one pooled HTTP session for all URL deliveries."""
        sem = asyncio.Semaphore(self.MAX_CONCURRENT_DELIVERIES)
        session = None
        if any(isinstance(s, str) for s, _ in pairs):
            import aiohttp

            session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.delivery_timeout),
                connector=aiohttp.TCPConnector(limit=self.MAX_CONCURRENT_DELIVERIES),
            )

        async def one(sub, event) -> bool:
            async with sem:
                self._m_inflight.inc()
                try:
                    if isinstance(sub, str):
                        return await self._deliver_url(topic, sub, event, session=session)
                    return await self._deliver(sub, event, session=session)
                finally:
                    self._m_inflight.dec()

        try:
            results = await asyncio.gather(*[one(s, e) for s, e in pairs])
        finally:
            if session is not None:
                await session.close()
        ok = sum(results)
        self._m_ok.inc(ok)
        if ok < len(results):
            self._m_err.inc(len(results) - ok)
        return ok

    async def publish(self, topic: str, event: dict, exclude: Collection[Handler] = ()) -> int:
        """Fan out to all subscribers concurrently; returns the delivered
        count. ``exclude`` skips specific subscribers (the platform's batch
        reactors, which run once per batch themselves)."""
        self._m_published.labels(topic=topic).inc()
        subs = [s for s in self._subs.get(topic, []) if s not in exclude]
        if not subs:
            return 0
        return await self._fan_out(topic, [(s, event) for s in subs])

    async def publish_many(
        self, topic: str, events: List[dict], exclude: Collection[Handler] = ()
    ) -> int:
        """Publish a batch of events (every event × subscriber delivery)."""
        self._m_published.labels(topic=topic).inc(len(events))
        subs = [s for s in self._subs.get(topic, []) if s not in exclude]
        if not subs or not events:
            return 0
        return await self._fan_out(topic, [(s, e) for e in events for s in subs])

    def publish_sync(self, topic: str, event: dict) -> int:
        """Publish from synchronous code (runs a private loop)."""
        return asyncio.run(self.publish(topic, event))


def replay_dlq_file(path: str | Path, timeout: float = 5.0) -> dict:
    """Re-deliver every event in a dead-letter JSONL (one blocking POST
    each, the fan-out's HTTP contract) and atomically rewrite the file
    with what still fails. Malformed lines are kept in place."""
    path = Path(path)
    if not path.exists():
        return {"replayed": 0, "failed": 0, "path": str(path), "replayed_urls": []}
    remaining: List[str] = []
    replayed = 0
    replayed_urls: set = set()
    for lineno, line in enumerate(path.read_text(encoding="utf-8").splitlines(), 1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
            url, event = rec["url"], rec["event"]
        except Exception as e:  # noqa: BLE001 — keep the record for a human
            log.warning("dlq replay: keeping malformed record %s:%d (%s)", path, lineno, e)
            remaining.append(line)
            continue
        try:
            httpjson.request("POST", url, event, timeout=timeout)
            replayed += 1
            replayed_urls.add(url)
        except Exception as e:  # noqa: BLE001 — still undeliverable, keep it
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["attempts"] = int(rec.get("attempts", 0)) + 1
            remaining.append(json.dumps(rec, ensure_ascii=False))
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text("".join(ln + "\n" for ln in remaining), encoding="utf-8")
    os.replace(tmp, path)
    return {
        "replayed": replayed,
        "failed": len(remaining),
        "path": str(path),
        "replayed_urls": sorted(replayed_urls),
    }
