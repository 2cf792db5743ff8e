"""In-process asyncio event bus.

Port of ``kakveda_tpu/events/bus.py`` for local subscribers: topics fan out
to async or sync callables, each awaited with a delivery timeout (sync ones
in the executor), and a failing subscriber is logged and counted as not
delivered — it never breaks the fan-out. Every publish counts its events
on ``kakveda_bus_events_published_total{topic}``. URL subscriptions with
their retries, circuit breaker and dead-letter queue (and their metric
families) come with a later slice.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from typing import Any, Awaitable, Callable, Collection, Dict, List, Union

from kakveda_tpu_torch.core import metrics as _metrics

log = logging.getLogger("kakveda.events")

TOPIC_TRACE_INGESTED = "trace.ingested"
TOPIC_FAILURE_DETECTED = "failure.detected"
TOPIC_CHILD_SAFETY = "child_safety_alert"

Handler = Callable[[dict], Union[Awaitable[Any], Any]]


def new_event_id() -> str:
    """Mint a bus event id (hex uuid4)."""
    return uuid.uuid4().hex


class EventBus:
    """Topic → local subscriber fan-out."""

    def __init__(self, delivery_timeout: float = 3.0):
        self._subs: Dict[str, List[Handler]] = {}
        self.delivery_timeout = delivery_timeout
        self._m_published = _metrics.get_registry().counter(
            "kakveda_bus_events_published_total",
            "Events published on the in-process bus", ("topic",),
        )

    def subscribe(self, topic: str, handler: Handler) -> int:
        if not callable(handler):
            raise TypeError("only in-process callables can subscribe (URL subscribers are not ported)")
        subs = self._subs.setdefault(topic, [])
        if handler not in subs:
            subs.append(handler)
        return len(subs)

    def topics(self) -> Dict[str, int]:
        """Topic → subscriber count."""
        return {k: len(v) for k, v in self._subs.items()}

    def has_subscribers(self, topic: str, exclude: Collection[Handler] = ()) -> bool:
        return any(s not in exclude for s in self._subs.get(topic, []))

    async def _deliver(self, sub: Handler, event: dict) -> bool:
        try:
            if asyncio.iscoroutinefunction(sub):
                await asyncio.wait_for(sub(event), timeout=self.delivery_timeout)
            else:
                loop = asyncio.get_running_loop()
                result = await asyncio.wait_for(
                    loop.run_in_executor(None, sub, event), timeout=self.delivery_timeout
                )
                if asyncio.iscoroutine(result):
                    await asyncio.wait_for(result, timeout=self.delivery_timeout)
            return True
        except Exception as e:  # noqa: BLE001 — fan-out must not break on one subscriber
            log.warning("event delivery failed: %s -> %r: %s", type(e).__name__, sub, e)
            return False

    async def _fan_out(self, pairs: List[tuple]) -> int:
        results = await asyncio.gather(*[self._deliver(s, e) for s, e in pairs])
        return sum(results)

    async def publish(self, topic: str, event: dict, exclude: Collection[Handler] = ()) -> int:
        """Fan out to all subscribers concurrently; returns the delivered count."""
        self._m_published.labels(topic=topic).inc()
        subs = [s for s in self._subs.get(topic, []) if s not in exclude]
        return await self._fan_out([(s, event) for s in subs]) if subs else 0

    async def publish_many(
        self, topic: str, events: List[dict], exclude: Collection[Handler] = ()
    ) -> int:
        """Publish a batch of events (every event × subscriber delivery)."""
        self._m_published.labels(topic=topic).inc(len(events))
        subs = [s for s in self._subs.get(topic, []) if s not in exclude]
        if not subs or not events:
            return 0
        return await self._fan_out([(s, e) for e in events for s in subs])
