"""Per-client rate limiting: a fixed-window limiter and a token bucket.

The port's own copy of ``kakveda_tpu/core/ratelimit.py``, in memory only.
:class:`RateLimiter` counts per-key fixed windows, sweeping expired
windows so keys derived from client IPs cannot grow without bound (the
reference's Redis tier behind ``KAKVEDA_REDIS_URL`` is not ported: nothing
in the port calls the limiter). :class:`TokenBucket` is the smooth-rate
tier the service's ingest routes use (``KAKVEDA_RATELIMIT_RPS`` /
``_BURST`` / ``_MAX_KEYS``).
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from kakveda_tpu_torch.core import metrics as _metrics


class RateLimiter:
    _SWEEP_EVERY = 1024

    def __init__(self):
        self._hits: Dict[str, Tuple[float, int]] = {}
        self._calls = 0

    def allow(self, key: str, limit: int, window_s: float = 60.0) -> bool:
        now = time.time()
        self._calls += 1
        if self._calls % self._SWEEP_EVERY == 0:
            self._hits = {k: v for k, v in self._hits.items() if now - v[0] < window_s}
        start, count = self._hits.get(key, (now, 0))
        if now - start >= window_s:
            start, count = now, 0
        count += 1
        self._hits[key] = (start, count)
        return count <= limit


class TokenBucket:
    """Per-key token bucket — the smooth-rate tier the ingest and
    playground routes use (``KAKVEDA_RATELIMIT_RPS``).

    The fixed-window :class:`RateLimiter` above admits a full window's
    burst at the window edge; a token bucket refills continuously (``rps``
    tokens/second up to ``burst``), so a client that exceeds its rate is
    told exactly how long until the next token — the ``retry_after``
    second element of :meth:`allow`, which the HTTP tier echoes as a 429
    ``Retry-After`` header in the same shape the admission controller
    sheds with (docs/robustness.md). In-memory only by design: per-client
    smoothing is a node-local concern.

    The table is HARD-bounded: the refill sweep drops idle keys, but a
    key-churn flood (1M distinct app ids inside one burst window) would
    still grow it between sweeps, so past ``KAKVEDA_RATELIMIT_MAX_KEYS``
    the least-recently-seen bucket is evicted on insert. Eviction is
    semantics-preserving in the only direction that matters — an evicted
    key re-enters FULL, exactly what its bucket would have refilled to by
    the time a genuinely idle client returns; a churn attacker evicting
    hot keys only ever GRANTS tokens, never wrongly denies. Table size is
    exported on the ``kakveda_tenant_table_size{plane="ratelimit"}``
    gauge.
    """

    _SWEEP_EVERY = 1024

    def __init__(self, rps: float, burst: Optional[float] = None,
                 max_keys: Optional[int] = None):
        if rps <= 0:
            raise ValueError(f"rps must be positive, got {rps}")
        self.rps = float(rps)
        self.burst = float(burst) if burst is not None else max(1.0, 2.0 * rps)
        if max_keys is None:
            try:
                max_keys = int(os.environ.get("KAKVEDA_RATELIMIT_MAX_KEYS", "65536"))
            except ValueError:
                max_keys = 65536
        self.max_keys = max(1, max_keys)
        # key -> (tokens, last_ts), most-recently-seen last (LRU order).
        self._buckets: "OrderedDict[str, Tuple[float, float]]" = OrderedDict()
        self._calls = 0
        self._g_table = _metrics.get_registry().gauge(
            "kakveda_tenant_table_size",
            "Live per-tenant state-table rows per plane (bounded by "
            "KAKVEDA_TENANT_TABLE / KAKVEDA_RATELIMIT_MAX_KEYS)",
            ("plane",),
        ).labels(plane="ratelimit")

    def allow(self, key: str, now: Optional[float] = None) -> Tuple[bool, float]:
        """(admitted, retry_after_s). ``retry_after`` is 0 when admitted,
        else the time until one full token has refilled."""
        if now is None:
            now = time.monotonic()
        self._calls += 1
        if self._calls % self._SWEEP_EVERY == 0:
            # Drop keys whose bucket has fully refilled — idle clients
            # (IP-derived keys on unauthenticated routes) must not leak.
            full_age = self.burst / self.rps
            self._buckets = OrderedDict(
                (k, v) for k, v in self._buckets.items() if now - v[1] < full_age
            )
        entry = self._buckets.get(key)
        if entry is None:
            tokens, last = self.burst, now
            if len(self._buckets) >= self.max_keys:
                self._buckets.popitem(last=False)  # least-recently-seen
        else:
            tokens, last = entry
            self._buckets.move_to_end(key)
        tokens = min(self.burst, tokens + (now - last) * self.rps)
        if tokens >= 1.0:
            self._buckets[key] = (tokens - 1.0, now)
            self._g_table.set(float(len(self._buckets)))
            return True, 0.0
        self._buckets[key] = (tokens, now)
        self._g_table.set(float(len(self._buckets)))
        return False, (1.0 - tokens) / self.rps
