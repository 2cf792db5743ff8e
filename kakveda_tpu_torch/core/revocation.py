"""JWT revocation store: logout invalidates the token.

The port's own copy of ``kakveda_tpu/core/revocation.py``, in memory only:
revoked token ids (jti) are held until their natural expiry in a TTL set.
The reference's Redis tier behind ``KAKVEDA_REDIS_URL`` is not ported, as
the rate limiter's is not (``core/ratelimit.py``). Where the reference
would share revocations and rate-limit windows across processes through
Redis, the port refuses to start rather than keep them per process
unannounced: a store asked for a Redis URL (the argument or
``KAKVEDA_REDIS_URL``) raises, as ``dashboard/db.PgDatabase`` does without
``psycopg2``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

from kakveda_tpu_torch.core import sanitize


class RevocationStore:
    def __init__(self, redis_url: Optional[str] = None):
        url = redis_url or os.environ.get("KAKVEDA_REDIS_URL")
        if url:
            # Redact userinfo: the URL may carry a password.
            safe = url.split("@", 1)[-1] if "@" in url else url.split("//", 1)[-1]
            raise RuntimeError(
                f"KAKVEDA_REDIS_URL points at {safe}, but the port keeps revocations and "
                "rate limits in memory only (no Redis tier); unset it to run per process"
            )
        self._mem: Dict[str, float] = {}  # jti -> expiry ts
        self._lock = sanitize.named_lock("RevocationStore._lock")

    def revoke(self, jti: str, expires_at: float) -> None:
        """Remember ``jti`` as revoked until ``expires_at`` (unix ts)."""
        with self._lock:
            self._sweep_locked()
            self._mem[jti] = expires_at

    def is_revoked(self, jti: str) -> bool:
        with self._lock:
            exp = self._mem.get(jti)
            if exp is None:
                return False
            if exp <= time.time():
                del self._mem[jti]
                return False
            return True

    def _sweep_locked(self) -> None:
        if len(self._mem) > 4096:
            now = time.time()
            self._mem = {k: v for k, v in self._mem.items() if v > now}
