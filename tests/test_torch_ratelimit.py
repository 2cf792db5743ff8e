"""The port's rate limiters (``kakveda_tpu_torch/core/ratelimit.py``) against
the JAX package's, on the CPU.

One seeded stream of (key, now) pairs goes through both packages'
``TokenBucket`` (the clock is the ``now=`` argument, so nothing is
masked), with ``KAKVEDA_RATELIMIT_MAX_KEYS`` small enough that eviction
runs, and through both ``RateLimiter``s on their in-memory path (the clock
is ``time.time``, patched in both modules to the same stepped values).
"""

import numpy as np
import pytest

from kakveda_tpu.core import ratelimit as jax_rl
from kakveda_tpu_torch.core import ratelimit as port_rl


def _stream(seed, n, keys, dt, hot=0.0):
    """(key, now) pairs: exponential gaps of mean ``dt``; a ``hot`` share
    of the calls goes to one key, the rest spread over ``keys``."""
    rng = np.random.default_rng(seed)
    now = 1000.0
    out = []
    for _ in range(n):
        now += float(rng.exponential(dt))
        key = "hot" if rng.random() < hot else f"k{int(rng.integers(keys))}"
        out.append((key, now))
    return out


@pytest.mark.parametrize("rps,burst,keys,max_keys,dt,hot", [
    (1.0, 1.0, 3, 65536, 0.2, 0.0),
    (50.0, 10.0, 4, 65536, 0.002, 0.0),
    (5.0, None, 40, 16, 0.005, 0.3),  # eviction at the key bound
    (0.5, 3.0, 2000, 64, 0.02, 0.5),  # churn past the bound and the 1024-call sweep
])
def test_token_bucket_stream_matches_jax(monkeypatch, rps, burst, keys, max_keys, dt, hot):
    monkeypatch.setenv("KAKVEDA_RATELIMIT_MAX_KEYS", str(max_keys))
    port, ref = port_rl.TokenBucket(rps, burst), jax_rl.TokenBucket(rps, burst)
    assert port.max_keys == ref.max_keys == max_keys and port.burst == ref.burst
    stream = _stream(3, 3000, keys, dt, hot)
    got = [port.allow(k, now=t) for k, t in stream]
    want = [ref.allow(k, now=t) for k, t in stream]
    assert got == want
    assert any(ok for ok, _ in got) and any(not ok for ok, _ in got)
    assert list(port._buckets) == list(ref._buckets) and len(port._buckets) <= max_keys


def test_token_bucket_rejects_what_jax_rejects():
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError):
            port_rl.TokenBucket(bad)
        with pytest.raises(ValueError):
            jax_rl.TokenBucket(bad)


@pytest.mark.parametrize("limit,window", [(3, 1.0), (10, 60.0)])
def test_rate_limiter_memory_path_matches_jax(monkeypatch, limit, window):
    stream = _stream(9, 2500, 30, 0.05)
    clock = {"t": 0.0}
    monkeypatch.setattr(port_rl.time, "time", lambda: clock["t"])
    port, ref = port_rl.RateLimiter(), jax_rl.RateLimiter(redis_url=None)
    got, want = [], []
    for k, t in stream:
        clock["t"] = t
        got.append(port.allow(k, limit, window))
        want.append(ref.allow(k, limit, window))
    assert got == want and any(got) and not all(got)
    assert port._hits == ref._hits
