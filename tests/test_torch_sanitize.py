"""The port's concurrency sanitizer (``kakveda_tpu_torch/core/sanitize.py``)
against the JAX package's, on the CPU.

Both packages get the same inputs: seeded edge lists for ``find_cycles``,
one lock-acquisition script for the recorded edges. What is masked: the
per-lock wait and hold times (wall clock) and each edge's first thread
name. The stall case blocks a loop once for about 100 ms against a 50 ms
threshold and holds each package's watchdog to one stall with a stack.
"""

import asyncio
import threading
import time

import numpy as np
import pytest

from kakveda_tpu.core import sanitize as jax_sanitize
from kakveda_tpu_torch.core import sanitize as port_sanitize

PACKAGES = {"jax": jax_sanitize, "port": port_sanitize}


@pytest.fixture(autouse=True)
def _clean():
    for m in PACKAGES.values():
        m.reset()
    yield
    for m in PACKAGES.values():
        m.reset()


def _edge_lists():
    rng = np.random.default_rng(17)
    out = [[], [("a", "b"), ("b", "a")], [("a", "b"), ("b", "c"), ("c", "a"), ("c", "d")]]
    for _ in range(40):
        n = int(rng.integers(2, 9))
        m = int(rng.integers(1, 3 * n))
        names = [f"L{i}" for i in range(n)]
        out.append([(names[int(rng.integers(n))], names[int(rng.integers(n))]) for _ in range(m)])
    return out


@pytest.mark.parametrize("case", range(43))
def test_find_cycles_matches_jax(case):
    edges = _edge_lists()[case]
    assert port_sanitize.find_cycles(edges) == jax_sanitize.find_cycles(edges)


@pytest.mark.parametrize("kind", ["lock", "rlock"])
def test_named_lock_is_the_bare_lock_when_off(monkeypatch, kind):
    monkeypatch.delenv("KAKVEDA_SANITIZE", raising=False)
    port = port_sanitize.named_lock("X._lock", kind=kind)
    ref = jax_sanitize.named_lock("X._lock", kind=kind)
    assert type(port) is type(ref) is type(threading.RLock() if kind == "rlock" else threading.Lock())
    assert not port_sanitize.enabled()


def _script(m):
    """One acquisition script: nested orders, an RLock re-entry, a lock
    taken alone, and one inverted pair (a cycle)."""
    a = m.named_lock("GFKB._lock")
    b = m.named_lock("TieredIndex.lock", kind="rlock")
    c = m.named_lock("ClusterState._lock", kind="rlock")
    d = m.named_lock("Tracer._lock")
    with a:
        with b:
            with b:
                with c:
                    pass
    with c:
        with d:
            pass
    with d:
        pass
    with b:
        with a:
            pass
    r = m.sanitizer_report()
    return {
        "enabled": r["enabled"],
        "edges": r["edges"],
        "cycles": r["cycles"],
        "acquisitions": {k: v["acquisitions"] for k, v in r["locks"].items()},
    }


def test_acquisition_script_records_the_same_edges(monkeypatch):
    monkeypatch.setenv("KAKVEDA_SANITIZE", "1")
    port, ref = _script(port_sanitize), _script(jax_sanitize)
    assert port == ref
    assert port["enabled"] and port["cycles"] == [["GFKB._lock", "TieredIndex.lock", "GFKB._lock"]]
    assert port_sanitize.lock_order_edges() == jax_sanitize.lock_order_edges()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_watchdog_records_one_stall_with_a_stack(pkg):
    m = PACKAGES[pkg]

    async def go():
        wd = m.LoopStallWatchdog(threshold_ms=50)
        await wd.start()
        await asyncio.sleep(0.05)
        time.sleep(0.1)  # block the loop once, past the threshold
        await asyncio.sleep(0.1)
        await wd.stop()
        return wd.stall_count

    assert asyncio.run(go()) >= 1
    # The one stall of the block, its stack at the blocking line (a loaded
    # host may add stalls of its own elsewhere).
    stalls = [x for x in m.sanitizer_report()["stalls"] if "block the loop once" in x["stack"]]
    assert len(stalls) == 1 and stalls[0]["stall_ms"] >= 50
