"""The port's event bus (``kakveda_tpu_torch/events/bus.py``) against the
JAX package's ``EventBus`` on the same scripts, on the CPU.

Each script runs once per package, each bus against its own in-process
aiohttp subscriber: URL delivery, retries with backoff, the breaker's
transitions (closed → open → half_open → closed), short circuits and the
dead-letter queue, ``replay_dlq`` / ``replay_dlq_file``, the automatic
replay after a re-close (``KAKVEDA_DLQ_AUTO_S``), persisted
subscriptions across a restart, and an ephemeral topic that never
dead-letters. What the subscriber saw, the breaker states, the
subscription log (byte for byte) and the DLQ records (their ``error``
text aside, which names each package's HTTP client, and their ``ts``)
must be equal.
"""

import asyncio
import json
import time

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from kakveda_tpu.events import bus as jbus
from kakveda_tpu_torch.events import bus as pbus

PACKAGES = {"jax": jbus, "port": pbus}


@pytest.fixture(autouse=True)
def _fast_bus(monkeypatch):
    monkeypatch.setenv("KAKVEDA_BUS_RETRIES", "3")
    monkeypatch.setenv("KAKVEDA_BUS_RETRY_BASE", "0.01")
    monkeypatch.setenv("KAKVEDA_BUS_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("KAKVEDA_BUS_BREAKER_COOLDOWN", "1.0")


def _subscriber():
    """An in-process HTTP subscriber whose next ``fail`` answers are
    ``status``; it records every body it accepted and counts every hit."""
    state = {"fail": 0, "status": 500, "seen": [], "hits": 0}

    async def hook(request):
        state["hits"] += 1
        body = await request.json()
        if state["fail"] > 0:
            state["fail"] -= 1
            return web.json_response({"ok": False}, status=state["status"])
        state["seen"].append(body)
        return web.json_response({"ok": True})

    app = web.Application()
    app.add_routes([web.post("/hook", hook)])
    return app, state


def _norm(obj, base):
    """``obj`` with the subscriber's base URL (its port differs per run)
    written as ``SUB``."""
    if isinstance(obj, str):
        return obj.replace(base, "SUB")
    if isinstance(obj, dict):
        return {_norm(k, base): _norm(v, base) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_norm(v, base) for v in obj)
    return obj


def _run_both(script, tmp_path):
    """``script(mod, bus_dir, client, state)`` once per package; the results."""
    out = {}
    for name, mod in PACKAGES.items():
        app, state = _subscriber()

        async def go():
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                res = await script(mod, tmp_path / name, client, state)
                return _norm(res, str(client.make_url("")).rstrip("/"))
            finally:
                await client.close()

        out[name] = asyncio.run(go())
    return out


def _dlq(path):
    recs = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    return [{k: v for k, v in r.items() if k not in ("ts", "error")} for r in recs]


def test_url_delivery_retries_then_succeeds(tmp_path):
    async def script(mod, d, client, state):
        bus = mod.EventBus(persist_path=d / "subs.jsonl")
        url = str(client.make_url("/hook"))
        bus.subscribe("t", url)
        state["fail"] = 2  # two 500s, then the third attempt lands
        n = await bus.publish("t", {"x": 1})
        return n, state["hits"], state["seen"], bus.breaker_states(), (d / "dlq.jsonl").exists()

    out = _run_both(script, tmp_path)
    assert out["port"] == out["jax"]
    n, hits, seen, _, dlq = out["port"]
    assert (n, hits, seen, dlq) == (1, 3, [{"x": 1}], False)


@pytest.mark.parametrize("status", [500, 429, 404])
def test_non_2xx_exhausts_retries_and_dead_letters(tmp_path, status):
    async def script(mod, d, client, state):
        bus = mod.EventBus(persist_path=d / "subs.jsonl")
        url = str(client.make_url("/hook"))
        bus.subscribe("t", url)
        state["fail"], state["status"] = 3, status
        n = await bus.publish("t", {"x": 2})
        return n, state["hits"], _dlq(d / "dlq.jsonl"), bus.breaker_states()[url]

    out = _run_both(script, tmp_path)
    assert out["port"] == out["jax"]
    n, hits, recs, state = out["port"]
    assert (n, hits, state) == (0, 3, "closed")
    assert recs == [{"topic": "t", "url": "SUB/hook", "event": {"x": 2}, "attempts": 3}]


def test_breaker_transitions_short_circuit_replay_and_reclose(tmp_path):
    """Two failed events open the breaker (threshold 2); the next event
    short-circuits into the DLQ without a hit; after the cooldown one
    half-open probe fails and reopens it; then the endpoint heals,
    ``replay_dlq`` re-delivers every record and closes the breaker."""

    async def script(mod, d, client, state):
        bus = mod.EventBus(persist_path=d / "subs.jsonl")
        url = str(client.make_url("/hook"))
        bus.subscribe("t", url)
        trail = []
        state["fail"] = 6
        for i in range(2):
            await bus.publish("t", {"i": i})
            trail.append((bus.breaker_states()[url], state["hits"]))
        await bus.publish("t", {"i": 2})  # short circuit: no hit
        trail.append((bus.breaker_states()[url], state["hits"]))
        await asyncio.sleep(1.05)
        state["fail"] = 3
        await bus.publish("t", {"i": 3})  # the half-open probe fails
        trail.append((bus.breaker_states()[url], state["hits"]))
        loop = asyncio.get_running_loop()
        replay = await loop.run_in_executor(None, bus.replay_dlq)
        trail.append((bus.breaker_states()[url], state["hits"]))
        return trail, replay["replayed"], replay["failed"], sorted(e["i"] for e in state["seen"]), _dlq(d / "dlq.jsonl")

    out = _run_both(script, tmp_path)
    assert out["port"] == out["jax"]
    trail, replayed, failed, seen, left = out["port"]
    assert trail == [("closed", 3), ("open", 6), ("open", 6), ("open", 9), ("closed", 13)]
    assert (replayed, failed, seen, left) == (4, 0, [0, 1, 2, 3], [])


def test_dlq_auto_replay_after_breaker_recloses(tmp_path, monkeypatch):
    monkeypatch.setenv("KAKVEDA_DLQ_AUTO_S", "0.2")

    async def script(mod, d, client, state):
        bus = mod.EventBus(persist_path=d / "subs.jsonl")
        url = str(client.make_url("/hook"))
        bus.subscribe("t", url)
        state["fail"] = 6
        for i in range(2):
            await bus.publish("t", {"i": i})
        await asyncio.sleep(1.05)
        await bus.publish("t", {"i": 2})  # the half-open probe succeeds: re-close
        states = [bus.breaker_states()[url]]
        dlq = d / "dlq.jsonl"
        for _ in range(50):  # the timer thread replays the DLQ, then rewrites it
            await asyncio.sleep(0.1)
            if len(state["seen"]) == 3 and not dlq.read_text().strip():
                break
        bus.close()
        return states, sorted(e["i"] for e in state["seen"]), _dlq(dlq)

    out = _run_both(script, tmp_path)
    assert out["port"] == out["jax"]
    assert out["port"] == (["closed"], [0, 1, 2], [])


def test_replay_dlq_file_keeps_what_still_fails_and_malformed_lines(tmp_path):
    async def script(mod, d, client, state):
        d.mkdir(parents=True)
        dlq = d / "dlq.jsonl"
        good, dead = str(client.make_url("/hook")), "http://127.0.0.1:9/hook"
        lines = [
            json.dumps({"ts": 1.0, "topic": "t", "url": good, "event": {"a": 1}, "error": "x", "attempts": 3}),
            "{not json",
            json.dumps({"ts": 2.0, "topic": "t", "url": dead, "event": {"b": 2}, "error": "x", "attempts": 3}),
        ]
        dlq.write_text("\n".join(lines) + "\n")
        loop = asyncio.get_running_loop()
        out = await loop.run_in_executor(None, lambda: mod.replay_dlq_file(dlq, timeout=2.0))
        kept = dlq.read_text().splitlines()
        return (out["replayed"], out["failed"], out["replayed_urls"], state["seen"],
                kept[0], [{k: v for k, v in json.loads(x).items() if k != "error"} for x in kept[1:]])

    out = _run_both(script, tmp_path)
    assert out["port"] == out["jax"]
    replayed, failed, urls_ok, seen, malformed, rest = out["port"]
    assert (replayed, failed, urls_ok, seen, malformed) == (1, 2, ["SUB/hook"], [{"a": 1}], "{not json")
    assert rest == [{"ts": 2.0, "topic": "t", "url": "http://127.0.0.1:9/hook", "event": {"b": 2}, "attempts": 4}]


def test_subscriptions_persist_across_a_restart(tmp_path):
    """Subscribe, unsubscribe and a malformed line: the log is byte-equal
    between the packages, a new bus replays the same table, and a log
    written by either package replays alike in the other."""
    logs = {}
    for name, mod in PACKAGES.items():
        path = tmp_path / name / "subs.jsonl"
        bus = mod.EventBus(persist_path=path)
        bus.subscribe("a", "http://h:1/x")
        bus.subscribe("a", "http://h:2/x")
        bus.subscribe("b", "http://h:1/y")
        bus.subscribe("a", "http://h:1/x")  # already there: no line
        bus.unsubscribe("a", "http://h:2/x")
        bus.subscribe("b", lambda e: None)  # local: never persisted
        with path.open("a") as f:
            f.write("{torn\n[1, 2]\n")
        logs[name] = path.read_bytes()
    assert logs["port"] == logs["jax"]
    for writer in PACKAGES:
        for name, mod in PACKAGES.items():
            again = mod.EventBus(persist_path=tmp_path / writer / "subs.jsonl")
            assert again.topics() == {"a": 1, "b": 1}, (writer, name)
            assert again.url_subscribers("a") == ["http://h:1/x"]
            assert again.url_subscribers("b") == ["http://h:1/y"]


def test_ephemeral_topic_never_dead_letters(tmp_path):
    async def script(mod, d, client, state):
        bus = mod.EventBus(delivery_timeout=0.5, persist_path=d / "subs.jsonl")
        bus.mark_ephemeral(mod.TOPIC_FLEET_CONTROL)
        dead = "http://127.0.0.1:9/fleet/gossip"  # connection refused
        bus.subscribe(mod.TOPIC_FLEET_CONTROL, dead)
        bus.subscribe("real.topic", dead)
        url = str(client.make_url("/hook"))
        bus.subscribe(mod.TOPIC_FLEET_CONTROL, url)
        state["fail"] = 1
        delivered = await bus.publish(mod.TOPIC_FLEET_CONTROL, {"seq": 1, "ts": time.time()})
        no_dlq = not (d / "dlq.jsonl").exists()
        await bus.publish("real.topic", {"x": 1})
        return delivered, state["hits"], no_dlq, [r["topic"] for r in _dlq(d / "dlq.jsonl")]

    out = _run_both(script, tmp_path)
    assert out["port"] == out["jax"]
    # One attempt each (no retry on the failing subscriber), no DLQ line
    # for the gossip topic, one for the same dead endpoint elsewhere.
    assert out["port"] == (0, 1, True, ["real.topic"])


def test_local_subscribers_and_the_replication_topic():
    assert pbus.replicate_topic("r3") == jbus.replicate_topic("r3") == "gfkb.replicate.to.r3"
    for const in ("TOPIC_GFKB_REPLICATE", "TOPIC_FLEET_CONTROL", "TOPIC_GFKB_REPLICATE_PREFIX",
                  "TOPIC_TRACE_INGESTED", "TOPIC_FAILURE_DETECTED", "TOPIC_CHILD_SAFETY"):
        assert getattr(pbus, const) == getattr(jbus, const)
    bus = pbus.EventBus()
    got = []
    bus.subscribe("t", got.append)
    bus.subscribe("t", "http://127.0.0.1:9/x")
    assert bus.url_subscribers("t") == ["http://127.0.0.1:9/x"]
    assert bus.publish_sync("t", {"k": 1}) == 1  # the dead URL fails, no DLQ path
    assert got == [{"k": 1}]
    bus.unsubscribe("t", got.append)
    assert bus.topics() == {"t": 1}
