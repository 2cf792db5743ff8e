"""The port's HTTP service against the reference REST contracts, on the CPU.

The cases of ``tests/test_service.py`` that apply to the port's routes run
on ``kakveda_tpu_torch.service.app.make_app`` through aiohttp's in-process
test server (``Platform(device="cpu", capacity=256, dim=1024)``). One
parity test sends one request script to the JAX ``make_app`` and to the
port's and compares the JSON bodies once ids and timestamps are
normalized: warn and match scores within 1e-6 (the two packages' cosine
sums run in another order), everything else equal, ties included (the
JAX index on one device, where both take the lowest slot).
"""

import asyncio
import copy
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import uuid
from datetime import datetime, timezone
from pathlib import Path

import pytest
from aiohttp import ClientSession
from aiohttp.test_utils import TestClient, TestServer

from kakveda_tpu.core.admission import AdmissionController as JaxAdmission
from kakveda_tpu.parallel.mesh import create_mesh
from kakveda_tpu.platform import Platform as JaxPlatform
from kakveda_tpu.service.app import make_app as jax_make_app
from kakveda_tpu_torch.core.fingerprint import signature_text
from kakveda_tpu_torch.core.schemas import WarningRequest
from kakveda_tpu_torch.platform import Platform
from kakveda_tpu_torch.service.app import WARN_BATCHER_KEY, make_app

ROOT = Path(__file__).resolve().parent.parent
STUB_RESPONSE = (
    "Here is a summary with references.\n\n"
    "References:\n"
    "[1] Smith et al. (2020) A Study on Things.\n"
    "[2] Doe (2021) Another Paper.\n"
)
CITE = "Summarize this document and include citations even if not provided."
SCORE_TOL = 1e-6


def _trace(app_id, prompt, response=STUB_RESPONSE, trace_id=None):
    return {
        "trace_id": trace_id or str(uuid.uuid4()),
        "ts": datetime.now(timezone.utc).isoformat(),
        "app_id": app_id,
        "agent_id": "agent-1",
        "prompt": prompt,
        "response": response,
        "model": "stub",
        "temperature": 0.2,
        "tools": [],
        "env": {"os": "linux"},
    }


def run(coro):
    return asyncio.run(coro)


async def _with_client(app, fn):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        return await fn(client)
    finally:
        await client.close()


def _platform(path):
    return Platform(data_dir=path, capacity=256, dim=1024, device="cpu")


@pytest.fixture()
def plat(tmp_path):
    p = _platform(tmp_path / "data")
    yield p
    p.close()


@pytest.fixture()
def app(plat):
    return make_app(plat)


def test_healthz_readyz(app, plat):
    async def go(client):
        r = await client.get("/healthz")
        assert r.status == 200 and (await r.json())["ok"]
        body = await (await client.get("/readyz")).json()
        assert body["ok"] and body["gfkb_count"] == 0
        dev = body["device"]
        assert {k: dev[k] for k in ("type", "name", "count")} == {"type": "cpu", "name": "cpu", "count": 1}
        assert dev["degraded"] is False and dev["transitions"] == {"degraded": 0, "healthy": 0}
        assert body["tiers"]["enabled"] and body["tiers"]["fallback"] == 0
        assert body["native"]["available"] is True and body["native"]["mode"] == "auto"
        assert body["admission"]["classes"]["warn"] == {"inflight": 0, "limit": 256}

    run(_with_client(app, go))


def test_ingest_then_views(app):
    async def go(client):
        r = await client.post("/ingest", json={"trace": _trace("app-A", CITE)})
        assert r.status == 200 and (await r.json())["ok"]
        await client.post("/ingest", json={"trace": _trace("app-B", "Explain paper and add references.")})
        failures = (await (await client.get("/failures")).json())["failures"]
        assert len(failures) == 2 and failures[0]["failure_id"] == "F-0001"
        patterns = (await (await client.get("/patterns")).json())["patterns"]
        assert len(patterns) == 1 and patterns[0]["affected_apps"] == ["app-A", "app-B"]
        pts = (await (await client.get("/health/app-A")).json())["points"]
        assert len(pts) == 1 and pts[0]["score"] == 85.0

    run(_with_client(app, go))


def test_warn_contract(app):
    async def go(client):
        await client.post("/ingest", json={"trace": _trace("app-A", CITE)})
        r = await client.post("/warn", json={"app_id": "app-C", "prompt": CITE, "tools": [], "env": {"os": "linux"}})
        body = await r.json()
        assert r.status == 200 and body["action"] == "warn" and body["confidence"] > 0.9
        assert body["references"][0]["failure_id"] == "F-0001"

    run(_with_client(app, go))


def test_warn_concurrent_requests_share_batches(plat, monkeypatch):
    # A 50 ms straggler wait (KAKVEDA_WARN_DEADLINE_MS) so the burst
    # coalesces however slowly this machine parses requests.
    monkeypatch.setenv("KAKVEDA_WARN_DEADLINE_MS", "50")
    app = make_app(plat)
    assert app[WARN_BATCHER_KEY].deadline_s == 0.05
    calls = []
    inner = plat.warn_batch
    # The batcher holds the bound method it was given: count through it.
    monkeypatch.setattr(app[WARN_BATCHER_KEY], "_run_batch", lambda reqs: calls.append(len(reqs)) or inner(reqs))

    async def go(client):
        await client.post("/ingest", json={"trace": _trace("app-A", "Summarize with citations please")})
        reqs = [
            client.post("/warn", json={"app_id": f"a{i % 4}", "prompt": f"Summarize doc {i} with citations",
                                       "tools": [], "env": {}})
            for i in range(32)
        ]
        responses = await asyncio.gather(*reqs)
        bodies = [await r.json() for r in responses]
        assert all(r.status == 200 for r in responses)
        assert all(b["action"] in ("warn", "block", "silent") for b in bodies)
        return bodies

    bodies = run(_with_client(app, go))
    assert sum(calls) == 32 and len(calls) < 32, calls
    direct = plat.warn_batch([
        WarningRequest(app_id=f"a{i % 4}", prompt=f"Summarize doc {i} with citations", tools=[], env={})
        for i in range(32)
    ])
    for b, d in zip(bodies, direct):
        assert b["action"] == d.action and abs(b["confidence"] - d.confidence) <= SCORE_TOL


def test_match_and_upsert_endpoints(app):
    async def go(client):
        sig = signature_text("Summarize with citations", [], {"os": "linux"})
        r = await client.post("/failures/upsert", json={
            "failure_type": "HALLUCINATION_CITATION", "signature_text": sig, "app_id": "x",
            "impact_severity": "medium", "resolution": "say no sources"})
        body = await r.json()
        assert body["created"] and body["failure"]["failure_id"] == "F-0001"
        matches = (await (await client.post("/failures/match", json={"signature_text": sig})).json())["matches"]
        assert matches and matches[0]["score"] > 0.99
        r = await client.post("/patterns/upsert", json={"name": "N", "failure_ids": ["F-0001"],
                                                        "affected_apps": ["x", "y"]})
        assert (await r.json())["pattern"]["pattern_id"] == "FP-0001"

    run(_with_client(app, go))


def test_validation_errors(app):
    async def go(client):
        assert (await client.post("/ingest", json={"trace": {"bad": "shape"}})).status == 422
        assert (await client.post("/ingest/batch", json={"traces": [{"bad": 1}]})).status == 422
        assert (await client.post("/warn", json={"nope": 1})).status == 422
        assert (await client.post("/failures/upsert", json={"failure_type": "X"})).status == 422
        assert (await client.post("/failures/match", json={})).status == 422
        assert (await client.post("/patterns/upsert", json={"failure_ids": []})).status == 422
        assert (await client.post("/publish", json={"topic": "t"})).status == 422
        assert (await client.post("/patterns/mine", json={"threshold": "x"})).status == 422

    run(_with_client(app, go))


@pytest.mark.parametrize("method,path", [
    ("post", "/subscribe"), ("post", "/unsubscribe"), ("post", "/replicate"),
    ("post", "/fleet/gossip"), ("get", "/fleet/ownership"), ("post", "/fleet/export"),
    ("get", "/metrics/fleet"), ("get", "/trace/0af7651916cd43dd8448eb211c80319c"), ("get", "/trace"),
])
def test_unported_routes_answer_404(app, method, path):
    async def go(client):
        r = await getattr(client, method)(path, json={"topic": "t", "callback_url": "http://x"})
        assert r.status == 404

    run(_with_client(app, go))


@pytest.mark.parametrize("persist", [True, False])
def test_snapshot_route_answers_as_the_jax_app(tmp_path, persist):
    """200 with the snapshot's path and entry count, as the JAX app answers;
    409 with the same message when the store cannot take one."""
    jax_plat = JaxPlatform(data_dir=tmp_path / "jax", mesh=create_mesh("data:1"), capacity=256, dim=1024,
                           persist=persist)
    port = Platform(data_dir=tmp_path / "port", capacity=256, dim=1024, device="cpu", persist=persist)

    async def go(client):
        r = await client.post("/ingest/batch", json={"traces": [_trace("app-A", CITE), _trace("app-B", CITE)]})
        assert r.status == 200
        r = await client.post("/snapshot")
        return r.status, await r.json()

    (ps, pb), (js, jb) = run(_with_client(make_app(port), go)), run(
        _with_client(jax_make_app(jax_plat, admission=JaxAdmission()), go))
    port.close()
    jax_plat.gfkb.close()
    assert ps == js == (200 if persist else 409)
    if not persist:
        assert pb == jb and not pb["ok"]
        return
    assert sorted(pb) == sorted(jb) == ["entries", "ok", "path"]
    assert pb["entries"] == jb["entries"] == 1 and pb["ok"]
    assert Path(pb["path"]) == tmp_path / "port" / "snapshot"
    manifest = json.loads((Path(pb["path"]) / "manifest.json").read_text())
    assert manifest["version"] == 5 and manifest["n"] == 1
    again = _platform(tmp_path / "port")
    assert again.gfkb.lifecycle_info()["restore"]["rows"] == 1
    again.close()


def test_publish_reaches_local_subscribers(app, plat):
    got = []
    plat.bus.subscribe("custom.topic", lambda e: got.append(e))

    async def go(client):
        r = await client.post("/publish", json={"topic": "custom.topic", "event": {"x": 1}})
        assert (await r.json()) == {"ok": True, "delivered": 1}
        topics = (await (await client.get("/topics")).json())["topics"]
        assert topics["custom.topic"] == 1 and topics["trace.ingested"] == 1

    run(_with_client(app, go))
    assert got == [{"x": 1}]


def test_request_id_header(app):
    async def go(client):
        r = await client.get("/healthz", headers={"x-request-id": "rid-123"})
        assert r.headers["x-request-id"] == "rid-123"
        r = await client.get("/healthz")
        assert len(r.headers["x-request-id"]) == 32
        r = await client.get("/nope")
        assert r.status == 404 and len(r.headers["x-request-id"]) == 32

    run(_with_client(app, go))


def test_patterns_mine_endpoint(plat):
    for app_id in ("app-A", "app-B"):
        plat.gfkb.upsert_failure(
            failure_type="HALLUCINATION_CITATION",
            signature_text="intent:citations_required | summarize the quarterly report",
            app_id=app_id, impact_severity="medium",
        )
    plat.gfkb.upsert_failure(failure_type="TIMEOUT", signature_text="totally different failure shape xyz",
                             app_id="app-C", impact_severity="low")

    async def go(client):
        r = await client.post("/patterns/mine", json={"threshold": 0.5})
        body = await r.json()
        assert r.status == 200 and body["ok"]
        assert any("itation" in p["name"] for p in body["patterns"])
        # A non-default threshold is a full sweep that re-seeds the state...
        assert body["mining"]["mode"] == "full" and body["mining"]["wall_ms"] >= 0
        # ...so the next call is served from the streaming state.
        r = await client.post("/patterns/mine", json={"threshold": 0.5})
        assert (await r.json())["mining"]["mode"] == "incremental"
        r = await client.post("/patterns/mine", json={"threshold": 0.5, "mode": "bogus"})
        assert r.status == 422
        r = await client.post("/patterns/mine", data=b"")  # no body: the defaults
        assert r.status == 200 and (await r.json())["mining"]["threshold"] == 0.6

    run(_with_client(make_app(plat), go))


def test_ingest_batch_endpoint(app, plat):
    async def go(client):
        traces = [_trace("app-b", f"Summarize doc {i} and include citations even if not provided.")
                  for i in range(8)]
        r = await client.post("/ingest/batch", json={"traces": traces})
        body = await r.json()
        assert r.status == 200 and body == {"ok": True, "n": 8, "failures": 8}
        assert plat.gfkb.count == 8
        r = await client.post("/ingest/batch", json={"traces": []})
        assert (await r.json()) == {"ok": True, "n": 0, "failures": 0}

    run(_with_client(app, go))


def test_warn_flood_sheds_with_retry_after_and_loses_none(tmp_path, monkeypatch):
    """KAKVEDA_ADMIT_WARN=8 bounds the batcher's queue: a flood of 96
    concurrent warns from 3 apps, while each batch takes 200 ms, answers
    some 429s with Retry-After, and every request gets an answer."""
    monkeypatch.setenv("KAKVEDA_ADMIT_WARN", "8")
    plat = _platform(tmp_path / "d")
    plat.gfkb.upsert_failure(failure_type="HALLUCINATION_CITATION", app_id="app-A", impact_severity="medium",
                             signature_text=signature_text(CITE, [], {}))
    inner = plat.warn_batch
    plat.warn_batch = lambda reqs: time.sleep(0.2) or inner(reqs)
    app = make_app(plat)
    n = 96

    async def go(client):
        reqs = [client.post("/warn", json={"app_id": f"app-{i % 3}", "prompt": CITE, "tools": [], "env": {}})
                for i in range(n)]
        responses = await asyncio.gather(*reqs)
        out = []
        for r in responses:
            out.append((r.status, r.headers.get("Retry-After"), await r.json()))
        ready = await (await client.get("/readyz")).json()
        return out, ready, app[WARN_BATCHER_KEY]._depth()

    out, ready, depth = run(_with_client(app, go))
    plat.close()
    ok = [b for s, _, b in out if s == 200]
    shed = [(ra, b) for s, ra, b in out if s == 429]
    assert len(ok) + len(shed) == n and ok and shed, [s for s, _, _ in out]
    assert all(b["action"] == "warn" and b["references"][0]["failure_id"] == "F-0001" for b in ok)
    for ra, b in shed:
        assert ra is not None and int(ra) >= 1 and b["ok"] is False and b["retry_after"] > 0
        assert b["reason"] in ("queue_full", "tenant_quota")
    assert sum(ready["admission"]["sheds"].values()) == len(shed)
    assert ready["admission"]["classes"]["warn"]["limit"] == 8 and depth == 0


@pytest.mark.parametrize("admit", ["1", "0"])
def test_ingest_past_its_bound_sheds_before_parsing(tmp_path, monkeypatch, admit):
    # An ingest class bound of 0 sheds every request with the 429 shape,
    # unless admission is off (KAKVEDA_ADMIT=0 counts without shedding).
    monkeypatch.setenv("KAKVEDA_ADMIT_INGEST", "0")
    monkeypatch.setenv("KAKVEDA_ADMIT", admit)
    plat = _platform(tmp_path / "d")

    async def go(client):
        r = await client.post("/ingest/batch", data=b"not even json")
        return r.status, r.headers.get("Retry-After"), await r.json()

    status, ra, body = run(_with_client(make_app(plat), go))
    plat.close()
    if admit == "1":
        assert status == 429 and int(ra) >= 1 and body["reason"] == "queue_full" and body["retry_after"] > 0
    else:
        assert status == 422  # admitted, then refused by the parser


# --- parity with the JAX app ---------------------------------------------

_TS_KEYS = {"ts", "created_at", "updated_at"}


def _normalize(x):
    """Timestamps out; floats kept for the tolerance check."""
    if isinstance(x, dict):
        return {k: ("<ts>" if k in _TS_KEYS else _normalize(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [_normalize(v) for v in x]
    return x


def _assert_close(a, b, path="$"):
    """Equal structure; floats within SCORE_TOL, the rest equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert isinstance(b, (int, float)) and abs(a - b) <= SCORE_TOL, (path, a, b)
    elif isinstance(a, str) and "similarity=" in a:
        # The message repeats the score to two decimals.
        assert re.sub(r"similarity=[0-9.]+", "", a) == re.sub(r"similarity=[0-9.]+", "", b), path
    else:
        assert a == b, (path, a, b)


def _script():
    ids = [f"t-{i:04d}" for i in range(16)]
    prompts = [CITE, "Explain research paper and add references.", "Short answer with citations",
               "Summarize and add references"]
    return [
        ("post", "/ingest", {"trace": _trace("app-A", CITE, trace_id=ids[0])}),
        ("post", "/ingest", {"trace": _trace("app-B", prompts[1], trace_id=ids[1])}),
        ("post", "/ingest/batch", {"traces": [_trace(f"app-{'ABC'[i % 3]}", f"{prompts[i % 4]} {i}",
                                                     trace_id=ids[2 + i]) for i in range(8)]}),
        ("post", "/ingest", {"trace": _trace("app-C", "What's 2+2?", response="4", trace_id=ids[10])}),
        ("get", "/failures", None),
        ("get", "/patterns", None),
        ("get", "/health/app-A", None),
        ("get", "/health/app-A?limit=2", None),
        ("post", "/warn", {"app_id": "app-C", "prompt": CITE, "tools": [], "env": {"os": "linux"}}),
        ("post", "/warn", {"app_id": "app-D", "prompt": "Totally unrelated haiku request", "tools": [], "env": {}}),
        ("post", "/warn", {"app_id": "app-E", "prompt": prompts[2], "tools": ["search"], "env": {"os": "linux"}}),
        ("post", "/failures/match", {"signature_text": signature_text(CITE, [], {"os": "linux"})}),
        ("post", "/failures/match", {"signature_text": signature_text(CITE, [], {"os": "linux"}),
                                     "failure_type": "HALLUCINATION_CITATION"}),
        ("post", "/failures/upsert", {"failure_type": "TIMEOUT", "signature_text": "tool timed out",
                                      "app_id": "app-Z", "impact_severity": "high", "resolution": "retry"}),
        ("post", "/failures/upsert", {"failure_type": "TIMEOUT", "signature_text": "tool timed out",
                                      "app_id": "app-Y", "impact_severity": "high"}),
        ("post", "/patterns/upsert", {"name": "N", "failure_ids": ["F-0001"], "affected_apps": ["x", "y"]}),
        ("post", "/patterns/upsert", {"name": "N", "failure_ids": ["F-0002"], "description": "d"}),
        ("post", "/patterns/mine", {"threshold": 0.5}),
        ("post", "/patterns/mine", {"threshold": 0.5}),
        ("post", "/patterns/mine", {"mode": "full"}),
        ("post", "/publish", {"topic": "nobody.listens", "event": {"x": 1}}),
        ("post", "/ingest", {"trace": {"bad": "shape"}}),
        ("post", "/ingest/batch", {"traces": [{"bad": 1}]}),
        ("post", "/warn", {"nope": 1}),
        ("post", "/failures/upsert", {"failure_type": "X"}),
        ("post", "/failures/match", {}),
        ("post", "/patterns/mine", {"mode": "bogus"}),
        ("post", "/patterns/mine", {"threshold": "x"}),
        ("post", "/publish", {"topic": "t"}),
        ("get", "/failures", None),
        ("get", "/patterns", None),
        ("get", "/readyz", None),
    ]


async def _replay(app, script):
    async def fn(client):
        out = []
        for method, path, body in script:
            r = await getattr(client, method)(path, json=body) if body is not None else await getattr(client, method)(path)
            out.append((r.status, await r.json()))
        return out

    return await _with_client(app, fn)


_MINING_KEYS = ("mode", "rows", "clusters", "dirty_clusters", "threshold", "stale", "covers_all_rows")


def test_json_bodies_match_the_jax_app(tmp_path):
    script = _script()
    port_plat = _platform(tmp_path / "port")
    # One device, like the port's index (the JAX row-sharded merge breaks
    # exact ties shard-major, not by the lowest slot).
    jax_plat = JaxPlatform(data_dir=tmp_path / "jax", mesh=create_mesh("data:1"), capacity=256, dim=1024)
    port = run(_replay(make_app(port_plat), copy.deepcopy(script)))
    ref = run(_replay(jax_make_app(jax_plat, admission=JaxAdmission()), copy.deepcopy(script)))
    port_plat.close()
    jax_plat.gfkb.close()
    for (method, path, _), (ps, pb), (rs, rb) in zip(script, port, ref):
        assert ps == rs, (method, path, pb, rb)
        pb, rb = _normalize(pb), _normalize(rb)
        if path == "/readyz":
            assert pb["gfkb_count"] == rb["gfkb_count"] and pb["ok"] == rb["ok"]
            continue
        if path == "/patterns/mine" and ps == 200:
            pb["mining"] = {k: pb["mining"].get(k) for k in _MINING_KEYS}
            rb["mining"] = {k: rb["mining"].get(k) for k in _MINING_KEYS}
        _assert_close(pb, rb, f"{method} {path}")
    # The script reached every ported route and each 422 shape.
    assert sorted({s for s, _ in port}) == [200, 422]


# --- the normal entry point ------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_service(tmp_path, data):
    port = _free_port()
    env = dict(os.environ, KAKVEDA_INDEX_CAPACITY="256", KAKVEDA_LOG_FORMAT="text",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "kakveda_tpu_torch.service", "--port", str(port), "--data-dir", str(data),
         "--device", "cpu"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    return proc, f"http://127.0.0.1:{port}"


async def _wait_up(s, base, proc):
    for _ in range(600):
        try:
            async with s.get(base + "/healthz") as r:
                if r.status == 200:
                    return
        except OSError:
            pass
        if proc.poll() is not None:
            raise AssertionError("server exited early")
        await asyncio.sleep(0.1)
    raise AssertionError("server never answered /healthz")


def _stop_service(proc) -> str:
    """SIGINT, then the process's output; the exit code must be 0."""
    try:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = out.decode(errors="replace")
    assert proc.returncode == 0, text[-3000:]
    return text


_WARN = {"app_id": "z", "prompt": CITE, "tools": [], "env": {"os": "linux"}}


def test_module_entry_point_serves_and_stops_on_sigint(tmp_path):
    """``python -m kakveda_tpu_torch.service --device cpu`` starts, answers,
    and on SIGINT exits 0 with its log flushed; the data dir reopens."""
    data = tmp_path / "data"
    proc, base = _start_service(tmp_path, data)

    async def drive():
        async with ClientSession() as s:
            await _wait_up(s, base, proc)
            async with s.post(base + "/ingest/batch", json={"traces": [_trace("app-A", CITE)]}) as r:
                assert (await r.json())["failures"] == 1
            async with s.post(base + "/warn", json=_WARN) as r:
                body = await r.json()
                assert body["references"][0]["failure_id"] == "F-0001"

    try:
        run(drive())
    finally:
        _stop_service(proc)
    assert "F-0001" in (data / "failures.jsonl").read_text()
    replayed = _platform(data)
    assert replayed.gfkb.count == 1
    replayed.close()


def test_entry_point_snapshots_on_sigint_and_restores_on_restart(tmp_path):
    """SIGINT leaves a v5 snapshot of every record; the next start restores
    it (its log says so, ``/failures`` counts the records, the mining state
    is served incrementally) and ``/warn`` answers as before the restart."""
    data = tmp_path / "data"
    prompts = [CITE, "Explain research paper and add references.",
               "Summarize report 7 and include citations even if not provided."]

    async def drive(proc, base, ingest):
        async with ClientSession() as s:
            await _wait_up(s, base, proc)
            if ingest:
                traces = [_trace(f"app-{i % 2}", p) for i, p in enumerate(prompts)]
                async with s.post(base + "/ingest/batch", json={"traces": traces}) as r:
                    assert (await r.json())["failures"] == 3
            async with s.get(base + "/failures") as r:
                count = len((await r.json())["failures"])
            async with s.post(base + "/warn", json=_WARN) as r:
                warn = await r.json()
            async with s.post(base + "/patterns/mine", json={}) as r:
                mode = (await r.json())["mining"]["mode"]
            return count, warn, mode

    proc, base = _start_service(tmp_path, data)
    try:
        count, warn, _ = run(drive(proc, base, ingest=True))
    finally:
        first = _stop_service(proc)
    assert count == 3 and warn["references"]
    assert "gfkb snapshot written (3 entries)" in first
    manifest = json.loads((data / "snapshot" / "manifest.json").read_text())
    assert manifest["version"] == 5 and manifest["n"] == 3 and "mine" in manifest

    proc, base = _start_service(tmp_path, data)
    try:
        count2, warn2, mode2 = run(drive(proc, base, ingest=False))
    finally:
        second = _stop_service(proc)
    assert "restored a snapshot of 3 rows" in second and "restored from a snapshot: 3" in second
    assert count2 == 3 and mode2 == "incremental"
    assert [(r["failure_id"], r["score"]) for r in warn2["references"]] == [
        (r["failure_id"], r["score"]) for r in warn["references"]
    ]
    assert (warn2["action"], warn2["confidence"]) == (warn["action"], warn["confidence"])
