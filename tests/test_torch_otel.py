"""The port's OpenTelemetry bridge (``kakveda_tpu_torch/core/otel.py``)
against the JAX package's, on the CPU.

``setup_otel`` installs a global tracer provider, which a process can do
once, so the gate runs each package in its own subprocess: with
``KAKVEDA_OTEL_ENABLED`` unset both answer False; set, both answer True
when the OTel SDK is importable and False when it is not (the
reference's best-effort gate; a machine with only ``opentelemetry-api``
answers False). ``export_native_span`` is held to the reference through a
recording tracer that stands in for the SDK's: the same span dicts give
the same span names, start and end times, attributes and status in both
packages, and the port's span ring bridges each recorded span through it.
Nothing is masked.
"""

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from kakveda_tpu.core import otel as jax_otel
from kakveda_tpu_torch.core import otel as port_otel
from kakveda_tpu_torch.core import trace as port_trace

ROOT = Path(__file__).resolve().parent.parent


class _RecordingSpan:
    def __init__(self, log, name, start_time):
        self.rec = {"name": name, "start": start_time, "attrs": {}, "status": None, "end": None}
        log.append(self.rec)

    def set_attribute(self, k, v):
        self.rec["attrs"][k] = v

    def set_status(self, status):
        self.rec["status"] = str(status.status_code)

    def end(self, end_time=None):
        self.rec["end"] = end_time


class _RecordingTracer:
    def __init__(self):
        self.log = []

    def start_span(self, name, start_time=None):
        return _RecordingSpan(self.log, name, start_time)


SPANS = [
    {"trace_id": "0af7651916cd43dd8448eb211c80319c", "span_id": "b7ad6b7169203331", "parent_id": None,
     "name": "service.request", "ts": 1700000000.25, "dur_ms": 12.5, "outcome": "ok",
     "attrs": {"path": "/warn", "method": "POST", "status": 200}},
    {"trace_id": "0af7651916cd43dd8448eb211c80319c", "span_id": "c7ad6b7169203332",
     "parent_id": "b7ad6b7169203331", "name": "gfkb.warn", "ts": 1700000000.251, "dur_ms": 3.25,
     "outcome": "degraded", "service": "r1",
     "attrs": {"tier": "warm", "nprobe": None, "degraded": True, "native": False, "action": "warn",
               "obj": {"x": 1}}},
    {"trace_id": "1af7651916cd43dd8448eb211c80319c", "span_id": "d7ad6b7169203333", "parent_id": None,
     "name": "serving.request", "ts": 1700000001.0, "dur_ms": 250.0, "outcome": "error",
     "attrs": {"engine": "e0", "tokens": 7, "ttft_ms": 1.5}},
    {},
]


@pytest.mark.parametrize("i", range(len(SPANS)))
def test_export_native_span_matches_jax(monkeypatch, i):
    out = {}
    for name, mod in (("jax", jax_otel), ("port", port_otel)):
        tr = _RecordingTracer()
        monkeypatch.setattr(mod, "_tracer", tr)
        mod.export_native_span(SPANS[i])
        out[name] = tr.log
    assert out["port"] == out["jax"]
    assert len(out["port"]) == (1 if SPANS[i] else 0)


def test_port_ring_bridges_recorded_spans(monkeypatch):
    tr = _RecordingTracer()
    monkeypatch.setattr(port_otel, "_tracer", tr)
    tracer = port_trace.Tracer(capacity=8, sample=1.0)
    with tracer.start_span("service.request", path="/warn"):
        tracer.start_span("gfkb.warn", app_id="a").end("ok", tier="hot")
    assert [s["name"] for s in tr.log] == ["gfkb.warn", "service.request"]
    assert tr.log[0]["attrs"]["tier"] == "hot" and tr.log[0]["attrs"]["kakveda.outcome"] == "ok"


_CHILD = r"""
import asyncio, importlib, json, sys
otel = importlib.import_module(sys.argv[1])
ok = otel.setup_otel("test")
try:
    import opentelemetry.sdk  # noqa: F401
    sdk = True
except ImportError:
    sdk = False
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

async def go():
    app = web.Application(middlewares=[otel.otel_middleware()])

    async def hello(request):
        return web.json_response({"ok": True})

    app.router.add_get("/", hello)
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.get("/")
        return r.status
    finally:
        await client.close()

print(json.dumps({"enabled": ok, "tracer": otel.get_tracer() is not None, "sdk": sdk,
                  "status": asyncio.run(go())}))
"""


@pytest.mark.parametrize("enabled", ["", "1"])
def test_setup_gate_matches_jax(enabled):
    env = dict(os.environ)
    env.pop("OTEL_EXPORTER_OTLP_ENDPOINT", None)
    if enabled:
        env["KAKVEDA_OTEL_ENABLED"] = enabled
    else:
        env.pop("KAKVEDA_OTEL_ENABLED", None)
    out = {}
    for name, mod in (("jax", "kakveda_tpu.core.otel"), ("port", "kakveda_tpu_torch.core.otel")):
        r = subprocess.run([sys.executable, "-c", _CHILD, mod], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        out[name] = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["port"] == out["jax"]
    want = bool(enabled) and out["port"]["sdk"]
    assert out["port"]["enabled"] is want and out["port"]["tracer"] is want
    assert out["port"]["status"] == 200


def test_otel_middleware_is_a_no_op_when_off(monkeypatch):
    monkeypatch.setattr(port_otel, "_tracer", None)

    async def go():
        app = web.Application(middlewares=[port_otel.otel_middleware()])

        async def hello(request):
            return web.json_response({"ok": True})

        app.router.add_get("/", hello)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.get("/")
            return r.status, await r.json()
        finally:
            await client.close()

    assert asyncio.run(go()) == (200, {"ok": True})
