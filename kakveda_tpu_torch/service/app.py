"""The port's HTTP surface — the reference's REST contracts on one port.

Port of ``kakveda_tpu/service/app.py`` for the failure-memory loop, served
from the torch ``Platform`` (the index on the card). Route map:

  GET  /healthz /readyz        liveness; readiness with the GFKB count,
                               admission occupancy, the native library's
                               status, the device (the card's name and
                               the device-loss latch) and the GFKB's
                               tiers (residency, routing, degraded warns)
  POST /ingest                 one trace (publish trace.ingested)
  POST /ingest/batch           a batch: one classify, one featurize, one
                               device scatter, one mining delta
  POST /warn                   through the MicroBatcher: concurrent warns
                               share one ``fused_topk`` launch
  GET  /failures               the GFKB's records
  POST /failures/match         top-k of one signature
  POST /failures/upsert        one versioned upsert (no replication: the
                               port has no peers)
  GET  /patterns               pattern entities
  POST /patterns/upsert        identity-by-name pattern upsert
  POST /patterns/mine          incremental or full-sweep mining
  POST /snapshot               a GFKB snapshot (a restart restores it and
                               replays only the log tail); 409 when the
                               store cannot take one (persist=False, or
                               a reload aborted it)
  GET  /health/{app_id}        health points
  POST /publish, GET /topics   the in-process bus
  GET  /metrics                Prometheus text of the process-global
                               registry (``core/metrics.py``: the serving
                               engine's families and the fault sites')
  GET  /flightrecorder         every live flight recorder's ring (each
                               serving engine's request timelines, cancels,
                               deadlines, loop deaths and restarts)

Not registered yet, so they answer 404, with the ROADMAP Queue 1 item that
brings each:

  /subscribe /unsubscribe      item 6 (the port's bus refuses URL
                               subscribers)
  /replicate /fleet/* /metrics/fleet  item 6
  /trace /trace/{trace_id}     item 5 (``core/trace.py``)

Also left for item 5: the per-client rate limiter, traffic capture, otel,
the service's fault sites and the loop-stall watchdog. The reference's
``KAKVEDA_WARN_RTT_EMU_MS`` emulates a TPU tunnel's round trip and has no
counterpart on a local card.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Optional

import torch
from aiohttp import web
from pydantic import ValidationError

from kakveda_tpu_torch import native
from kakveda_tpu_torch.core import metrics as _metrics
from kakveda_tpu_torch.core.admission import (
    AdmissionController,
    DeviceUnavailableError,
    OverloadError,
    get_device_health,
)
from kakveda_tpu_torch.core.runtime import ensure_request_id, get_runtime_config
from kakveda_tpu_torch.core.schemas import (
    FailureMatchRequest,
    IngestBatchRequest,
    IngestRequest,
    Severity,
    WarningRequest,
)
from kakveda_tpu_torch.index.gfkb import SnapshotError
from kakveda_tpu_torch.platform import Platform
from kakveda_tpu_torch.service.batcher import MicroBatcher

log = logging.getLogger("kakveda.service")

WARN_BATCHER_KEY: web.AppKey[MicroBatcher] = web.AppKey("warn_batcher", MicroBatcher)


def _json_error(status: int, message: str) -> web.Response:
    return web.json_response({"ok": False, "error": message}, status=status)


def overload_response(e: OverloadError) -> web.Response:
    """THE 429 shape: a ``Retry-After`` header plus the hint repeated in
    the JSON body for clients that only read bodies."""
    return web.json_response(
        {
            "ok": False,
            "error": str(e),
            "retry_after": round(e.retry_after, 2),
            "reason": e.reason or "overload",
        },
        status=429,
        headers={"Retry-After": str(max(1, int(round(e.retry_after))))},
    )


def degraded_response(e: DeviceUnavailableError) -> web.Response:
    """503 for device-loss degraded mode: retryable by contract (the probe
    un-latches when the card answers again)."""
    return web.json_response(
        {
            "ok": False,
            "error": str(e),
            "retry_after": round(e.retry_after, 2),
            "degraded": True,
        },
        status=503,
        headers={"Retry-After": str(max(1, int(round(e.retry_after))))},
    )


@web.middleware
async def request_context_middleware(request: web.Request, handler):
    """Request id (echoed in the configured header) + duration logging;
    a shed anywhere under the handler becomes the one 429 shape, and a
    device path refused while degraded the one 503."""
    cfg = get_runtime_config(service_name="kakveda-tpu-torch")
    rid = ensure_request_id(request.headers.get(cfg.request_id_header))
    started = time.perf_counter()
    try:
        response = await handler(request)
    except OverloadError as e:
        response = overload_response(e)
    except DeviceUnavailableError as e:
        response = degraded_response(e)
    except web.HTTPException as e:
        e.headers[cfg.request_id_header] = rid
        raise
    response.headers[cfg.request_id_header] = rid
    log.info(
        "request",
        extra={
            "request_id": rid,
            "path": request.path,
            "method": request.method,
            "status_code": response.status,
            "duration_ms": int((time.perf_counter() - started) * 1000),
        },
    )
    return response


def _device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"type": "cuda", "name": torch.cuda.get_device_name(device), "count": torch.cuda.device_count()}
    return {"type": device.type, "name": device.type, "count": 1}


def metrics_routes() -> list:
    """The metrics plane's routes: ``GET /metrics`` (the registry's
    Prometheus text) and ``GET /flightrecorder`` (every live recorder's
    ring as JSON). One registry per process, so any app that mounts them
    shows the whole picture."""

    async def metrics_ep(request):
        return web.Response(
            body=_metrics.get_registry().render().encode("utf-8"),
            headers={"Content-Type": _metrics.PROMETHEUS_CONTENT_TYPE},
        )

    async def flightrecorder_ep(request):
        return web.json_response({"recorders": _metrics.dump_recorders()})

    return [web.get("/metrics", metrics_ep), web.get("/flightrecorder", flightrecorder_ep)]


def make_app(platform: Optional[Platform] = None, **platform_kw) -> web.Application:
    """The API over ``platform`` (or a ``Platform(**platform_kw)``). The
    native library loads here, before the first request: a ``g++`` build
    inside a request thread would stall that request for seconds
    (``KAKVEDA_NATIVE=require`` raises here if it cannot build)."""
    native.load()
    plat = platform or Platform(**platform_kw)
    adm = AdmissionController()
    device = _device_info(plat.device)

    app = web.Application(middlewares=[request_context_middleware])

    # KAKVEDA_WARN_MAX_BATCH coalesced requests per device call,
    # KAKVEDA_WARN_DEADLINE_MS straggler wait; the queue is bounded by the
    # warn class's admission limit, and batches are composed fairly across
    # app ids.
    warn_max_batch = int(os.environ.get("KAKVEDA_WARN_MAX_BATCH", "64") or 64)
    warn_deadline_s = float(os.environ.get("KAKVEDA_WARN_DEADLINE_MS", "2") or 2) / 1e3
    warn_batcher: MicroBatcher = MicroBatcher(
        plat.warn_batch, max_batch=warn_max_batch, deadline_s=warn_deadline_s,
        max_queue=adm.limits["warn"], admission=adm,
        tenant_key=lambda r: r.app_id,
    )
    app[WARN_BATCHER_KEY] = warn_batcher

    async def _on_startup(app):
        warn_batcher.start()

    async def _on_cleanup(app):
        await warn_batcher.stop()

    app.on_startup.append(_on_startup)
    app.on_cleanup.append(_on_cleanup)

    # --- liveness -------------------------------------------------------

    async def healthz(request):
        return web.json_response({"ok": True})

    async def readyz(request):
        """Readiness with the mode: a degraded platform still answers warns
        from the host tiers, so ``ok`` stays true and ``device.degraded``
        says how."""
        return web.json_response(
            {
                "ok": True,
                "gfkb_count": plat.gfkb.count,
                "device": {**device, **get_device_health().info()},
                "admission": adm.info(),
                "tiers": plat.gfkb.tiers_info(),
                "native": native.status(),
            }
        )

    # --- ingest ---------------------------------------------------------

    async def ingest(request):
        # Admission runs BEFORE the body is parsed: a shed must cost
        # microseconds, not a JSON decode and a pydantic pass.
        with adm.slot("ingest"):
            try:
                req = IngestRequest.model_validate(await request.json())
            except (ValidationError, ValueError) as e:
                return _json_error(422, str(e))
            await plat.ingest(req.trace)
        return web.json_response({"ok": True, "trace_id": req.trace.trace_id})

    async def ingest_batch(request):
        """One validate + one device scatter per batch; answers the batch's
        failure count."""
        with adm.slot("ingest"):
            try:
                req = IngestBatchRequest.model_validate(await request.json())
            except (ValidationError, ValueError) as e:
                return _json_error(422, str(e))
            if not req.traces:
                return web.json_response({"ok": True, "n": 0, "failures": 0})
            signals = await plat.ingest_batch(req.traces)
        return web.json_response({"ok": True, "n": len(req.traces), "failures": len(signals)})

    # --- warn -----------------------------------------------------------

    async def warn(request):
        try:
            req = WarningRequest.model_validate(await request.json())
        except (ValidationError, ValueError) as e:
            return _json_error(422, str(e))
        res = await warn_batcher.submit(req)
        return web.json_response(res.model_dump())

    # --- GFKB -----------------------------------------------------------

    async def list_failures(request):
        return web.json_response({"failures": [f.model_dump(mode="json") for f in plat.failures()]})

    async def match(request):
        try:
            req = FailureMatchRequest.model_validate(await request.json())
        except (ValidationError, ValueError) as e:
            return _json_error(422, str(e))
        matches = plat.gfkb.match(req.signature_text, failure_type=req.failure_type)
        return web.json_response({"matches": [m.model_dump() for m in matches]})

    async def upsert_failure(request):
        try:
            body = await request.json()
            rec, created = plat.gfkb.upsert_failure(
                failure_type=body["failure_type"],
                signature_text=body["signature_text"],
                app_id=body["app_id"],
                impact_severity=Severity(body["impact_severity"]),
                context_signature=body.get("context_signature"),
                root_cause=body.get("root_cause"),
                resolution=body.get("resolution"),
            )
        except (KeyError, ValueError, ValidationError) as e:
            return _json_error(422, str(e))
        return web.json_response({"ok": True, "created": created, "failure": rec.model_dump(mode="json")})

    async def list_patterns(request):
        return web.json_response({"patterns": [p.model_dump(mode="json") for p in plat.patterns_list()]})

    async def upsert_pattern(request):
        try:
            body = await request.json()
            p, created = plat.gfkb.upsert_pattern(
                name=body["name"],
                failure_ids=body.get("failure_ids", []),
                affected_apps=body.get("affected_apps", []),
                description=body.get("description"),
            )
        except (KeyError, ValueError, ValidationError) as e:
            return _json_error(422, str(e))
        return web.json_response({"ok": True, "created": created, "pattern": p.model_dump(mode="json")})

    async def mine_patterns(request):
        """Pattern mining over the GFKB. Body (all optional):
        {"threshold": 0.6, "mode": "auto"|"full"|"incremental"}. The
        response carries the freshness fields of ``Platform.mine``."""
        try:
            body = await request.json()
        except Exception:  # noqa: BLE001 — an empty or non-JSON body means the defaults
            body = {}
        try:
            threshold = float(body.get("threshold", 0.6))
        except (TypeError, ValueError, AttributeError):
            return _json_error(422, "threshold must be a number")
        mode = body.get("mode", "auto") if isinstance(body, dict) else "auto"
        if mode not in ("auto", "full", "incremental"):
            return _json_error(422, "mode must be auto|full|incremental")
        loop = asyncio.get_running_loop()
        with adm.slot("background"):
            found, info = await loop.run_in_executor(None, plat.mine, threshold, mode)
        return web.json_response(
            {"ok": True, "patterns": [p.model_dump(mode="json") for p in found], "mining": info}
        )

    async def snapshot(request):
        """Point-in-time GFKB snapshot, written off the event loop in a
        background admission slot."""
        loop = asyncio.get_running_loop()
        try:
            with adm.slot("background"):
                path = await loop.run_in_executor(None, plat.gfkb.snapshot)
        except SnapshotError as e:  # persist=False, or aborted by a reload
            return _json_error(409, str(e))
        return web.json_response({"ok": True, "path": str(path), "entries": plat.gfkb.count})

    # --- health + bus ---------------------------------------------------

    async def app_health(request):
        app_id = request.match_info["app_id"]
        limit = min(max(int(request.query.get("limit", 50)), 1), 500)
        return web.json_response({"app_id": app_id, "points": plat.health_history(app_id, limit)})

    async def publish(request):
        body = await request.json()
        topic, event = body.get("topic"), body.get("event")
        if not topic or event is None:
            return _json_error(422, "topic and event required")
        delivered = await plat.bus.publish(topic, event)
        return web.json_response({"ok": True, "delivered": delivered})

    async def topics(request):
        return web.json_response({"topics": plat.bus.topics()})

    app.add_routes(
        [
            web.get("/healthz", healthz),
            web.get("/readyz", readyz),
            web.post("/ingest", ingest),
            web.post("/ingest/batch", ingest_batch),
            web.post("/warn", warn),
            web.get("/failures", list_failures),
            web.post("/failures/match", match),
            web.post("/failures/upsert", upsert_failure),
            web.get("/patterns", list_patterns),
            web.post("/patterns/upsert", upsert_pattern),
            web.post("/patterns/mine", mine_patterns),
            web.post("/snapshot", snapshot),
            web.get("/health/{app_id}", app_health),
            web.post("/publish", publish),
            web.get("/topics", topics),
        ]
    )
    app.add_routes(metrics_routes())
    return app
