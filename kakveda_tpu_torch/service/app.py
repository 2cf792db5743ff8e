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
                               registry (``core/metrics.py``)
  GET  /flightrecorder         every live flight recorder's ring (each
                               serving engine's request timelines, cancels,
                               deadlines, loop deaths and restarts; the
                               admission, device-health and sanitizer
                               recorders)
  GET  /trace                  the span ring and its counters
                               (``core/trace.py``); ``?n=`` the last n
  GET  /trace/{trace_id}       one trace's spans

The request plane, as the reference has it: every request runs inside a
``service.request`` span (the incoming W3C ``traceparent`` is its parent,
else the request id is its trace id) and past the ``service.handler``
fault site (armed: a clean 500); ``/ingest`` and ``/ingest/batch`` pass
the per-client token bucket (``KAKVEDA_RATELIMIT_RPS`` / ``_BURST``: a
429 with ``reason: "ratelimit"``) and run under a ``gfkb.ingest`` span;
``/warn`` runs under a ``gfkb.warn`` span carrying the answer's tier,
nprobe, degraded flag, native availability and action, and observes
``kakveda_warn_request_seconds`` with its trace id as the exemplar.
Admission is the process-global controller (``core/admission.py``), so
the serving engine and this app see one pressure picture and one
brownout ladder, whose step ``/readyz`` reports. With ``KAKVEDA_SANITIZE``
set the app runs the loop-stall watchdog (``core/sanitize.py``); with
``KAKVEDA_OTEL_ENABLED`` and the SDK present, the OTel server-span
middleware (``core/otel.py``).

Not registered yet, so they answer 404, with the ROADMAP Queue 1 item that
brings each:

  /subscribe /unsubscribe      item 6 (the port's bus refuses URL
                               subscribers)
  /replicate /fleet/* /metrics/fleet  item 6

Traffic capture belongs to the traffic plane and is not ported. The
reference's ``KAKVEDA_WARN_RTT_EMU_MS`` emulates a TPU tunnel's round trip
and has no counterpart on a local card.
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
from kakveda_tpu_torch.core import admission as _admission
from kakveda_tpu_torch.core import faults as _faults
from kakveda_tpu_torch.core import metrics as _metrics
from kakveda_tpu_torch.core import otel
from kakveda_tpu_torch.core import sanitize
from kakveda_tpu_torch.core import trace as _trace
from kakveda_tpu_torch.core.admission import DeviceUnavailableError, OverloadError
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
_STALL_WATCHDOG_KEY: web.AppKey[object] = web.AppKey("sanitize_stall_watchdog", object)

# Chaos site for the HTTP tier, resolved once at import: an armed
# service.handler fault turns a request into a clean 500 before its
# handler runs.
_FAULT_HANDLER = _faults.site("service.handler")


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
    a shed anywhere under the handler becomes the one 429 shape, a device
    path refused while degraded the one 503, and an armed
    ``service.handler`` a clean 500.

    The request runs inside a ``service.request`` span: the incoming W3C
    ``traceparent`` is its parent, else a new root whose trace id is the
    request id (32 hex), so logs, the echoed header and the span tree join
    on one key. Handlers reach the span as ``request["trace_span"]``. When
    the otel middleware runs outside this one it already resolved the
    request id; it is reused."""
    cfg = get_runtime_config(service_name="kakveda-tpu-torch")
    rid = request.get("request_id") or ensure_request_id(request.headers.get(cfg.request_id_header))
    span = _trace.get_tracer().start_span(
        "service.request",
        traceparent=request.headers.get(_trace.TRACEPARENT_HEADER),
        trace_id=rid,
        path=request.path,
        method=request.method,
        rid=rid,
    )
    request["trace_span"] = span
    span.activate()
    started = time.perf_counter()
    try:
        _FAULT_HANDLER.fire()
        response = await handler(request)
    except _faults.FaultInjected as e:
        response = _json_error(500, str(e))
    except OverloadError as e:
        response = overload_response(e)
    except DeviceUnavailableError as e:
        response = degraded_response(e)
    except web.HTTPException as e:
        e.headers[cfg.request_id_header] = rid
        span.deactivate()
        span.end(
            "error" if e.status >= 500 else "shed" if e.status == 429 else span.outcome,
            status=e.status,
        )
        raise
    except BaseException:
        span.deactivate()
        span.end("error")
        raise
    response.headers[cfg.request_id_header] = rid
    span.deactivate()
    span.end(
        "shed" if response.status == 429
        else "degraded" if response.status == 503
        else "error" if response.status >= 500
        else span.outcome,  # a 200 degraded warn may have marked it
        status=response.status,
    )
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
    Prometheus text), ``GET /flightrecorder`` (every live recorder's ring
    as JSON), ``GET /trace`` (the span ring and its counters; ``?n=`` the
    last n) and ``GET /trace/{trace_id}`` (one trace's spans). One registry
    and one tracer per process, so any app that mounts them shows the
    whole picture."""

    async def metrics_ep(request):
        return web.Response(
            body=_metrics.get_registry().render().encode("utf-8"),
            headers={"Content-Type": _metrics.PROMETHEUS_CONTENT_TYPE},
        )

    async def flightrecorder_ep(request):
        return web.json_response({"recorders": _metrics.dump_recorders()})

    async def trace_ring_ep(request):
        tr = _trace.get_tracer()
        try:
            limit = int(request.query["n"]) if "n" in request.query else None
        except ValueError:
            limit = None
        return web.json_response({"plane": tr.plane(), "spans": tr.dump(limit=limit)})

    async def trace_one_ep(request):
        tid = request.match_info["trace_id"]
        return web.json_response({"trace_id": tid, "spans": _trace.get_tracer().dump(tid)})

    return [
        web.get("/metrics", metrics_ep),
        web.get("/flightrecorder", flightrecorder_ep),
        web.get("/trace", trace_ring_ep),
        web.get("/trace/{trace_id}", trace_one_ep),
    ]


def make_app(
    platform: Optional[Platform] = None,
    admission: Optional[_admission.AdmissionController] = None,
    **platform_kw,
) -> web.Application:
    """The API over ``platform`` (or a ``Platform(**platform_kw)``). The
    native library loads here, before the first request: a ``g++`` build
    inside a request thread would stall that request for seconds
    (``KAKVEDA_NATIVE=require`` raises here if it cannot build).
    ``admission`` defaults to the process-global controller; tests may
    pass a private one."""
    native.load()
    plat = platform or Platform(**platform_kw)
    adm = admission if admission is not None else _admission.get_admission()
    health = _admission.get_device_health()
    device = _device_info(plat.device)

    # Optional per-client token bucket (KAKVEDA_RATELIMIT_RPS) on the
    # ingest routes — the same 429 shape as admission sheds.
    rl_rps = float(os.environ.get("KAKVEDA_RATELIMIT_RPS", "0") or 0)
    bucket = None
    if rl_rps > 0:
        from kakveda_tpu_torch.core.ratelimit import TokenBucket

        burst = os.environ.get("KAKVEDA_RATELIMIT_BURST")
        bucket = TokenBucket(rl_rps, float(burst) if burst else None)

    def _ratelimit(request) -> None:
        if bucket is None:
            return
        ok, ra = bucket.allow(request.remote or "anon")
        if not ok:
            adm.note_shed("ingest", "ratelimit", retry_after=ra)
            raise OverloadError(
                f"per-client rate limit exceeded ({rl_rps:g} rps)",
                retry_after=ra, klass="ingest", reason="ratelimit",
            )

    middlewares = [request_context_middleware]
    if otel.setup_otel("platform"):
        middlewares.insert(0, otel.otel_middleware())
    app = web.Application(middlewares=middlewares)

    # Trace provenance resolved once at construction: warn spans note
    # whether the native scorer could have served them.
    _trace.get_tracer().service = os.environ.get("KAKVEDA_REPLICA_ID", "")
    native_avail = bool(native.status().get("available"))
    h_warn = _metrics.get_registry().histogram(
        "kakveda_warn_request_seconds",
        "End-to-end /warn wall inside the service handler "
        "(exemplar-linked to its trace id)",
    )

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
        if sanitize.enabled():
            # Loop-stall watchdog: stalls past KAKVEDA_SANITIZE_STALL_MS
            # dump the loop thread's stack to the sanitizer flight recorder.
            wd = sanitize.LoopStallWatchdog()
            await wd.start()
            app[_STALL_WATCHDOG_KEY] = wd

    async def _on_cleanup(app):
        wd = app.get(_STALL_WATCHDOG_KEY)
        if wd is not None:
            await wd.stop()
        await warn_batcher.stop()

    app.on_startup.append(_on_startup)
    app.on_cleanup.append(_on_cleanup)

    # --- liveness -------------------------------------------------------

    async def healthz(request):
        return web.json_response({"ok": True})

    async def readyz(request):
        """Readiness with the mode: a degraded platform still answers warns
        from the host tiers, so ``ok`` stays true and ``device.degraded``
        says how; ``admission`` carries the brownout ladder's step."""
        return web.json_response(
            {
                "ok": True,
                "gfkb_count": plat.gfkb.count,
                "device": {**device, **health.info()},
                "admission": adm.info(),
                "tiers": plat.gfkb.tiers_info(),
                "native": native.status(),
            }
        )

    # --- ingest ---------------------------------------------------------

    async def ingest(request):
        # Admission runs BEFORE the body is parsed: a shed must cost
        # microseconds, not a JSON decode and a pydantic pass.
        _ratelimit(request)
        with adm.slot("ingest"):
            try:
                req = IngestRequest.model_validate(await request.json())
            except (ValidationError, ValueError) as e:
                return _json_error(422, str(e))
            with _trace.get_tracer().start_span("gfkb.ingest", app_id=req.trace.app_id, n=1):
                await plat.ingest(req.trace)
        return web.json_response({"ok": True, "trace_id": req.trace.trace_id})

    async def ingest_batch(request):
        """One validate + one device scatter per batch; answers the batch's
        failure count."""
        _ratelimit(request)
        with adm.slot("ingest"):
            try:
                req = IngestBatchRequest.model_validate(await request.json())
            except (ValidationError, ValueError) as e:
                return _json_error(422, str(e))
            if not req.traces:
                return web.json_response({"ok": True, "n": 0, "failures": 0})
            with _trace.get_tracer().start_span(
                "gfkb.ingest", app_id=req.traces[0].app_id, n=len(req.traces)
            ):
                signals = await plat.ingest_batch(req.traces)
        return web.json_response({"ok": True, "n": len(req.traces), "failures": len(signals)})

    # --- warn -----------------------------------------------------------

    async def warn(request):
        try:
            req = WarningRequest.model_validate(await request.json())
        except (ValidationError, ValueError) as e:
            return _json_error(422, str(e))
        # The batcher's bounded queue is the warn class's shed point; a
        # degraded card still answers here through the host tiers.
        t0 = time.perf_counter()
        with _trace.get_tracer().start_span("gfkb.warn", app_id=req.app_id) as gspan:
            res = await warn_batcher.submit(req)
            gspan.set(
                tier=res.tier, nprobe=res.nprobe, degraded=res.degraded,
                native=native_avail, action=res.action,
            )
            if res.degraded:
                gspan.outcome = "degraded"
                parent = request.get("trace_span")
                if parent is not None:
                    parent.outcome = "degraded"
        h_warn.observe(time.perf_counter() - t0, exemplar=gspan.trace_id or None)
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
