"""The port's HTTP surface — the reference's REST contracts on one port.

Port of ``kakveda_tpu/service/app.py`` for the failure-memory loop, served
from the torch ``Platform`` (the index on the card). Route map:

  GET  /healthz /readyz        liveness; readiness with the GFKB count,
                               admission occupancy, the native library's
                               status, the device (the card's name, the
                               device-loss latch and this process's
                               ``fused_topk`` launches) and the GFKB's
                               tiers (residency, routing, degraded warns)
  POST /ingest                 one trace (publish trace.ingested)
  POST /ingest/batch           a batch: one classify, one featurize, one
                               device scatter, one mining delta
  POST /warn                   through the MicroBatcher: concurrent warns
                               share one ``fused_topk`` launch
  GET  /failures               the GFKB's records
  POST /failures/match         top-k of one signature
  POST /failures/upsert        one versioned upsert, replicated to the
                               peers as ingest rows are
  GET  /patterns               pattern entities
  POST /patterns/upsert        identity-by-name pattern upsert
  POST /patterns/mine          incremental or full-sweep mining
  POST /snapshot               a GFKB snapshot (a restart restores it and
                               replays only the log tail); 409 when the
                               store cannot take one (persist=False, or
                               a reload aborted it)
  GET  /health/{app_id}        health points
  POST /subscribe /unsubscribe a callback URL on a bus topic (durable,
                               at-least-once: retries, breaker, DLQ)
  POST /publish, GET /topics   the bus
  POST /replicate              apply one peer's replication event
                               (idempotent by event id; the ownership
                               epoch fence first)
  POST /fleet/gossip           fold one peer's control sample
  GET|POST /fleet/ownership    the acknowledged ownership view; a push
                               of a newer epoch swaps it (monotonic)
  POST /fleet/export           a range migration's export (control
                               plane, off the loop, at most 2 at once)
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

A replica spawned by the fleet supervisor (``fleet/supervisor.py``) reads
its identity from the env: ``KAKVEDA_REPLICA_ID``, ``KAKVEDA_FLEET_PEERS``
(legacy full replication: every peer's ``/replicate`` and
``/fleet/gossip`` subscribe on the bus), or, under
``KAKVEDA_FLEET_OWNERSHIP=1``, ``KAKVEDA_FLEET_MEMBERS`` with
``KAKVEDA_FLEET_REPLICATION`` (one replication topic per peer, the view
persisted in ``data_dir/ownership.json``). A gossip task publishes the
replica's control sample every ``KAKVEDA_FLEET_GOSSIP_S``; ``/readyz``
carries the ``fleet`` view (and ``ownership`` with the resident rows by
role). The ``fleet.replicate_apply`` fault site fails an apply with a
clean 500. ``/metrics/fleet`` belongs to the router (``fleet/router.py``).

Traffic capture (``kakveda_tpu_torch/traffic/capture.py``): every warn and
ingest arrival lands in a bounded ``FlightRecorder("traffic")`` ring, shown
by ``GET /flightrecorder``, which ``cli traffic record`` converts into a
replayable log (``KAKVEDA_TRAFFIC_CAPTURE=0`` turns it off,
``KAKVEDA_TRAFFIC_CAPTURE_N`` sizes the ring, default 2048). The
reference's ``KAKVEDA_WARN_RTT_EMU_MS`` emulates a TPU tunnel's round trip
and has no counterpart on a local card.

:func:`make_agent_echo_app` is the reference's external-agent contract
(``/health``, ``/capabilities``, ``/invoke``), which
``python -m kakveda_tpu_torch.service.agent_echo`` serves on its own; the
dashboard's agent registry and playground call it.
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
from kakveda_tpu_torch.events.bus import (
    TOPIC_FLEET_CONTROL,
    TOPIC_GFKB_REPLICATE,
    TOPIC_GFKB_REPLICATE_PREFIX,
    replicate_topic,
)
from kakveda_tpu_torch.fleet.gossip import FleetView, GossipPublisher
from kakveda_tpu_torch.fleet.ownership import (
    OwnershipState,
    OwnershipView,
    parse_members,
    plan_targets,
    responsible_source,
    shard_key_of_row,
)
from kakveda_tpu_torch.index.gfkb import SnapshotError
from kakveda_tpu_torch.ops.fused_topk import fused_topk
from kakveda_tpu_torch.platform import Platform
from kakveda_tpu_torch.service.batcher import MicroBatcher

log = logging.getLogger("kakveda.service")

WARN_BATCHER_KEY: web.AppKey[MicroBatcher] = web.AppKey("warn_batcher", MicroBatcher)
_GOSSIP_TASK_KEY: web.AppKey[object] = web.AppKey("fleet_gossip_task", object)
_STALL_WATCHDOG_KEY: web.AppKey[object] = web.AppKey("sanitize_stall_watchdog", object)

# Chaos site for the HTTP tier, resolved once at import: an armed
# service.handler fault turns a request into a clean 500 before its
# handler runs.
_FAULT_HANDLER = _faults.site("service.handler")
# Fleet replication apply: armed, a peer's /replicate dies with a clean 500
# — the publishing bus retries, breaks, dead-letters, and DLQ replay
# converges the gap later. Never a lost row, never a failed origin ingest.
_FAULT_REPLICATE = _faults.site("fleet.replicate_apply")


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

    # Traffic capture: every warn/ingest arrival lands in this bounded ring
    # so `traffic record` can pull GET /flightrecorder and convert the
    # timeline into a replayable traffic log. One append per request when
    # enabled; KAKVEDA_TRAFFIC_CAPTURE=0 makes record() a no-op (capacity 0).
    _cap_on = os.environ.get("KAKVEDA_TRAFFIC_CAPTURE", "1") != "0"
    traffic_rec = _metrics.FlightRecorder(
        "traffic",
        capacity=int(os.environ.get("KAKVEDA_TRAFFIC_CAPTURE_N", "2048")) if _cap_on else 0,
    )

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
    _trace.get_tracer().service = plat.replica_id or ""
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

    # Fleet wiring: peers subscribe on the local bus so accepted ingest
    # replicates out (gfkb.replicate, at-least-once) and control state
    # gossips out (fleet.control, ephemeral); subscriptions of a previous
    # topology are pruned so dead URLs do not burn the breaker.
    replica_id = os.environ.get("KAKVEDA_REPLICA_ID", "")
    fleet_peers = [
        u.strip().rstrip("/")
        for u in (os.environ.get("KAKVEDA_FLEET_PEERS", "") or "").split(",")
        if u.strip()
    ]
    fleet_view = FleetView(ttl_s=float(os.environ.get("KAKVEDA_FLEET_GOSSIP_TTL_S", "5") or 5))
    gossip_s = float(os.environ.get("KAKVEDA_FLEET_GOSSIP_S", "1") or 1)

    # Sharded ownership: this replica holds only its owned + standby key
    # ranges. The acknowledged view persists, so a restart mid-topology-
    # change resumes at its epoch (the env only seeds epoch 1).
    own_state: Optional[OwnershipState] = None
    own_path = plat.data_dir / "ownership.json"
    if os.environ.get("KAKVEDA_FLEET_OWNERSHIP", "0") == "1":
        members = parse_members(os.environ.get("KAKVEDA_FLEET_MEMBERS", ""))
        if not members:  # solo run: self owns everything
            members = {replica_id or "r?": ""}
        env_view = OwnershipView(
            members,
            replication=int(os.environ.get("KAKVEDA_FLEET_REPLICATION", "2") or 2),
            vnodes=int(os.environ.get("KAKVEDA_FLEET_VNODES", "64") or 64),
        )
        persisted = OwnershipView.load(own_path)
        own_state = OwnershipState(
            persisted if persisted is not None and persisted.epoch > env_view.epoch else env_view,
            replica_id or "r?",
        )
        plat.ownership = own_state

    def _sync_fleet_subscriptions() -> None:
        """Ownership-mode bus wiring, re-run on every acknowledged view
        swap: gossip to every other member, replication on one topic per
        peer, and the topics of departed members (and any legacy broadcast
        subscription) pruned."""
        view = own_state.view
        self_id = own_state.self_id
        want = {
            TOPIC_FLEET_CONTROL: {
                url + "/fleet/gossip" for rid, url in view.members.items() if rid != self_id and url
            },
            TOPIC_GFKB_REPLICATE: set(),  # never broadcast under ownership
        }
        for rid, url in view.members.items():
            if rid != self_id and url:
                want[replicate_topic(rid)] = {url + "/replicate"}
        for topic in list(plat.bus.topics()):
            if topic.startswith(TOPIC_GFKB_REPLICATE_PREFIX) and topic not in want:
                want[topic] = set()  # a departed member
        for topic, urls in want.items():
            for url in plat.bus.url_subscribers(topic):
                if url not in urls:
                    plat.bus.unsubscribe(topic, url)
            for url in sorted(urls):
                plat.bus.subscribe(topic, url)

    gossip: Optional[GossipPublisher] = None
    if own_state is not None and (fleet_peers or len(own_state.view.members) > 1):
        plat.bus.mark_ephemeral(TOPIC_FLEET_CONTROL)
        _sync_fleet_subscriptions()
        gossip = GossipPublisher(
            plat.bus, adm, health, replica_id or "r?", fleet_view, interval_s=gossip_s, ownership=own_state,
        )
    elif fleet_peers:
        plat.bus.mark_ephemeral(TOPIC_FLEET_CONTROL)
        for topic, suffix in ((TOPIC_FLEET_CONTROL, "/fleet/gossip"), (TOPIC_GFKB_REPLICATE, "/replicate")):
            want = {p + suffix for p in fleet_peers}
            for url in plat.bus.url_subscribers(topic):
                if url not in want:
                    plat.bus.unsubscribe(topic, url)
            for url in sorted(want):
                plat.bus.subscribe(topic, url)
        gossip = GossipPublisher(plat.bus, adm, health, replica_id or "r?", fleet_view, interval_s=gossip_s)

    async def _on_startup(app):
        warn_batcher.start()
        if gossip is not None:
            app[_GOSSIP_TASK_KEY] = asyncio.get_running_loop().create_task(gossip.run())
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
        t = app.get(_GOSSIP_TASK_KEY)
        if t is not None:
            t.cancel()
            try:
                await t
            except asyncio.CancelledError:
                pass
        await warn_batcher.stop()
        plat.bus.close()  # cancel a pending DLQ auto-replay

    app.on_startup.append(_on_startup)
    app.on_cleanup.append(_on_cleanup)

    # --- liveness -------------------------------------------------------

    async def healthz(request):
        return web.json_response({"ok": True})

    async def readyz(request):
        """Readiness with the mode: a degraded platform still answers warns
        from the host tiers, so ``ok`` stays true and ``device.degraded``
        says how; ``admission`` carries the brownout ladder's step.
        ``device.launches`` counts this process's ``fused_topk`` kernel
        launches (0 on the CPU, where no kernel runs)."""
        body = {
            "ok": True,
            "gfkb_count": plat.gfkb.count,
            "device": {**device, **health.info(), "launches": {"fused_topk": fused_topk.launches}},
            "admission": adm.info(),
            "tiers": plat.gfkb.tiers_info(),
            "native": native.status(),
            "fleet": {
                "replica_id": replica_id,
                "peers": len(fleet_peers),
                "view": fleet_view.peers(),
                "degraded_any": fleet_view.any_degraded(),
                "worst_brownout": fleet_view.worst_brownout(),
            },
        }
        if own_state is not None:
            view = own_state.view
            owned_arcs, standby_arcs = view.arc_counts(own_state.self_id)
            rows = {"owned": 0, "standby": 0, "foreign": 0}
            # O(distinct shard keys): app counts, not row scans.
            for key, n in plat.gfkb.shard_key_counts().items():
                role = view.role(own_state.self_id, key)
                bucket = role if role in ("owner", "standby") else "foreign"
                rows["owned" if bucket == "owner" else bucket] += n
            body["ownership"] = {
                "enabled": True,
                "epoch": view.epoch,
                "replication": view.replication,
                "members": list(view.members),
                "owned_arcs": owned_arcs,
                "standby_arcs": standby_arcs,
                "rows": rows,
            }
        return web.json_response(body)

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
            traffic_rec.record("ingest", app_id=req.trace.app_id, n=1)
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
            traffic_rec.record("ingest", app_id=req.traces[0].app_id, n=len(req.traces))
            with _trace.get_tracer().start_span(
                "gfkb.ingest", app_id=req.traces[0].app_id, n=len(req.traces)
            ):
                signals = await plat.ingest_batch(req.traces)
        return web.json_response({"ok": True, "n": len(req.traces), "failures": len(signals)})

    # --- fleet (replication fan-in, control gossip, ownership) ------------

    m_fence = m_stale_view = None
    if own_state is not None:
        reg = _metrics.get_registry()
        m_fence = reg.counter(
            "kakveda_fleet_fenced_rows_total",
            "Replicated rows dropped by the ownership-epoch fence (stale "
            "events for ranges this replica no longer holds)",
        )
        m_stale_view = reg.counter(
            "kakveda_fleet_stale_view_total",
            "Gossip samples revealing a peer at a newer ownership epoch "
            "than the locally acknowledged view",
        )

    async def replicate(request):
        """Apply one peer's replication event, idempotently by event id,
        through the organic insert path (off the loop, in an ingest slot).
        A failure (chaos: fleet.replicate_apply) or a shed is a clean
        error back to the peer's bus, whose retry / breaker / DLQ owns the
        redelivery. Ownership-epoch fence: an event stamped with an older
        epoch than the acknowledged view keeps only the rows this replica
        still holds, and one left with none is a clean 2xx drop, so the
        origin retires it instead of re-growing a migrated range."""
        try:
            body = await request.json()
        except ValueError as e:
            return _json_error(422, str(e))
        if not isinstance(body, dict):
            return _json_error(422, "id (str) and rows (list) required")
        event_id, rows = body.get("id"), body.get("rows")
        if not isinstance(event_id, str) or not isinstance(rows, list):
            return _json_error(422, "id (str) and rows (list) required")
        # Continue the origin's trace (the envelope's "trace" stamp).
        with _trace.get_tracer().start_span(
            "gfkb.replicate_apply",
            traceparent=body.get("trace") or None,
            origin=body.get("origin"), event_id=event_id, n=len(rows),
        ) as rspan:
            dropped = 0
            epoch = body.get("epoch")
            if isinstance(epoch, int):
                rspan.set(epoch=epoch)
            if own_state is not None and isinstance(epoch, int) and epoch < own_state.view.epoch:
                view = own_state.view
                kept = [
                    r for r in rows
                    if isinstance(r, dict) and view.is_holder(own_state.self_id, shard_key_of_row(r))
                ]
                dropped = len(rows) - len(kept)
                if dropped:
                    m_fence.inc(dropped)
                if not kept:
                    rspan.set(dropped=dropped, reason="stale_epoch")
                    return web.json_response(
                        {"ok": True, "applied": 0, "deduped": False, "dropped": dropped, "reason": "stale_epoch"}
                    )
                rows = kept
            _FAULT_REPLICATE.fire()
            loop = asyncio.get_running_loop()
            with adm.slot("ingest"):
                try:
                    applied = await loop.run_in_executor(None, plat.gfkb.apply_replication, rows, event_id)
                except (KeyError, ValueError) as e:  # a malformed row payload
                    rspan.set(error=type(e).__name__)
                    rspan.end("error")
                    return _json_error(422, f"bad replication rows: {e}")
            rspan.set(applied=applied, deduped=applied == 0)
            out = {"ok": True, "applied": applied, "deduped": applied == 0}
            if dropped:
                out["dropped"] = dropped
            return web.json_response(out)

    async def fleet_ownership_get(request):
        if own_state is None:
            return web.json_response({"enabled": False})
        return web.json_response({"enabled": True, **own_state.view.to_dict()})

    async def fleet_ownership_post(request):
        """Acknowledge a newer ownership view (the router's promotion push,
        or a rebalance flip). Monotonic: an epoch at or below the current
        one is a ``stale`` no-op ack. A swap persists atomically and
        rewires the per-peer replication topics before answering."""
        if own_state is None:
            return _json_error(409, "ownership disabled on this replica")
        try:
            new_view = OwnershipView.from_dict(await request.json())
        except (ValueError, KeyError, TypeError) as e:
            return _json_error(422, f"bad ownership view: {e}")
        cur = own_state.view
        if new_view.epoch <= cur.epoch:
            return web.json_response({"ok": True, "stale": True, "epoch": cur.epoch})
        own_state.view = new_view  # one reference write: readers swap whole
        try:
            new_view.save(own_path)
        except OSError as e:
            log.warning("ownership view persist failed: %s", e)
        _sync_fleet_subscriptions()
        log.info("ownership epoch %d -> %d (%d members)", cur.epoch, new_view.epoch, len(new_view.members))
        return web.json_response({"ok": True, "stale": False, "epoch": new_view.epoch})

    # The migration's export is control plane, not tenant background work:
    # a fleet that cannot migrate while saturated cannot scale out of it.
    # Its own small in-flight bound instead (past it, an immediate 429).
    export_inflight = 0

    async def fleet_export(request):
        """The rows past ``since`` that this replica is the responsible
        source for, grouped by gaining target (``run_rebalance``)."""
        nonlocal export_inflight
        if own_state is None:
            return _json_error(409, "ownership disabled on this replica")
        try:
            body = await request.json()
            old_v = OwnershipView.from_dict(body["old"])
            new_v = OwnershipView.from_dict(body["new"])
            sources = [str(x) for x in body.get("sources") or []]
            since = int(body.get("since", 0))
        except (ValueError, KeyError, TypeError) as e:
            return _json_error(422, f"bad export request: {e}")
        if export_inflight >= 2:
            return _json_error(429, "export concurrency bound")
        loop = asyncio.get_running_loop()
        export_inflight += 1
        try:
            rows, count = await loop.run_in_executor(None, plat.gfkb.export_rows, since)
        finally:
            export_inflight -= 1
        grouped: dict = {}
        for row in rows:
            key = shard_key_of_row(row)
            if responsible_source(key, old_v, sources) != own_state.self_id:
                continue
            for tgt in plan_targets(key, old_v, new_v):
                grouped.setdefault(tgt, []).append(row)
        return web.json_response({"rows": grouped, "count": count})

    async def fleet_gossip(request):
        """Fold one peer's control sample and re-feed the folded pressure
        into the local admission controller (an input: gate state only
        moves through the controller's own helpers)."""
        try:
            body = await request.json()
        except ValueError as e:
            return _json_error(422, str(e))
        fresh = fleet_view.fold(body) if isinstance(body, dict) else False
        if fresh:
            adm.note_fleet_pressure(fleet_view.fleet_pressure(), ttl_s=fleet_view.ttl_s)
            if own_state is not None:
                # A peer gossiping a newer epoch: this replica missed a push.
                peer_epoch = body.get("ownership_epoch")
                if isinstance(peer_epoch, int) and peer_epoch > own_state.view.epoch:
                    m_stale_view.inc()
                    log.warning(
                        "stale ownership view: peer %s at epoch %d, local %d",
                        body.get("replica"), peer_epoch, own_state.view.epoch,
                    )
        return web.json_response({"ok": True, "fresh": fresh})

    # --- warn -----------------------------------------------------------

    async def warn(request):
        try:
            req = WarningRequest.model_validate(await request.json())
        except (ValidationError, ValueError) as e:
            return _json_error(422, str(e))
        traffic_rec.record("warn", app_id=req.app_id, prompt=req.prompt)
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
        # Manual upserts replicate as ingest rows do: one publish path.
        await plat.replicate_rows(
            [
                {
                    "failure_type": body["failure_type"],
                    "signature_text": body["signature_text"],
                    "app_id": body["app_id"],
                    "impact_severity": body["impact_severity"],
                    "context_signature": body.get("context_signature"),
                    "root_cause": body.get("root_cause"),
                    "resolution": body.get("resolution"),
                }
            ]
        )
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

    async def subscribe(request):
        body = await request.json()
        topic, cb = body.get("topic"), body.get("callback_url")
        if not topic or not cb:
            return _json_error(422, "topic and callback_url required")
        n = plat.bus.subscribe(topic, cb)
        return web.json_response({"ok": True, "topic": topic, "subscribers": n})

    async def unsubscribe(request):
        body = await request.json()
        topic, cb = body.get("topic"), body.get("callback_url")
        if not topic or not cb:
            return _json_error(422, "topic and callback_url required")
        plat.bus.unsubscribe(topic, cb)
        return web.json_response({"ok": True, "topic": topic})

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
            web.post("/subscribe", subscribe),
            web.post("/unsubscribe", unsubscribe),
            web.post("/publish", publish),
            web.get("/topics", topics),
            web.post("/replicate", replicate),
            web.post("/fleet/gossip", fleet_gossip),
            web.get("/fleet/ownership", fleet_ownership_get),
            web.post("/fleet/ownership", fleet_ownership_post),
            web.post("/fleet/export", fleet_export),
        ]
    )
    app.add_routes(metrics_routes())
    return app


def make_agent_echo_app(agent_name: str = "agent-echo") -> web.Application:
    """The reference's external-agent contract: ``/health``,
    ``/capabilities``, and ``/invoke`` echoing the event back."""
    app = web.Application()

    async def health(request):
        return web.json_response({"ok": True, "service": agent_name, "status": "healthy"})

    async def capabilities(request):
        return web.json_response(
            {
                "name": agent_name,
                "capabilities": ["echo"],
                "events_in": ["*"],
                "events_out": ["echo"],
            }
        )

    async def invoke(request):
        body = await request.json()
        out = {
            "event_type": "echo",
            "payload": {
                "received_event_type": str(body.get("event_type") or "unknown"),
                "received_payload": body.get("payload"),
                "agent": agent_name,
            },
        }
        return web.json_response({"status": "ok", "events": [out]})

    app.add_routes(
        [
            web.get("/health", health),
            web.get("/capabilities", capabilities),
            web.post("/invoke", invoke),
        ]
    )
    return app
