"""Best-effort OpenTelemetry bootstrap.

The port's own copy of ``kakveda_tpu/core/otel.py``: an OTLP span
exporter plus per-request server spans, enabled only when
``KAKVEDA_OTEL_ENABLED`` is truthy and degrading to a no-op when the SDK
(or the exporter endpoint) is absent — observability must never take the
service down. ``opentelemetry`` is imported only inside the functions
that need it, so a machine without the SDK imports this module and
:func:`setup_otel` answers False there.

The server is aiohttp, so instrumentation is an explicit middleware
(``otel_middleware``) that opens one server span per request, records
method/route/status, and marks 5xx as errors. Device-side profiling is
separate (``core/profiling.py``); OTel covers the host plane.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

from kakveda_tpu_torch.core.runtime import get_runtime_config

log = logging.getLogger("kakveda.otel")

_tracer: Optional[Any] = None
_setup_done = False


def setup_otel(service_name: str) -> bool:
    """Install a tracer provider with an OTLP exporter. Returns enabled?"""
    global _tracer, _setup_done
    if _setup_done:
        return _tracer is not None
    _setup_done = True
    cfg = get_runtime_config(service_name=service_name)
    if not cfg.otel_enabled:
        return False
    try:
        from opentelemetry import trace
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import BatchSpanProcessor

        provider = TracerProvider(
            resource=Resource.create({"service.name": cfg.otel_service_name})
        )
        if cfg.otel_exporter_otlp_endpoint:
            try:
                from opentelemetry.exporter.otlp.proto.http.trace_exporter import (
                    OTLPSpanExporter,
                )

                provider.add_span_processor(
                    BatchSpanProcessor(
                        OTLPSpanExporter(endpoint=cfg.otel_exporter_otlp_endpoint)
                    )
                )
            except Exception as e:  # noqa: BLE001 — exporter is optional
                log.warning("otel exporter unavailable: %s", e)
        trace.set_tracer_provider(provider)
        _tracer = trace.get_tracer("kakveda-tpu")
        log.info("otel enabled (service=%s)", cfg.otel_service_name)
        return True
    except Exception as e:  # noqa: BLE001 — never block startup on otel
        log.warning("otel disabled: %s", e)
        return False


def get_tracer() -> Optional[Any]:
    return _tracer


def add_span_events(name: str, payload: Optional[dict]) -> None:
    """Attach a flat payload (e.g. the serving engine's request timeline)
    to the CURRENT server span as one event, so traces and /metrics
    correlate by request id. No-op without otel, a recording span, or a
    payload — observability never breaks the request path."""
    if _tracer is None or not payload:
        return
    try:
        from opentelemetry import trace

        span = trace.get_current_span()
        if span is None or not span.is_recording():
            return
        span.add_event(
            name,
            {
                k: v
                for k, v in payload.items()
                if isinstance(v, (str, bool, int, float))
            },
        )
    except Exception:  # noqa: BLE001 — telemetry must not take the request down
        pass


def export_native_span(span: dict) -> None:
    """Bridge ONE finished native span (core/trace.py ring dict) into the
    OTel SDK — called by the native tracer's record path only when
    ``KAKVEDA_OTEL_ENABLED`` stood setup up (``_tracer`` set), so the off
    path stays a single None check and zero import. The native trace id is
    attached as attributes (``kakveda.trace_id``/``span_id``/``parent_id``)
    — the shared 32-hex id is what parents the export under the server
    span in the backend; no new hard dependency, never raises."""
    if _tracer is None or not span:
        return
    try:
        start_ns = int(span.get("ts", 0.0) * 1e9)
        end_ns = start_ns + int(span.get("dur_ms", 0.0) * 1e6)
        ot = _tracer.start_span(span.get("name", "span"), start_time=start_ns)
        try:
            for k in ("trace_id", "span_id", "parent_id", "outcome", "service"):
                v = span.get(k)
                if v:
                    ot.set_attribute(f"kakveda.{k}", str(v))
            for k, v in (span.get("attrs") or {}).items():
                if isinstance(v, (str, bool, int, float)):
                    ot.set_attribute(str(k), v)
            if span.get("outcome") == "error":
                from opentelemetry.trace import Status, StatusCode

                ot.set_status(Status(StatusCode.ERROR))
        finally:
            ot.end(end_time=end_ns)
    except Exception:  # noqa: BLE001 — telemetry must not take the request down
        pass


def otel_middleware():
    """aiohttp middleware: one server span per request (no-op when off).

    The request id is resolved HERE (incoming header or fresh) and stashed
    on the request so the inner request-context middleware reuses it —
    span attribute ``request.id`` and the logged/echoed ``x-request-id``
    are the same value, the correlation key across traces, /metrics
    exemplars and the flight recorder."""
    from aiohttp import web

    from kakveda_tpu_torch.core.runtime import ensure_request_id, get_runtime_config

    @web.middleware
    async def mw(request: web.Request, handler):
        tracer = _tracer
        if tracer is None:
            return await handler(request)
        from opentelemetry.trace import SpanKind, Status, StatusCode

        cfg = get_runtime_config(service_name="kakveda-tpu")
        rid = ensure_request_id(request.headers.get(cfg.request_id_header))
        request["request_id"] = rid
        with tracer.start_as_current_span(
            f"{request.method} {request.path}", kind=SpanKind.SERVER
        ) as span:
            span.set_attribute("http.request.method", request.method)
            span.set_attribute("url.path", request.path)
            span.set_attribute("request.id", rid)
            try:
                response = await handler(request)
            except web.HTTPException as exc:
                span.set_attribute("http.response.status_code", exc.status)
                if exc.status >= 500:
                    span.set_status(Status(StatusCode.ERROR))
                raise
            except Exception as exc:
                span.set_status(Status(StatusCode.ERROR, str(exc)))
                raise
            span.set_attribute("http.response.status_code", response.status)
            if response.status >= 500:
                span.set_status(Status(StatusCode.ERROR))
            return response

    return mw
