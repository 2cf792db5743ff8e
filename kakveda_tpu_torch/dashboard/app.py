"""Dashboard app factory.

Assembles the aiohttp application: DB init + demo-user bootstrap + prod
secret guardrail (reference: services/dashboard/app.py:1261-1329),
middlewares (user resolution, security headers, request logging), and all
route modules.

The port's copy of ``kakveda_tpu/dashboard/app.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from aiohttp import web

from kakveda_tpu_torch.core.revocation import RevocationStore
from kakveda_tpu_torch.core.runtime import get_runtime_config
from kakveda_tpu_torch.dashboard.core import (
    CTX_KEY,
    DashboardContext,
    csrf_middleware,
    security_headers_middleware,
    user_middleware,
)
from kakveda_tpu_torch.dashboard.db import make_database
from kakveda_tpu_torch.models.runtime import ModelRuntime, get_runtime
from kakveda_tpu_torch.platform import Platform
from kakveda_tpu_torch.service.app import metrics_routes, request_context_middleware


def make_dashboard_app(
    platform: Optional[Platform] = None,
    db_path: str | Path | None = None,
    model: Optional[ModelRuntime] = None,
    demo_users: bool = True,
    **platform_kw,
) -> web.Application:
    cfg = get_runtime_config(service_name="dashboard")
    if cfg.env == "production" and cfg.dashboard_jwt_secret == "dev-secret-change-me":
        raise RuntimeError(
            "refusing to start in production with the default JWT secret "
            "(set DASHBOARD_JWT_SECRET)"
        )

    # Refuses a Redis URL before anything is built (core/revocation.py).
    revocations = RevocationStore()
    plat = platform or Platform(**platform_kw)
    db = make_database(db_path or (Path(cfg.data_dir) / "dashboard.db"))
    # Demo accounts carry published credentials and self-repair to them on
    # every start — never in production (KAKVEDA_DEMO_USERS=1 overrides for
    # an explicit opt-in).
    import os

    if cfg.env == "production" and os.environ.get("KAKVEDA_DEMO_USERS") != "1":
        demo_users = False
    db.bootstrap(demo_users=demo_users)

    ctx = DashboardContext(
        platform=plat,
        db=db,
        # The configured runtime on the Platform's device (the card unless
        # the Platform was built elsewhere), shared with its judge.
        model=model or get_runtime(cfg.model_runtime, device=plat.device),
        jwt_secret=cfg.dashboard_jwt_secret,
        revocations=revocations,
    )

    from kakveda_tpu_torch.core import otel

    middlewares = [
        request_context_middleware,
        user_middleware,
        security_headers_middleware,
        csrf_middleware,
    ]
    if otel.setup_otel("dashboard"):
        middlewares.insert(0, otel.otel_middleware())
    app = web.Application(middlewares=middlewares)
    app[CTX_KEY] = ctx

    from kakveda_tpu_torch.dashboard import routes_admin, routes_auth, routes_data, routes_main

    routes_auth.setup(app)
    routes_main.setup(app)
    routes_data.setup(app)
    routes_admin.setup(app)

    async def healthz(request):
        return web.json_response({"ok": True})

    async def readyz(request):
        try:
            db.one("SELECT 1 AS one")
            return web.json_response({"ok": True})
        except Exception as e:  # noqa: BLE001
            return web.json_response({"ok": False, "error": str(e)}, status=503)

    app.add_routes([web.get("/healthz", healthz), web.get("/readyz", readyz)])
    # The metrics plane (GET /metrics, GET /flightrecorder) — same routes
    # as the service app; the registry and recorders are process-global.
    app.add_routes(metrics_routes())

    # Bus subscriptions (reference: services/dashboard/app.py:1332-1431):
    # traces ingested through the platform API (not just scenario runs) land
    # in the runs explorer, and child-safety alerts from external agents
    # become WarningEvent rows. Raising on failure lets the bus's delivery
    # accounting see it (a swallowed insert error would silently lose e.g. a
    # high-severity safety alert).
    import logging as _logging
    import time as _time
    from datetime import datetime as _dt

    _log = _logging.getLogger("kakveda.dashboard.events")

    def _event_ts(event: dict) -> float:
        """Honor the trace's own timestamp (backfilled traces must not all
        land at 'now'); fall back to the wall clock."""
        raw = event.get("ts")
        if isinstance(raw, (int, float)):
            return float(raw)
        if isinstance(raw, str):
            try:
                return _dt.fromisoformat(raw.replace("Z", "+00:00")).timestamp()
            except ValueError:
                pass
        return _time.time()

    def _on_trace_ingested(event: dict) -> None:
        try:
            db.execute(
                "INSERT OR IGNORE INTO trace_runs (trace_id, ts, app_id, agent_id, prompt,"
                " response, provider, model, status, tags_json) VALUES (?,?,?,?,?,?,?,?,'ok','[]')",
                (
                    str(event.get("trace_id") or ""),
                    _event_ts(event),
                    str(event.get("app_id") or "unknown"),
                    event.get("agent_id"),
                    str(event.get("prompt") or ""),
                    str(event.get("response") or ""),
                    "event",
                    event.get("model"),
                ),
            )
        except Exception:
            _log.exception("trace.ingested persistence failed")
            raise

    def _on_child_safety(event: dict) -> None:
        sev = str(event.get("severity") or "medium").lower()
        confidence = {"low": 0.4, "medium": 0.7, "high": 0.95}.get(sev, 0.7)
        try:
            db.execute(
                "INSERT INTO warning_events (ts, app_id, action, confidence, failure_type,"
                " message, source) VALUES (?,?,?,?,?,?,'child_safety')",
                (
                    _event_ts(event),
                    str(event.get("app_id") or "unknown"),
                    "block" if sev == "high" else "warn",
                    confidence,
                    str(event.get("failure_type") or "CHILD_SAFETY"),
                    str(event.get("message") or event.get("reason") or "child safety alert"),
                ),
            )
        except Exception:
            _log.exception("child_safety_alert persistence failed")
            raise

    from kakveda_tpu_torch.events.bus import TOPIC_CHILD_SAFETY, TOPIC_TRACE_INGESTED

    plat.bus.subscribe(TOPIC_TRACE_INGESTED, _on_trace_ingested)
    plat.bus.subscribe(TOPIC_CHILD_SAFETY, _on_child_safety)

    async def _unsubscribe(app_):
        # A second make_dashboard_app on the same Platform (tests, reload)
        # must not leave stale closures duplicating rows / pinning the DB.
        plat.bus.unsubscribe(TOPIC_TRACE_INGESTED, _on_trace_ingested)
        plat.bus.unsubscribe(TOPIC_CHILD_SAFETY, _on_child_safety)

    app.on_cleanup.append(_unsubscribe)
    return app
