"""Dashboard app context: jinja env, auth/session helpers, middleware.

The port's copy of ``kakveda_tpu/dashboard/core.py``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, List, Optional

import secrets

import jinja2
from aiohttp import web

from kakveda_tpu_torch.core.ratelimit import RateLimiter
from kakveda_tpu_torch.core.revocation import RevocationStore
from kakveda_tpu_torch.core.runtime import get_runtime_config
from kakveda_tpu_torch.dashboard import auth as auth_lib
from kakveda_tpu_torch.dashboard import rbac
from kakveda_tpu_torch.dashboard.db import Database
from kakveda_tpu_torch.models.runtime import ModelRuntime
from kakveda_tpu_torch.platform import Platform

log = logging.getLogger("kakveda.dashboard")

COOKIE_NAME = "kakveda_token"
VIEW_AS_COOKIE = "kakveda_view_as"
PROJECT_COOKIE = "kakveda_project"

TEMPLATES_DIR = Path(__file__).parent / "templates"


@dataclass
class DashboardContext:
    platform: Platform
    db: Database
    model: ModelRuntime
    jwt_secret: str
    revocations: RevocationStore = field(default_factory=RevocationStore)
    jinja: jinja2.Environment = field(init=False)

    def __post_init__(self):
        self.jinja = jinja2.Environment(
            loader=jinja2.FileSystemLoader(str(TEMPLATES_DIR)),
            autoescape=True,
        )
        # Epoch-seconds → "YYYY-MM-DD HH:MM" UTC; DB rows store raw floats.
        import datetime as _dt

        self.jinja.filters["ts_utc"] = lambda ts: (
            _dt.datetime.fromtimestamp(float(ts), tz=_dt.timezone.utc).strftime("%Y-%m-%d %H:%M")
            if ts else "—"
        )

    def render(self, request: web.Request, template: str, **ctx: Any) -> web.Response:
        user = request.get("user")
        html = self.jinja.get_template(template).render(
            user=user, request=request, csp_nonce=request.get("csp_nonce", ""), **ctx
        )
        return web.Response(text=html, content_type="text/html")


CTX_KEY: web.AppKey[DashboardContext] = web.AppKey("dashboard_ctx", DashboardContext)


# --- user resolution -------------------------------------------------------


@dataclass
class CurrentUser:
    email: str
    display_name: str
    roles: List[str]
    user_id: int
    impersonated_by: Optional[str] = None

    @property
    def is_admin(self) -> bool:
        return rbac.has_role(self.roles, rbac.ADMIN)


def resolve_user(request: web.Request) -> Optional[CurrentUser]:
    """Cookie JWT → DB-truth user (roles come from the DB, not the token —
    reference: services/dashboard/app.py:681-720 — with admin 'view-as'
    impersonation via a second cookie)."""
    ctx = request.app[CTX_KEY]
    token = request.cookies.get(COOKIE_NAME)
    if not token:
        return None
    claims = auth_lib.decode_token(token, secret=ctx.jwt_secret)
    if not claims:
        return None
    if claims.get("jti") and ctx.revocations.is_revoked(claims["jti"]):
        return None
    row = ctx.db.user_by_email(claims.get("sub", ""))
    if row is None or not row["is_active"]:
        return None
    roles = ctx.db.user_roles(row["id"])
    user = CurrentUser(
        email=row["email"],
        display_name=row["display_name"] or row["email"],
        roles=roles,
        user_id=row["id"],
    )
    view_as = request.cookies.get(VIEW_AS_COOKIE)
    if view_as and user.is_admin:
        target = ctx.db.user_by_email(view_as)
        if target is not None:
            return CurrentUser(
                email=target["email"],
                display_name=target["display_name"] or target["email"],
                roles=ctx.db.user_roles(target["id"]),
                user_id=target["id"],
                impersonated_by=user.email,
            )
    return user


def require_login(handler):
    async def wrapped(request: web.Request):
        if request.get("user") is None:
            raise web.HTTPFound(f"/login?next={request.path}")
        return await handler(request)

    return wrapped


def require_roles(*allowed: str):
    def deco(handler):
        async def wrapped(request: web.Request):
            user: Optional[CurrentUser] = request.get("user")
            if user is None:
                raise web.HTTPFound(f"/login?next={request.path}")
            if not rbac.require_any(user.roles, allowed):
                raise web.HTTPForbidden(text="insufficient role")
            return await handler(request)

        return wrapped

    return deco


# --- middleware ------------------------------------------------------------


@web.middleware
async def user_middleware(request: web.Request, handler):
    request["user"] = resolve_user(request)
    return await handler(request)


def _stamp_security_headers(response, nonce: str = "") -> None:
    # Inline scripts (warnings charts, playground streaming) carry a
    # per-request nonce: script-src falls back to default-src 'self'
    # otherwise, and 'self' BLOCKS inline execution in real browsers —
    # a gap TestClient-based tests can't see (clients don't enforce CSP).
    script_src = f" 'nonce-{nonce}'" if nonce else ""
    response.headers.setdefault(
        "Content-Security-Policy",
        f"default-src 'self'; script-src 'self'{script_src}; "
        "style-src 'self' 'unsafe-inline'",
    )
    response.headers.setdefault("X-Frame-Options", "DENY")
    response.headers.setdefault("X-Content-Type-Options", "nosniff")
    if get_runtime_config(service_name="dashboard").env == "production":
        response.headers.setdefault(
            "Strict-Transport-Security", "max-age=31536000; includeSubDomains"
        )


@web.middleware
async def security_headers_middleware(request: web.Request, handler):
    """CSP/XFO/no-sniff on every response
    (reference: services/dashboard/app.py:615-626). Redirects and error
    pages are raised as HTTPException by most handlers, so the raised path
    must be stamped too."""
    request["csp_nonce"] = secrets.token_urlsafe(16)
    try:
        response = await handler(request)
    except web.HTTPException as exc:
        _stamp_security_headers(exc, request["csp_nonce"])
        _stamp_csrf_cookie(request, exc)
        raise
    _stamp_security_headers(response, request["csp_nonce"])
    _stamp_csrf_cookie(request, response)
    return response


CSRF_COOKIE = "csrf_token"


def _stamp_csrf_cookie(request: web.Request, response) -> None:
    """Issue the double-submit CSRF token cookie when absent — the
    reference sets it even with enforcement disabled
    (reference: services/dashboard/app.py:655-663), so clients are primed
    before enforcement is switched on."""
    if request.cookies.get(CSRF_COOKIE):
        return
    try:
        response.set_cookie(
            CSRF_COOKIE,
            secrets.token_urlsafe(32),
            httponly=False,  # double-submit: JS must read it back
            samesite="Lax",
            secure=get_runtime_config(service_name="dashboard").env == "production",
        )
    except (AttributeError, RuntimeError):  # prepared/streamed responses
        pass


@web.middleware
async def csrf_middleware(request: web.Request, handler):
    """Double-submit CSRF check on mutating methods, enforcement gated on
    ``KAKVEDA_CSRF_ENFORCE=1`` (the reference ships with enforcement
    disabled too; the cookie issuance above keeps clients ready)."""
    import os

    if request.method in ("POST", "PUT", "PATCH", "DELETE") and os.environ.get(
        "KAKVEDA_CSRF_ENFORCE", ""
    ).lower() in ("1", "true", "yes"):
        # /api/* authenticates by API key/bearer, not cookies — exempt.
        if not request.path.startswith("/api/"):
            cookie = request.cookies.get(CSRF_COOKIE, "")
            sent = request.headers.get("X-CSRF-Token", "")
            if not sent and request.content_type == "application/x-www-form-urlencoded":
                form = await request.post()
                sent = str(form.get("csrf_token", ""))
            if not cookie or sent != cookie:
                raise web.HTTPForbidden(text="CSRF token missing or mismatched")
    return await handler(request)


# --- shared rate limiter ---------------------------------------------------

RATE_LIMITER = RateLimiter()
