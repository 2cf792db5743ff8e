"""Auth flows: login/logout/register/forgot/reset
(reference: services/dashboard/app.py:2481-2672).

The port's copy of ``kakveda_tpu/dashboard/routes_auth.py``.
"""

from __future__ import annotations

import os
import re
import time

from aiohttp import web

from kakveda_tpu_torch.core.runtime import get_runtime_config
from kakveda_tpu_torch.dashboard import auth as auth_lib
from kakveda_tpu_torch.dashboard import email as email_lib
from kakveda_tpu_torch.dashboard.core import COOKIE_NAME, CTX_KEY, RATE_LIMITER, VIEW_AS_COOKIE
from kakveda_tpu_torch.dashboard.routes_main import off_loop

_EMAIL_RE = re.compile(r"^[^@\s]+@[^@\s]+\.[^@\s]+$|^[^@\s]+@local$")

# Reference password policy: ≥8 chars with letters and digits
# (reference: services/dashboard/app.py:521-533).
def _password_ok(pw: str) -> bool:
    return len(pw) >= 8 and any(c.isalpha() for c in pw) and any(c.isdigit() for c in pw)


def _client_key(request: web.Request, bucket: str) -> str:
    peer = request.remote or "unknown"
    return f"{bucket}:{peer}"


def setup(app: web.Application) -> None:
    ctx = app[CTX_KEY]

    async def login_page(request):
        return ctx.render(request, "login.html", error=None, next=request.query.get("next", "/"))

    async def login(request):
        if not RATE_LIMITER.allow(_client_key(request, "login"), limit=20):
            return ctx.render(request, "login.html", error="Too many attempts; slow down.", next="/")
        form = await request.post()
        email = str(form.get("email", "")).strip().lower()
        password = str(form.get("password", ""))
        row = ctx.db.user_by_email(email)
        # pbkdf2 is ~100 ms of CPU; keep it off the event loop that serves
        # the /warn micro-batcher.
        pw_ok = row is not None and await off_loop(
            auth_lib.verify_password, password, row["password_hash"]
        )
        if row is None or not row["is_active"] or not pw_ok:
            ctx.db.audit(email, "login.failed")
            return ctx.render(request, "login.html", error="Invalid credentials", next=form.get("next", "/"))
        roles = ctx.db.user_roles(row["id"])
        token = auth_lib.create_access_token(email=email, roles=roles, secret=ctx.jwt_secret)
        nxt = str(form.get("next") or "/")
        # Local-path redirects only: "//evil.com" is protocol-relative and
        # "/\evil.com" gets browser-normalized to it, so backslashes are
        # rejected outright.
        if not nxt.startswith("/") or nxt.startswith("//") or "\\" in nxt:
            nxt = "/"
        resp = web.HTTPFound(nxt)
        resp.set_cookie(COOKIE_NAME, token, httponly=True, samesite="Lax")
        ctx.db.audit(email, "login.ok")
        raise resp

    async def logout(request):
        user = request.get("user")
        # Revoke the token itself (reference:
        # services/dashboard/app.py:2507-2524 + redis_helpers.py:26-59) —
        # deleting the cookie alone leaves a stolen copy valid until expiry.
        token = request.cookies.get(COOKIE_NAME)
        if token:
            claims = auth_lib.decode_token(token, secret=ctx.jwt_secret)
            if claims and claims.get("jti"):
                ctx.revocations.revoke(claims["jti"], float(claims.get("exp", 0)))
        resp = web.HTTPFound("/login")
        resp.del_cookie(COOKIE_NAME)
        resp.del_cookie(VIEW_AS_COOKIE)
        if user:
            ctx.db.audit(user.email, "logout")
        raise resp

    async def register_page(request):
        return ctx.render(request, "register.html", error=None)

    async def register(request):
        if not RATE_LIMITER.allow(_client_key(request, "register"), limit=10):
            return ctx.render(request, "register.html", error="Too many attempts; slow down.")
        form = await request.post()
        email = str(form.get("email", "")).strip().lower()
        password = str(form.get("password", ""))
        name = str(form.get("display_name", "")).strip() or email
        if not _EMAIL_RE.match(email):
            return ctx.render(request, "register.html", error="Invalid email address")
        if not _password_ok(password):
            return ctx.render(
                request, "register.html", error="Password needs ≥8 chars with letters and digits"
            )
        if ctx.db.user_by_email(email) is not None:
            return ctx.render(request, "register.html", error="Account already exists")
        pw_hash = await off_loop(auth_lib.hash_password, password)
        uid = ctx.db.execute(
            "INSERT INTO users (email, password_hash, display_name, is_active, created_at)"
            " VALUES (?,?,?,1,?)",
            (email, pw_hash, name, time.time()),
        )
        rid = ctx.db.one("SELECT id FROM roles WHERE name='viewer'")["id"]
        ctx.db.execute("INSERT OR IGNORE INTO user_roles (user_id, role_id) VALUES (?,?)", (uid, rid))
        ctx.db.audit(email, "register")
        raise web.HTTPFound("/login")

    async def forgot_page(request):
        return ctx.render(request, "forgot.html", sent=False, reset_link=None)

    async def forgot(request):
        if not RATE_LIMITER.allow(_client_key(request, "forgot"), limit=5):
            return ctx.render(request, "forgot.html", sent=True, reset_link=None)
        form = await request.post()
        email = str(form.get("email", "")).strip().lower()
        row = ctx.db.user_by_email(email)
        reset_link = None
        if row is not None:
            token = auth_lib.mint_reset_token()
            ctx.db.execute(
                "INSERT INTO password_reset_tokens (token, user_id, expires_at) VALUES (?,?,?)",
                (token, row["id"], time.time() + 3600),
            )
            # SMTP delivery when configured (reference:
            # services/dashboard/app.py:2585-2642); otherwise demo mode shows
            # the link inline — but never in production, where that would
            # hand any account's reset token to an anonymous requester.
            # Mail clients need an absolute URL. Only DASHBOARD_BASE_URL is
            # trusted in production — deriving the base from request.host
            # would let an attacker poison the emailed link via the Host
            # header and harvest the victim's live reset token. Outside
            # production the request origin is a convenience fallback.
            base = os.environ.get("DASHBOARD_BASE_URL", "").rstrip("/")
            if not base and get_runtime_config(service_name="dashboard").env != "production":
                base = f"{request.scheme}://{request.host}"
            link = f"{base}/reset?token={token}"
            sent = False
            if email_lib.smtp_configured():
                sent = await off_loop(
                    email_lib.send_email,
                    email,
                    "Password reset",
                    f"Reset your password: {link}\nThis link expires in 1 hour.",
                )
            if not sent and get_runtime_config(service_name="dashboard").env != "production":
                reset_link = link
            ctx.db.audit(email, "forgot.requested", {"emailed": sent})
        return ctx.render(request, "forgot.html", sent=True, reset_link=reset_link)

    async def reset_page(request):
        return ctx.render(request, "reset.html", token=request.query.get("token", ""), error=None)

    async def reset(request):
        form = await request.post()
        token = str(form.get("token", ""))
        password = str(form.get("password", ""))
        row = ctx.db.one(
            "SELECT * FROM password_reset_tokens WHERE token=? AND used=0 AND expires_at>?",
            (token, time.time()),
        )
        if row is None:
            return ctx.render(request, "reset.html", token=token, error="Invalid or expired token")
        if not _password_ok(password):
            return ctx.render(
                request, "reset.html", token=token, error="Password needs ≥8 chars with letters and digits"
            )
        pw_hash = await off_loop(auth_lib.hash_password, password)
        ctx.db.execute(
            "UPDATE users SET password_hash=? WHERE id=?",
            (pw_hash, row["user_id"]),
        )
        ctx.db.execute("UPDATE password_reset_tokens SET used=1 WHERE token=?", (token,))
        ctx.db.audit(None, "password.reset", {"user_id": row["user_id"]})
        raise web.HTTPFound("/login")

    app.add_routes(
        [
            web.get("/login", login_page),
            web.post("/login", login),
            web.get("/logout", logout),
            web.post("/logout", logout),
            web.get("/register", register_page),
            web.post("/register", register),
            web.get("/forgot", forgot_page),
            web.post("/forgot", forgot),
            web.get("/reset", reset_page),
            web.post("/reset", reset),
        ]
    )
