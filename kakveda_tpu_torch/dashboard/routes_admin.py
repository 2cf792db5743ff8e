"""Admin, agent registry, projects, public ingest API
(reference: services/dashboard/app.py:811-1179, 1436-1605, 2675-2763,
3651-3694).

The port's copy of ``kakveda_tpu/dashboard/routes_admin.py``.
"""

from __future__ import annotations

import hashlib
import json
import secrets
import shutil
import time
from datetime import datetime, timezone
from typing import Optional

from aiohttp import web

from kakveda_tpu_torch.core.schemas import TracePayload
from kakveda_tpu_torch.dashboard.core import (
    CTX_KEY,
    PROJECT_COOKIE,
    VIEW_AS_COOKIE,
    require_login,
    require_roles,
)
from kakveda_tpu_torch.dashboard.routes_main import estimate_cost_micro_usd, estimate_tokens


def _hash_api_key(key: str) -> str:
    return hashlib.sha256(key.encode("utf-8")).hexdigest()


async def _agent_health(base_url: str) -> dict:
    """``GET {base_url}/health`` off the loop: its status and JSON body,
    whatever the status; ``{"status": 0, "body": {"error": ...}}`` when no
    JSON answer came. The port's ``core/httpjson`` where the reference uses
    ``httpx``: only the error's text differs."""
    from kakveda_tpu_torch.core import httpjson
    from kakveda_tpu_torch.dashboard.routes_main import off_loop

    try:
        status, body = await off_loop(httpjson.answer, "GET", f"{base_url}/health", timeout=5.0)
        return {"status": status, "body": json.loads(body)}
    except Exception as e:  # noqa: BLE001
        return {"status": 0, "body": {"error": f"{type(e).__name__}: {e}"}}


def setup(app: web.Application) -> None:
    ctx = app[CTX_KEY]
    plat = ctx.platform

    # ------------------------------------------------------------------
    # admin: users, audit, impersonation, purge
    # ------------------------------------------------------------------

    @require_roles("admin")
    async def admin_users(request):
        users = ctx.db.query("SELECT * FROM users ORDER BY email")
        for u in users:
            u["roles"] = ctx.db.user_roles(u["id"])
        return ctx.render(request, "admin_users.html", users=users)

    @require_roles("admin")
    async def admin_set_role(request):
        form = await request.post()
        uid = int(form.get("user_id", 0))
        role = str(form.get("role") or "")
        rid_row = ctx.db.one("SELECT id FROM roles WHERE name=?", (role,))
        if rid_row is None:
            raise web.HTTPBadRequest(text="unknown role")
        ctx.db.execute("DELETE FROM user_roles WHERE user_id=?", (uid,))
        ctx.db.execute(
            "INSERT INTO user_roles (user_id, role_id) VALUES (?,?)", (uid, rid_row["id"])
        )
        ctx.db.audit(request["user"].email, "admin.set_role", {"user_id": uid, "role": role})
        raise web.HTTPFound("/admin/users")

    @require_roles("admin")
    async def admin_toggle_active(request):
        form = await request.post()
        uid = int(form.get("user_id", 0))
        ctx.db.execute("UPDATE users SET is_active = 1 - is_active WHERE id=?", (uid,))
        ctx.db.audit(request["user"].email, "admin.toggle_active", {"user_id": uid})
        raise web.HTTPFound("/admin/users")

    @require_roles("admin")
    async def admin_impersonate(request):
        """'View as' — second cookie, honored only for admins
        (reference: services/dashboard/app.py:2730-2763)."""
        form = await request.post()
        email = str(form.get("email") or "")
        resp = web.HTTPFound("/")
        if email:
            resp.set_cookie(VIEW_AS_COOKIE, email, httponly=True, samesite="Lax")
            ctx.db.audit(request["user"].email, "admin.impersonate", {"as": email})
        else:
            resp.del_cookie(VIEW_AS_COOKIE)
            ctx.db.audit(request["user"].email, "admin.impersonate.clear")
        raise resp

    @require_roles("admin")
    async def admin_audit(request):
        events = ctx.db.query("SELECT * FROM audit_events ORDER BY ts DESC LIMIT 200")
        return ctx.render(request, "admin_audit.html", events=events)

    _DEMO_APPS = {"app-A", "app-B"}

    def _demo_counts():
        """Per-store (demo rows, total rows) for the purge preview.
        Patterns count from the in-memory union — the delta-append log's
        raw lines don't carry full membership."""
        out = []
        data_dir = plat.gfkb.data_dir
        for name in ("failures.jsonl", "health.jsonl"):
            p = data_dir / name
            demo = total = 0
            if p.exists():
                for line in p.read_text(encoding="utf-8").splitlines():
                    if not line.strip():
                        continue
                    total += 1
                    try:
                        row = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    apps = set(row.get("affected_apps") or [])
                    if row.get("app_id") in _DEMO_APPS or (apps and apps <= _DEMO_APPS):
                        demo += 1
            out.append({"store": name, "demo": demo, "total": total})
        pats = plat.gfkb.list_patterns()
        demo_pats = sum(
            1 for p in pats if p.affected_apps and set(p.affected_apps) <= _DEMO_APPS
        )
        out.append({"store": "patterns", "demo": demo_pats, "total": len(pats)})
        for table in ("trace_runs", "warning_events", "scenario_runs"):
            demo = sum(
                ctx.db.one(f"SELECT COUNT(*) AS n FROM {table} WHERE app_id=?", (a,))["n"]
                for a in _DEMO_APPS
            )
            total = ctx.db.one(f"SELECT COUNT(*) AS n FROM {table}")["n"]
            out.append({"store": f"db:{table}", "demo": demo, "total": total})
        return out

    def _backups():
        data_dir = plat.gfkb.data_dir
        return sorted(
            (
                {"name": p.name, "size": p.stat().st_size}
                for p in data_dir.glob("*.bak-*")
            ),
            key=lambda b: b["name"],
            reverse=True,
        )

    @require_roles("admin")
    async def admin_purge_demo_page(request):
        """Preview + confirm flow before the destructive purge
        (reference: services/dashboard/app.py:811-830 + its
        admin_purge_demo.html): shows what will be removed and the existing
        timestamped backups; the POST requires an explicit confirmation."""
        return ctx.render(
            request,
            "admin_purge_demo.html",
            apps=sorted(_DEMO_APPS),
            counts=_demo_counts(),
            backups=_backups(),
            message=request.query.get("message") or "",
            error=request.query.get("error") or "",
        )

    @require_roles("admin")
    async def admin_purge_demo(request):
        """Backup then purge demo apps app-A/app-B from JSONL + DB
        (reference: services/dashboard/app.py:833-867)."""
        form = await request.post()
        if form.get("confirm") != "yes":
            raise web.HTTPFound("/admin/purge-demo?error=confirmation%20required")
        demo_apps = _DEMO_APPS
        stamp = datetime.now(timezone.utc).strftime("%Y%m%d-%H%M%S")
        data_dir = plat.gfkb.data_dir
        for name in ("failures.jsonl", "patterns.jsonl", "health.jsonl"):
            p = data_dir / name
            if p.exists():
                shutil.copy2(p, p.with_suffix(f".jsonl.bak-{stamp}"))
        # JSONL purge (reference: services/dashboard/app.py:330-375 purges
        # all three stores). failures/health filter line-by-line; a corrupt
        # line (crash mid-append) is skipped, not fatal — the preview
        # already tolerates it and a purge must not 500 after backing up.
        def _purge_jsonl(path):
            if not path.exists():
                return
            kept = []
            for line in path.read_text(encoding="utf-8").splitlines():
                if not line.strip():
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                apps = set(row.get("affected_apps") or [])
                if row.get("app_id") in demo_apps or (apps and apps <= demo_apps):
                    continue
                kept.append(line)
            path.write_text("\n".join(kept) + ("\n" if kept else ""), encoding="utf-8")

        # Admin-only, confirmed purge: a timestamped .bak was copied above
        # and gfkb.reload() below replays the result — a crash mid-rewrite
        # loses at most this purge, recoverable from the backup.
        _purge_jsonl(plat.gfkb.failures_path)  # kakveda: allow[atomic-log-rewrite]
        _purge_jsonl(plat.health.health_path)
        # The patterns log is DELTA-append (each line carries only that
        # upsert's new members), so line filtering can't remove an app from
        # a pattern. Rewrite it CONSOLIDATED from the in-memory union:
        # full-membership lines minus demo apps; patterns spanning only
        # demo apps disappear. (Replay unions full lines identically.)
        kept_lines = []
        for pat in plat.gfkb.list_patterns():
            apps = [a for a in pat.affected_apps if a not in demo_apps]
            if not apps:
                continue
            cleaned = pat.model_copy(update={"affected_apps": apps})
            kept_lines.append(cleaned.model_dump_json())
        # Log rewrite + full GFKB replay are seconds of disk/CPU at scale —
        # off the event loop, or every dashboard request stalls behind the
        # purge (event-loop-blocking rule).
        import asyncio

        loop = asyncio.get_running_loop()
        rewritten = "\n".join(kept_lines) + ("\n" if kept_lines else "")
        await loop.run_in_executor(
            None,
            # Same admin-purge exception as _purge_jsonl: .bak taken above,
            # reload() replays below.
            lambda: plat.gfkb.patterns_path.write_text(rewritten, encoding="utf-8"),  # kakveda: allow[atomic-log-rewrite]
        )
        for app_id in demo_apps:
            ctx.db.execute("DELETE FROM trace_runs WHERE app_id=?", (app_id,))
            ctx.db.execute("DELETE FROM warning_events WHERE app_id=?", (app_id,))
            ctx.db.execute("DELETE FROM scenario_runs WHERE app_id=?", (app_id,))
        # The device index and host metadata were built from the pre-purge
        # log — replay the rewritten files so queries and id minting agree.
        await loop.run_in_executor(None, plat.gfkb.reload)
        ctx.db.audit(request["user"].email, "admin.purge_demo", {"apps": sorted(demo_apps)})
        from urllib.parse import quote

        msg = f"Purged demo apps {sorted(demo_apps)}; backups stamped {stamp}."
        raise web.HTTPFound(f"/admin/purge-demo?message={quote(msg)}")

    # ------------------------------------------------------------------
    # agent registry
    # ------------------------------------------------------------------

    @require_login
    async def agents_page(request):
        agents = ctx.db.query("SELECT * FROM agent_registry ORDER BY name")
        return ctx.render(request, "agents.html", agents=agents, test_result=None)

    @require_roles("admin")
    async def admin_agents_page(request):
        """Dedicated agent-management page (reference:
        services/dashboard/app.py:949-1087 + admin_agents.html): full
        register/update form, enable toggle, health test, removal."""
        agents = ctx.db.query("SELECT * FROM agent_registry ORDER BY name")
        return ctx.render(request, "admin_agents.html", agents=agents, test_result=None)

    @require_roles("admin")
    async def admin_serving_page(request):
        """Serving observability: which runtime backs generation, the
        shared engine's pool state (submitted/completed/max_active,
        slots/window), the serving-lever flags (weight + KV quant), and —
        under a multi-model router — the HBM budget accounting (resident
        models, bytes, headroom). No reference counterpart (its model
        tier is a stateless per-request Ollama hop)."""
        stats = ctx.model.serving_stats() if hasattr(ctx.model, "serving_stats") else {
            "runtime": getattr(ctx.model, "name", "unknown"), "engine": None,
        }
        return ctx.render(
            request, "admin_serving.html", stats=stats,
            prefix_result=request.query.get("prefix", ""),
            can_register_prefix=callable(getattr(ctx.model, "register_prefix", None)),
        )

    @require_roles("admin")
    async def admin_serving_prefix(request):
        """Register a shared prompt prefix (system preamble) on the serving
        engine from the ops panel — later requests starting with it
        prefill only their suffix (models/serving.py prefix cache)."""
        from kakveda_tpu_torch.dashboard.routes_main import off_loop

        form = await request.post()
        text = str(form.get("prefix") or "").strip()
        reg = getattr(ctx.model, "register_prefix", None)
        if not text or not callable(reg):
            raise web.HTTPFound("/admin/serving?prefix=unsupported")
        ok = await off_loop(reg, text)
        ctx.db.audit(
            request["user"].email, "serving.prefix_register",
            {"chars": len(text), "accepted": bool(ok)},
        )
        raise web.HTTPFound(f"/admin/serving?prefix={'registered' if ok else 'refused'}")

    @require_roles("admin")
    async def admin_agent_delete(request):
        form = await request.post()
        name = str(form.get("name") or "")
        ctx.db.execute("DELETE FROM agent_registry WHERE name=?", (name,))
        ctx.db.audit(request["user"].email, "agent.delete", {"name": name})
        raise web.HTTPFound("/admin/agents")

    @require_roles("admin")
    async def admin_agent_test(request):
        """Health test rendered back into the admin page."""
        name = request.match_info["name"]
        agent = ctx.db.one("SELECT * FROM agent_registry WHERE name=?", (name,))
        if agent is None:
            raise web.HTTPNotFound(text="agent not found")
        result = await _agent_health(agent["base_url"])
        agents = ctx.db.query("SELECT * FROM agent_registry ORDER BY name")
        return ctx.render(
            request, "admin_agents.html", agents=agents, test_result={"name": name, **result}
        )

    @require_roles("admin")
    async def agent_register(request):
        form = await request.post()
        name = str(form.get("name") or "").strip()
        base_url = str(form.get("base_url") or "").strip()
        if not name or not base_url:
            raise web.HTTPBadRequest(text="name and base_url required")
        ctx.db.execute(
            "INSERT OR REPLACE INTO agent_registry (name, base_url, auth_kind, auth_secret_env,"
            " enabled, created_at) VALUES (?,?,?,?,1,?)",
            (
                name,
                base_url,
                str(form.get("auth_kind") or "none"),
                # env-var *name*, never the secret itself
                str(form.get("auth_secret_env") or "") or None,
                time.time(),
            ),
        )
        ctx.db.audit(request["user"].email, "agent.register", {"name": name})
        nxt = str(form.get("next") or "/agents")
        # Reject protocol-relative //host targets, not just absolute URLs.
        raise web.HTTPFound(nxt if nxt.startswith("/") and not nxt.startswith("//") else "/agents")

    @require_roles("admin")
    async def agent_toggle(request):
        form = await request.post()
        name = str(form.get("name") or "")
        ctx.db.execute("UPDATE agent_registry SET enabled = 1 - enabled WHERE name=?", (name,))
        nxt = str(form.get("next") or "/agents")
        raise web.HTTPFound(nxt if nxt.startswith("/") and not nxt.startswith("//") else "/agents")

    @require_login
    async def agent_test(request):
        """Health-check an agent (reference: app.py:874-946)."""
        name = request.match_info["name"]
        agent = ctx.db.one("SELECT * FROM agent_registry WHERE name=?", (name,))
        if agent is None:
            raise web.HTTPNotFound(text="agent not found")
        result = await _agent_health(agent["base_url"])
        agents = ctx.db.query("SELECT * FROM agent_registry ORDER BY name")
        return ctx.render(
            request, "agents.html", agents=agents, test_result={"name": name, **result}
        )

    async def agent_self_register(request):
        """External agents may self-register (reference: app.py:1105-1160)."""
        body = await request.json()
        name = str(body.get("name") or "").strip()
        base_url = str(body.get("base_url") or "").strip()
        if not name or not base_url:
            return web.json_response({"ok": False, "error": "name and base_url required"}, status=422)
        ctx.db.execute(
            "INSERT OR REPLACE INTO agent_registry (name, base_url, auth_kind, enabled,"
            " capabilities_json, created_at) VALUES (?,?,'none',1,?,?)",
            (name, base_url, json.dumps(body.get("capabilities", [])), time.time()),
        )
        return web.json_response({"ok": True, "name": name})

    async def agent_heartbeat(request):
        name = request.match_info["name"]
        n = ctx.db.execute_rowcount(
            "UPDATE agent_registry SET last_heartbeat=? WHERE name=?", (time.time(), name)
        )
        if not n:
            return web.json_response({"ok": False, "error": "unknown agent"}, status=404)
        return web.json_response({"ok": True})

    async def api_agents(request):
        agents = ctx.db.query("SELECT name, base_url, enabled, last_heartbeat FROM agent_registry")
        return web.json_response({"agents": agents})

    # ------------------------------------------------------------------
    # projects + API keys + budgets
    # ------------------------------------------------------------------

    @require_login
    async def projects_page(request):
        projects = ctx.db.query(
            "SELECT p.*, b.monthly_budget_micro_usd, b.spent_micro_usd FROM projects p"
            " LEFT JOIN project_budgets b ON b.project_id=p.id ORDER BY p.name"
        )
        return ctx.render(request, "projects.html", projects=projects, new_key=None)

    @require_roles("admin", "operator")
    async def project_create(request):
        form = await request.post()
        name = str(form.get("name") or "").strip()
        if not name:
            raise web.HTTPBadRequest(text="name required")
        ctx.db.execute(
            "INSERT OR IGNORE INTO projects (name, created_at) VALUES (?,?)", (name, time.time())
        )
        # Re-read the id: an ignored duplicate insert returns no usable
        # lastrowid, and re-submitting an existing project must still be
        # able to set its budget.
        pid = ctx.db.one("SELECT id FROM projects WHERE name=?", (name,))["id"]
        budget = int(form.get("monthly_budget_micro_usd") or 0)
        if pid and budget:
            ctx.db.execute(
                "INSERT OR REPLACE INTO project_budgets (project_id, monthly_budget_micro_usd,"
                " spent_micro_usd) VALUES (?,?,COALESCE((SELECT spent_micro_usd FROM"
                " project_budgets WHERE project_id=?),0))",
                (pid, budget, pid),
            )
        ctx.db.audit(request["user"].email, "project.create", {"name": name})
        raise web.HTTPFound("/projects")

    @require_login
    async def project_select(request):
        form = await request.post()
        pid = str(form.get("project_id") or "")
        resp = web.HTTPFound("/projects")
        if pid:
            resp.set_cookie(PROJECT_COOKIE, pid, httponly=True, samesite="Lax")
        else:
            resp.del_cookie(PROJECT_COOKIE)
        raise resp

    @require_login
    async def project_clear(request):
        """Drop the active-project cookie (reference: app.py:1436-1486)."""
        resp = web.HTTPFound("/projects")
        resp.del_cookie(PROJECT_COOKIE)
        raise resp

    @require_roles("admin", "operator")
    async def project_api_key(request):
        """Mint an API key: shown once, stored as sha256
        (reference: app.py:1489-1510)."""
        form = await request.post()
        pid = int(form.get("project_id", 0))
        key = f"kk-{secrets.token_urlsafe(24)}"
        ctx.db.execute(
            "INSERT INTO project_api_keys (project_id, key_hash, label, created_at)"
            " VALUES (?,?,?,?)",
            (pid, _hash_api_key(key), str(form.get("label") or ""), time.time()),
        )
        ctx.db.audit(request["user"].email, "project.api_key.create", {"project_id": pid})
        projects = ctx.db.query(
            "SELECT p.*, b.monthly_budget_micro_usd, b.spent_micro_usd FROM projects p"
            " LEFT JOIN project_budgets b ON b.project_id=p.id ORDER BY p.name"
        )
        return ctx.render(request, "projects.html", projects=projects, new_key=key)

    # ------------------------------------------------------------------
    # public ingest API (X-API-Key) with budget enforcement
    # ------------------------------------------------------------------

    async def api_ingest_run(request):
        """Programmatic run ingestion (reference: app.py:1512-1605)."""
        api_key = request.headers.get("X-API-Key", "")
        if not api_key:
            return web.json_response({"ok": False, "error": "X-API-Key required"}, status=401)
        row = ctx.db.one(
            "SELECT * FROM project_api_keys WHERE key_hash=? AND revoked=0",
            (_hash_api_key(api_key),),
        )
        if row is None:
            return web.json_response({"ok": False, "error": "invalid API key"}, status=403)
        project_id = row["project_id"]

        try:
            body = await request.json()
            prompt = str(body.get("prompt") or "")
            response_text = str(body.get("response") or "")
            app_id = str(body.get("app_id") or "api-app")
        except Exception:  # noqa: BLE001
            return web.json_response({"ok": False, "error": "bad json"}, status=422)

        tokens_in = estimate_tokens(prompt)
        tokens_out = estimate_tokens(response_text)
        cost = estimate_cost_micro_usd(tokens_in, tokens_out)

        status = "ok"
        error: Optional[str] = None
        budget = ctx.db.one("SELECT * FROM project_budgets WHERE project_id=?", (project_id,))
        if budget and budget["monthly_budget_micro_usd"] > 0:
            if budget["spent_micro_usd"] + cost > budget["monthly_budget_micro_usd"]:
                status, error = "error", "budget exceeded"

        from kakveda_tpu_torch.dashboard.db import new_trace_id

        trace_id = str(body.get("trace_id") or new_trace_id())
        inserted = ctx.db.execute_rowcount(
            "INSERT OR IGNORE INTO trace_runs (trace_id, ts, app_id, agent_id, project_id, prompt,"
            " response, provider, model, latency_ms, tokens_in, tokens_out, cost_micro_usd,"
            " status, error, tags_json) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (
                trace_id,
                time.time(),
                app_id,
                str(body.get("agent_id") or "api"),
                project_id,
                prompt,
                response_text,
                str(body.get("provider") or "api"),
                body.get("model"),
                body.get("latency_ms"),
                tokens_in,
                tokens_out,
                cost,
                status,
                error,
                json.dumps(body.get("tags", [])),
            ),
        )
        # A duplicate trace_id is a retry: acknowledge idempotently without
        # charging the budget or re-running the pipeline.
        if inserted == 0:
            return web.json_response(
                {"ok": True, "trace_id": trace_id, "cost_micro_usd": 0, "duplicate": True}
            )
        if status == "ok" and budget:
            ctx.db.execute(
                "UPDATE project_budgets SET spent_micro_usd = spent_micro_usd + ? WHERE project_id=?",
                (cost, project_id),
            )
        if status == "ok":
            await plat.ingest(
                TracePayload(
                    trace_id=trace_id,
                    ts=datetime.now(timezone.utc),
                    app_id=app_id,
                    agent_id=str(body.get("agent_id") or "api"),
                    prompt=prompt,
                    response=response_text,
                    model=body.get("model"),
                    tools=list(body.get("tools", [])),
                    env=dict(body.get("env", {})),
                )
            )
        code = 200 if status == "ok" else 402
        return web.json_response(
            {"ok": status == "ok", "trace_id": trace_id, "cost_micro_usd": cost, "error": error},
            status=code,
        )

    app.add_routes(
        [
            web.get("/admin/users", admin_users),
            web.post("/admin/users/role", admin_set_role),
            web.post("/admin/users/toggle", admin_toggle_active),
            web.post("/admin/impersonate", admin_impersonate),
            web.get("/admin/audit", admin_audit),
            web.get("/admin/purge-demo", admin_purge_demo_page),
            web.post("/admin/purge-demo", admin_purge_demo),
            web.get("/admin/agents", admin_agents_page),
            web.get("/admin/serving", admin_serving_page),
            web.post("/admin/serving/prefix", admin_serving_prefix),
            web.post("/admin/agents/delete", admin_agent_delete),
            web.get("/admin/agents/{name}/test", admin_agent_test),
            web.get("/agents", agents_page),
            web.post("/agents/register", agent_register),
            web.post("/agents/toggle", agent_toggle),
            web.get("/agents/{name}/test", agent_test),
            web.post("/api/agents/register", agent_self_register),
            web.post("/api/agents/{name}/heartbeat", agent_heartbeat),
            web.get("/api/agents", api_agents),
            web.get("/projects", projects_page),
            web.post("/projects/create", project_create),
            web.post("/projects/select", project_select),
            web.post("/projects/clear", project_clear),
            web.post("/projects/api-key", project_api_key),
            web.post("/api/ingest/run", api_ingest_run),
        ]
    )
