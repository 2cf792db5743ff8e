"""Core dashboard pages: home, health, failures, scenarios, warnings, runs,
playground (reference: services/dashboard/app.py §2.1-2.8 areas).

The port's copy of ``kakveda_tpu/dashboard/routes_main.py``.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

from aiohttp import web

import asyncio

from kakveda_tpu_torch.core import admission as _admission
from kakveda_tpu_torch.core.admission import DeviceUnavailableError, OverloadError
from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
from kakveda_tpu_torch.dashboard.core import CTX_KEY, require_login, require_roles
from kakveda_tpu_torch.dashboard.db import new_trace_id
from kakveda_tpu_torch.models.runtime import UnknownModelError


async def off_loop(fn, *args, **kwargs):
    """Run a blocking call (model generate, sync HTTP) in the executor so it
    can't stall the shared event loop serving /warn and /healthz."""
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, lambda: fn(*args, **kwargs))


# Optional per-client token bucket on the playground routes
# (KAKVEDA_RATELIMIT_RPS, same shape as the service /ingest limiter:
# 429 + Retry-After). Lazy module-level singleton — the env is read once,
# like every other serving lever.
_PLAYGROUND_BUCKET = None
_PLAYGROUND_BUCKET_INIT = False


def _playground_ratelimit(request) -> None:
    global _PLAYGROUND_BUCKET, _PLAYGROUND_BUCKET_INIT
    if not _PLAYGROUND_BUCKET_INIT:
        _PLAYGROUND_BUCKET_INIT = True
        rps = float(os.environ.get("KAKVEDA_RATELIMIT_RPS", "0") or 0)
        if rps > 0:
            from kakveda_tpu_torch.core.ratelimit import TokenBucket

            burst = os.environ.get("KAKVEDA_RATELIMIT_BURST")
            _PLAYGROUND_BUCKET = TokenBucket(rps, float(burst) if burst else None)
    if _PLAYGROUND_BUCKET is None:
        return
    ok, ra = _PLAYGROUND_BUCKET.allow(request.remote or "anon")
    if not ok:
        _admission.get_admission().note_shed("interactive", "ratelimit", retry_after=ra)
        raise OverloadError(
            "per-client rate limit exceeded", retry_after=ra,
            klass="interactive", reason="ratelimit",
        )


def _retry_after_http(e) -> "web.HTTPException":
    """Map a typed shed/degraded error to the playground's HTTP answer:
    429 (overload) or 503 (device loss), both with Retry-After."""
    headers = {"Retry-After": str(max(1, int(round(e.retry_after))))}
    if isinstance(e, OverloadError):
        return web.HTTPTooManyRequests(text=str(e), headers=headers)
    return web.HTTPServiceUnavailable(text=str(e), headers=headers)

TOKEN_PRICE_MICRO_USD_IN = 15  # per 1k tokens — env-tunable in the runtime config
TOKEN_PRICE_MICRO_USD_OUT = 75


def estimate_tokens(text: str) -> int:
    """len/4 heuristic (reference: services/dashboard/app.py:139-147)."""
    return max(1, len(text or "") // 4)


def estimate_cost_micro_usd(tokens_in: int, tokens_out: int) -> int:
    return (tokens_in * TOKEN_PRICE_MICRO_USD_IN + tokens_out * TOKEN_PRICE_MICRO_USD_OUT) // 1000


def parse_advanced_query(q: str) -> Dict[str, Any]:
    """Runs-explorer mini query language: free text plus ``provider:x``,
    ``model:x``, ``project:x``, ``tag:x`` / ``label:x`` (repeatable —
    a run matches ANY of the listed values), ``thumb:up``,
    ``latency_ms>N`` / ``latency_ms<N``, ``has:error``
    (reference: services/dashboard/app.py:173-221)."""
    out: Dict[str, Any] = {"text": [], "filters": {}}
    f = out["filters"]
    for tok in (q or "").split():
        if tok.startswith(("provider:", "model:", "thumb:", "project:")):
            k, _, v = tok.partition(":")
            f[k] = v
        elif tok.startswith(("tag:", "label:")):
            k, _, v = tok.partition(":")
            f.setdefault(k + "s", []).append(v)
        elif tok.startswith("latency_ms") and (">" in tok or "<" in tok):
            op = ">" if ">" in tok else "<"
            try:
                f["latency_gt" if op == ">" else "latency_lt"] = int(tok.split(op, 1)[1])
            except ValueError:
                pass
        elif tok == "has:error":
            f["has_error"] = True
        else:
            out["text"].append(tok)
    out["text"] = " ".join(out["text"])
    return out


def setup(app: web.Application) -> None:
    ctx = app[CTX_KEY]
    plat = ctx.platform

    # ------------------------------------------------------------------
    # home
    # ------------------------------------------------------------------

    @require_login
    async def home(request):
        # Paged + incrementally-maintained accessors: the home view costs
        # O(page), not O(all records), at 1M-row GFKBs.
        failures = plat.failures_page(limit=15)
        patterns = plat.patterns_list()
        apps = plat.apps()
        health = {a: plat.health_history(a, limit=1) for a in apps}
        recent_warnings = ctx.db.query(
            "SELECT * FROM warning_events ORDER BY ts DESC LIMIT 10"
        )
        return ctx.render(
            request,
            "home.html",
            failures=failures,
            patterns=patterns,
            health={a: (pts[-1] if pts else None) for a, pts in health.items()},
            recent_warnings=recent_warnings,
            gfkb_count=plat.gfkb.count,
        )

    # ------------------------------------------------------------------
    # health + failure detail
    # ------------------------------------------------------------------

    @require_login
    async def health_page(request):
        app_id = request.query.get("app_id", "")
        apps = plat.apps()
        points = plat.health_history(app_id, limit=100) if app_id else []
        return ctx.render(request, "health.html", apps=apps, app_id=app_id, points=points)

    @require_roles("admin")
    async def health_test(request):
        """Admin fault injection: publish a synthetic failure.detected
        (reference: services/dashboard/app.py:1762-1819)."""
        form = await request.post()
        app_id = str(form.get("app_id") or "test-app")
        severity = str(form.get("severity") or "medium")
        ftype = str(form.get("failure_type") or "SYNTHETIC_TEST")
        event = {
            "trace_id": new_trace_id(),
            "ts": datetime.now(timezone.utc).isoformat(),
            "app_id": app_id,
            "failure_type": ftype,
            "severity": severity,
            "context_signature": {"injected": True},
        }
        await plat.bus.publish("failure.detected", event)
        ctx.db.audit(request["user"].email, "health.test", event)
        raise web.HTTPFound(f"/health-page?app_id={app_id}")

    @require_login
    async def failure_detail(request):
        fid = request.match_info["failure_id"]
        # Version-aware lookup: F-0001v3 pins a version, plain id = latest
        # (reference: services/dashboard/app.py:1822-1909).
        want_version = None
        if "v" in fid[2:]:
            base, _, v = fid.rpartition("v")
            if v.isdigit():
                fid, want_version = base, int(v)
        rec = plat.get_failure(fid)
        if rec is None:
            raise web.HTTPNotFound(text=f"failure {fid} not found")
        history = []
        if plat.gfkb.failures_path.exists():
            # The failures log grows unbounded — read it off the event loop
            # so a big GFKB doesn't stall every other request.
            raw = await asyncio.get_running_loop().run_in_executor(
                None, lambda: plat.gfkb.failures_path.read_text(encoding="utf-8")
            )
            for line in raw.splitlines():
                if not line.strip():
                    continue
                row = json.loads(line)
                if row.get("failure_id") == fid:
                    history.append(row)
        shown = rec.model_dump(mode="json")
        if want_version is not None:
            pinned = next((h for h in history if h.get("version") == want_version), None)
            if pinned:
                shown = pinned
        return ctx.render(
            request, "failure_detail.html", failure=shown, history=history, latest=rec
        )

    # ------------------------------------------------------------------
    # scenario runner
    # ------------------------------------------------------------------

    @require_login
    async def scenarios_page(request):
        recent = ctx.db.query("SELECT * FROM scenario_runs ORDER BY ts DESC LIMIT 20")
        return ctx.render(request, "scenarios.html", recent=recent)

    @require_roles("admin", "operator")
    async def run_scenario(request):
        """The canonical end-to-end path: warn → generate → ingest, with
        span capture (reference: services/dashboard/app.py:2094-2226)."""
        form = await request.post()
        app_id = str(form.get("app_id") or "app-A")
        prompt = str(form.get("prompt") or "")
        if not prompt:
            raise web.HTTPBadRequest(text="prompt required")
        user = request["user"]
        trace_id = new_trace_id()
        t_start = time.time()

        w_t0 = time.time()
        warning = await off_loop(
            plat.warn,
            WarningRequest(app_id=app_id, agent_id="dashboard", prompt=prompt, tools=[], env={}),
        )
        w_t1 = time.time()

        g_t0 = time.time()
        gen = await off_loop(ctx.model.generate, prompt)
        g_t1 = time.time()

        # Rich trace row BEFORE plat.ingest: the dashboard's trace.ingested
        # subscriber inserts a sparse fallback row for externally-ingested
        # traces, and INSERT OR IGNORE means whichever lands first wins.
        tokens_in = estimate_tokens(prompt)
        tokens_out = estimate_tokens(gen.text)
        ctx.db.execute(
            "INSERT OR IGNORE INTO trace_runs (trace_id, ts, app_id, agent_id, prompt, response,"
            " provider, model, latency_ms, tokens_in, tokens_out, cost_micro_usd, status)"
            " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,'ok')",
            (
                trace_id,
                t_start,
                app_id,
                "dashboard",
                prompt,
                gen.text,
                gen.meta.get("provider"),
                gen.meta.get("model"),
                gen.meta.get("latency_ms"),
                tokens_in,
                tokens_out,
                estimate_cost_micro_usd(tokens_in, tokens_out),
            ),
        )

        i_t0 = time.time()
        trace = TracePayload(
            trace_id=trace_id,
            ts=datetime.now(timezone.utc),
            app_id=app_id,
            agent_id="dashboard",
            prompt=prompt,
            response=gen.text,
            model=gen.meta.get("model"),
            tools=[],
            env={},
        )
        await plat.ingest(trace)
        i_t1 = time.time()
        ctx.db.execute(
            "INSERT INTO scenario_runs (ts, user_email, app_id, prompt, response, warning_action,"
            " warning_confidence, provider, model, latency_ms, trace_id) VALUES (?,?,?,?,?,?,?,?,?,?,?)",
            (
                t_start,
                user.email,
                app_id,
                prompt,
                gen.text,
                warning.action,
                warning.confidence,
                gen.meta.get("provider"),
                gen.meta.get("model"),
                gen.meta.get("latency_ms"),
                trace_id,
            ),
        )
        best = warning.references[0] if warning.references else None
        wid = ctx.db.execute(
            "INSERT INTO warning_events (ts, app_id, action, confidence, pattern_id, failure_id,"
            " failure_type, message, source) VALUES (?,?,?,?,?,?,?,?, 'scenario')",
            (
                t_start,
                app_id,
                warning.action,
                warning.confidence,
                warning.pattern_id,
                best.failure_id if best else None,
                best.failure_type if best else None,
                warning.message,
            ),
        )
        parent = ctx.db.add_span(trace_id, "scenario.run", t_start, i_t1)
        ctx.db.add_span(trace_id, "warn_policy.call", w_t0, w_t1, parent, {"action": warning.action})
        ctx.db.add_span(trace_id, "model.generate", g_t0, g_t1, parent, gen.meta)
        ctx.db.add_span(trace_id, "ingestion.ingest", i_t0, i_t1, parent)
        ctx.db.audit(user.email, "scenario.run", {"app_id": app_id, "trace_id": trace_id})
        raise web.HTTPFound(f"/warnings#w-{wid}")

    # ------------------------------------------------------------------
    # warnings + analytics
    # ------------------------------------------------------------------

    @require_login
    async def warnings_page(request):
        """Warning list + interactive analytics (reference:
        services/dashboard/app.py:1912-2041, templates/warnings.html):
        stat tiles, a 30-day daily-count chart with every day present,
        per-app / per-pattern / cost breakdowns — plus the raw 90-day rows
        shipped as JSON so the 30d/90d window and app filter re-aggregate
        CLIENT-side with no round trip."""
        now = time.time()
        d30 = now - 30 * 86400
        app_filter = (request.query.get("app_id") or "").strip()
        sql = "SELECT * FROM warning_events WHERE ts>?"
        params: List[Any] = [now - 90 * 86400]
        if app_filter:
            sql += " AND app_id=?"
            params.append(app_filter)
        events = ctx.db.query(sql + " ORDER BY ts DESC LIMIT 500", tuple(params))
        # Aggregates run over the FULL 30d window in SQL — the event list
        # is capped at the 500 newest, and deriving the tiles/chart from
        # it would silently undercount busy deployments.
        def agg(col_expr: str, since: float):
            q = (
                f"SELECT {col_expr} AS k, COUNT(*) AS n FROM warning_events "
                "WHERE ts>?" + (" AND app_id=?" if app_filter else "") + " GROUP BY k"
            )
            p = [since] + ([app_filter] if app_filter else [])
            return ctx.db.query(q, tuple(p))

        by_day: Dict[int, int] = {
            int(r["k"]): r["n"] for r in agg("CAST(ts/86400 AS INTEGER)", d30)
        }
        by_app = [
            (r["k"], r["n"])
            for r in sorted(agg("app_id", d30), key=lambda r: -r["n"])
        ]
        by_pattern = [
            (r["k"], r["n"])
            for r in sorted(agg("pattern_id", d30), key=lambda r: -r["n"])
            if r["k"]
        ]
        # Every day present (zero-filled) so the chart reads as a time
        # series, not a sparse list of whichever days had warnings. Keys
        # run from the cutoff's UTC day through TODAY inclusive — the
        # cutoff day holds real events (SQL keeps ts > d30 within it),
        # and anything past today would be a phantom empty bucket.
        day0, day_last = int(d30 // 86400), int(now // 86400)
        by_day_filled = [
            (
                datetime.fromtimestamp(d * 86400, tz=timezone.utc).strftime("%Y-%m-%d"),
                by_day.get(d, 0),
            )
            for d in range(day0, day_last + 1)
        ]
        cost_sql = "SELECT app_id, SUM(cost_micro_usd) AS cost FROM trace_runs WHERE ts>?"
        cost_params: List[Any] = [d30]
        if app_filter:
            cost_sql += " AND app_id=?"
            cost_params.append(app_filter)
        cost_rows = ctx.db.query(cost_sql + " GROUP BY app_id", tuple(cost_params))
        total_cost = sum((c["cost"] or 0) for c in cost_rows) / 1e6
        n30 = sum(n for _, n in by_day_filled)
        # Raw rows for instant client-side re-aggregation (the newest 500
        # of the 90d window; `truncated` tells the client its re-derived
        # numbers are a view, not the full count). "<" is escaped so a
        # hostile app_id cannot terminate the <script> block (stored XSS).
        rows_json = json.dumps(
            {
                "truncated": len(events) >= 500,
                "rows": [
                    {
                        "ts": e["ts"],
                        "app_id": e["app_id"],
                        "action": e["action"],
                        "pattern_id": e["pattern_id"],
                        "confidence": e["confidence"],
                    }
                    for e in events
                ],
            }
        ).replace("<", "\\u003c")
        # Full-window SQL aggregates for the INITIAL render: the client
        # script only re-aggregates from the truncated rows_json once a
        # filter changes (with a visible "view" badge) — deriving the
        # first paint from 500 rows would silently undercount busy
        # deployments (the very thing the SQL aggregation exists for).
        server_agg_json = json.dumps(
            {
                "by_day": by_day_filled,
                "by_app": by_app[:12],
                "by_pattern": by_pattern[:12],
                "n_events": len(events),
            }
        ).replace("<", "\\u003c")
        return ctx.render(
            request,
            "warnings.html",
            events=events,
            server_agg_json=server_agg_json,
            cost_by_app=cost_rows,
            total_warnings_30d=n30,
            apps_active_30d=len(by_app),
            total_cost_usd_30d=total_cost,
            rows_json=rows_json,
            app_filter=app_filter,
        )

    # ------------------------------------------------------------------
    # runs explorer + detail + feedback
    # ------------------------------------------------------------------

    @require_login
    async def runs_page(request):
        q = request.query.get("q", "")
        parsed = parse_advanced_query(q)
        sql = "SELECT * FROM trace_runs"
        clauses: List[str] = []
        params: List[Any] = []
        f = parsed["filters"]
        if f.get("provider"):
            clauses.append("provider=?")
            params.append(f["provider"])
        if f.get("model"):
            clauses.append("model=?")
            params.append(f["model"])
        if f.get("latency_gt") is not None:
            clauses.append("latency_ms>?")
            params.append(f["latency_gt"])
        if f.get("latency_lt") is not None:
            clauses.append("latency_ms<?")
            params.append(f["latency_lt"])
        if f.get("has_error"):
            clauses.append("(status='error' OR error IS NOT NULL)")
        if f.get("project"):
            # project:<name> (or a raw numeric id) scopes to one project.
            proj = ctx.db.one("SELECT id FROM projects WHERE name=?", (f["project"],))
            if proj is not None:
                clauses.append("project_id=?")
                params.append(proj["id"])
            elif f["project"].isdigit():
                clauses.append("project_id=?")
                params.append(int(f["project"]))
            else:
                clauses.append("1=0")  # unknown project: empty result, not all runs
        if f.get("tags"):
            # Repeatable tag: — a run matches ANY of the listed tags
            # (reference IN-subquery semantics, app.py:2831-2837).
            clauses.append("(" + " OR ".join(["tags_json LIKE ?"] * len(f["tags"])) + ")")
            params.extend(f"%{t}%" for t in f["tags"])
        if parsed["text"]:
            clauses.append("(prompt LIKE ? OR response LIKE ? OR app_id LIKE ?)")
            like = f"%{parsed['text']}%"
            params.extend([like, like, like])
        if f.get("thumb") or f.get("labels"):
            sub = "SELECT trace_id FROM run_feedback WHERE 1=1"
            if f.get("thumb"):
                sub += " AND thumb=?"
                params.append(f["thumb"])
            if f.get("labels"):
                sub += " AND label IN (" + ",".join("?" * len(f["labels"])) + ")"
                params.extend(f["labels"])
            clauses.append(f"trace_id IN ({sub})")
        if clauses:
            sql += " WHERE " + " AND ".join(clauses)
        sql += " ORDER BY ts DESC LIMIT 100"
        runs = ctx.db.query(sql, params)
        return ctx.render(request, "runs.html", runs=runs, q=q)

    @require_login
    async def run_detail(request):
        trace_id = request.match_info["trace_id"]
        run = ctx.db.one("SELECT * FROM trace_runs WHERE trace_id=?", (trace_id,))
        if run is None:
            raise web.HTTPNotFound(text="run not found")
        spans = ctx.db.query(
            "SELECT * FROM trace_spans WHERE trace_id=? ORDER BY start_ts", (trace_id,)
        )
        # Waterfall layout: a real span TREE (parent walk, depth-indented,
        # children under their parent in start order) with pct offsets
        # relative to the full window (reference:
        # services/dashboard/app.py:2927-2970).
        total_ms = 1
        if spans:
            t0 = min(s["start_ts"] for s in spans)
            t1 = max(s["end_ts"] for s in spans)
            total = max(t1 - t0, 1e-6)
            total_ms = int(total * 1000)
            by_parent: Dict[Optional[int], List[Dict]] = defaultdict(list)
            for s in spans:
                s["pct_left"] = round(100.0 * (s["start_ts"] - t0) / total, 2)
                s["pct_width"] = round(max(0.5, 100.0 * (s["end_ts"] - s["start_ts"]) / total), 2)
                s["start_off_ms"] = int((s["start_ts"] - t0) * 1000)
                s["duration_ms"] = int((s["end_ts"] - s["start_ts"]) * 1000)
                s["meta"] = json.loads(s["meta_json"] or "{}")
                by_parent[s["parent_id"]].append(s)
            for kids in by_parent.values():
                kids.sort(key=lambda s: s["start_ts"])
            ordered: List[Dict] = []
            seen: set = set()

            def walk(parent_id, depth):
                for s in by_parent.get(parent_id, []):
                    if s["id"] in seen:  # parent cycle from corrupted ingestion
                        continue
                    seen.add(s["id"])
                    s["depth"] = depth
                    s["has_children"] = bool(by_parent.get(s["id"]))
                    ordered.append(s)
                    walk(s["id"], depth + 1)

            walk(None, 0)
            # Orphan subtrees (parent_id points at a span not in this
            # trace — partial ingestion, pruned parent): walk them as
            # extra roots rather than silently dropping them from the
            # waterfall.
            span_ids = {s["id"] for s in spans}
            for s in sorted(spans, key=lambda s: s["start_ts"]):
                if s["id"] not in seen and s["parent_id"] not in span_ids:
                    seen.add(s["id"])
                    s["depth"] = 0
                    s["has_children"] = bool(by_parent.get(s["id"]))
                    ordered.append(s)
                    walk(s["id"], 1)
            # Last resort: spans whose parent chain never reaches a root —
            # a parent cycle or self-parenting row. Surface them as extra
            # depth-0 rows (the seen-guard in walk() breaks the cycle)
            # instead of vanishing them from the waterfall.
            for s in sorted(spans, key=lambda s: s["start_ts"]):
                if s["id"] not in seen:
                    seen.add(s["id"])
                    s["depth"] = 0
                    s["has_children"] = bool(by_parent.get(s["id"]))
                    ordered.append(s)
                    walk(s["id"], 1)
            spans = ordered
        feedback = ctx.db.query("SELECT * FROM run_feedback WHERE trace_id=?", (trace_id,))
        return ctx.render(
            request, "run_detail.html", run=run, spans=spans, feedback=feedback,
            total_ms=total_ms,
        )

    @require_login
    async def run_feedback(request):
        trace_id = request.match_info["trace_id"]
        form = await request.post()
        thumb = str(form.get("thumb") or "")
        label = str(form.get("label") or "") or None
        note = str(form.get("note") or "") or None
        if thumb not in ("up", "down"):
            raise web.HTTPBadRequest(text="thumb must be up|down")
        ctx.db.execute(
            "INSERT OR IGNORE INTO run_feedback (trace_id, user_email, thumb, label, note, ts)"
            " VALUES (?,?,?,?,?,?)",
            (trace_id, request["user"].email, thumb, label, note, time.time()),
        )
        raise web.HTTPFound(f"/runs/{trace_id}")

    # ------------------------------------------------------------------
    # playground
    # ------------------------------------------------------------------

    # Model listing may hit the network (Ollama /api/tags, 3 s timeout);
    # cache it so page loads and run re-renders don't pay that per request.
    _models_cache: dict = {"ts": 0.0, "models": None}
    _MODELS_TTL_S = 60.0

    async def _get_models() -> list:
        now = time.time()
        if _models_cache["models"] is None or now - _models_cache["ts"] > _MODELS_TTL_S:
            from kakveda_tpu_torch.models.runtime import list_models

            _models_cache["models"] = await off_loop(list_models, ctx.model)
            _models_cache["ts"] = now
        return _models_cache["models"]

    @require_login
    async def playground_page(request):
        agents = ctx.db.query("SELECT * FROM agent_registry WHERE enabled=1")
        prompts = ctx.db.query(
            "SELECT p.name, v.text, v.version FROM prompt_library p JOIN prompt_versions v"
            " ON v.prompt_id=p.id ORDER BY p.name, v.version DESC"
        )
        experiments = ctx.db.query("SELECT * FROM experiments ORDER BY created_at DESC")
        return ctx.render(
            request,
            "playground.html",
            agents=agents,
            prompts=prompts,
            experiments=experiments,
            models=await _get_models(),
            result=None,
        )

    def record_playground_run(trace_id, t0, t1, prompt, text, provider, model, latency_ms, span, meta):
        """One trace_runs row + span for a playground invocation — shared by
        the blocking and streaming endpoints (same table shape, same cost
        accounting)."""
        tokens_in, tokens_out = estimate_tokens(prompt), estimate_tokens(text)
        ctx.db.execute(
            "INSERT OR IGNORE INTO trace_runs (trace_id, ts, app_id, agent_id, prompt,"
            " response, provider, model, latency_ms, tokens_in, tokens_out,"
            " cost_micro_usd, status) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,'ok')",
            (
                trace_id, t0, "playground", provider, prompt, text, provider,
                model, latency_ms, tokens_in, tokens_out,
                estimate_cost_micro_usd(tokens_in, tokens_out),
            ),
        )
        ctx.db.add_span(trace_id, span, t0, t1, meta=meta)

    @require_roles("admin", "operator")
    async def playground_stream(request):
        """Server-sent-events streaming generation: text deltas reach the
        client per decode chunk instead of after the full response — the
        reference's playground blocks on one whole Ollama reply
        (services/dashboard/app.py:3127-3299). Runtimes without a
        generate_stream (the Ollama client) fall back to a single delta
        event; the stub streams word-by-word. The run is recorded to
        trace_runs exactly like /playground/run."""
        form = await request.post()
        prompt = str(form.get("prompt") or "")
        if not prompt:
            raise web.HTTPBadRequest(text="prompt required")
        _playground_ratelimit(request)
        chosen_target = str(form.get("target") or "model")
        chosen = (
            chosen_target.split(":", 1)[1] if chosen_target.startswith("model:") else None
        )
        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "X-Accel-Buffering": "no",
            }
        )
        await resp.prepare(request)
        loop = asyncio.get_running_loop()
        ch: asyncio.Queue = asyncio.Queue()
        t0 = time.time()

        import threading

        cancelled = threading.Event()

        def pump():
            # Blocking generator runs in the executor; deltas hop to the
            # event loop thread-safely. The sentinel carries the outcome.
            # On client disconnect the handler sets `cancelled`; closing
            # the generator cancels the engine request (slot frees instead
            # of decoding for nobody).
            try:
                stream_fn = getattr(ctx.model, "generate_stream", None)
                parts: list = []
                if callable(stream_fn):
                    try:
                        gen = stream_fn(prompt, model=chosen, cancel=cancelled)
                    except TypeError:  # runtime without cancel support
                        gen = stream_fn(prompt, model=chosen)
                    try:
                        for d in gen:
                            parts.append(d)
                            loop.call_soon_threadsafe(ch.put_nowait, ("delta", d))
                            if cancelled.is_set():
                                break
                    finally:
                        gen.close()
                else:
                    gen = ctx.model.generate(prompt, model=chosen)
                    parts.append(gen.text)
                    loop.call_soon_threadsafe(ch.put_nowait, ("delta", gen.text))
                loop.call_soon_threadsafe(ch.put_nowait, ("done", "".join(parts)))
            except (OverloadError, DeviceUnavailableError) as e:
                # Shed/brownout/degraded rejection: the terminal error
                # frame carries the RETRY HINT so an EventSource client
                # can back off and resubmit instead of guessing.
                loop.call_soon_threadsafe(
                    ch.put_nowait,
                    ("error", {
                        "error": f"{type(e).__name__}: {e}",
                        "retry_after": round(e.retry_after, 2),
                        "retryable": True,
                    }),
                )
            except Exception as e:  # noqa: BLE001 — surface in-stream, not a 500 mid-SSE
                loop.call_soon_threadsafe(ch.put_nowait, ("error", f"{type(e).__name__}: {e}"))

        task = loop.run_in_executor(None, pump)
        text = ""
        # Idle streams emit SSE comment keepalives so buffering/idle-timeout
        # proxies don't sever the connection while a request waits for a
        # slot or a slow chunk (comment lines are invisible to clients).
        keepalive_s = float(os.environ.get("KAKVEDA_SSE_KEEPALIVE", "15"))
        last_write = time.monotonic()
        try:
            while True:
                try:
                    kind, payload = await asyncio.wait_for(ch.get(), timeout=0.5)
                except asyncio.TimeoutError:
                    # No delta yet (queued behind a full pool, or a slow
                    # model): a write has never failed, so poll the
                    # transport — a gone client must cancel the engine
                    # request instead of holding a slot for nobody.
                    tr = request.transport
                    if tr is None or tr.is_closing():
                        cancelled.set()
                        break
                    if keepalive_s > 0 and time.monotonic() - last_write >= keepalive_s:
                        await resp.write(b": keepalive\n\n")
                        last_write = time.monotonic()
                    continue
                last_write = time.monotonic()
                if kind == "delta":
                    await resp.write(
                        b"data: " + json.dumps({"delta": payload}).encode() + b"\n\n"
                    )
                elif kind == "error":
                    # Terminal error frame (engine died mid-stream, model
                    # raised, request shed by admission/brownout): a typed
                    # `event: error` so EventSource clients get an
                    # addressable event, plus the error in the data
                    # payload for raw line parsers — then the stream
                    # CLOSES instead of going silent until the client
                    # times out. Shed payloads arrive as dicts carrying
                    # the retry_after hint; plain failures as strings.
                    body = payload if isinstance(payload, dict) else {"error": payload}
                    await resp.write(
                        b"event: error\ndata: " + json.dumps(body).encode() + b"\n\n"
                    )
                    break
                else:
                    text = payload
                    latency_ms = int((time.time() - t0) * 1000)
                    await resp.write(
                        b"data: "
                        + json.dumps({"done": True, "latency_ms": latency_ms}).encode()
                        + b"\n\n"
                    )
                    break
        except (ConnectionResetError, ConnectionError):
            cancelled.set()  # client went away: stop generating for nobody
        finally:
            cancelled.set()
            await task
        if text:
            t1 = time.time()
            # Provider/model from the runtime, not a hardcoded "torch": the
            # stream yields text only (no meta), but the blocking
            # endpoint records meta["provider"], and a stub/Ollama-backed
            # stream must attribute the same way or provider: queries and
            # the runs table mislabel streamed traffic.
            provider = getattr(ctx.model, "name", None) or "torch"
            model_used = (
                chosen
                or getattr(ctx.model, "model_label", None)
                or getattr(ctx.model, "model", None)
            )
            if model_used is None:
                try:
                    model_used = (ctx.model.list_models() or [None])[0]
                except Exception:  # noqa: BLE001 — attribution must not fail the stream
                    model_used = None
            record_playground_run(
                new_trace_id(), t0, t1, prompt, text, provider, model_used,
                int((t1 - t0) * 1000), "playground.stream", {"streamed": True},
            )
        await resp.write_eof()
        return resp

    @require_roles("admin", "operator")
    async def playground_run(request):
        """Direct model or external-agent invocation with span + cost capture
        (reference: services/dashboard/app.py:3127-3299)."""
        form = await request.post()
        prompt = str(form.get("prompt") or "")
        target = str(form.get("target") or "model")
        experiment = str(form.get("experiment") or "")
        if not prompt:
            raise web.HTTPBadRequest(text="prompt required")
        _playground_ratelimit(request)
        trace_id = new_trace_id()
        t0 = time.time()
        if target.startswith("agent:"):
            name = target.split(":", 1)[1]
            agent = ctx.db.one("SELECT * FROM agent_registry WHERE name=? AND enabled=1", (name,))
            if agent is None:
                raise web.HTTPBadRequest(text=f"unknown agent {name}")
            from kakveda_tpu_torch.core import httpjson

            try:
                body = await off_loop(
                    httpjson.post_json,
                    f"{agent['base_url']}/invoke",
                    {"event_type": "ask", "payload": {"prompt": prompt}},
                    timeout=10.0,
                )
                text = json.dumps(body.get("events", []), indent=1)
                meta = {"provider": f"agent:{name}", "model": name}
            except Exception as e:  # noqa: BLE001 — surface agent errors in UI
                text = f"agent error: {type(e).__name__}: {e}"
                meta = {"provider": f"agent:{name}", "model": name, "error": str(e)}
        else:
            # target "model" (runtime default) or "model:<name>" (explicit
            # model — reference's per-model variant, app.py:1226-1258).
            chosen = target.split(":", 1)[1] if target.startswith("model:") else None
            try:
                gen = await off_loop(lambda: ctx.model.generate(prompt, model=chosen))
                text, meta = gen.text, gen.meta
            except (OverloadError, DeviceUnavailableError) as e:
                # Shed by admission/brownout (429) or device-loss degraded
                # mode (503): retryable by contract, Retry-After attached
                # — never rendered as a fake model answer.
                raise _retry_after_http(e)
            except UnknownModelError as e:
                # Stale/hand-crafted model label (multi-model runtimes
                # reject unknown labels): surface in the UI, not a 500.
                # ONLY the label rejection — other ValueErrors ('no decode
                # room', prompt too long) are real serving faults and must
                # reach the error middleware.
                text = f"model error: {e}"
                meta = {"provider": "error", "model": chosen, "error": str(e)}
        t1 = time.time()
        # Engine-backed generations carry their serving timeline (queue
        # wait, prefill, TTFT, tokens/s, engine request id) in meta; hang
        # it on this request's OTel span so traces correlate with /metrics
        # and the flight recorder by request id. No-op without otel.
        from kakveda_tpu_torch.core import otel as _otel

        _otel.add_span_events("serving.timeline", meta.get("serve"))
        record_playground_run(
            trace_id, t0, t1, prompt, text, meta.get("provider"), meta.get("model"),
            meta.get("latency_ms", int((t1 - t0) * 1000)), "playground.run", meta,
        )
        if experiment:
            exp = ctx.db.one("SELECT id FROM experiments WHERE name=?", (experiment,))
            if exp:
                ctx.db.execute(
                    "INSERT OR IGNORE INTO experiment_runs (experiment_id, trace_id) VALUES (?,?)",
                    (exp["id"], trace_id),
                )
        agents = ctx.db.query("SELECT * FROM agent_registry WHERE enabled=1")
        return ctx.render(
            request,
            "playground.html",
            agents=agents,
            prompts=[],
            experiments=ctx.db.query("SELECT * FROM experiments"),
            models=await _get_models(),
            result={"text": text, "meta": meta, "trace_id": trace_id},
        )

    app.add_routes(
        [
            web.get("/", home),
            web.get("/health-page", health_page),
            web.post("/health/test", health_test),
            web.get("/failures/{failure_id}", failure_detail),
            web.get("/scenarios", scenarios_page),
            web.post("/scenarios/run", run_scenario),
            web.get("/warnings", warnings_page),
            web.get("/runs", runs_page),
            web.get("/runs/{trace_id}", run_detail),
            web.post("/runs/{trace_id}/feedback", run_feedback),
            web.get("/playground", playground_page),
            web.post("/playground/run", playground_run),
            web.post("/playground/stream", playground_stream),
        ]
    )
