"""The port's dashboard against the JAX package's, on the CPU.

Every flow of ``tests/test_dashboard.py`` and ``tests/test_otel_revocation.py``
runs through both apps: ``kakveda_tpu.dashboard.app.make_dashboard_app`` over
the JAX ``Platform`` (one device, so exact ties break by the lowest slot, as
the port's do) and ``kakveda_tpu_torch.dashboard.app.make_dashboard_app`` over
``Platform(device="cpu")``, each at capacity 256 and dim 1024 with its own
``StubRuntime`` (two flows serve a tiny Llama instead: the JAX runtime, and the
port's over the same weights). Each flow sends one request sequence and makes
the reference test's own assertions in both packages; the test then holds the
port's transcript to the JAX package's: every response's status, redirect
target, content type, security headers, the cookies it sets (by name) and its
body (rendered HTML or JSON), and at the end every table of the dashboard's
sqlite database (``trace_runs``, ``trace_spans``, the eval results and the
rest, row for row).

Normalised in both transcripts before they are compared, and nothing else:

* CSP nonces (``nonce-…`` in the header, ``nonce="…"`` in a page);
* CSRF tokens and JWTs (only cookie names are compared, never their values);
* generated ids: UUIDs and 32-hex ids (trace ids, a request's serving trace
  id, and the 8-character prefix a page shows), the serving engine's
  ``request_id`` (its arrival count, which concurrent requests reorder),
  API keys (``kk-…``), password-reset tokens, and the salted password and key
  hashes and reset tokens stored in the database;
* the Llama runtime's own name in the two flows that serve one (``tpu``
  for the JAX package's, ``torch`` for the port's: its provider label);
* the test servers' own ports (``127.0.0.1:<port>`` in an emailed link);
* timestamps and the times measured from them: epoch seconds, ISO and
  ``YYYY-MM-DD HH:MM`` datetimes, a backup's ``YYYYMMDD-HHMMSS`` stamp, millisecond figures (``… ms``, ``*_ms``
  fields), a span waterfall's ``left:`` / ``width:`` percentages, and the
  database's time and latency columns.

Ids the database numbers (``AUTOINCREMENT``) are compared as they are, but for
the one flow that sends requests concurrently, where rows are compared as a
set without their ``id``. Warn confidences are compared as rendered: both
packages give the same float here.
"""

import asyncio
import contextlib
import json
import re
import sqlite3
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from kakveda_tpu.parallel.mesh import create_mesh


# ---------------------------------------------------------------------------
# the two packages
# ---------------------------------------------------------------------------


def _pkg(name: str) -> types.SimpleNamespace:
    """The modules a flow touches, from one package."""
    if name == "jax":
        from kakveda_tpu.core import otel, revocation, schemas
        from kakveda_tpu.dashboard import app, auth, core, db, email
        from kakveda_tpu.models import runtime
        from kakveda_tpu.platform import Platform
        from kakveda_tpu.service import app as service_app

        def platform(path):
            return Platform(data_dir=path, capacity=256, dim=1024, mesh=create_mesh("data:1"))

    else:
        from kakveda_tpu_torch.core import otel, revocation, schemas
        from kakveda_tpu_torch.dashboard import app, auth, core, db, email
        from kakveda_tpu_torch.models import runtime
        from kakveda_tpu_torch.platform import Platform
        from kakveda_tpu_torch.service import app as service_app

        def platform(path):
            return Platform(data_dir=path, capacity=256, dim=1024, device="cpu")

    return types.SimpleNamespace(
        name=name, make_dashboard_app=app.make_dashboard_app, auth=auth, core=core, db=db, email=email,
        runtime=runtime, platform=platform, schemas=schemas, revocation=revocation, otel=otel,
        service_app=service_app,
    )


PKGS = ("jax", "port")


def run(coro):
    return asyncio.run(coro)


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------

_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}|\b[0-9a-f]{32}\b")
_SUBS = [
    (re.compile(r"nonce-[A-Za-z0-9_\-]+"), "nonce-<nonce>"),
    (re.compile(r'nonce="[A-Za-z0-9_\-]+"'), 'nonce="<nonce>"'),
    (re.compile(r"kk-[A-Za-z0-9_\-]+"), "kk-<key>"),
    (re.compile(r"token=[A-Za-z0-9_\-\.]+"), "token=<token>"),
    (re.compile(r"\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}(\.\d+)?(Z|[+-]\d{2}:\d{2})?"), "<datetime>"),
    (re.compile(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}(:\d{2}(\.\d+)?)?"), "<datetime>"),
    (re.compile(r"20\d{6}-\d{6}\b"), "<stamp>"),  # a backup's stamp (URL-quoted: %20 before it)
    (re.compile(r"127\.0\.0\.1:\d+"), "127.0.0.1:<port>"),  # the test server's own port
    (re.compile(r"\b1[6-9]\d{8}(\.\d+)?\b"), "<ts>"),
    (re.compile(r"""((["']|&#39;|&#34;)\w*(_ms|_s|latency|_ts)(["']|&#39;|&#34;): )-?[\d.e\-]+"""), r"\1<t>"),
    (re.compile(r"""((["']|&#39;|&#34;)request_id(["']|&#39;|&#34;): )\d+"""), r"\1<n>"),  # the engine's arrival count
    (re.compile(r"-?\d+(\.\d+)?(\s*)ms\b"), r"<t>\2ms"),
    (re.compile(r"\b(left|width):\s*-?[\d.]+%"), r"\1:<t>%"),
]


class Ids:
    """UUID → ``<id-n>``, numbered by first appearance across a transcript;
    and the model runtime's own name (``runtime``: ``tpu`` for the JAX
    package's Llama runtime, ``torch`` for the port's) → ``<runtime>``."""

    def __init__(self, runtime: str = ""):
        self.map = {}
        self.runtime = re.compile(rf"(?<![\w-]){runtime}(?![\w-])") if runtime else None

    def __call__(self, text: str) -> str:
        if self.runtime is not None:
            text = self.runtime.sub("<runtime>", text)
        for u in _UUID.findall(text):
            self.map.setdefault(u, f"<id-{len(self.map)}>")
        text = _UUID.sub(lambda m: self.map[m.group(0)], text)
        for u, tag in self.map.items():  # a page shows a trace id's first 8 characters too
            text = text.replace(u[:8], tag + "[:8]")
        return text


def normalise(text: str, ids: Ids) -> str:
    text = ids(text)
    for pat, rep in _SUBS:
        text = pat.sub(rep, text)
    return text


_TIME_COLUMNS = {"ts", "created_at", "expires_at", "last_heartbeat", "start_ts", "end_ts", "latency_ms"}
_SECRET_COLUMNS = {"password_hash", "key_hash", "token"}


def db_rows(path: Path, ids: Ids, ordered: bool = True) -> dict:
    """Every table of the dashboard database, normalised."""
    con = sqlite3.connect(str(path))
    con.row_factory = sqlite3.Row
    try:
        tables = [r[0] for r in con.execute("SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
        out = {}
        for t in tables:
            if t == "sqlite_sequence":
                continue
            rows = []
            for r in con.execute(f"SELECT * FROM {t} ORDER BY rowid"):
                row = {}
                for k in r.keys():
                    v = r[k]
                    if k in _TIME_COLUMNS and v is not None:
                        v = "<t>"
                    elif k in _SECRET_COLUMNS:
                        v = "<secret>"
                    elif isinstance(v, str):
                        v = normalise(v, ids)
                    if k != "id" or ordered:
                        row[k] = v
                rows.append(row)
            out[t] = rows if ordered else sorted(rows, key=lambda x: json.dumps(x, sort_keys=True, default=str))
        return out
    finally:
        con.close()


# ---------------------------------------------------------------------------
# a recording client
# ---------------------------------------------------------------------------

_HEADERS = ("Content-Security-Policy", "X-Frame-Options", "Retry-After")


class Rec:
    """A ``TestClient`` that writes each exchange into the transcript."""

    def __init__(self, client, log: list, ids: Ids):
        self.client, self.log, self.ids = client, log, ids

    @property
    def session(self):
        return self.client.session

    def note(self, what, value):
        self.log.append(("note", what, normalise(json.dumps(value, sort_keys=True, default=str), self.ids)))

    async def _send(self, method, path, **kw):
        r = await self.client.request(method, path, **kw)
        body = await r.text()
        cookies = sorted(c.split("=", 1)[0] for c in r.headers.getall("Set-Cookie", []))
        self.log.append((
            method, normalise(path, self.ids), r.status, normalise(r.headers.get("Location") or "", self.ids),
            r.headers.get("Content-Type", "").split(";")[0], cookies,
            {h: normalise(r.headers[h], self.ids) for h in _HEADERS if h in r.headers},
            normalise(body, self.ids),
        ))
        return r, body

    async def get(self, path, **kw):
        return await self._send("GET", path, **kw)

    async def post(self, path, **kw):
        return await self._send("POST", path, **kw)


async def _login(rec, email="admin@local", password="admin123"):
    r, body = await rec.post(
        "/login", data={"email": email, "password": password, "next": "/"}, allow_redirects=False
    )
    assert r.status == 302, body


# ---------------------------------------------------------------------------
# the flows: tests/test_dashboard.py's and tests/test_otel_revocation.py's
# ---------------------------------------------------------------------------

CITE = "Summarize this and include citations even if not provided."


async def flow_auth_redirect_and_login(rec, env):
    r, _ = await rec.get("/", allow_redirects=False)
    assert r.status == 302 and "/login" in r.headers["Location"]
    r, body = await rec.get("/login")
    assert r.status == 200 and "Sign in" in body
    r, body = await rec.post("/login", data={"email": "admin@local", "password": "wrong", "next": "/"})
    assert "Invalid credentials" in body
    await _login(rec)
    r, body = await rec.get("/")
    assert r.status == 200 and "Failure intelligence overview" in body


async def flow_scenario_run_creates_warning_runs_spans(rec, env):
    await _login(rec)
    r, _ = await rec.post(
        "/scenarios/run",
        data={"app_id": "app-A", "prompt": "Summarize this document and include citations even if not provided."},
        allow_redirects=False,
    )
    assert r.status == 302 and "/warnings" in r.headers["Location"]
    _, body = await rec.get("/warnings")
    assert "app-A" in body
    _, body = await rec.get("/runs")
    assert "stub" in body
    _, text = await rec.get("/scenarios")
    assert "spans" in text
    m = re.search(r"/runs/([0-9a-f-]{36})", text)
    _, detail = await rec.get(f"/runs/{m.group(1)}")
    assert "scenario.run" in detail and "warn_policy.call" in detail


async def flow_rbac_viewer_cannot_run_scenarios(rec, env):
    await _login(rec, "viewer@local", "viewer123")
    r, _ = await rec.post("/scenarios/run", data={"app_id": "a", "prompt": "x"}, allow_redirects=False)
    assert r.status == 403
    r, _ = await rec.get("/admin/users", allow_redirects=False)
    assert r.status == 403


async def flow_admin_users_and_impersonation(rec, env):
    await _login(rec)
    _, body = await rec.get("/admin/users")
    assert "viewer@local" in body
    r, _ = await rec.post("/admin/impersonate", data={"email": "viewer@local"}, allow_redirects=False)
    assert r.status == 302
    _, body = await rec.get("/")
    assert "as-of admin@local" in body


async def flow_datasets_eval_flow(rec, env):
    await _login(rec)
    await rec.post("/datasets/create", data={"name": "ds1", "description": "d"})
    await rec.post("/datasets/1/examples", data={"app_id": "eval-app", "prompt": "Summarize with citations please"})
    await rec.post("/datasets/1/examples", data={"app_id": "eval-app", "prompt": "What is 2+2?"})
    r, _ = await rec.post("/datasets/1/eval", allow_redirects=False)
    assert r.status == 302
    _, body = await rec.get(r.headers["Location"])
    assert "pass rate 50%" in body and "p50" in body


async def flow_prompts_versioning(rec, env):
    await _login(rec)
    await rec.post("/prompts/save", data={"name": "p1", "text": "v1 text"})
    await rec.post("/prompts/save", data={"name": "p1", "text": "v2 text"})
    _, body = await rec.get("/prompts/1")
    assert "v2 text" in body and "v1 text" in body


async def flow_experiments_and_playground(rec, env):
    await _login(rec)
    await rec.post("/experiments/create", data={"name": "exp1"})
    _, body = await rec.post("/playground/run", data={"prompt": "hello", "target": "model", "experiment": "exp1"})
    assert "Result" in body
    _, body = await rec.get("/experiments/1")
    assert "1 runs" in body or "p50" in body


async def flow_warnings_analytics_and_span_waterfall_depth(rec, env):
    await _login(rec)
    for app in ("app-A", "app-A", "app-B"):
        await rec.post("/scenarios/run", data={"app_id": app, "prompt": CITE}, allow_redirects=False)
    _, body = await rec.get("/warnings")
    assert 'id="tile-total"' in body and 'id="day-chart"' in body
    assert 'id="f-window"' in body and 'id="f-app"' in body
    rows = json.loads(re.search(r'<script id="rows-data"[^>]*>(.*?)</script>', body, re.S).group(1))["rows"]
    assert len(rows) >= 2 and {r["app_id"] for r in rows} >= {"app-A", "app-B"}
    _, body_b = await rec.get("/warnings?app_id=app-B")
    rows_b = json.loads(re.search(r'<script id="rows-data"[^>]*>(.*?)</script>', body_b, re.S).group(1))["rows"]
    assert {r["app_id"] for r in rows_b} == {"app-B"}
    evil = "</script><b>pwn</b>"
    await rec.post("/scenarios/run", data={"app_id": evil, "prompt": "include citations please"},
                   allow_redirects=False)
    _, body_x = await rec.get("/warnings")
    block = re.search(r'<script id="rows-data"[^>]*>(.*?)</script>', body_x, re.S).group(1)
    assert "</script" not in block and "\\u003c/script" in block
    _, runs_page = await rec.get("/scenarios")
    trace = re.search(r"/runs/([0-9a-f-]{36})", runs_page).group(1)
    _, detail = await rec.get(f"/runs/{trace}")
    assert "Span waterfall" in detail and "ms total" in detail and "padding-left:" in detail


async def flow_playground_concurrent_requests_share_engine(rec, env):
    """Concurrent playground runs through one shared engine; each reply
    equals the runtime's solo (engine-off) output."""
    await _login(rec)
    prompts = ["first failure", "second timeout story", "third"]
    posts = [rec.client.post("/playground/run", data={"prompt": p, "target": "model"}) for p in prompts]
    for p, r in zip(prompts, await asyncio.gather(*posts)):  # into the transcript in the prompts' order
        page = await r.text()
        assert r.status == 200 and env.solo[p] in page, f"engine output for {p!r} != solo decode"
        rec.log.append(("POST", "/playground/run", r.status, p, normalise(page, rec.ids)))
    stats = env.model.serving_stats()["engine"]
    assert stats["completed"] == len(prompts)
    rec.note("texts", [env.solo[p] for p in prompts])


async def flow_admin_serving_page_reports_engine_and_levers(rec, env):
    await _login(rec)
    _, body = await rec.get("/admin/serving")
    assert "No engine yet" in body and "kv int8" in body
    await rec.post("/playground/run", data={"prompt": "hi", "target": "model"})
    _, body = await rec.get("/admin/serving")
    assert re.search(r"\d+ slots × \d+-token window", body) and "submitted / completed" in body


async def flow_admin_serving_page_under_the_stub(rec, env):
    await _login(rec)
    _, body = await rec.get("/admin/serving")
    assert "no serving pool" in body


async def flow_project_api_key_ingest_and_budget(rec, env):
    await _login(rec)
    await rec.post("/projects/create", data={"name": "proj1", "monthly_budget_micro_usd": "10"})
    r = await rec.client.post("/projects/api-key", data={"project_id": 1, "label": "ci"})
    page = await r.text()
    key = re.search(r"kk-[A-Za-z0-9_\-]+", page).group(0)
    rec.log.append(("POST", "/projects/api-key", r.status, "", "", [], {}, normalise(page, rec.ids)))
    r, _ = await rec.post("/api/ingest/run", json={"prompt": "x"})
    assert r.status == 401
    r, _ = await rec.post("/api/ingest/run", json={"prompt": "x"}, headers={"X-API-Key": "bad"})
    assert r.status == 403
    r, body = await rec.post(
        "/api/ingest/run", json={"prompt": "Summarize with citations", "response": "See [1]", "app_id": "api-app"},
        headers={"X-API-Key": key},
    )
    out = json.loads(body)
    assert r.status == 200 and out["ok"] and out["cost_micro_usd"] >= 0
    r, body = await rec.post(
        "/api/ingest/run", json={"prompt": "word " * 2000, "response": "resp " * 2000}, headers={"X-API-Key": key}
    )
    assert r.status == 402 and json.loads(body)["error"] == "budget exceeded"


async def flow_api_ingest_duplicate_trace_is_idempotent(rec, env):
    await _login(rec)
    await rec.post("/projects/create", data={"name": "proj1", "monthly_budget_micro_usd": "1000000"})
    r = await rec.client.post("/projects/api-key", data={"project_id": 1, "label": "ci"})
    key = re.search(r"kk-[A-Za-z0-9_\-]+", await r.text()).group(0)
    payload = {"prompt": "hello world", "response": "resp", "trace_id": "t-dup-1"}
    r1, b1 = await rec.post("/api/ingest/run", json=payload, headers={"X-API-Key": key})
    spent1 = env.db.one("SELECT spent_micro_usd FROM project_budgets WHERE project_id=1")
    r2, b2 = await rec.post("/api/ingest/run", json=payload, headers={"X-API-Key": key})
    spent2 = env.db.one("SELECT spent_micro_usd FROM project_budgets WHERE project_id=1")
    assert json.loads(b1)["ok"] and not json.loads(b1).get("duplicate") and json.loads(b2).get("duplicate") is True
    assert spent1 == spent2


async def flow_health_page_and_fault_injection(rec, env):
    await _login(rec)
    r, _ = await rec.post(
        "/health/test", data={"app_id": "test-app", "severity": "high", "failure_type": "SYNTH"},
        allow_redirects=False,
    )
    assert r.status == 302
    _, body = await rec.get("/health-page?app_id=test-app")
    assert "test-app" in body and "points" in body


async def flow_security_headers(rec, env):
    r, _ = await rec.get("/login")
    assert "Content-Security-Policy" in r.headers and r.headers["X-Frame-Options"] == "DENY"


async def flow_csp_nonce_covers_inline_scripts(rec, env):
    await _login(rec)
    nonces = []
    for _ in range(2):
        r, body = await rec.get("/warnings")
        m = re.search(r"script-src 'self' 'nonce-([^']+)'", r.headers["Content-Security-Policy"])
        assert f'<script nonce="{m.group(1)}">' in body
        nonces.append(m.group(1))
    assert nonces[0] != nonces[1]


async def flow_purge_demo_reloads_gfkb(rec, env):
    await _login(rec)
    for app_id in ("app-A", "app-B"):
        await rec.post("/scenarios/run", data={"app_id": app_id, "prompt": "Summarize with citations please"},
                       allow_redirects=False)
    assert env.plat.gfkb.count > 0
    r, _ = await rec.post("/admin/purge-demo", data={"confirm": "yes"}, allow_redirects=False)
    assert r.status == 302
    assert env.plat.gfkb.count == 0 and env.plat.gfkb.match("anything") == []
    rec_, created = env.plat.gfkb.upsert_failure(
        failure_type="T", signature_text="s", app_id="x", impact_severity=env.pkg.schemas.Severity.low,
    )
    assert created and rec_.failure_id == "F-0001"
    rec.note("after purge", [env.plat.gfkb.count, rec_.failure_id])


async def flow_login_rejects_backslash_redirect(rec, env):
    r, _ = await rec.post(
        "/login", data={"email": "admin@local", "password": "admin123", "next": "/\\evil.com"},
        allow_redirects=False,
    )
    assert r.status == 302 and r.headers["Location"] == "/"


async def flow_security_headers_on_redirects(rec, env):
    r, _ = await rec.get("/", allow_redirects=False)
    assert r.status == 302 and "Content-Security-Policy" in r.headers and r.headers["X-Frame-Options"] == "DENY"


async def flow_forgot_hides_reset_link_in_production(rec, env):
    _, body = await rec.post("/forgot", data={"email": "admin@local"})
    assert "token=" not in body


async def flow_project_clear_cookie(rec, env):
    await _login(rec)
    await rec.post("/projects/create", data={"name": "p1"})
    r, _ = await rec.post("/projects/select", data={"project_id": "1"}, allow_redirects=False)
    assert r.status == 302
    r, _ = await rec.post("/projects/clear", allow_redirects=False)
    assert r.status == 302
    assert any("project" in c for c in r.headers.getall("Set-Cookie", []))


async def flow_forgot_sends_email_when_smtp_configured(rec, env):
    sent = {}

    def fake_send(to, subject, body):
        sent.update(to=to, subject=subject, body=body)
        return True

    env.monkeypatch.setattr(env.pkg.email, "send_email", fake_send)
    _, body = await rec.post("/forgot", data={"email": "admin@local"})
    assert "token=" not in body
    assert sent["to"] == "admin@local" and "/reset?token=" in sent["body"]
    rec.note("email", sent)


async def flow_evals_list_page(rec, env):
    await _login(rec)
    r, body = await rec.get("/evals")
    assert r.status == 200 and "Evaluation runs" in body
    await rec.post("/datasets/create", data={"name": "ds1", "description": ""})
    await rec.post("/datasets/1/examples", data={"prompt": "Summarize with citations", "app_id": "eval-app",
                                                 "expected": ""})
    await rec.post("/datasets/1/eval")
    _, body = await rec.get("/evals")
    assert "/eval/1" in body and "ds1" in body


async def flow_playground_model_selection(rec, env):
    await _login(rec)
    _, page = await rec.get("/playground")
    assert 'value="model:stub"' in page
    r, body = await rec.post("/playground/run", data={"prompt": "hi", "target": "model:stub"})
    assert r.status == 200 and "stub" in body


async def flow_csrf_cookie_issued_and_enforced(rec, env):
    r, _ = await rec.get("/login")
    assert r.status == 200
    cookies = {c.key: c.value for c in rec.session.cookie_jar}
    token = cookies["csrf_token"]
    await _login(rec)
    env.monkeypatch.setenv("KAKVEDA_CSRF_ENFORCE", "1")
    r, _ = await rec.post("/scenarios/run", data={"app_id": "a"}, allow_redirects=False)
    assert r.status == 403
    r, _ = await rec.post(
        "/scenarios/run", data={"app_id": "app-A", "prompt": "Summarize with citations", "csrf_token": token},
        allow_redirects=False,
    )
    assert r.status in (200, 302)


async def flow_admin_purge_demo_confirm_flow(rec, env):
    from datetime import datetime, timezone

    await _login(rec)
    for app_id in ("app-A", "app-B", "prod-app"):
        await env.plat.ingest_batch([
            env.pkg.schemas.TracePayload(
                trace_id=f"t-{app_id}", ts=datetime.now(timezone.utc), app_id=app_id, agent_id="t",
                prompt=f"Summarize the {app_id} report with citations even if not provided",
                response="Done [1] (Smith 2021)", tools=[], env={},
            )
        ])
    r, page = await rec.get("/admin/purge-demo")
    assert r.status == 200 and "app-A" in page and "failures.jsonl" in page
    r, _ = await rec.post("/admin/purge-demo", data={}, allow_redirects=False)
    assert r.status == 302 and "error" in r.headers["Location"]
    r, _ = await rec.post("/admin/purge-demo", data={"confirm": "yes"}, allow_redirects=False)
    assert r.status == 302 and "message=" in r.headers["Location"]
    _, page = await rec.get(r.headers["Location"])  # the banner names the backups (a timestamp suffix)
    assert "Purged demo apps" in page and ".bak-" in page
    apps = env.plat.apps()
    assert "prod-app" in apps and "app-A" not in apps
    rec.note("apps", sorted(apps))


async def flow_admin_agents_page(rec, env):
    await _login(rec)
    r, _ = await rec.post(
        "/agents/register",
        data={"name": "probe", "base_url": "http://127.0.0.1:9", "auth_kind": "bearer_env",
              "auth_secret_env": "PROBE_TOKEN", "next": "/admin/agents"},
        allow_redirects=False,
    )
    assert r.status == 302 and r.headers["Location"] == "/admin/agents"
    _, page = await rec.get("/admin/agents")
    assert "probe" in page and "PROBE_TOKEN" in page
    r, _ = await rec.post("/admin/agents/delete", data={"name": "probe"}, allow_redirects=False)
    assert r.status == 302
    _, page = await rec.get("/admin/agents")
    assert "probe" not in page


async def flow_span_waterfall_survives_parent_cycles(rec, env):
    now = time.time()
    tid = "11111111-2222-3333-4444-555555555555"
    db = env.db
    db.execute("INSERT INTO trace_runs (trace_id, ts, app_id, status) VALUES (?,?,?,?)", (tid, now, "app-C", "ok"))
    root = db.add_span(tid, "root", now, now + 1.0)
    db.add_span(tid, "child", now + 0.1, now + 0.5, parent_id=root)
    a = db.add_span(tid, "cyc-a", now + 0.2, now + 0.3, parent_id=10**6)
    b = db.add_span(tid, "cyc-b", now + 0.25, now + 0.35, parent_id=a)
    db.execute("UPDATE trace_spans SET parent_id=? WHERE id=?", (b, a))
    s = db.add_span(tid, "self-loop", now + 0.4, now + 0.45, parent_id=10**6)
    db.execute("UPDATE trace_spans SET parent_id=? WHERE id=?", (s, s))
    await _login(rec)
    _, detail = await rec.get(f"/runs/{tid}")
    for name in ("root", "child", "cyc-a", "cyc-b", "self-loop"):
        assert name in detail


async def flow_warnings_initial_render_uses_server_aggregates(rec, env):
    await _login(rec)
    await rec.post("/scenarios/run", data={"app_id": "app-S", "prompt": CITE}, allow_redirects=False)
    _, body = await rec.get("/warnings")
    agg = json.loads(re.search(r'<script id="server-agg"[^>]*>(.*?)</script>', body, re.S).group(1))
    assert sum(n for _, n in agg["by_day"]) >= 1 and any(a == "app-S" for a, _ in agg["by_app"])
    script = body[body.index("server-agg"):]
    assert "renderChart(new Map(SERVER.by_day" in script
    assert re.search(r"^\s*refresh\(\);", script, re.M) is None


async def flow_runs_query_language_operators(rec, env):
    import uuid

    db = env.db
    now = time.time()
    pid = db.execute("INSERT INTO projects (name, created_at) VALUES (?,?)", ("proj-x", now))
    rows = [("app-fast", 100, None, ["prod"], "good"), ("app-slow", 5000, pid, ["canary"], "bad"),
            ("app-mid", 1500, None, ["staging"], None)]
    for i, (app_id, lat, proj, tags, label) in enumerate(rows):
        tid = str(uuid.UUID(int=i + 1))
        db.execute(
            "INSERT INTO trace_runs (trace_id, ts, app_id, latency_ms, project_id, tags_json, status)"
            " VALUES (?,?,?,?,?,?,?)", (tid, now, app_id, lat, proj, json.dumps(tags), "ok"),
        )
        if label:
            db.execute("INSERT INTO run_feedback (trace_id, user_email, thumb, label, ts) VALUES (?,?,?,?,?)",
                       (tid, "t@local", "up", label, now))
    await _login(rec)

    async def hits(q):
        _, body = await rec.get("/runs", params={"q": q})
        return {a for a in ("app-fast", "app-slow", "app-mid") if a in body}

    assert await hits("latency_ms>2000") == {"app-slow"}
    assert await hits("latency_ms<500") == {"app-fast"}
    assert await hits("latency_ms>500 latency_ms<2000") == {"app-mid"}
    assert await hits("project:proj-x") == {"app-slow"}
    assert await hits("project:no-such") == set()
    assert await hits("tag:prod tag:canary") == {"app-fast", "app-slow"}
    assert await hits("label:good label:bad") == {"app-fast", "app-slow"}
    assert await hits("tag:prod label:bad") == set()


async def flow_logout_revokes_token(rec, env):
    r, _ = await rec.post(
        "/login", data={"email": "admin@local", "password": "admin123", "next": "/"}, allow_redirects=False
    )
    assert r.status == 302
    token = rec.session.cookie_jar.filter_cookies(rec.client.make_url("/"))["kakveda_token"].value
    r, _ = await rec.get("/", allow_redirects=False)
    assert r.status == 200
    await rec.post("/logout", allow_redirects=False)
    r, _ = await rec.get("/", headers={"Cookie": f"kakveda_token={token}"}, allow_redirects=False)
    assert r.status == 302 and "/login" in r.headers["Location"]


# name → (flow, options). Options: "env" set before the app is built,
# "model": "stub" | "llama" | "llama_kv8", "concurrent": rows compared as a set.
FLOWS = {
    "auth_redirect_and_login": (flow_auth_redirect_and_login, {}),
    "scenario_run_creates_warning_runs_spans": (flow_scenario_run_creates_warning_runs_spans, {}),
    "rbac_viewer_cannot_run_scenarios": (flow_rbac_viewer_cannot_run_scenarios, {}),
    "admin_users_and_impersonation": (flow_admin_users_and_impersonation, {}),
    "datasets_eval_flow": (flow_datasets_eval_flow, {}),
    "prompts_versioning": (flow_prompts_versioning, {}),
    "experiments_and_playground": (flow_experiments_and_playground, {}),
    "warnings_analytics_and_span_waterfall_depth": (flow_warnings_analytics_and_span_waterfall_depth, {}),
    "playground_concurrent_requests_share_engine": (
        flow_playground_concurrent_requests_share_engine, {"model": "llama", "concurrent": True}),
    "admin_serving_page_reports_engine_and_levers": (
        flow_admin_serving_page_reports_engine_and_levers, {"model": "llama", "env": {"KAKVEDA_KV_QUANT": "int8"}}),
    "admin_serving_page_under_the_stub": (flow_admin_serving_page_under_the_stub, {}),
    "project_api_key_ingest_and_budget": (flow_project_api_key_ingest_and_budget, {}),
    "health_page_and_fault_injection": (flow_health_page_and_fault_injection, {}),
    "security_headers": (flow_security_headers, {}),
    "csp_nonce_covers_inline_scripts": (flow_csp_nonce_covers_inline_scripts, {}),
    "purge_demo_reloads_gfkb": (flow_purge_demo_reloads_gfkb, {}),
    "login_rejects_backslash_redirect": (flow_login_rejects_backslash_redirect, {}),
    "security_headers_on_redirects": (flow_security_headers_on_redirects, {}),
    "api_ingest_duplicate_trace_is_idempotent": (flow_api_ingest_duplicate_trace_is_idempotent, {}),
    "forgot_hides_reset_link_in_production": (flow_forgot_hides_reset_link_in_production, {"env": {
        "KAKVEDA_ENV": "production", "DASHBOARD_JWT_SECRET": "prod-secret-123456", "KAKVEDA_DEMO_USERS": "1"}}),
    "project_clear_cookie": (flow_project_clear_cookie, {}),
    "forgot_sends_email_when_smtp_configured": (flow_forgot_sends_email_when_smtp_configured, {"env": {
        "SMTP_HOST": "smtp.example.com", "SMTP_USER": "mailer"}}),
    "evals_list_page": (flow_evals_list_page, {}),
    "playground_model_selection": (flow_playground_model_selection, {}),
    "csrf_cookie_issued_and_enforced": (flow_csrf_cookie_issued_and_enforced, {}),
    "admin_purge_demo_confirm_flow": (flow_admin_purge_demo_confirm_flow, {}),
    "admin_agents_page": (flow_admin_agents_page, {}),
    "span_waterfall_survives_parent_cycles": (flow_span_waterfall_survives_parent_cycles, {}),
    "warnings_initial_render_uses_server_aggregates": (flow_warnings_initial_render_uses_server_aggregates, {}),
    "runs_query_language_operators": (flow_runs_query_language_operators, {}),
    "logout_revokes_token": (flow_logout_revokes_token, {}),
}


# ---------------------------------------------------------------------------
# the tiny Llama both packages serve (two flows)
# ---------------------------------------------------------------------------

_LLAMA = dict(vocab_size=264, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=48, max_seq_len=256)


def _llama(pkg_name: str, monkeypatch):
    """(runtime, solo texts of the concurrent flow's prompts): the JAX
    ``LlamaRuntime`` from seed 0, or the port's over the same weights."""
    from kakveda_tpu.models import generate as JG
    from kakveda_tpu.models.llama import LlamaConfig as JConfig, init_params

    jcfg = JConfig(**_LLAMA, dtype=jnp.float32)
    jp = init_params(jax.random.PRNGKey(0), jcfg)
    if pkg_name == "jax":
        def make():
            return JG.LlamaRuntime(cfg=jcfg, params=jp)
    else:
        from kakveda_tpu_torch.convert import llama_params_from_jax
        from kakveda_tpu_torch.models import generate as TG
        from kakveda_tpu_torch.models.llama import LlamaConfig as TConfig

        tcfg = TConfig(**_LLAMA, dtype=torch.float32)
        tp = llama_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")

        def make():
            return TG.LlamaRuntime(cfg=tcfg, params=tp, device="cpu")
    with monkeypatch.context() as m:
        m.setenv("KAKVEDA_SERVE_CONTINUOUS", "0")
        solo_rt = make()
        solo = {p: solo_rt.generate(p, max_tokens=8).text for p in
                ("first failure", "second timeout story", "third")}
    return make(), solo


def _close(rt) -> None:
    eng = getattr(rt, "_engine", None)
    if eng is not None:
        eng.close()


# ---------------------------------------------------------------------------
# running a flow in one package
# ---------------------------------------------------------------------------


def run_flow(pkg_name: str, name: str, tmp: Path, monkeypatch) -> list:
    flow, opts = FLOWS[name]
    pkg = _pkg(pkg_name)
    log: list = []
    pkg.core.RATE_LIMITER._hits.clear()  # process-global: a fresh login window per run
    with monkeypatch.context() as m:
        for k in ("KAKVEDA_ENV", "KAKVEDA_DEMO_USERS", "KAKVEDA_CSRF_ENFORCE", "SMTP_HOST", "SMTP_USER",
                  "KAKVEDA_KV_QUANT", "KAKVEDA_RATELIMIT_RPS"):
            m.delenv(k, raising=False)
        for k, v in opts.get("env", {}).items():
            m.setenv(k, v)
        model, solo = (pkg.runtime.StubRuntime(), None)
        if opts.get("model") == "llama":
            model, solo = _llama(pkg_name, m)
        ids = Ids(model.name if opts.get("model") else "")
        plat = pkg.platform(tmp / "data")
        app = pkg.make_dashboard_app(platform=plat, db_path=tmp / "dash.db", model=model)
        env = types.SimpleNamespace(pkg=pkg, plat=plat, db=app[pkg.core.CTX_KEY].db, model=model, solo=solo,
                                    monkeypatch=m, tmp=tmp)

        async def go():
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                await flow(Rec(client, log, ids), env)
            finally:
                await client.close()

        try:
            run(go())
        finally:
            _close(model)
    return log + [("db", db_rows(tmp / "dash.db", ids, ordered=not opts.get("concurrent")))]


def _first_difference(a: list, b: list) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            sx, sy = str(x), str(y)
            at = next((j for j, (cx, cy) in enumerate(zip(sx, sy)) if cx != cy), min(len(sx), len(sy)))
            return f"entry {i} ({sx[:40]}), from char {at}:\n jax:  {sx[at - 200:at + 600]}\n port: {sy[at - 200:at + 600]}"
    return f"lengths {len(a)} / {len(b)}"


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_flow_matches_jax(name, tmp_path, monkeypatch):
    """One request sequence through both dashboards: the reference test's
    assertions hold in each, and the port's transcript (statuses, redirects,
    headers, cookies set, bodies, database rows) equals the JAX package's."""
    jax_log = run_flow("jax", name, tmp_path / "jax", monkeypatch)
    port_log = run_flow("port", name, tmp_path / "port", monkeypatch)
    assert port_log == jax_log, _first_difference(jax_log, port_log)


# ---------------------------------------------------------------------------
# the module-level cases
# ---------------------------------------------------------------------------


def case_jwt_roundtrip_and_tamper(pkg, tmp, monkeypatch):
    a = pkg.auth
    tok = a.create_access_token(email="a@local", roles=["admin"], secret="s1")
    claims = a.decode_token(tok, secret="s1")
    assert a.decode_token(tok, secret="s2") is None
    assert a.decode_token(tok[:-4] + "AAAA", secret="s1") is None
    assert a.decode_token("garbage", secret="s1") is None
    other = _pkg("jax" if pkg.name == "port" else "port").auth
    cross = other.decode_token(tok, secret="s1")  # each package reads the other's tokens
    assert cross == claims
    return {k: v for k, v in claims.items() if k not in ("jti", "exp", "iat")}


def case_password_hash_roundtrip(pkg, tmp, monkeypatch):
    a = pkg.auth
    h = a.hash_password("hunter42x")
    other = _pkg("jax" if pkg.name == "port" else "port").auth
    return [a.verify_password("hunter42x", h), a.verify_password("wrong", h),
            a.verify_password("hunter42x", "malformed"), other.verify_password("hunter42x", h)]


def case_pg_dialect_translation(pkg, tmp, monkeypatch):
    d = pkg.db
    stmts = d.pg_schema(d._SCHEMA)
    assert sum(1 for s in stmts if s.upper().startswith("CREATE TABLE")) == 23
    return [d.pg_translate("SELECT * FROM users WHERE email=?"),
            d.pg_translate("INSERT OR IGNORE INTO roles (name) VALUES (?)"),
            d.pg_translate("INSERT OR IGNORE INTO user_roles (user_id, role_id)\n VALUES (?,?)"),
            d.pg_translate("UPDATE users SET is_active=? WHERE id=?"), stmts, sorted(d._IDLESS_TABLES)]


def case_make_database_respects_env(pkg, tmp, monkeypatch):
    monkeypatch.delenv("KAKVEDA_DB_URL", raising=False)
    db = pkg.db.make_database(tmp / "x.db")
    assert isinstance(db, pkg.db.Database)
    monkeypatch.setenv("KAKVEDA_DB_URL", "postgresql://u:p@nowhere:5432/d")
    with pytest.raises(RuntimeError, match="psycopg2") as ei:
        pkg.db.make_database(tmp / "y.db")
    return str(ei.value)


def case_production_requires_secret(pkg, tmp, monkeypatch):
    monkeypatch.setenv("KAKVEDA_ENV", "production")
    monkeypatch.delenv("DASHBOARD_JWT_SECRET", raising=False)
    with pytest.raises(RuntimeError, match="JWT secret") as ei:
        pkg.make_dashboard_app(platform=pkg.platform(tmp / "data"), db_path=tmp / "dash.db",
                               model=pkg.runtime.StubRuntime())
    return str(ei.value)


def case_production_skips_demo_users(pkg, tmp, monkeypatch):
    monkeypatch.setenv("KAKVEDA_ENV", "production")
    monkeypatch.setenv("DASHBOARD_JWT_SECRET", "prod-secret-123456")
    monkeypatch.delenv("KAKVEDA_DEMO_USERS", raising=False)
    app = pkg.make_dashboard_app(platform=pkg.platform(tmp / "data"), db_path=tmp / "dash.db",
                                 model=pkg.runtime.StubRuntime())
    return app[pkg.core.CTX_KEY].db.user_by_email("admin@local")


def case_revocation_store_memory_ttl(pkg, tmp, monkeypatch):
    rs = pkg.revocation.RevocationStore(redis_url=None)
    rs.revoke("jti-1", time.time() + 60)
    rs.revoke("jti-old", time.time() - 1)
    return [rs.is_revoked("jti-1"), rs.is_revoked("jti-2"), rs.is_revoked("jti-old")]


def case_otel_disabled_by_default(pkg, tmp, monkeypatch):
    otel = pkg.otel
    monkeypatch.setattr(otel, "_setup_done", False)
    monkeypatch.setattr(otel, "_tracer", None)
    monkeypatch.delenv("KAKVEDA_OTEL_ENABLED", raising=False)
    return [otel.setup_otel("test"), otel.get_tracer()]


def case_otel_enabled_creates_tracer(pkg, tmp, monkeypatch):
    otel = pkg.otel
    monkeypatch.setattr(otel, "_setup_done", False)
    monkeypatch.setattr(otel, "_tracer", None)
    monkeypatch.setenv("KAKVEDA_OTEL_ENABLED", "1")
    ok = otel.setup_otel("test")
    tracer = otel.get_tracer() is not None

    async def go():
        app = web.Application(middlewares=[otel.otel_middleware()])

        async def hello(request):
            return web.json_response({"ok": True})

        app.router.add_get("/", hello)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.get("/")
            return [r.status, await r.json()]
        finally:
            await client.close()

    out = [ok, tracer, run(go())]
    monkeypatch.setattr(otel, "_setup_done", False)
    monkeypatch.setattr(otel, "_tracer", None)
    return out


def case_make_app_and_dashboard_install_otel_middleware(pkg, tmp, monkeypatch):
    otel = pkg.otel
    sentinel = object()
    monkeypatch.setattr(otel, "setup_otel", lambda name: True)
    monkeypatch.setattr(otel, "otel_middleware", lambda: sentinel)
    plat = pkg.platform(tmp / "data")
    app = pkg.service_app.make_app(plat)
    dash = pkg.make_dashboard_app(platform=plat, db_path=tmp / "dash.db", model=pkg.runtime.StubRuntime())
    return [app.middlewares[0] is sentinel, dash.middlewares[0] is sentinel]


def case_otel_middleware_records_request_id_and_span_events(pkg, tmp, monkeypatch):
    otel = pkg.otel
    recorded = {}

    class FakeSpan:
        def set_attribute(self, k, v):
            recorded[k] = v

        def add_event(self, name, attrs):
            recorded.setdefault("events", []).append((name, dict(attrs)))

        def is_recording(self):
            return True

        def set_status(self, s):
            pass

    fake_span = FakeSpan()
    tr = types.ModuleType("opentelemetry.trace")
    tr.SpanKind = types.SimpleNamespace(SERVER="server")
    tr.Status = lambda code, desc=None: (code, desc)
    tr.StatusCode = types.SimpleNamespace(ERROR="error")
    tr.get_current_span = lambda: fake_span
    ot = types.ModuleType("opentelemetry")
    ot.trace = tr
    monkeypatch.setitem(sys.modules, "opentelemetry", ot)
    monkeypatch.setitem(sys.modules, "opentelemetry.trace", tr)

    class FakeTracer:
        @contextlib.contextmanager
        def start_as_current_span(self, name, kind=None):
            yield fake_span

    monkeypatch.setattr(otel, "_tracer", FakeTracer())

    async def go():
        app = web.Application(middlewares=[otel.otel_middleware(), pkg.service_app.request_context_middleware])

        async def ping(request):
            return web.json_response({"ok": True})

        app.router.add_get("/ping", ping)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.get("/ping", headers={"x-request-id": "rid-123"})
            return [r.status, r.headers["x-request-id"]]
        finally:
            await client.close()

    resp = run(go())
    otel.add_span_events("serving.timeline", {"ttft_ms": 1.5, "refs": [1, 2]})
    assert recorded["request.id"] == "rid-123" and ("serving.timeline", {"ttft_ms": 1.5}) in recorded["events"]
    return [resp, {k: v for k, v in recorded.items() if not k.startswith("http.request")}]


CASES = {
    "jwt_roundtrip_and_tamper": case_jwt_roundtrip_and_tamper,
    "password_hash_roundtrip": case_password_hash_roundtrip,
    "pg_dialect_translation": case_pg_dialect_translation,
    "make_database_respects_env": case_make_database_respects_env,
    "production_requires_secret": case_production_requires_secret,
    "production_skips_demo_users": case_production_skips_demo_users,
    "revocation_store_memory_ttl": case_revocation_store_memory_ttl,
    "otel_disabled_by_default": case_otel_disabled_by_default,
    "otel_enabled_creates_tracer": case_otel_enabled_creates_tracer,
    "make_app_and_dashboard_install_otel_middleware": case_make_app_and_dashboard_install_otel_middleware,
    "otel_middleware_records_request_id_and_span_events": case_otel_middleware_records_request_id_and_span_events,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_matches_jax(name, tmp_path, monkeypatch):
    """The dashboard's auth, database, revocation and OTel pieces: the
    reference test's assertions in each package, and equal results."""
    out = {}
    for p in PKGS:
        with monkeypatch.context() as m:
            out[p] = CASES[name](_pkg(p), tmp_path / p, m)
    assert out["port"] == out["jax"]


def test_up_mounts_the_dashboard_beside_the_api(tmp_path):
    """``service.main._serve`` with ``dashboard_port`` serves the dashboard
    over the API's own Platform: a scenario run on the dashboard is a failure
    the API's ``/failures`` lists."""
    import socket

    import aiohttp

    from kakveda_tpu_torch.core.runtime import get_runtime_config
    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service import main as service_main

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    plat = Platform(data_dir=tmp_path / "data", capacity=256, dim=1024, device="cpu")
    api, dash = free_port(), free_port()

    async def go():
        import os

        os.environ["KAKVEDA_DATA_DIR"] = str(tmp_path / "data")  # the dashboard's db, as `up` places it
        assert get_runtime_config(service_name="dashboard").data_dir == str(tmp_path / "data")
        server = asyncio.ensure_future(service_main._serve(plat, "127.0.0.1", api, dash))
        try:
            async with aiohttp.ClientSession(cookie_jar=aiohttp.CookieJar(unsafe=True)) as s:
                for _ in range(200):
                    try:
                        async with s.get(f"http://127.0.0.1:{dash}/healthz") as r:
                            if r.status == 200:
                                break
                    except aiohttp.ClientError:
                        await asyncio.sleep(0.05)
                async with s.post(f"http://127.0.0.1:{dash}/login", allow_redirects=False,
                                  data={"email": "admin@local", "password": "admin123", "next": "/"}) as r:
                    assert r.status == 302
                async with s.post(f"http://127.0.0.1:{dash}/scenarios/run", allow_redirects=False,
                                  data={"app_id": "app-A", "prompt": CITE}) as r:
                    assert r.status == 302
                async with s.get(f"http://127.0.0.1:{api}/failures") as r:
                    failures = await r.json()
            return failures
        finally:
            server.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await server
            os.environ.pop("KAKVEDA_DATA_DIR", None)

    failures = run(go())["failures"]
    plat.close()
    assert [f["affected_apps"] for f in failures] == [["app-A"]]
    assert (tmp_path / "data" / "dashboard.db").exists()


def test_dashboard_refuses_a_redis_url(tmp_path, monkeypatch):
    """The port has no Redis tier: where the reference shares logout
    revocations and the auth routes' rate-limit windows through
    ``KAKVEDA_REDIS_URL``, the port's dashboard refuses to start, before it
    builds a Platform or a database, and does not print the URL's password."""
    from kakveda_tpu_torch.core.revocation import RevocationStore
    from kakveda_tpu_torch.dashboard.app import make_dashboard_app

    monkeypatch.setenv("KAKVEDA_REDIS_URL", "redis://:s3cretpass@cache:6379/0")
    with pytest.raises(RuntimeError, match="no Redis tier") as err:
        make_dashboard_app(db_path=tmp_path / "dash.db", data_dir=tmp_path / "data", device="cpu")
    assert "s3cretpass" not in str(err.value) and "cache:6379/0" in str(err.value)
    assert not (tmp_path / "dash.db").exists() and not (tmp_path / "data").exists()
    monkeypatch.delenv("KAKVEDA_REDIS_URL")
    with pytest.raises(RuntimeError, match="no Redis tier"):
        RevocationStore(redis_url="redis://cache:6379/0")
    assert not RevocationStore().is_revoked("jti")
