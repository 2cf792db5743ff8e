"""Datasets/evaluations, prompt library, experiments
(reference: services/dashboard/app.py:2229-2478, 3302-3532, 3554-3648).

The port's copy of ``kakveda_tpu/dashboard/routes_data.py``.
"""

from __future__ import annotations

import time
from datetime import datetime, timezone
from typing import List

from aiohttp import web

from kakveda_tpu_torch.core.fingerprint import detect_citation_markers, prompt_intent_tags
from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
from kakveda_tpu_torch.dashboard.core import CTX_KEY, require_login, require_roles
from kakveda_tpu_torch.dashboard.db import new_trace_id
from kakveda_tpu_torch.dashboard.routes_main import estimate_cost_micro_usd, estimate_tokens


def _p50_p95(values: List[int]) -> tuple[float, float]:
    if not values:
        return 0.0, 0.0
    vs = sorted(values)
    return (
        float(vs[len(vs) // 2]),
        float(vs[min(len(vs) - 1, int(len(vs) * 0.95))]),
    )


def citation_check_passes(prompt: str, response: str) -> bool:
    """Deterministic eval check: a citation-demanding prompt must NOT get a
    fabricated-citation response (reference: services/dashboard/app.py:2306-2312)."""
    wants = "intent:citations_required" in prompt_intent_tags(prompt)
    has_markers = detect_citation_markers(response).has_citation_markers
    return not (wants and has_markers)


def setup(app: web.Application) -> None:
    ctx = app[CTX_KEY]
    plat = ctx.platform

    # ------------------------------------------------------------------
    # datasets
    # ------------------------------------------------------------------

    @require_login
    async def datasets_page(request):
        datasets = ctx.db.query(
            "SELECT d.*, COUNT(e.id) AS n_examples FROM datasets d"
            " LEFT JOIN dataset_examples e ON e.dataset_id=d.id GROUP BY d.id ORDER BY d.created_at DESC"
        )
        return ctx.render(request, "datasets.html", datasets=datasets)

    @require_roles("admin", "operator")
    async def dataset_create(request):
        form = await request.post()
        name = str(form.get("name") or "").strip()
        if not name:
            raise web.HTTPBadRequest(text="name required")
        ctx.db.execute(
            "INSERT OR IGNORE INTO datasets (name, description, created_at) VALUES (?,?,?)",
            (name, str(form.get("description") or ""), time.time()),
        )
        raise web.HTTPFound("/datasets")

    @require_login
    async def dataset_detail(request):
        ds_id = int(request.match_info["ds_id"])
        ds = ctx.db.one("SELECT * FROM datasets WHERE id=?", (ds_id,))
        if ds is None:
            raise web.HTTPNotFound(text="dataset not found")
        examples = ctx.db.query("SELECT * FROM dataset_examples WHERE dataset_id=?", (ds_id,))
        evals = ctx.db.query(
            "SELECT * FROM evaluation_runs WHERE dataset_id=? ORDER BY ts DESC", (ds_id,)
        )
        return ctx.render(request, "dataset_detail.html", ds=ds, examples=examples, evals=evals)

    @require_roles("admin", "operator")
    async def example_add(request):
        ds_id = int(request.match_info["ds_id"])
        form = await request.post()
        prompt = str(form.get("prompt") or "").strip()
        if not prompt:
            raise web.HTTPBadRequest(text="prompt required")
        ctx.db.execute(
            "INSERT INTO dataset_examples (dataset_id, app_id, prompt, expected) VALUES (?,?,?,?)",
            (ds_id, str(form.get("app_id") or "eval-app"), prompt, str(form.get("expected") or "")),
        )
        raise web.HTTPFound(f"/datasets/{ds_id}")

    def _persist_trace(ex: dict, gen, trace_id: str, ts: float) -> TracePayload:
        """Rich trace_runs row + the TracePayload to ingest, shared by the
        single-example and batched-eval paths so the 13-column insert can't
        drift between them. The row goes in BEFORE plat.ingest — the
        trace.ingested subscriber writes a sparse fallback row and
        INSERT OR IGNORE is first-wins."""
        tin, tout = estimate_tokens(ex["prompt"]), estimate_tokens(gen.text)
        ctx.db.execute(
            "INSERT OR IGNORE INTO trace_runs (trace_id, ts, app_id, agent_id, prompt, response,"
            " provider, model, latency_ms, tokens_in, tokens_out, cost_micro_usd, status)"
            " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,'ok')",
            (
                trace_id,
                ts,
                ex["app_id"],
                "eval",
                ex["prompt"],
                gen.text,
                gen.meta.get("provider"),
                gen.meta.get("model"),
                gen.meta.get("latency_ms"),
                tin,
                tout,
                estimate_cost_micro_usd(tin, tout),
            ),
        )
        return TracePayload(
            trace_id=trace_id,
            ts=datetime.now(timezone.utc),
            app_id=ex["app_id"],
            agent_id="eval",
            prompt=ex["prompt"],
            response=gen.text,
            model=gen.meta.get("model"),
            tools=[],
            env={},
        )

    async def _run_one_example(ex: dict, prewarned: bool = False) -> dict:
        """warn → generate → deterministic check → trace persist.
        ``prewarned=True`` when the caller already warned the whole dataset
        in one batched device call."""
        trace_id = new_trace_id()
        t0 = time.time()
        from kakveda_tpu_torch.dashboard.routes_main import off_loop

        if not prewarned:
            await off_loop(
                plat.warn,
                WarningRequest(
                    app_id=ex["app_id"], agent_id="eval", prompt=ex["prompt"], tools=[], env={}
                ),
            )
        gen = await off_loop(ctx.model.generate, ex["prompt"])
        passed = citation_check_passes(ex["prompt"], gen.text)
        await plat.ingest(_persist_trace(ex, gen, trace_id, t0))
        return {
            "trace_id": trace_id,
            "passed": passed,
            "latency_ms": gen.meta.get("latency_ms", 0),
            "provider": gen.meta.get("provider"),
        }

    @require_roles("admin", "operator")
    async def example_run_now(request):
        ds_id = int(request.match_info["ds_id"])
        ex_id = int(request.match_info["ex_id"])
        ex = ctx.db.one(
            "SELECT * FROM dataset_examples WHERE id=? AND dataset_id=?", (ex_id, ds_id)
        )
        if ex is None:
            raise web.HTTPNotFound(text="example not found")
        res = await _run_one_example(ex)
        raise web.HTTPFound(f"/runs/{res['trace_id']}")

    # ------------------------------------------------------------------
    # evaluations
    # ------------------------------------------------------------------

    @require_roles("admin", "operator")
    async def eval_run(request):
        ds_id = int(request.match_info["ds_id"])
        examples = ctx.db.query("SELECT * FROM dataset_examples WHERE dataset_id=?", (ds_id,))
        if not examples:
            raise web.HTTPBadRequest(text="dataset has no examples")
        run_id = ctx.db.execute(
            "INSERT INTO evaluation_runs (dataset_id, ts, user_email, total, passed, status)"
            " VALUES (?,?,?,?,0,'running')",
            (ds_id, time.time(), request["user"].email, len(examples)),
        )
        # The whole dataset runs as THREE batched calls — one warn_batch
        # (single compiled matmul+top-k), one generate_batch (single padded
        # decode stream on the torch runtime), one ingest_batch (single
        # classify+embed+insert) — where the reference loops
        # warn→generate→ingest one example at a time
        # (reference: services/dashboard/app.py:2315-2393, SURVEY §3.4's
        # "obvious batch-parallel target"). Per-example results are
        # unchanged: generate_batch is exact left-padded batching.
        from kakveda_tpu_torch.dashboard.routes_main import off_loop
        from kakveda_tpu_torch.models.runtime import generate_batch

        await off_loop(
            plat.warn_batch,
            [
                WarningRequest(
                    app_id=ex["app_id"], agent_id="eval", prompt=ex["prompt"], tools=[], env={}
                )
                for ex in examples
            ],
        )
        t0 = time.time()
        gens = await off_loop(generate_batch, ctx.model, [ex["prompt"] for ex in examples])
        passed = 0
        traces = []
        for ex, gen in zip(examples, gens):
            trace_id = new_trace_id()
            ok = citation_check_passes(ex["prompt"], gen.text)
            passed += int(ok)
            traces.append(_persist_trace(ex, gen, trace_id, t0))
            ctx.db.execute(
                "INSERT INTO evaluation_results (eval_run_id, example_id, trace_id, passed,"
                " detail, latency_ms, provider) VALUES (?,?,?,?,?,?,?)",
                (
                    run_id,
                    ex["id"],
                    trace_id,
                    int(ok),
                    None if ok else "citation hallucination detected",
                    gen.meta.get("latency_ms", 0),
                    gen.meta.get("provider"),
                ),
            )
        await plat.ingest_batch(traces)
        ctx.db.execute(
            "UPDATE evaluation_runs SET passed=?, status='done' WHERE id=?", (passed, run_id)
        )
        ctx.db.audit(request["user"].email, "eval.run", {"dataset_id": ds_id, "run_id": run_id})
        raise web.HTTPFound(f"/eval/{run_id}")

    @require_login
    async def evals_page(request):
        """All evaluation runs across datasets, newest first."""
        runs = ctx.db.query(
            "SELECT e.*, d.name AS dataset_name FROM evaluation_runs e"
            " LEFT JOIN datasets d ON d.id=e.dataset_id ORDER BY e.ts DESC LIMIT 200"
        )
        return ctx.render(request, "evals.html", runs=runs)

    @require_login
    async def eval_detail(request):
        """Pass-rate + p50/p95 latency + provider split
        (reference: services/dashboard/app.py:2396-2478)."""
        run_id = int(request.match_info["run_id"])
        run = ctx.db.one("SELECT * FROM evaluation_runs WHERE id=?", (run_id,))
        if run is None:
            raise web.HTTPNotFound(text="eval run not found")
        results = ctx.db.query("SELECT * FROM evaluation_results WHERE eval_run_id=?", (run_id,))
        lat = [r["latency_ms"] or 0 for r in results]
        p50, p95 = _p50_p95(lat)
        providers: dict = {}
        for r in results:
            providers[r["provider"]] = providers.get(r["provider"], 0) + 1
        return ctx.render(
            request,
            "eval_detail.html",
            run=run,
            results=results,
            p50=p50,
            p95=p95,
            providers=providers,
            pass_rate=(100.0 * run["passed"] / run["total"]) if run["total"] else 0.0,
        )

    # ------------------------------------------------------------------
    # prompt library
    # ------------------------------------------------------------------

    @require_login
    async def prompts_page(request):
        prompts = ctx.db.query(
            "SELECT p.*, MAX(v.version) AS latest FROM prompt_library p"
            " LEFT JOIN prompt_versions v ON v.prompt_id=p.id GROUP BY p.id ORDER BY p.name"
        )
        return ctx.render(request, "prompts.html", prompts=prompts)

    @require_roles("admin", "operator")
    async def prompt_save(request):
        """Create or add an auto-incrementing version
        (reference: services/dashboard/app.py:3302-3417)."""
        form = await request.post()
        name = str(form.get("name") or "").strip()
        text = str(form.get("text") or "").strip()
        if not name or not text:
            raise web.HTTPBadRequest(text="name and text required")
        p = ctx.db.one("SELECT id FROM prompt_library WHERE name=?", (name,))
        pid = (
            p["id"]
            if p
            else ctx.db.execute(
                "INSERT INTO prompt_library (name, description, created_at) VALUES (?,?,?)",
                (name, str(form.get("description") or ""), time.time()),
            )
        )
        latest = ctx.db.one(
            "SELECT COALESCE(MAX(version),0) AS v FROM prompt_versions WHERE prompt_id=?", (pid,)
        )["v"]
        ctx.db.execute(
            "INSERT INTO prompt_versions (prompt_id, version, text, created_at) VALUES (?,?,?,?)",
            (pid, latest + 1, text, time.time()),
        )
        raise web.HTTPFound(f"/prompts/{pid}")

    @require_login
    async def prompt_detail(request):
        pid = int(request.match_info["pid"])
        p = ctx.db.one("SELECT * FROM prompt_library WHERE id=?", (pid,))
        if p is None:
            raise web.HTTPNotFound(text="prompt not found")
        versions = ctx.db.query(
            "SELECT * FROM prompt_versions WHERE prompt_id=? ORDER BY version DESC", (pid,)
        )
        return ctx.render(request, "prompt_detail.html", prompt=p, versions=versions)

    # ------------------------------------------------------------------
    # experiments
    # ------------------------------------------------------------------

    @require_login
    async def experiments_page(request):
        exps = ctx.db.query(
            "SELECT e.*, COUNT(r.trace_id) AS n_runs FROM experiments e"
            " LEFT JOIN experiment_runs r ON r.experiment_id=e.id GROUP BY e.id ORDER BY e.created_at DESC"
        )
        return ctx.render(request, "experiments.html", experiments=exps)

    @require_roles("admin", "operator")
    async def experiment_create(request):
        form = await request.post()
        name = str(form.get("name") or "").strip()
        if not name:
            raise web.HTTPBadRequest(text="name required")
        ctx.db.execute(
            "INSERT OR IGNORE INTO experiments (name, description, created_at) VALUES (?,?,?)",
            (name, str(form.get("description") or ""), time.time()),
        )
        raise web.HTTPFound("/experiments")

    @require_login
    async def experiment_detail(request):
        """Run links + p50/p95 scorecard (reference: app.py:3420-3532)."""
        eid = int(request.match_info["eid"])
        exp = ctx.db.one("SELECT * FROM experiments WHERE id=?", (eid,))
        if exp is None:
            raise web.HTTPNotFound(text="experiment not found")
        runs = ctx.db.query(
            "SELECT t.* FROM trace_runs t JOIN experiment_runs r ON r.trace_id=t.trace_id"
            " WHERE r.experiment_id=? ORDER BY t.ts DESC",
            (eid,),
        )
        p50, p95 = _p50_p95([r["latency_ms"] or 0 for r in runs])
        return ctx.render(
            request, "experiment_detail.html", exp=exp, runs=runs, p50=p50, p95=p95
        )

    app.add_routes(
        [
            web.get("/datasets", datasets_page),
            web.post("/datasets/create", dataset_create),
            web.get("/datasets/{ds_id}", dataset_detail),
            web.post("/datasets/{ds_id}/examples", example_add),
            web.post("/datasets/{ds_id}/examples/{ex_id}/run", example_run_now),
            web.post("/datasets/{ds_id}/eval", eval_run),
            web.get("/evals", evals_page),
            web.get("/eval/{run_id}", eval_detail),
            web.get("/prompts", prompts_page),
            web.post("/prompts/save", prompt_save),
            web.get("/prompts/{pid}", prompt_detail),
            web.get("/experiments", experiments_page),
            web.post("/experiments/create", experiment_create),
            web.get("/experiments/{eid}", experiment_detail),
        ]
    )
