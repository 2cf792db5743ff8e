"""The port's request plane as a whole, held to the JAX package's on the CPU.

Both apps run over CPU Platforms (the JAX one at capacity 256 and dim 1024
on a one-device mesh, as ``tests/test_service.py`` builds it; the port's
with ``device="cpu"``) and get one request script:

* ingests and warns carrying W3C ``traceparent`` headers (and request
  ids), then ``/trace/{id}`` of those traces;
* a second app over the same Platform with ``KAKVEDA_RATELIMIT_RPS=1`` and
  ``KAKVEDA_RATELIMIT_BURST=1`` (the bucket is read at ``make_app``): three
  quick ``/ingest`` from one client, then one ``/warn`` (warn is not
  rate-limited);
* a noisy tenant and a victim tenant on ``/warn`` with the warn bound at 8,
  each request sent once the one before it is queued or shed, while the
  first batch is held (so each submit sees the same queue in both
  packages), then released;
* ``service.handler`` armed for 3 requests, then five ``/healthz``;
* ``/readyz``, and the 35 families of the metric catalog.

Compared: statuses and bodies (warn scores within 1e-6; the Retry-After
number in a 429 body is a drain-rate estimate and is masked, its header
compared), span trees (names, parent links, outcomes, attributes; span
ids, times and the request-id attribute masked), the ``/readyz``
admission block (the port's extra ``sheds`` key is held to the 429s
counted), and each family's movement over the script: counter deltas,
histogram counts (seconds masked), and the value of each gauge series that
either script set (a series no step sets holds whatever an earlier test in
the worker left, so it is masked). ``KAKVEDA_ADMIT_OCC_WINDOW_S=0``
makes the reported occupancy the instantaneous one.
"""

import asyncio
import re
import threading
import uuid
from datetime import datetime, timezone

import pytest
from aiohttp.test_utils import TestClient, TestServer

from kakveda_tpu.core import admission as jax_admission
from kakveda_tpu.core import faults as jax_faults
from kakveda_tpu.core import metrics as jax_metrics
from kakveda_tpu.core import trace as jax_trace
from kakveda_tpu.parallel.mesh import create_mesh
from kakveda_tpu.platform import Platform as JaxPlatform
from kakveda_tpu.service.app import WARN_BATCHER_KEY as JAX_BATCHER_KEY
from kakveda_tpu.service.app import make_app as jax_make_app
from kakveda_tpu_torch.core import admission as port_admission
from kakveda_tpu_torch.core import faults as port_faults
from kakveda_tpu_torch.core import metrics as port_metrics
from kakveda_tpu_torch.core import trace as port_trace
from kakveda_tpu_torch.platform import Platform
from kakveda_tpu_torch.service.app import WARN_BATCHER_KEY, make_app

FAMILIES = [
    "kakveda_admission_admitted_total", "kakveda_admission_inflight",
    "kakveda_admission_tenant_shed_total", "kakveda_admission_tenant_quota_degraded_total",
    "kakveda_tenant_table_size",
    "kakveda_brownout_state", "kakveda_brownout_transitions_total",
    "kakveda_device_degraded", "kakveda_device_degraded_transitions_total", "kakveda_device_probe_total",
    "kakveda_ingest_batch_seconds", "kakveda_ingest_traces_total", "kakveda_ingest_failures_total",
    "kakveda_microbatch_batch_size", "kakveda_microbatch_queue_depth",
    "kakveda_mine_attach_total", "kakveda_mine_clusters", "kakveda_mine_merges_total",
    "kakveda_mine_sweeps_total", "kakveda_mine_update_seconds",
    "kakveda_native_score_seconds", "kakveda_native_fallback_total",
    "kakveda_gfkb_compact_total", "kakveda_gfkb_route_candidates", "kakveda_gfkb_tier_promote_total",
    "kakveda_gfkb_tier_route_total", "kakveda_gfkb_tier_rows", "kakveda_gfkb_tier_spill_total",
    "kakveda_gfkb_tombstone_total", "kakveda_gfkb_tombstoned_rows",
    "kakveda_warn_batch_seconds", "kakveda_warn_fallback_total", "kakveda_warn_request_seconds",
    "kakveda_warn_requests_total",
    "kakveda_bus_events_published_total",
]
assert len(FAMILIES) == 35

STUB_RESPONSE = (
    "Here is a summary with references.\n\n"
    "References:\n"
    "[1] Smith et al. (2020) A Study on Things.\n"
    "[2] Doe (2021) Another Paper.\n"
)
CITE = "Summarize this document and include citations even if not provided."
SCORE_TOL = 1e-6

PKG = {
    "jax": dict(admission=jax_admission, faults=jax_faults, metrics=jax_metrics, trace=jax_trace,
                make_app=jax_make_app, batcher_key=JAX_BATCHER_KEY,
                platform=lambda d: JaxPlatform(data_dir=d, mesh=create_mesh("data:1"), capacity=256, dim=1024)),
    "port": dict(admission=port_admission, faults=port_faults, metrics=port_metrics, trace=port_trace,
                 make_app=make_app, batcher_key=WARN_BATCHER_KEY,
                 platform=lambda d: Platform(data_dir=d, capacity=256, dim=1024, device="cpu")),
}


@pytest.fixture(autouse=True)
def _clean():
    for p in PKG.values():
        p["faults"].disarm()
        p["admission"].reset_for_tests()
        p["trace"].get_tracer().reset()
    yield
    for p in PKG.values():
        p["faults"].disarm()
        p["admission"].reset_for_tests()
        p["trace"].get_tracer().reset()


def _tp(i):
    return f"00-{i:032x}-{i + 0x100:016x}-01", f"{i:032x}", f"{i + 0x100:016x}"


def _trace_body(app_id, prompt, i, response=STUB_RESPONSE):
    return {
        "trace_id": str(uuid.UUID(int=i)),
        "ts": datetime(2026, 1, 1, tzinfo=timezone.utc).isoformat(),
        "app_id": app_id, "agent_id": "agent-1", "prompt": prompt, "response": response,
        "model": "stub", "temperature": 0.2, "tools": [], "env": {"os": "linux"},
    }


def _masked_tree(spans):
    names = {s["span_id"]: s["name"] for s in spans}
    out = []
    for s in spans:
        attrs = {k: v for k, v in s["attrs"].items() if k != "rid"}
        out.append((s["name"], names.get(s["parent_id"], s["parent_id"]), s["trace_id"], s["outcome"], attrs))
    return out


def _mask_body(b):
    if isinstance(b, dict):
        return {k: ("<ra>" if k == "retry_after" else _mask_body(v)) for k, v in b.items()}
    if isinstance(b, (list, tuple)):
        return [_mask_body(v) for v in b]
    return b


def _gauges_touched(before, after):
    """(family, label) of each gauge series the script set: new, or moved.

    The registry is process-global, so a gauge no step of the script sets
    still holds what an earlier test in the same worker left in it.
    """
    out = set()
    for name in FAMILIES:
        fam = after.get(name)
        if fam is None or fam["type"] != "gauge":
            continue
        prev = (before.get(name) or {}).get("series", {})
        out |= {(name, label) for label, v in fam["series"].items() if prev.get(label) != v}
    return out


def _family_moves(before, after, gauges):
    out = {}
    for name in FAMILIES:
        fam = after.get(name)
        if fam is None:
            out[name] = None
            continue
        prev = (before.get(name) or {}).get("series", {})
        moves = {}
        for label, v in fam["series"].items():
            if isinstance(v, dict):  # histogram: the count's movement only
                d = v["count"] - (prev.get(label) or {}).get("count", 0)
                if d:
                    moves[label] = ("count", d)
            elif fam["type"] == "gauge":
                if (name, label) in gauges:
                    moves[label] = ("value", v)
            else:
                d = v - prev.get(label, 0)
                if d:
                    moves[label] = ("delta", d)
        out[name] = (fam["type"], moves)
    return out


def _drive(pkg, tmp_path, monkeypatch):
    p = PKG[pkg]
    monkeypatch.setenv("KAKVEDA_ADMIT_WARN", "8")
    monkeypatch.setenv("KAKVEDA_ADMIT_OCC_WINDOW_S", "0")
    monkeypatch.setenv("KAKVEDA_ADMIT_RA_JITTER", "0")
    monkeypatch.delenv("KAKVEDA_RATELIMIT_RPS", raising=False)
    p["admission"].reset_for_tests()
    plat = p["platform"](tmp_path / pkg)
    gate = threading.Event()
    gate.set()
    inner = plat.warn_batch
    plat.warn_batch = lambda reqs: gate.wait(60) and inner(reqs)
    reg = p["metrics"].get_registry()
    before = reg.snapshot()
    app = p["make_app"](plat)
    monkeypatch.setenv("KAKVEDA_RATELIMIT_RPS", "1")
    monkeypatch.setenv("KAKVEDA_RATELIMIT_BURST", "1")
    app_rl = p["make_app"](plat)
    monkeypatch.delenv("KAKVEDA_RATELIMIT_RPS")
    monkeypatch.delenv("KAKVEDA_RATELIMIT_BURST")
    faults = p["faults"]

    async def go():
        c = TestClient(TestServer(app))
        c_rl = TestClient(TestServer(app_rl))
        await c.start_server()
        await c_rl.start_server()
        log = []

        async def call(client, method, path, i=None, **kw):
            headers = {}
            if i is not None:
                headers = {"traceparent": _tp(i)[0], "x-request-id": f"{i:032x}"}
            r = await getattr(client, method)(path, headers=headers, **kw)
            ctype = r.headers.get("Content-Type", "")
            body = await r.json() if "json" in ctype else None
            return r.status, r.headers.get("Retry-After"), body

        try:
            traces = [_trace_body(f"app-{k % 2}", CITE if k % 3 else "Explain this with references.", k)
                      for k in range(6)]
            log.append(("ingest_batch", await call(c, "post", "/ingest/batch", 1, json={"traces": traces})))
            log.append(("ingest", await call(c, "post", "/ingest", 2,
                                             json={"trace": _trace_body("app-2", CITE, 99)})))
            for i in range(3, 7):
                log.append(("warn", await call(c, "post", "/warn", i, json={
                    "app_id": f"app-{i % 3}", "prompt": CITE if i % 2 else "hello world", "tools": [],
                    "env": {"os": "linux"}})))
            for i in (1, 2, 3, 4):
                status, _, body = await call(c, "get", f"/trace/{_tp(i)[1]}")
                log.append(("trace", status, _masked_tree(body["spans"])))
            # The token bucket: one token, then 429s; warn is not limited.
            for _ in range(3):
                log.append(("rl_ingest", await call(c_rl, "post", "/ingest", data=b"not json")))
            log.append(("rl_warn", (await call(c_rl, "post", "/warn", json={
                "app_id": "app-0", "prompt": "hello world"}))[0]))
            # Noisy and victim tenants against a held batch: each request is
            # queued (or shed) before the next is sent.
            gate.clear()
            batcher = app[p["batcher_key"]]
            tasks = []
            order = ["noisy"] * 3 + ["victim"] + ["noisy"] * 5 + ["victim"] + ["noisy"] * 8 + ["victim"] * 2
            for n, tenant in enumerate(order):
                depth = batcher._depth()
                tasks.append(asyncio.ensure_future(call(c, "post", "/warn", json={
                    "app_id": tenant, "prompt": f"{CITE} {n}", "tools": [], "env": {}})))
                for _ in range(2500):
                    await asyncio.sleep(0.002)
                    if tasks[-1].done() or batcher._depth() > depth or (n == 0 and _ > 50):
                        break
            gate.set()
            flood = await asyncio.gather(*tasks)
            log.append(("flood", [(t, s, ra, b) for t, (s, ra, b) in zip(order, flood)]))
            # The service.handler site, armed for three requests.
            faults.arm("service.handler:1.0:3")
            for _ in range(5):
                log.append(("handler", await call(c, "get", "/healthz")))
            faults.disarm()
            ready = (await call(c, "get", "/readyz"))[2]
            text = await (await c.get("/metrics")).text()
            plane = (await call(c, "get", "/trace"))[2]["plane"]
            return log, ready, text, plane
        finally:
            gate.set()
            await c.close()
            await c_rl.close()

    log, ready, text, plane = asyncio.run(go())
    after = reg.snapshot()
    getattr(plat, "close", lambda: None)()
    return log, ready, text, plane, (before, after)


def _assert_close(a, b, path="$"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert isinstance(b, (int, float)) and abs(a - b) <= SCORE_TOL, (path, a, b)
    elif isinstance(a, str) and "similarity=" in a:
        assert re.sub(r"similarity=[0-9.]+", "", a) == re.sub(r"similarity=[0-9.]+", "", b), path
    else:
        assert a == b, (path, a, b)


def test_request_plane_matches_jax(tmp_path, monkeypatch):
    ref = _drive("jax", tmp_path, monkeypatch)
    port = _drive("port", tmp_path, monkeypatch)
    (log, ready, text, plane, snaps), (rlog, rready, _, rplane, rsnaps) = port, ref
    # A gauge is compared where either script set it, by its value after.
    gauges = _gauges_touched(*snaps) | _gauges_touched(*rsnaps)
    moves, rmoves = _family_moves(*snaps, gauges), _family_moves(*rsnaps, gauges)

    _assert_close(_mask_body(log), _mask_body(rlog))

    steps = {}
    for entry in log:
        steps.setdefault(entry[0], []).append(entry[1:])
    # Traces: service.request under the caller's span, its handler span inside.
    tree_warn = steps["trace"][2][1]
    assert [(n, par) for n, par, *_ in tree_warn] == [("gfkb.warn", "service.request"),
                                                      ("service.request", _tp(3)[2])]
    assert set(tree_warn[0][4]) == {"app_id", "tier", "nprobe", "degraded", "native", "action"}
    assert [n for n, *_ in steps["trace"][0][1]] == ["gfkb.ingest", "service.request"]
    # The token bucket: the first request spends the token, then 429s.
    assert [e[0][0] for e in steps["rl_ingest"]] == [422, 429, 429] and steps["rl_warn"] == [(200,)]
    for status, ra, body in [e[0] for e in steps["rl_ingest"]][1:]:
        assert ra == "1" and body["reason"] == "ratelimit" and body["ok"] is False
    # Tenants: every shed is the noisy tenant's, every victim request served.
    flood = steps["flood"][0][0]
    sheds = [(t, b["reason"]) for t, s, _, b in flood if s == 429]
    served = sum(s == 200 for _, s, _, _ in flood)
    assert sheds and all(t == "noisy" for t, _ in sheds) and served + len(sheds) == len(flood)
    assert "tenant_quota" in {r for _, r in sheds}
    assert all(s == 200 for t, s, _, _ in flood if t == "victim")
    # The armed handler site: three clean 500s, then 200s.
    assert [e[0][0] for e in steps["handler"]] == [500, 500, 500, 200, 200]

    adm, radm = dict(ready["admission"]), rready["admission"]
    sheds_port = adm.pop("sheds")
    assert adm == radm
    assert sheds_port["ingest/ratelimit"] == 2 and sum(sheds_port.values()) == 2 + len(sheds)
    assert radm["brownout_step"] == 0 and radm["tenants"]["top_shed"][0]["tenant"] == "noisy"
    # The one span open when /trace reads the counters is its own request's.
    assert plane == rplane and plane["orphaned"] == 1

    for name in FAMILIES:
        assert f"# TYPE {name} " in text, name
    assert moves == rmoves
    assert moves["kakveda_admission_tenant_shed_total"][1] == {"tenant=noisy": ("delta", len(sheds))}
    assert moves["kakveda_warn_request_seconds"][1][""] == ("count", 4 + 1 + served)
    # Each bucket's exemplar is the trace id of a warn it observed.
    ex = re.findall(r'kakveda_warn_request_seconds_bucket\{[^}]*\} \d+ # \{trace_id="([0-9a-f]{32})"\}', text)
    assert ex
