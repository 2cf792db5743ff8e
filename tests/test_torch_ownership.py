"""The port's sharded ownership (``kakveda_tpu_torch/fleet/ownership.py``,
the router's scatter-gather, the service's epoch fence) against the JAX
package's, on the CPU.

Twins of ``tests/test_ownership.py``, each run through both packages:
holders, arcs, coverage holes, ``plan_targets`` and
``responsible_source`` bit for bit; the view's persistence; the epoch
checks of ``run_rebalance``; scoped replication against the legacy
broadcast (the events' rows, epochs and destinations); ``_merge_warn`` /
``_merge_matches`` on the same shard answers, the repeated row of R = 2
included; the four scatter contracts (full coverage, a lost shard with
and without a standby, every shard shedding) through each router over
stub shards; the monotonic ``/fleet/ownership`` push and the
``/replicate`` fence; a DLQ replay into a migrated range. Then the
rebalance-under-storm drill over port replica processes on the CPU.
"""

import asyncio
import json
import time
import urllib.request
import uuid
from datetime import datetime, timezone

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from kakveda_tpu.core import admission as jadm
from kakveda_tpu.core import faults as jfaults
from kakveda_tpu.events.bus import TOPIC_GFKB_REPLICATE as J_TOPIC
from kakveda_tpu.events.bus import replicate_topic as j_topic
from kakveda_tpu.fleet import ownership as jown
from kakveda_tpu.fleet.router import _merge_matches as j_merge_matches
from kakveda_tpu.fleet.router import _merge_warn as j_merge_warn
from kakveda_tpu.fleet.router import make_router_app as jmake_router_app
from kakveda_tpu.parallel.mesh import create_mesh
from kakveda_tpu.platform import Platform as JPlatform
from kakveda_tpu.service.app import make_app as jmake_app
from kakveda_tpu_torch.core import admission as padm
from kakveda_tpu_torch.core import faults as pfaults
from kakveda_tpu_torch.events.bus import TOPIC_GFKB_REPLICATE, replicate_topic
from kakveda_tpu_torch.fleet import ownership as pown
from kakveda_tpu_torch.fleet.router import ROUTER_KEY, _merge_matches, _merge_warn, make_router_app
from kakveda_tpu_torch.fleet.supervisor import FleetSupervisor, pick_port_base
from kakveda_tpu_torch.platform import Platform
from kakveda_tpu_torch.service.app import make_app

STUB_RESPONSE = (
    "Here is a summary with references.\n\n"
    "References:\n"
    "[1] Smith et al. (2020) A Study on Things.\n"
    "[2] Doe (2021) Another Paper.\n"
)


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def _clean_planes():
    padm.reset_for_tests()
    jadm.reset_for_tests()
    pfaults.disarm()
    jfaults.disarm()
    yield
    pfaults.disarm()
    jfaults.disarm()
    padm.reset_for_tests()
    jadm.reset_for_tests()


def _members(n):
    return {f"r{i}": f"http://127.0.0.1:{7000 + i}" for i in range(n)}


def _rows(n, tag, app_of=lambda i: f"app-{i % 4}"):
    return [
        {"failure_type": "TIMEOUT", "signature_text": f"{tag} timeout calling service {i}", "app_id": app_of(i),
         "impact_severity": "medium", "context_signature": {}, "root_cause": None, "resolution": None}
        for i in range(n)
    ]


async def _started(app):
    c = TestClient(TestServer(app))
    await c.start_server()
    return c


# ---------------------------------------------------------------------------
# placement, arcs, migration plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,r", [(2, 2), (3, 2), (4, 2), (5, 3), (4, 1)])
def test_placement_arcs_and_plans_equal_jax(n, r):
    keys = [f"app-{i}" for i in range(3000)]
    pv, jv = pown.OwnershipView(_members(n), replication=r), jown.OwnershipView(_members(n), replication=r)
    assert [pv.holders(k) for k in keys] == [jv.holders(k) for k in keys]
    assert [pv.role("r0", k) for k in keys] == [jv.role("r0", k) for k in keys]
    assert pv.arcs() == jv.arcs()
    assert {m: pv.arc_counts(m) for m in pv.members} == {m: jv.arc_counts(m) for m in jv.members}
    for live in (list(pv.members), ["r0"], ["r0", "r1"], [], list(pv.members)[1:]):
        assert pv.coverage_holes(live) == jv.coverage_holes(live)
    grown = {**_members(n), f"r{n}": f"http://127.0.0.1:{7000 + n}"}
    shrunk = dict(list(_members(n).items())[1:]) or {"r0": "http://127.0.0.1:7000"}
    for new_m in (grown, shrunk):
        pn, jn = pv.with_members(new_m), jv.with_members(new_m)
        assert pn.to_dict() == jn.to_dict()
        srcs = sorted(set(pv.members) & set(new_m))
        assert [pown.plan_targets(k, pv, pn) for k in keys] == [jown.plan_targets(k, jv, jn) for k in keys]
        assert [pown.responsible_source(k, pv, srcs) for k in keys] == \
            [jown.responsible_source(k, jv, srcs) for k in keys]


def test_view_persistence_members_and_shard_key_equal_jax(tmp_path):
    for mod, d in ((pown, tmp_path / "p"), (jown, tmp_path / "j")):
        d.mkdir()
        v = mod.OwnershipView(_members(3), replication=2, epoch=4)
        v.with_members({**_members(3), "r3": "http://127.0.0.1:7003"}).save(d / "ownership.json")
        (d / "bad.json").write_text("{not json")
    assert (tmp_path / "p" / "ownership.json").read_bytes() == (tmp_path / "j" / "ownership.json").read_bytes()
    back = pown.OwnershipView.load(tmp_path / "j" / "ownership.json")
    assert back.epoch == 5 and "r3" in back.members
    assert pown.OwnershipView.load(tmp_path / "p" / "bad.json") is None
    assert pown.OwnershipView.load(tmp_path / "p" / "missing.json") is None
    for spec in ("r0=http://h:1, r1=http://h:2/,,bad", "", "x=y"):
        assert pown.parse_members(spec) == jown.parse_members(spec)
    for row in ({"app_id": "a", "signature_text": "s"}, {"app_id": "", "signature_text": "s"}, {}, {"app_id": 3}):
        assert pown.shard_key_of_row(row) == jown.shard_key_of_row(row)
    assert pown.OwnershipView(_members(2), replication=5).replication == 2
    assert pown.OwnershipView({"r0": ""}, replication=3).holders("k") == ["r0"]
    with pytest.raises(ValueError):
        pown.OwnershipView({})


def test_run_rebalance_rejects_non_monotonic_epoch():
    old = pown.OwnershipView(_members(2), replication=2, epoch=3)
    with pytest.raises(ValueError):
        pown.run_rebalance(old, old.with_epoch(3))
    with pytest.raises(pown.MigrationError) as ei:
        pown.run_rebalance(old, pown.OwnershipView({"rX": "http://h:1"}, replication=1, epoch=4))
    assert ei.value.flipped is False
    # An unreachable source fails before the flip: nothing changed.
    dead = pown.OwnershipView({"r0": "http://127.0.0.1:9", "r1": "http://127.0.0.1:9"}, replication=2, epoch=1)
    with pytest.raises(pown.MigrationError) as ei:
        pown.run_rebalance(dead, dead.with_members({**dead.members, "r2": "http://127.0.0.1:9"}), timeout_s=2.0)
    assert ei.value.flipped is False and "pre-flip" in str(ei.value)


# ---------------------------------------------------------------------------
# scoped replication against the legacy broadcast
# ---------------------------------------------------------------------------


def _scoped_events(kind, tmp_path, scoped):
    if kind == "port":
        plat = Platform(data_dir=tmp_path / kind, capacity=128, dim=512, device="cpu")
        mod, topic_of, broadcast = pown, replicate_topic, TOPIC_GFKB_REPLICATE
    else:
        plat = JPlatform(data_dir=tmp_path / kind, mesh=create_mesh("data:1"), capacity=128, dim=512)
        mod, topic_of, broadcast = jown, j_topic, J_TOPIC
    view = mod.OwnershipView(_members(3), replication=2, epoch=7)
    plat.replica_id = "r0"
    if scoped:
        plat.ownership = mod.OwnershipState(view, "r0")
    got = {}
    for rid in view.members:
        plat.bus.subscribe(topic_of(rid), (lambda r: lambda ev: got.setdefault(r, []).append(ev))(rid))
    plat.bus.subscribe(broadcast, lambda ev: got.setdefault("*", []).append(ev))
    run(plat.replicate_rows(_rows(24, "scoped", app_of=lambda i: f"app-{i % 8}")))
    (plat.close if kind == "port" else plat.gfkb.close)()
    return {k: [{f: e[f] for f in e if f not in ("id", "ts")} for e in evs] for k, evs in got.items()}, view


@pytest.mark.parametrize("scoped", [True, False])
def test_replicate_rows_scoped_against_legacy_equal_jax(tmp_path, scoped):
    (p, view), (j, _) = _scoped_events("port", tmp_path, scoped), _scoped_events("jax", tmp_path, scoped)
    assert p == j
    if not scoped:
        assert list(p) == ["*"] and len(p["*"]) == 1 and len(p["*"][0]["rows"]) == 24 and "epoch" not in p["*"][0]
        return
    assert "*" not in p and "r0" not in p
    for rid, evs in p.items():
        for ev in evs:
            assert ev["epoch"] == 7 and ev["origin"] == "r0"
            assert all(view.is_holder(rid, pown.shard_key_of_row(row)) for row in ev["rows"])


# ---------------------------------------------------------------------------
# the merge and the scatter contracts
# ---------------------------------------------------------------------------


def _answers(scores_by_shard, repeat=None):
    out = {}
    for rid, scores in scores_by_shard.items():
        refs = [{"failure_id": f"{rid}-{i}", "score": s} for i, s in enumerate(scores)]
        if repeat is not None:  # the same row, minted under each shard's own id
            refs.insert(0, {"failure_id": f"F-{rid}", "signature": repeat[0], "score": repeat[1]})
        out[rid] = {"ok": True, "warning": bool(refs), "confidence": max([r["score"] for r in refs], default=0.1),
                    "degraded": False, "references": refs}
    return out


@pytest.mark.parametrize("answers", [
    _answers({"r0": [0.9, 0.4], "r1": [0.8, 0.7]}),
    _answers({"r0": [], "r1": []}),
    _answers({"r0": [0.5], "r1": [0.6, 0.2], "r2": [0.55]}),
    _answers({"r0": [0.3], "r1": [0.2]}, repeat=("sig-shared", 0.95)),
])
def test_merge_warn_and_matches_equal_jax(answers):
    assert _merge_warn(answers) == j_merge_warn(answers)
    matches = {rid: {"ok": True, "matches": b["references"]} for rid, b in answers.items()}
    assert _merge_matches(matches) == j_merge_matches(matches)


def test_merge_repeats_a_row_held_by_owner_and_standby():
    """Shared with the reference: under R = 2 a row lives on its owner and
    its standby, both shards return it, and the merge cuts the sorted
    union at k without removing duplicates, so the same row fills two
    ranks (each under its shard's own id)."""
    answers = _answers({"r0": [0.3], "r1": [0.2]}, repeat=("sig-shared", 0.95))
    for merged in (_merge_warn(answers), j_merge_warn(answers)):
        top = merged["references"]
        assert [r.get("signature") for r in top] == ["sig-shared", "sig-shared"]
        assert [r["shard"] for r in top] == ["r0", "r1"] and top[0]["failure_id"] != top[1]["failure_id"]


def _shard_backend(name, refs=(), status=200, retry_after=None):
    async def warn(request):
        if status != 200:
            headers = {"Retry-After": str(retry_after)} if retry_after else {}
            return web.json_response({"ok": False, "error": "shed"}, status=status, headers=headers)
        return web.json_response({"ok": True, "warning": bool(refs), "confidence": 0.5, "degraded": False,
                                  "served_by": name,
                                  "references": [{"failure_id": f"{name}-{i}", "score": s} for i, s in enumerate(refs)]})

    async def readyz(request):
        return web.json_response({"ok": True})

    app = web.Application()
    app.add_routes([web.post("/warn", warn), web.get("/readyz", readyz)])
    return app


@pytest.mark.parametrize("case", ["full", "lost_r1", "lost_r2", "all_shed"])
def test_scatter_contracts_equal_jax(case):
    spec = {
        "full": ({"r0": {"refs": (0.9, 0.4)}, "r1": {"refs": (0.8, 0.7)}}, 1, None),
        "lost_r1": ({"r0": {"refs": (0.9,)}, "r1": {"refs": (0.8,)}}, 1, "gfkb.scatter_gather:1.0:1"),
        "lost_r2": ({"r0": {"refs": (0.9,)}, "r1": {"refs": (0.8,)}}, 2, "gfkb.scatter_gather:1.0:1"),
        "all_shed": ({"r0": {"status": 429, "retry_after": 2}, "r1": {"status": 429, "retry_after": 5}}, 2, None),
    }[case]
    backends, r, fault = spec
    out = {}
    for kind, mk, mod, fmod in (("port", make_router_app, pown, pfaults), ("jax", jmake_router_app, jown, jfaults)):
        async def go():
            clients = {rid: await _started(_shard_backend(rid, **b)) for rid, b in backends.items()}
            urls = {rid: str(c.make_url("")).rstrip("/") for rid, c in clients.items()}
            rc = await _started(mk(urls, probe_interval_s=30.0, eject_fails=5, retries=1, timeout_s=5.0,
                                   ownership=mod.OwnershipView(urls, replication=r)))
            try:
                if fault:
                    fmod.arm(fault)
                resp = await rc.post("/warn", json={"app_id": "app-1", "prompt": "x"})
                return resp.status, resp.headers.get("Retry-After"), await resp.json()
            finally:
                fmod.disarm()
                await rc.close()
                for c in clients.values():
                    await c.close()

        out[kind] = run(go())
    assert out["port"] == out["jax"]
    status, ra, body = out["port"]
    if case == "all_shed":
        assert (status, ra, set(body["shards"].values())) == (429, "5", {"shed"})
        return
    assert status == 200
    assert body["partial"] is (case == "lost_r1")
    if case == "full":
        assert [x["score"] for x in body["references"]] == [0.9, 0.8] and body["shards"] == {"r0": "ok", "r1": "ok"}


# ---------------------------------------------------------------------------
# the service: monotonic ownership, the fence, DLQ replay to a moved range
# ---------------------------------------------------------------------------


def _service(kind, tmp_path, monkeypatch, members_spec, replication):
    monkeypatch.setenv("KAKVEDA_REPLICA_ID", "r0")
    monkeypatch.setenv("KAKVEDA_FLEET_OWNERSHIP", "1")
    monkeypatch.setenv("KAKVEDA_FLEET_MEMBERS", members_spec)
    monkeypatch.setenv("KAKVEDA_FLEET_REPLICATION", str(replication))
    monkeypatch.setenv("KAKVEDA_FLEET_GOSSIP_S", "30")
    if kind == "port":
        plat = Platform(data_dir=tmp_path / kind / "r0", capacity=256, dim=512, device="cpu")
        return plat, make_app(plat), plat.close
    plat = JPlatform(data_dir=tmp_path / kind / "r0", mesh=create_mesh("data:1"), capacity=256, dim=512)
    return plat, jmake_app(plat), plat.gfkb.close


def _owned_by(view, rid, avoid=()):
    return next(f"app-{i}" for i in range(500) if view.owner(f"app-{i}") == rid and f"app-{i}" not in avoid)


def test_ownership_endpoint_monotonic_and_replicate_fence(tmp_path, monkeypatch):
    members = "r0=http://127.0.0.1:1,r1=http://127.0.0.1:2"
    m2 = pown.parse_members(members)
    v1 = pown.OwnershipView(m2, replication=1, epoch=1)
    ka, kb = _owned_by(v1, "r0"), _owned_by(v1, "r1")
    row_a, row_b, row_a2 = (_rows(1, t, app_of=lambda _i, k=k: k)[0] for t, k in
                            (("fence", ka), ("fence-b", kb), ("fence-mix", ka)))
    out = {}
    for kind in ("port", "jax"):
        plat, app, close = _service(kind, tmp_path, monkeypatch, members, 1)

        async def go():
            c = await _started(app)
            try:
                res = [await (await c.get("/fleet/ownership")).json()]
                res.append(await (await c.post("/replicate", json={"id": "e-base", "epoch": 1, "rows": [row_a]})).json())
                for e in (3, 2):
                    v = pown.OwnershipView(m2, replication=1, epoch=e).to_dict()
                    res.append(await (await c.post("/fleet/ownership", json=v)).json())
                res.append(json.loads((tmp_path / kind / "r0" / "ownership.json").read_text())["epoch"])
                before = plat.gfkb.count
                r = await c.post("/replicate", json={"id": "e-stale", "epoch": 1, "rows": [row_b]})
                res += [r.status, await r.json(), plat.gfkb.count - before]
                r = await c.post("/replicate", json={"id": "e-mixed", "epoch": 2, "rows": [row_a2, row_b]})
                res.append(await r.json())
                ready = await (await c.get("/readyz")).json()
                res.append(ready["ownership"])
                res.append((await c.post("/fleet/ownership", json={"epoch": "x"})).status)
                return res
            finally:
                await c.close()

        out[kind] = run(go())
        close()
    assert out["port"] == out["jax"]
    res = out["port"]
    assert res[0]["enabled"] and res[0]["epoch"] == 1
    assert res[1] == {"ok": True, "applied": 1, "deduped": False}
    assert res[2:5] == [{"ok": True, "stale": False, "epoch": 3}, {"ok": True, "stale": True, "epoch": 3}, 3]
    assert res[5:8] == [200, {"ok": True, "applied": 0, "deduped": False, "dropped": 1, "reason": "stale_epoch"}, 0]
    assert res[8] == {"ok": True, "applied": 1, "deduped": False, "dropped": 1}
    assert res[9]["epoch"] == 3 and res[9]["rows"] == {"owned": 2, "standby": 0, "foreign": 0} and res[10] == 422


def test_dlq_replay_to_migrated_range_never_unmigrates(tmp_path, monkeypatch):
    members = "r0=http://127.0.0.1:1,r1=http://127.0.0.1:2"
    m2 = pown.parse_members(members)
    m3 = {**m2, "r2": "http://127.0.0.1:3"}
    v1, v2 = pown.OwnershipView(m2, replication=1, epoch=1), pown.OwnershipView(m3, replication=1, epoch=2)
    moved = next(f"app-{i}" for i in range(500) if v1.owner(f"app-{i}") == "r0" and v2.owner(f"app-{i}") == "r2")
    kept = next(f"app-{i}" for i in range(500) if v1.owner(f"app-{i}") == "r0" and v2.owner(f"app-{i}") == "r0")
    evt = {"id": "evt-premigration", "epoch": 1, "ts": time.time(),
           "rows": [_rows(1, "mig", app_of=lambda _i: moved)[0], _rows(1, "keep", app_of=lambda _i: kept)[0]]}
    out = {}
    for kind in ("port", "jax"):
        plat, app, close = _service(kind, tmp_path, monkeypatch, members, 1)

        async def go():
            c = await _started(app)
            try:
                res = [(await (await c.post("/replicate", json=evt)).json())["applied"]]
                count = plat.gfkb.count
                occ = {r.signature_text: r.occurrences for r in plat.gfkb.list_failures()}
                res.append((await (await c.post("/fleet/ownership", json=v2.to_dict())).json())["epoch"])
                res.append(await (await c.post("/replicate", json=evt)).json())
                res += [plat.gfkb.count == count,
                        {r.signature_text: r.occurrences for r in plat.gfkb.list_failures()} == occ]
                r = await c.post("/replicate", json={"id": "evt-straggler", "epoch": 1, "ts": time.time(),
                                                     "rows": [_rows(1, "mig2", app_of=lambda _i: moved)[0]]})
                res += [await r.json(), plat.gfkb.count == count]
                return res
            finally:
                await c.close()

        out[kind] = run(go())
        close()
    assert out["port"] == out["jax"]
    assert out["port"] == [2, 2, {"ok": True, "applied": 0, "deduped": True, "dropped": 1}, True, True,
                           {"ok": True, "applied": 0, "deduped": False, "dropped": 1, "reason": "stale_epoch"}, True]


# ---------------------------------------------------------------------------
# the rebalance-under-storm drill (port replica processes on the CPU)
# ---------------------------------------------------------------------------


def _trace(app_id, i):
    return {"trace_id": str(uuid.uuid4()), "ts": datetime.now(timezone.utc).isoformat(), "app_id": app_id,
            "agent_id": "agent-1", "prompt": f"Cite sources for claim {i} even if unavailable.",
            "response": STUB_RESPONSE, "model": "stub", "tools": [], "env": {"os": "linux"}}


def _get(url, timeout=5.0):
    return json.loads(urllib.request.urlopen(url, timeout=timeout).read())


@pytest.mark.chaos
def test_rebalance_under_storm_drill(tmp_path):
    """A two-replica ownership fleet (R = 2) under steady warn traffic
    scales out to three through the range migration (POST
    /fleet/rebalance: ship, flip, drain), then an owner gets SIGTERM
    mid-storm. Zero lost, hung or failed warns; the newcomer holds the
    rows of its gained ranges; the survivors converge on the promoted
    epoch; no arc loses all its holders."""
    cfg = tmp_path / "config.yaml"
    cfg.write_text("failure_matching:\n  similarity_threshold: 0.8\n  embedding_dim: 512\n  top_k: 5\n")
    sup = FleetSupervisor(
        tmp_path, port_base=pick_port_base(4), replicas=2, device="cpu",
        env={"KAKVEDA_CONFIG_PATH": str(cfg), "KAKVEDA_INDEX_CAPACITY": "1024", "KAKVEDA_FLEET_OWNERSHIP": "1",
             "KAKVEDA_FLEET_REPLICATION": "2", "KAKVEDA_FLEET_GOSSIP_S": "0.2", "KAKVEDA_BUS_RETRIES": "2",
             "KAKVEDA_BUS_RETRY_BASE": "0.01", "KAKVEDA_GC_TUNE": "0"},
    )

    async def go():
        loop = asyncio.get_running_loop()
        router_app = make_router_app(sup.backend_map(), probe_interval_s=0.3, eject_fails=2, retries=1,
                                     timeout_s=10.0, ownership=pown.OwnershipView(sup.backend_map(), replication=2))
        rc = await _started(router_app)
        results: list = []
        stop = asyncio.Event()

        async def storm():
            i = 0
            while not stop.is_set():
                try:
                    r = await asyncio.wait_for(
                        rc.post("/warn", json={"app_id": f"app-{i % 8}", "prompt": f"Cite sources for claim {i}."}),
                        timeout=15.0)
                    body = await r.json()
                    results.append((r.status, bool(body.get("partial"))))
                except asyncio.TimeoutError:
                    results.append(("hung", False))
                i += 1
                await asyncio.sleep(0.1)

        task = None
        try:
            for b in range(4):
                r = await rc.post("/ingest/batch",
                                  json={"traces": [_trace(f"app-{b * 2 + j % 2}", b * 8 + j) for j in range(6)]})
                assert r.status == 200, await r.text()
            idx = await loop.run_in_executor(None, sup.add_replica)
            await loop.run_in_executor(None, sup.wait_ready, 180.0)
            task = asyncio.create_task(storm())
            await asyncio.sleep(1.0)
            r = await rc.post("/fleet/rebalance", json={"add": {"id": sup.replica_id(idx), "url": sup.url(idx)}})
            body = await r.json()
            assert r.status == 200 and body["ok"] and body["epoch"] == 2, body
            assert body["rows_moved"] > 0
            ready2 = await loop.run_in_executor(None, _get, sup.url(idx) + "/readyz")
            assert ready2["ownership"]["epoch"] == 2 and ready2["gfkb_count"] > 0
            assert ready2["ownership"]["rows"]["foreign"] == 0
            await asyncio.sleep(1.0)
            await loop.run_in_executor(None, sup.stop, 0)  # SIGTERM an owner mid-storm
            router = router_app[ROUTER_KEY]
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                if router.ownership.epoch >= 3 and "r0" in router.ejected():
                    break
                await asyncio.sleep(0.2)
            await asyncio.sleep(1.0)
            stop.set()
            await task
            assert router.ownership.epoch >= 3 and "r0" in router.ejected()
            for i in (1, 2):
                own = await loop.run_in_executor(None, _get, sup.url(i) + "/fleet/ownership")
                assert own["epoch"] >= 3 and set(own["members"]) == {"r0", "r1", "r2"}, (i, own)
            rep = await (await rc.get("/readyz")).json()
            assert rep["ownership"]["coverage_holes"] == 0 and rep["fleet"]["brownout"] == "normal"
            statuses = [s for s, _ in results]
            assert len(statuses) > 20 and all(s == 200 for s in statuses), [s for s in statuses if s != 200][:5]
            assert not any(p for _, p in results)  # R = 2: one lost owner leaves no hole
        finally:
            stop.set()
            if task is not None and not task.done():
                task.cancel()
            await rc.close()

    try:
        sup.start_all()
        sup.wait_ready(timeout_s=180.0)
        run(go())
    finally:
        sup.stop_all()
