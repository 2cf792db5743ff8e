"""The port's replica fleet (``kakveda_tpu_torch/fleet/``) against the JAX
package's, on the CPU.

Twins of ``tests/test_fleet.py``, each script run through both packages:
the hash ring's assignment (bit for bit, 10,000 keys over several
memberships), the fleet view's freshness rules, gossip feeding the
brownout ladder (directly and through ``/fleet/gossip``), ingest
replicated to a peer over the bus and deduplicated, the
``fleet.replicate_apply`` fault's dead-letter-then-replay, the router's
affinity, retry, ejection and ``router.forward`` fault over stub
replicas, federation and trace assembly through the router, the
supervisor's lease marker and its refusal to start a card child without a
card, the CLI's fleet flags, and the kill-one-replica drill over port
replica processes (``--device cpu``, capacity 1024, dim 512, the
reference drill's sizes). Finally one ingest-and-warn script through a
two-replica fleet of each package (in-process apps behind in-process
routers): normalized bodies equal, scores within 1e-6.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
import uuid
from datetime import datetime, timezone
from pathlib import Path

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from kakveda_tpu.core import admission as jadm
from kakveda_tpu.core import faults as jfaults
from kakveda_tpu.fleet import gossip as jgossip
from kakveda_tpu.fleet.hashring import HashRing as JRing
from kakveda_tpu.fleet.router import ROUTER_KEY as JROUTER_KEY
from kakveda_tpu.fleet.router import make_router_app as jmake_router_app
from kakveda_tpu.parallel.mesh import create_mesh
from kakveda_tpu.platform import Platform as JPlatform
from kakveda_tpu.service.app import make_app as jmake_app
from kakveda_tpu_torch.core import admission as padm
from kakveda_tpu_torch.core import faults as pfaults
from kakveda_tpu_torch.core import metrics as pmetrics
from kakveda_tpu_torch.events.bus import TOPIC_GFKB_REPLICATE, replay_dlq_file
from kakveda_tpu_torch.fleet import gossip as pgossip
from kakveda_tpu_torch.fleet.hashring import HashRing as PRing
from kakveda_tpu_torch.fleet.router import ROUTER_KEY, make_router_app
from kakveda_tpu_torch.fleet.supervisor import FleetSupervisor, pick_port_base
from kakveda_tpu_torch.platform import Platform
from kakveda_tpu_torch.service.app import make_app

ROOT = Path(__file__).resolve().parent.parent
SCORE_TOL = 1e-6
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


def _trace(app_id, prompt):
    return {
        "trace_id": str(uuid.uuid4()),
        "ts": datetime.now(timezone.utc).isoformat(),
        "app_id": app_id,
        "agent_id": "agent-1",
        "prompt": prompt,
        "response": STUB_RESPONSE,
        "model": "stub",
        "tools": [],
        "env": {"os": "linux"},
    }


async def _started(app):
    c = TestClient(TestServer(app))
    await c.start_server()
    return c


def _base(client):
    return str(client.make_url("")).rstrip("/")


# ---------------------------------------------------------------------------
# hash ring, fleet view, gossip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("members", [
    ["r0", "r1"], ["r0", "r1", "r2", "r3"], ["r3", "r1", "r0"], [f"r{i}" for i in range(7)], ["solo"],
])
def test_hashring_assignment_equals_jax(members):
    keys = [f"app-{i}" for i in range(10_000)]
    p, j = PRing(members), JRing(members)
    assert p.nodes == j.nodes
    assert [p.assign(k) for k in keys] == [j.assign(k) for k in keys]
    assert [p.preference(k, limit=2) for k in keys[:2000]] == [j.preference(k, limit=2) for k in keys[:2000]]
    assert p.arc_preferences(limit=2) == j.arc_preferences(limit=2)
    ex = (members[0],)
    assert [p.assign(k, exclude=ex) for k in keys[:2000]] == [j.assign(k, exclude=ex) for k in keys[:2000]]


def _sample(replica="rX", seq=1, occ=0.0, **kw):
    s = {"replica": replica, "seq": seq, "ts": time.time(), "occupancy": occ,
         "brownout": "normal", "brownout_step": 0, "degraded": False}
    s.update(kw)
    return s


def test_fleet_view_freshness_discipline_equals_jax():
    out = {}
    for name, mod in (("jax", jgossip), ("port", pgossip)):
        view = mod.FleetView(ttl_s=1.0)
        trail = [view.fold(_sample(seq=2, occ=0.5)), view.fold(_sample(seq=2, occ=0.9)),
                 view.fold(_sample(seq=1, occ=0.9)), view.fleet_pressure(),
                 view.fold(_sample(replica="rY", seq=9, ts=time.time() - 60))]
        time.sleep(1.1)
        trail += [view.fleet_pressure(), view.peers(),
                  view.fold(_sample(replica="rZ", seq=1, occ=0.2, degraded=True, brownout="clamped",
                                    brownout_step=2, ownership_epoch=4)),
                  view.any_degraded(), view.worst_brownout(),
                  view.fold({"replica": mod.FleetView.ROUTER_SENDER, "seq": 1, "ts": time.time(),
                             "occupancy": 0.0, "probe_verdicts": {"rZ": False}}),
                  view.fleet_pressure(), view.probe_verdicts()]
        out[name] = trail
    assert out["port"] == out["jax"]
    assert out["port"][:6] == [True, False, False, 0.5, False, 0.0]


def test_sample_from_ready_and_publisher_sample_equal_jax():
    ready = {"admission": {"occupancy": 0.61234, "brownout": "no_spec", "brownout_step": 1},
             "device": {"degraded": True}, "ownership": {"epoch": 3}}
    old = {"admission": {"classes": {"warn": {"inflight": 3, "limit": 4}, "ingest": {"inflight": 0, "limit": 2}}}}
    for r in (ready, old, {}):
        a, b = pgossip.sample_from_ready("r1", 7, r), jgossip.sample_from_ready("r1", 7, r)
        assert a.pop("ts") == pytest.approx(b.pop("ts"), abs=5) and a == b
    samples = []
    for mod, adm_mod in ((pgossip, padm), (jgossip, jadm)):
        brown = adm_mod.BrownoutController(enabled=True, enter=0.85, exit=0.3, dwell_s=0.0)
        adm = adm_mod.AdmissionController(enabled=True, brownout=brown)
        pub = mod.GossipPublisher(None, adm, adm_mod.DeviceHealth(), "r0", mod.FleetView(ttl_s=5.0))
        s = pub.sample()
        s.pop("ts")
        samples.append(s)
    assert samples[0] == samples[1] == {"replica": "r0", "seq": 1, "occupancy": 0.0, "brownout": "normal",
                                        "brownout_step": 0, "degraded": False}


def test_fleet_pressure_drives_local_ladder():
    """The gossip input steps the local ladder and expires, so a dead peer
    cannot pin the fleet browned-out (the same steps in both packages)."""
    trails = []
    for mod in (padm, jadm):
        brown = mod.BrownoutController(enabled=True, enter=0.85, exit=0.3, dwell_s=0.0)
        adm = mod.AdmissionController(limits={"warn": 4, "ingest": 2, "interactive": 2, "background": 1},
                                      enabled=True, brownout=brown)
        adm.note_fleet_pressure(0.95, ttl_s=1.0)
        trail = [brown.step, adm.pressure(), adm.info()["fleet_pressure"]]
        time.sleep(1.1)
        trail.append(adm.pressure())
        adm.note_fleet_pressure(0.0, ttl_s=1.0)
        trail.append(brown.step)
        trails.append(trail)
    assert trails[0] == trails[1] == [1, 0.95, 0.95, 0.0, 0]


def test_gossip_endpoint_feeds_private_admission(tmp_path):
    """POST /fleet/gossip folds a peer sample and the ladder follows, end to
    end through each package's app with a private controller."""
    out = {}
    for name, amod in (("port", padm), ("jax", jadm)):
        brown = amod.BrownoutController(enabled=True, enter=0.85, exit=0.3, dwell_s=0.0)
        adm = amod.AdmissionController(enabled=True, brownout=brown)
        if name == "port":
            plat = Platform(data_dir=tmp_path / name, capacity=256, dim=1024, device="cpu")
            app = make_app(plat, admission=adm)
        else:
            plat = JPlatform(data_dir=tmp_path / name, mesh=create_mesh("data:1"), capacity=256, dim=1024)
            app = jmake_app(plat, admission=adm)

        async def go():
            c = await _started(app)
            try:
                r1 = await (await c.post("/fleet/gossip", json=_sample(seq=1, occ=0.97))).json()
                state = brown.state
                ready = await (await c.get("/readyz")).json()
                r2 = await (await c.post("/fleet/gossip", json=_sample(seq=1, occ=0.97))).json()
                view = ready["fleet"]["view"]["rX"]
                view.pop("age_s")
                view.pop("ts")
                return r1, state, ready["admission"]["fleet_pressure"], view, r2, sorted(ready["fleet"])
            finally:
                await c.close()

        out[name] = run(go())
        (plat.close if name == "port" else plat.gfkb.close)()
    assert out["port"] == out["jax"]
    assert out["port"][:3] == ({"ok": True, "fresh": True}, "no_spec", 0.97)


# ---------------------------------------------------------------------------
# replication over the bus
# ---------------------------------------------------------------------------


def _pair(kind, tmp_path):
    if kind == "port":
        a = Platform(data_dir=tmp_path / kind / "a", capacity=256, dim=1024, device="cpu")
        b = Platform(data_dir=tmp_path / kind / "b", capacity=256, dim=1024, device="cpu")
        return a, b, make_app, lambda p: p.close()
    a = JPlatform(data_dir=tmp_path / kind / "a", mesh=create_mesh("data:1"), capacity=256, dim=1024)
    b = JPlatform(data_dir=tmp_path / kind / "b", mesh=create_mesh("data:1"), capacity=256, dim=1024)
    return a, b, jmake_app, lambda p: p.gfkb.close()


def test_ingest_replicates_to_peer_and_dedups(tmp_path):
    traces = [_trace(f"app-{i % 3}", f"Cite sources for claim {i} even if unavailable.") for i in range(8)]
    rows = [{"failure_type": "TIMEOUT", "signature_text": f"dup timeout calling service {i}", "app_id": "app-1",
             "impact_severity": "medium", "context_signature": {}, "root_cause": None, "resolution": None}
            for i in range(3)]
    out = {}
    for kind in ("port", "jax"):
        pa, pb, mk, close = _pair(kind, tmp_path)

        async def go():
            ca, cb = await _started(mk(pa)), await _started(mk(pb))
            try:
                pa.bus.subscribe(TOPIC_GFKB_REPLICATE, str(cb.make_url("/replicate")))
                r = await ca.post("/ingest/batch", json={"traces": traces})
                res = [r.status, await r.json(), pa.gfkb.count, pb.gfkb.count]
                evt = {"id": "dup-evt", "rows": rows, "ts": time.time()}
                for _ in range(2):
                    r = await cb.post("/replicate", json=evt)
                    res.append(await r.json())
                r = await cb.post("/replicate", json={"rows": "nope"})
                res += [r.status, pb.gfkb.count, [x.signature_text for x in pb.gfkb.list_failures()]]
                return res
            finally:
                await ca.close()
                await cb.close()

        out[kind] = run(go())
        close(pa)
        close(pb)
    assert out["port"] == out["jax"]
    st, body, na, nb, first, second, bad, n_after, _ = out["port"]
    assert st == 200 and body["failures"] == na == nb == 8
    assert first == {"ok": True, "applied": 3, "deduped": False}
    assert second == {"ok": True, "applied": 0, "deduped": True}
    assert bad == 422 and n_after == 11


@pytest.mark.chaos
def test_replicate_apply_fault_dead_letters_then_replay(tmp_path, monkeypatch):
    """Armed fleet.replicate_apply: the peer's apply 500s, the origin's bus
    exhausts its retries and dead-letters the event; disarmed, a replay of
    the DLQ file converges the peer (both packages alike)."""
    monkeypatch.setenv("KAKVEDA_BUS_RETRIES", "2")
    monkeypatch.setenv("KAKVEDA_BUS_RETRY_BASE", "0.01")
    out = {}
    for kind, fmod in (("port", pfaults), ("jax", jfaults)):
        pa, pb, mk, close = _pair(kind, tmp_path)
        dlq = tmp_path / kind / "a" / "dlq.jsonl"

        async def go():
            ca, cb = await _started(mk(pa)), await _started(mk(pb))
            try:
                pa.bus.subscribe(TOPIC_GFKB_REPLICATE, str(cb.make_url("/replicate")))
                fmod.arm("fleet.replicate_apply:1.0:-1")
                traces = [_trace("app-x", f"Cite sources for claim {i} even if unavailable.") for i in range(4)]
                r = await ca.post("/ingest/batch", json={"traces": traces})
                res = [r.status, pa.gfkb.count, pb.gfkb.count, len(dlq.read_text().splitlines())]
            finally:
                await ca.close()
                fmod.disarm()
            rep = await asyncio.get_running_loop().run_in_executor(None, lambda: replay_dlq_file(dlq, timeout=5.0))
            res += [rep["replayed"], rep["failed"], pb.gfkb.count]
            await cb.close()
            return res

        out[kind] = run(go())
        close(pa)
        close(pb)
    assert out["port"] == out["jax"] == [200, 4, 0, 1, 1, 0, 4]


# ---------------------------------------------------------------------------
# the router over stub replicas
# ---------------------------------------------------------------------------


def _stub_backend(name, seen, *, fail_with=None):
    app = web.Application()

    async def warn(request):
        body = await request.json()
        if fail_with is not None:
            return web.json_response({"ok": False}, status=fail_with)
        seen.setdefault(name, []).append(body.get("app_id"))
        return web.json_response({"action": "silent", "confidence": 0.0, "references": [], "served_by": name})

    async def readyz(request):
        return web.json_response({"ok": True, "gfkb_count": 7, "admission": {"brownout": "normal", "brownout_step": 0},
                                  "device": {"degraded": False}})

    async def shed(request):
        return web.json_response({"ok": False, "error": "shed", "retry_after": 2.0}, status=429,
                                 headers={"Retry-After": "2"})

    app.add_routes([web.post("/warn", warn), web.get("/readyz", readyz), web.post("/ingest", shed)])
    return app


ROUTERS = {"port": (make_router_app, ROUTER_KEY), "jax": (jmake_router_app, JROUTER_KEY)}


def test_router_shards_by_app_key_with_affinity():
    out = {}
    for kind, (mk, _) in ROUTERS.items():
        seen: dict = {}

        async def go():
            b0 = await _started(_stub_backend("b0", seen))
            b1 = await _started(_stub_backend("b1", seen))
            rc = await _started(mk({"r0": _base(b0), "r1": _base(b1)}, probe_interval_s=30.0, eject_fails=3,
                                   retries=1))
            try:
                owners = {}
                for i in range(32):
                    r = await rc.post("/warn", json={"app_id": f"app-{i % 16}", "prompt": "x"})
                    owners.setdefault(f"app-{i % 16}", set()).add((await r.json())["served_by"])
                r = await rc.post("/ingest", json={"trace": {"app_id": "a"}})
                return owners, r.status, r.headers["Retry-After"]
            finally:
                await rc.close()
                await b0.close()
                await b1.close()

        out[kind] = run(go())
    assert out["port"] == out["jax"]
    owners, status, ra = out["port"]
    assert all(len(v) == 1 for v in owners.values()) and len(set().union(*owners.values())) == 2
    assert (status, ra) == (429, "2")


def test_router_retries_next_replica_and_ejects_dead():
    out = {}
    for kind, (mk, key) in ROUTERS.items():
        seen: dict = {}

        async def go():
            live = await _started(_stub_backend("live", seen))
            app = mk({"r0": "http://127.0.0.1:9", "r1": _base(live)}, probe_interval_s=30.0, eject_fails=2,
                     retries=1, timeout_s=3.0)
            rc = await _started(app)
            try:
                statuses = []
                for i in range(12):
                    r = await rc.post("/warn", json={"app_id": f"app-{i}", "prompt": "x"})
                    statuses.append((r.status, (await r.json())["served_by"]))
                rep = await (await rc.get("/readyz")).json()
                return (statuses, app[key].ejected(), rep["ok"], rep["replicas"]["r0"]["ejected"],
                        rep["replicas"]["r1"]["healthy"], rep["fleet"]["healthy"])
            finally:
                await rc.close()
                await live.close()

        out[kind] = run(go())
    assert out["port"] == out["jax"]
    assert out["port"] == ([(200, "live")] * 12, ["r0"], True, True, True, 1)


@pytest.mark.chaos
def test_router_forward_fault_reroutes():
    out = {}
    for kind, (mk, _) in ROUTERS.items():
        fmod = pfaults if kind == "port" else jfaults
        seen: dict = {}

        async def go():
            b0 = await _started(_stub_backend("b0", seen))
            b1 = await _started(_stub_backend("b1", seen))
            rc = await _started(mk({"r0": _base(b0), "r1": _base(b1)}, probe_interval_s=30.0, eject_fails=5,
                                   retries=1))
            try:
                fmod.arm("router.forward:1.0:1")
                r = await rc.post("/warn", json={"app_id": "app-z", "prompt": "x"})
                return r.status, (await r.json())["served_by"]
            finally:
                fmod.disarm()
                await rc.close()
                await b0.close()
                await b1.close()

        out[kind] = run(go())
    assert out["port"] == out["jax"]
    assert out["port"][0] == 200


def test_router_federates_metrics_and_assembles_traces(tmp_path):
    """Through the port's router over two port apps: ``/metrics/fleet`` holds
    both replicas' families (counters summed, gauges per replica) and
    ``/trace/{id}`` assembles the router's hop with the replica's
    ``service.request`` span."""
    plats = [Platform(data_dir=tmp_path / f"r{i}", capacity=256, dim=1024, device="cpu") for i in range(2)]

    async def go():
        reps = [await _started(make_app(p)) for p in plats]
        rc = await _started(make_router_app({f"r{i}": _base(c) for i, c in enumerate(reps)},
                                            probe_interval_s=30.0, retries=1))
        try:
            tid = uuid.uuid4().hex
            tp = f"00-{tid}-{uuid.uuid4().hex[:16]}-01"
            r = await rc.post("/warn", json={"app_id": "app-1", "prompt": "Cite sources.", "tools": [], "env": {}},
                              headers={"traceparent": tp})
            assert r.status == 200
            fed = await (await rc.get("/metrics/fleet")).text()
            tr = await (await rc.get(f"/trace/{tid}")).json()
            return fed, tr
        finally:
            await rc.close()
            for c in reps:
                await c.close()

    fed, tr = run(go())
    for p in plats:
        p.close()
    assert "# TYPE kakveda_warn_batch_seconds histogram" in fed
    # Gauges gain each source's replica label (the router's own render too).
    for rid in ("r0", "r1", "__router__"):
        assert f'replica="{rid}"' in fed, rid
    names = {s["name"] for s in tr["spans"]}
    assert {"router.request", "router.forward", "service.request", "gfkb.warn"} <= names
    assert tr["tree"] and set(tr["sources"]) == {"__router__", "r0", "r1"}


# ---------------------------------------------------------------------------
# the supervisor and the CLI
# ---------------------------------------------------------------------------


def test_cli_parser_fleet_flags():
    from kakveda_tpu.cli.main import build_parser as jparser
    from kakveda_tpu_torch.cli.main import build_parser

    argv = ["up", "--replicas", "4", "--port-base", "9000", "--dir", "/tmp/x"]
    args, jargs = build_parser().parse_args(argv), jparser().parse_args(argv)
    for k in ("replicas", "port_base", "dir", "replica_index", "host", "port", "detach", "autoscale",
              "dashboard_port"):
        assert getattr(args, k) == getattr(jargs, k), k
    assert args.replicas == 4 and args.port_base == 9000 and args.replica_index is None
    assert args.device is None and args.dashboard_port == 8110
    down = build_parser().parse_args(["down", "--dir", "/tmp/x"])
    assert down.timeout == jparser().parse_args(["down", "--dir", "/tmp/x"]).timeout


def test_supervisor_lease_marker_and_card_children_want_a_card(tmp_path, monkeypatch):
    sup = FleetSupervisor(tmp_path, port_base=pick_port_base(1), replicas=1, env={"KAKVEDA_INDEX_CAPACITY": "64"})
    assert sup.device == "cuda" and not sup.may_hold_device_lease(0)
    monkeypatch.setenv("KAKVEDA_FLEET_TPU_LEASE", "1")
    assert sup.may_hold_device_lease(0)
    monkeypatch.delenv("KAKVEDA_FLEET_TPU_LEASE")
    # No card here: the child asked for the card exits non-zero, and the
    # readiness wait says so with the child's log.
    try:
        sup.start_all()
        with pytest.raises(RuntimeError, match="exited during startup"):
            sup.wait_ready(timeout_s=120.0)
        assert sup.procs[0].wait(timeout=60) != 0
        assert "CUDA is not available" in sup.log_file(0).read_text()
        assert json.loads((tmp_path / "fleet.json").read_text())["replicas"][0]["id"] == "r0"
    finally:
        sup.stop_all()
    assert not (tmp_path / "fleet.json").exists()


def test_cli_up_replicas_and_down_sweep(tmp_path):
    """``cli up --replicas 2 --device cpu -d`` starts a fleet in the
    background; ``down`` stops the router and sweeps the replicas' pid
    files."""
    cfg = tmp_path / "config.yaml"
    cfg.write_text("failure_matching:\n  similarity_threshold: 0.8\n  embedding_dim: 512\n  top_k: 5\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
           "KAKVEDA_CONFIG_PATH": str(cfg), "KAKVEDA_INDEX_CAPACITY": "256", "KAKVEDA_GC_TUNE": "0"}
    base = pick_port_base(3)
    root = tmp_path / "fleet"
    cli = [sys.executable, "-m", "kakveda_tpu_torch.cli"]
    r = subprocess.run(cli + ["up", "-d", "--dir", str(root), "--port", str(base), "--replicas", "2",
                              "--device", "cpu"], env=env, capture_output=True, text=True, timeout=60)
    try:
        assert r.returncode == 0, r.stderr
        deadline = time.monotonic() + 180
        ready = None
        while time.monotonic() < deadline:
            try:
                ready = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{base}/readyz", timeout=2).read())
                break
            except OSError:
                time.sleep(0.5)
        assert ready is not None and ready["fleet"]["healthy"] == 2, (root / "server.log").read_text()[-2000:]
        assert sorted(p.name for p in root.glob("replica-*.pid")) == ["replica-0.pid", "replica-1.pid"]
        manifest = json.loads((root / "fleet.json").read_text())
        assert [x["url"] for x in manifest["replicas"]] == [f"http://127.0.0.1:{base + 1}",
                                                             f"http://127.0.0.1:{base + 2}"]
    finally:
        d = subprocess.run(cli + ["down", "--dir", str(root), "--timeout", "60"], env=env, capture_output=True,
                           text=True, timeout=180)
    assert d.returncode == 0, d.stdout + d.stderr
    assert not list(root.glob("*.pid")) and not (root / "fleet.json").exists()


# ---------------------------------------------------------------------------
# the kill-one-replica drill (port replica processes on the CPU)
# ---------------------------------------------------------------------------


def _get(url, timeout=5.0):
    return json.loads(urllib.request.urlopen(url, timeout=timeout).read())


def _post(url, obj, timeout=30.0):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(), headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


@pytest.mark.chaos
def test_kill_one_replica_drill(tmp_path):
    """SIGTERM one of two port replicas mid-load: zero lost warns (the
    router re-routes every request to the survivor), the dead replica's
    gap is healed by DLQ replay after its restart, and the fleet state
    converges again (router /readyz healthy, ladder normal)."""
    root = tmp_path / "fleet"
    root.mkdir()
    cfg = root / "config.yaml"
    cfg.write_text("failure_matching:\n  similarity_threshold: 0.8\n  embedding_dim: 512\n  top_k: 5\n")
    sup = FleetSupervisor(
        root, port_base=pick_port_base(2), replicas=2, device="cpu",
        env={"KAKVEDA_CONFIG_PATH": str(cfg), "KAKVEDA_INDEX_CAPACITY": "1024", "KAKVEDA_FLEET_GOSSIP_S": "0.2",
             "KAKVEDA_BUS_RETRIES": "2", "KAKVEDA_BUS_RETRY_BASE": "0.01", "KAKVEDA_GC_TUNE": "0"},
    )
    gap_prompt = "Cite sources for the postmortem gap report even if unavailable."

    async def go():
        router_app = make_router_app(sup.backend_map(), probe_interval_s=0.3, eject_fails=2, retries=1,
                                     timeout_s=10.0)
        rc = await _started(router_app)
        statuses: list = []
        stop = asyncio.Event()
        task = None
        loop = asyncio.get_running_loop()

        def reroutes():
            fam = pmetrics.get_registry().snapshot().get("kakveda_fleet_reroutes_total", {})
            return sum(v for v in fam.get("series", {}).values() if isinstance(v, (int, float)))

        async def storm():
            i = 0
            while not stop.is_set():
                r = await rc.post("/warn", json={"app_id": f"app-{i % 16}", "prompt": f"Cite sources for claim {i}."})
                await r.read()
                statuses.append(r.status)
                i += 1
                await asyncio.sleep(0.01)

        try:
            traces = [_trace(f"app-{i % 8}", f"Cite sources for claim {i} even if unavailable.") for i in range(16)]
            r = await rc.post("/ingest/batch", json={"traces": traces})
            assert r.status == 200, await r.text()
            counts = []
            for u in sup.urls():
                for _ in range(40):
                    n = (await loop.run_in_executor(None, _get, u + "/readyz"))["gfkb_count"]
                    if n > 0:
                        break
                    await asyncio.sleep(0.25)
                counts.append(n)
            assert counts[0] == counts[1] == 16, counts

            before = reroutes()
            task = asyncio.create_task(storm())
            await asyncio.sleep(1.0)
            await loop.run_in_executor(None, sup.stop, 1)  # SIGTERM replica 1 mid-load
            await asyncio.sleep(2.0)
            r = await rc.post("/ingest/batch", json={"traces": [_trace("app-gap", gap_prompt)]})
            assert r.status == 200
            dlq = sup.data_dir(0) / "dlq.jsonl"
            for _ in range(60):
                if dlq.exists() and dlq.read_text().strip():
                    break
                await asyncio.sleep(0.25)
            assert dlq.exists() and dlq.read_text().strip(), "no DLQ record"
            stop.set()
            await task
            assert statuses and all(s == 200 for s in statuses), [s for s in statuses if s != 200][:5]
            assert reroutes() > before

            sup.start(1)
            await loop.run_in_executor(None, sup.wait_ready, 240.0)
            n0 = (await loop.run_in_executor(None, _get, sup.url(0) + "/readyz"))["gfkb_count"]
            n1 = (await loop.run_in_executor(None, _get, sup.url(1) + "/readyz"))["gfkb_count"]
            assert n1 < n0, (n0, n1)  # the gap is real before the replay
            out = await loop.run_in_executor(None, lambda: replay_dlq_file(dlq, timeout=10.0))
            assert out["failed"] == 0 and out["replayed"] >= 1, out
            n1 = (await loop.run_in_executor(None, _get, sup.url(1) + "/readyz"))["gfkb_count"]
            assert n1 == n0, (n0, n1)
            body = await loop.run_in_executor(
                None, lambda: _post(sup.url(1) + "/warn", {"app_id": "probe", "prompt": gap_prompt}))
            assert body["references"], body
            router = router_app[ROUTER_KEY]
            await router.probe_once()
            rep = router.report()
            assert rep["fleet"]["healthy"] == 2 and rep["fleet"]["brownout"] == "normal", rep
        finally:
            stop.set()
            if task is not None and not task.done():
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
            await rc.close()

    try:
        sup.start_all()
        sup.wait_ready(timeout_s=300.0)
        run(go())
    finally:
        sup.stop_all()


# ---------------------------------------------------------------------------
# the whole slice: one script through a two-replica fleet of each package
# ---------------------------------------------------------------------------


def _normalize(obj):
    """Ids that each replica mints and wall-clock fields out; scores kept."""
    if isinstance(obj, dict):
        return {k: _normalize(v) for k, v in obj.items()
                if k not in ("failure_id", "pattern_id", "trace_id", "created_at", "updated_at", "ts", "shard")}
    if isinstance(obj, list):
        return [_normalize(v) for v in obj]
    return obj


def _close_scores(a, b, path="$"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close_scores(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close_scores(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, abs=SCORE_TOL), path
    else:
        assert a == b, path


def test_two_replica_fleet_answers_as_the_jax_fleet(tmp_path):
    """Ingest through the router (legacy replication to the peer), then
    warns, matches and reads: the port's fleet and the JAX fleet answer
    the same normalized bodies, and both replicas of each hold every row."""
    prompts = [f"Cite sources for claim {i} even if unavailable." for i in range(12)]
    script = (
        [("post", "/ingest/batch", {"traces": [_trace(f"app-{i % 4}", p) for i, p in enumerate(prompts[:8])]})]
        + [("post", "/ingest", {"trace": _trace("app-9", prompts[8])})]
        + [("post", "/warn", {"app_id": f"app-{i % 4}", "prompt": prompts[i], "tools": [], "env": {}})
           for i in (0, 3, 8, 11)]
        + [("post", "/failures/match", {"signature_text": "intent:citations_required | cite sources for claim 2"})]
        + [("get", "/failures", None), ("get", "/health/app-1", None)]
    )
    out = {}
    for kind in ("port", "jax"):
        if kind == "port":
            plats = [Platform(data_dir=tmp_path / kind / f"r{i}", capacity=256, dim=1024, device="cpu")
                     for i in range(2)]
            mk_app, mk_router = make_app, make_router_app
        else:
            plats = [JPlatform(data_dir=tmp_path / kind / f"r{i}", mesh=create_mesh("data:1"), capacity=256,
                               dim=1024) for i in range(2)]
            mk_app, mk_router = jmake_app, jmake_router_app

        async def go():
            reps = [await _started(mk_app(p)) for p in plats]
            for i, p in enumerate(plats):  # legacy full replication: each peer's /replicate
                p.bus.subscribe(TOPIC_GFKB_REPLICATE, _base(reps[1 - i]) + "/replicate")
            rc = await _started(mk_router({f"r{i}": _base(c) for i, c in enumerate(reps)}, probe_interval_s=30.0,
                                          retries=1))
            try:
                bodies = []
                for method, path, body in script:
                    r = await (rc.post(path, json=body) if method == "post" else rc.get(path))
                    bodies.append((r.status, _normalize(await r.json())))
                return bodies, [p.gfkb.count for p in plats]
            finally:
                await rc.close()
                for c in reps:
                    await c.close()

        out[kind] = run(go())
        for p in plats:
            (p.close if kind == "port" else p.gfkb.close)()
    (pb, pc), (jb, jc) = out["port"], out["jax"]
    assert pc == jc and pc[0] == pc[1] == 9
    _close_scores(pb, jb)
    warns = [b for (_, b), (_, path, _) in zip(pb, script) if path == "/warn"]
    assert all(w["references"] for w in warns) and warns[0]["confidence"] > 0.99
