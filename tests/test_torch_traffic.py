"""The port's traffic harness (``kakveda_tpu_torch/traffic/``) and the
service's capture ring against the JAX package's, on the CPU.

Twins of ``tests/test_traffic.py``, each run through both packages:

* every generator in ``SCENARIOS`` at two seeds: events, chaos timeline,
  notes and SLO equal, key for key; ``synth_traces`` and the unknown-name
  error;
* ``evaluate`` over one ``ReplayResult`` (records of every bucket, phase
  and tenant, partial and flap notes, a ladder recovery) against every
  scenario's SLO and one that declares every gate: reports equal;
  ``percentile`` and the result's own accounting;
* traffic logs: a log written by either package read by the other (a
  malformed line skipped alike); ``from_flightrecorder``;
* ``replay`` and ``run_chaos`` over deterministic fakes: buckets, skips,
  the ``traffic.dispatch`` site, the chaos log, ``run_scenario``'s
  ``scale_events`` notes;
* the capture ring's ``/flightrecorder`` dump from both apps after the same
  requests (times masked), and ``KAKVEDA_TRAFFIC_CAPTURE=0``.

Then, on the port alone at the reference tests' sizes with ``--device cpu``:
the capture round trip over HTTP, ``cli traffic record`` / ``replay``
against a service process, and the storm drill as ``cli traffic storm``
runs it, in a fresh interpreter (the reference's twin is green only when
scipy was imported first in its worker; a fresh process has nothing
imported first).
"""

import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer

import kakveda_tpu.traffic as JT
from kakveda_tpu.core import admission as jadm
from kakveda_tpu.core import faults as jfaults
import kakveda_tpu_torch.traffic as PT
from kakveda_tpu_torch.core import admission as padm
from kakveda_tpu_torch.core import faults as pfaults
from kakveda_tpu_torch.traffic.scenarios import synth_traces as p_synth

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"jax": (JT, jadm, jfaults), "port": (PT, padm, pfaults)}


@pytest.fixture(autouse=True)
def _clean_globals():
    for _, adm, faults in PKGS.values():
        faults.disarm()
        adm.reset_for_tests()
    yield
    for _, adm, faults in PKGS.values():
        faults.disarm()
        adm.reset_for_tests()


def run(coro):
    return asyncio.run(coro)


# ---------------------------------------------------------------------------
# scenarios: the same seed gives the same events as the JAX package's
# ---------------------------------------------------------------------------


def _scenario_dict(sc) -> dict:
    return dict(name=sc.name, seed=sc.seed, duration_s=sc.duration_s, events=sc.events, chaos=sc.chaos,
                slo=dataclasses.asdict(sc.slo), notes=sc.notes, keys=sc.app_key_sequence(),
                schedule=sc.arrival_schedule())


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(JT.SCENARIOS))
def test_every_scenario_equals_jax(name, seed):
    got = _scenario_dict(PT.make_scenario(name, seed=seed))
    assert got == _scenario_dict(JT.make_scenario(name, seed=seed))
    assert got["events"], name
    assert json.dumps(got, sort_keys=True) == json.dumps(_scenario_dict(PT.make_scenario(name, seed=seed)),
                                                         sort_keys=True)


def test_scenario_knobs_and_names_equal_jax():
    assert sorted(PT.SCENARIOS) == sorted(JT.SCENARIOS)
    kw = [("storm", dict(duration_s=8.0, gossip_ttl_s=3.0, kill_replica=1)),
          ("flash_crowd", dict(baseline_s=4.0, surge_s=18.0, decay_s=12.0, warn_rps=4.0, surge_x=3.0, bg_rps=12.0,
                               apps=8, crash_replica=1, gossip_ttl_s=3.0, max_scale_flaps=1)),
          ("rebalance_storm", dict(kill_replica=0)), ("failure_storm", dict(device_loss=False)),
          ("noisy_neighbor", dict(victims=5, flood_rps=80.0))]
    for name, k in kw:
        assert _scenario_dict(PT.make_scenario(name, seed=11, **k)) == \
            _scenario_dict(JT.make_scenario(name, seed=11, **k))
    with pytest.raises(ValueError) as pe:
        PT.make_scenario("nope")
    with pytest.raises(ValueError) as je:
        JT.make_scenario("nope")
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("near_dup", [False, True])
def test_synth_traces_equal_jax(near_dup):
    from kakveda_tpu.traffic.scenarios import synth_traces as j_synth

    assert p_synth(3, "app-9", 12, near_dup=near_dup) == j_synth(3, "app-9", 12, near_dup=near_dup)


# ---------------------------------------------------------------------------
# SLO evaluation on one ReplayResult
# ---------------------------------------------------------------------------


def _records():
    """Records of every bucket, phase and tenant (deterministic)."""
    recs = []
    phases = ("baseline", "storm", "recovery", "flood", "capture")
    statuses = ("ok", "ok", "ok", "shed", "degraded", "error", "hung", "skipped")
    apps = ("app-v0", "app-v1", "app-flood", "")
    for i in range(240):
        klass = ("warn", "warn", "warn", "background", "ingest", "interactive")[i % 6]
        st = statuses[(i * 5) % len(statuses)]
        recs.append({"klass": klass, "phase": phases[(i // 3) % len(phases)], "app": apps[(i * 7) % len(apps)],
                     "t": round(i * 0.05, 3), "status": st, "latency_ms": round(3.0 + (i * 37 % 101) * 0.5, 3),
                     "late_ms": round((i * 13 % 17) * 0.25, 3),
                     **({"trace": f"{i:032x}"} if i % 4 else {})})
    return recs


def _result(T, notes=None, recovery=None, drop=0):
    res = T.ReplayResult(ladder_recovery_s=recovery)
    res.records = [dict(r) for r in _records()]
    for r in res.records:
        res.generated_counts[r["klass"]] = res.generated_counts.get(r["klass"], 0) + 1
    res.generated_counts["warn"] += drop  # generated but never accounted: lost
    res.skipped = {"interactive": sum(1 for r in res.records if r["status"] == "skipped")}
    res.ttfts_ms = [12.5, 40.0, 7.25]
    res.notes = dict(notes or {})
    res.wall_s = 12.3456
    return res


ALL_GATES = dict(name="all", warn_p50_ms=20.0, warn_p95_ms=30.0, warn_p95_x_baseline=1.2, ttft_p95_ms=20.0,
                 max_shed_rate={"warn": 0.0, "background": 0.5}, shed_only=("background",), zero_hung=True,
                 zero_lost=("warn", "ingest"), recovery_s=1.0, max_partial_rate=0.05, max_scale_flaps=0,
                 flood_app="app-flood", max_victim_shed_rate=0.05, victim_p95_x_baseline=1.1,
                 max_tenant_starvation_s=0.5, min_flood_shed_share=0.9)


@pytest.mark.parametrize("slo", sorted(JT.SCENARIOS) + ["all", "all_vacuous"])
def test_evaluate_equals_jax(slo):
    reports = []
    for T, _, _ in PKGS.values():
        if slo == "all":
            s, notes, rec = T.SLO(**ALL_GATES), {"partial": 7.0, "scale_flaps": 2.0}, 2.5
        elif slo == "all_vacuous":
            s, notes, rec = T.SLO(**{**ALL_GATES, "flood_app": ""}), {}, None
        else:
            s, notes, rec = T.make_scenario(slo, seed=1).slo, {"partial": 1.0, "scale_flaps": 1.0}, 0.75
        rep = T.evaluate(s, _result(T, notes, rec, drop=2))
        reports.append((rep.to_dict(), rep.summary(), [g.gate for g in rep.failures()]))
    assert reports[0] == reports[1]
    if slo == "all":
        assert not reports[1][0]["ok"] and any(g["exemplars"] for g in reports[1][0]["gates"] if not g["ok"])


def test_replay_result_accounting_equals_jax():
    out = []
    for T, _, _ in PKGS.values():
        res = _result(T, {"partial": 3.0}, 1.5)
        out.append((res.to_dict(), res.class_counts(), res.tenant_counts(), res.tenant_counts("warn"),
                    res.tenant_latencies_ms("app-v0"), res.tenant_latencies_ms("app-v1", phase="flood"),
                    res.latencies_ms("warn", "baseline"), res.generated("interactive"), res.ttft_ms(),
                    [T.slo.percentile([r["latency_ms"] for r in res.records], q) for q in (0, 50, 95, 99, 100)],
                    T.slo.percentile([], 95)))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# traffic logs and the capture conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_log_written_by_one_package_read_by_the_other(writer, reader, tmp_path):
    W, R = PKGS[writer][0], PKGS[reader][0]
    events = W.make_scenario("failure_storm", seed=4).events
    p = tmp_path / "log.jsonl"
    n = W.write_log(p, list(reversed(events)), meta={"source": "test", "seed": 4})
    assert n == len(events)
    with p.open("a") as f:
        f.write("{torn\n")
        f.write("[1, 2]\n")
        f.write('{"method": "POST"}\n')
    meta, got = R.read_log(p)
    assert got == events and meta == {"source": "test", "seed": 4, "version": 1}
    assert R.read_log(p) == W.read_log(p)
    assert p.read_text().splitlines()[0] == json.dumps({"kakveda_traffic_log": 1,
                                                        "meta": {"source": "test", "seed": 4}})


def test_from_flightrecorder_equals_jax():
    payload = {"recorders": [
        {"name": "serving/x", "events": [{"t": 1.0, "kind": "warn", "app_id": "z", "prompt": "p"}]},
        {"name": "traffic", "events": []},  # a torn-down app's empty ring
        {"name": "traffic", "events": [
            {"t": 100.0, "kind": "warn", "app_id": "a", "prompt": "Cite it."},
            {"t": 100.4, "kind": "ingest", "app_id": "b", "n": 3},
            {"t": 100.2, "kind": "other"},
            {"t": 101.0, "kind": "warn", "app_id": "a", "prompt": "Again."},
        ]},
    ]}
    for seed in (0, 3):
        got = PT.from_flightrecorder(payload, seed=seed)
        assert got == JT.from_flightrecorder(payload, seed=seed)
        assert [e["t"] for e in got] == [0.0, 0.4, 1.0] and len(got[1]["body"]["traces"]) == 3
    assert PT.from_flightrecorder({"recorders": []}) == JT.from_flightrecorder({"recorders": []}) == []
    assert PT.from_flightrecorder(payload, recorder="serving/x") == \
        JT.from_flightrecorder(payload, recorder="serving/x")


# ---------------------------------------------------------------------------
# replay and the chaos timeline over deterministic fakes
# ---------------------------------------------------------------------------


def _ev(t, path, klass, method="POST", phase="baseline", app="app-0"):
    return {"t": t, "method": method, "path": path, "klass": klass, "app_id": app, "phase": phase, "body": {}}


def _masked(res) -> dict:
    recs = sorted(({k: v for k, v in r.items() if k not in ("latency_ms", "late_ms", "trace")}
                   for r in res.records), key=lambda r: (r["t"], r["klass"], r["app"], r["status"]))
    return dict(records=recs, generated=res.generated_counts, skipped=res.skipped, ttft=res.ttft_ms(),
                counts=res.class_counts(), notes=res.notes)


def _replay_run(pkg, armed: bool):
    T, _, faults = PKGS[pkg]
    statuses = {"/ok": 200, "/shed": 429, "/deg": 503, "/boom": 500}

    async def post(path, body):
        if path == "/slow":
            await asyncio.sleep(0.5)
            return 200
        if path == "/raise":
            raise ConnectionError("refused")
        return statuses[path]

    async def gen(event):
        return 0.01

    events = [_ev(0.0, "/ok", "warn"), _ev(0.0, "/shed", "warn", app="app-1"), _ev(0.0, "/deg", "warn"),
              _ev(0.0, "/boom", "background"), _ev(0.0, "/generate", "interactive", method="LOCAL"),
              _ev(0.0, "/nope", "interactive", method="LOCAL"), _ev(0.01, "/slow", "warn", phase="storm"),
              _ev(0.02, "/raise", "ingest")]
    if armed:
        faults.arm("traffic.dispatch:1:2")
    try:
        res = run(T.replay(events, post=post, speed=100.0, timeout_s=0.2, extra_dispatch={"/generate": gen}))
    finally:
        faults.disarm()
    rep = T.evaluate(T.SLO(), res).to_dict()
    for g in rep["gates"]:  # exemplars are the dispatches' random trace ids: their count
        if "exemplars" in g:
            g["exemplars"] = len(g["exemplars"])
    return _masked(res), rep


@pytest.mark.parametrize("armed", [False, True])
def test_replay_buckets_equal_jax(armed):
    got = _replay_run("port", armed)
    assert got == _replay_run("jax", armed)
    counts = got[0]["counts"]
    if not armed:
        assert counts["warn"] == {"ok": 1, "shed": 1, "degraded": 1, "hung": 1}
        assert counts["interactive"] == {"ok": 1, "skipped": 1} and counts["ingest"] == {"error": 1}


class _FakeSupervisor:
    def __init__(self, lease=False):
        self.calls, self.lease = [], lease

    def stop(self, i, timeout_s=20.0, sig=None):
        self.calls.append(("stop", i, None if sig is None else int(sig)))

    def start(self, i):
        self.calls.append(("start", i))

    def may_hold_device_lease(self, i):
        return self.lease


class _FakeScaler:
    def decision_counts(self):
        return {"scale_up:ok": 1}

    def flap_count(self):
        return 0

    def info(self):
        return {"state": "cooldown"}


def _chaos_run(pkg, lease):
    T, adm_mod, faults = PKGS[pkg]
    adm = adm_mod.AdmissionController(enabled=True, brownout=adm_mod.BrownoutController(enabled=False))
    sup = _FakeSupervisor(lease)
    seen, called = {}, []

    async def go():
        timeline = [
            {"t": 0.0, "action": "faults", "spec": "device.unavailable:1.0:-1"},
            {"t": 0.01, "action": "fleet_pressure", "pressure": 0.9, "ttl_s": 5.0},
            {"t": 0.02, "action": "kill_replica", "replica": 1},
            {"t": 0.03, "action": "restart_replica", "replica": 1},
            {"t": 0.04, "action": "crash_replica", "replica": 0},
            {"t": 0.05, "action": "scale_events"},
            {"t": 0.06, "action": "rebalance"},
            {"t": 0.07, "action": "bogus"},
            {"t": 0.3, "action": "faults", "spec": ""},
        ]

        async def probe():
            await asyncio.sleep(0.15)
            seen["armed_mid_window"] = faults.site("device.unavailable").armed

        applied, _ = await asyncio.gather(
            T.run_chaos(timeline, admission=adm, supervisor=sup, autoscaler=_FakeScaler(),
                        callbacks={"rebalance": lambda act: called.append(act["action"])}),
            probe())
        return applied

    applied = run(go())
    return applied, sup.calls, called, seen, round(adm.fleet_pressure(), 6), faults.site("device.unavailable").armed


@pytest.mark.parametrize("lease", [False, True])
def test_run_chaos_equals_jax(lease):
    got = _chaos_run("port", lease)
    assert got == _chaos_run("jax", lease)
    applied, calls, called, seen, pressure, armed_after = got
    assert seen["armed_mid_window"] and not armed_after and pressure == 0.9 and called == ["rebalance"]
    by = {a["action"]: a for a in applied}
    assert by["crash_replica"]["applied"] is (not lease) and not by["bogus"]["applied"]
    assert by["scale_events"]["scale"] == {"counts": {"scale_up:ok": 1}, "flaps": 0, "state": "cooldown"}


def _scenario_run(pkg):
    T, adm_mod, _ = PKGS[pkg]
    adm = adm_mod.AdmissionController(enabled=True, brownout=adm_mod.BrownoutController(enabled=False))
    sc = T.make_scenario("flash_crowd", seed=2, baseline_s=0.05, surge_s=0.1, decay_s=0.05, warn_rps=40.0,
                         bg_rps=20.0)

    async def post(path, body):
        return 429 if path == "/patterns/mine" else 200

    res = run(T.run_scenario(sc, post=post, speed=1.0, timeout_s=5.0, admission=adm, autoscaler=_FakeScaler(),
                             recovery_horizon_s=1.0))
    return _masked(res), res.ladder_recovery_s is not None, T.evaluate(sc.slo, res).to_dict()


def test_run_scenario_notes_and_recovery_equal_jax():
    got = _scenario_run("port")
    assert got == _scenario_run("jax")
    assert got[0]["notes"] == {"scale_flaps": 0.0, "scale_decisions": 1.0} and got[1]


# ---------------------------------------------------------------------------
# the service's capture ring
# ---------------------------------------------------------------------------


def _traffic_ring(payload) -> list:
    rings = [r for r in payload["recorders"] if r["name"] == "traffic" and r["events"]]
    assert len(rings) == 1, [r["name"] for r in payload["recorders"]]
    return [{k: v for k, v in e.items() if k != "t"} for e in rings[0]["events"]]


def _capture_run(pkg, tmp_path, seed_traces):
    if pkg == "jax":
        from kakveda_tpu.parallel.mesh import create_mesh
        from kakveda_tpu.platform import Platform as P
        from kakveda_tpu.service.app import make_app

        plat = P(data_dir=tmp_path / pkg, capacity=1 << 10, dim=256, mesh=create_mesh("data:1"))
    else:
        from kakveda_tpu_torch.platform import Platform as P
        from kakveda_tpu_torch.service.app import make_app

        plat = P(data_dir=tmp_path / pkg, capacity=1 << 10, dim=256, device="cpu")
    adm_mod = PKGS[pkg][1]
    adm = adm_mod.AdmissionController(enabled=True, brownout=adm_mod.BrownoutController(enabled=False))

    async def go():
        client = TestClient(TestServer(make_app(platform=plat, admission=adm)))
        await client.start_server()
        try:
            for i in range(3):
                r = await client.post("/warn", json={"app_id": f"app-{i % 2}", "prompt": f"Cite sources {i}."})
                assert r.status == 200
            r = await client.post("/ingest/batch", json={"traces": seed_traces})
            assert r.status == 200
            r = await client.post("/ingest/batch", json={"traces": []})
            assert r.status == 200
            r = await client.post("/ingest", json={"trace": seed_traces[0]})
            assert r.status == 200
            r = await client.post("/warn", json={"app_id": "app-9"})  # invalid: 422, not captured
            assert r.status == 422
            return await (await client.get("/flightrecorder")).json()
        finally:
            await client.close()

    try:
        payload = run(go())
    finally:
        if pkg == "port":
            plat.close()
    return _traffic_ring(payload), PKGS[pkg][0].from_flightrecorder(payload, seed=3)


def test_capture_ring_dump_equals_jax(tmp_path):
    traces = p_synth(0, "app-9", 2)
    got = _capture_run("port", tmp_path, traces)
    want = _capture_run("jax", tmp_path, traces)
    assert got[0] == want[0]
    assert [e["kind"] for e in got[0]] == ["warn"] * 3 + ["ingest", "ingest"]
    assert [{k: v for k, v in e.items() if k != "t"} for e in got[1]] == \
        [{k: v for k, v in e.items() if k != "t"} for e in want[1]]


def test_capture_off_records_nothing(tmp_path, monkeypatch):
    from kakveda_tpu_torch.core.metrics import dump_recorders
    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service.app import make_app

    monkeypatch.setenv("KAKVEDA_TRAFFIC_CAPTURE", "0")
    plat = Platform(data_dir=tmp_path, capacity=256, dim=256, device="cpu")
    app = make_app(platform=plat)

    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            assert (await client.post("/warn", json={"app_id": "a", "prompt": "Cite it."})).status == 200
        finally:
            await client.close()

    try:
        run(go())
    finally:
        plat.close()
    # Rings of other apps in this worker may hold events; none can be this
    # app's, whose capacity is 0.
    assert all(e.get("prompt") != "Cite it." for r in dump_recorders() if r["name"] == "traffic"
               for e in r["events"])


# ---------------------------------------------------------------------------
# the port alone at the reference tests' sizes, --device cpu
# ---------------------------------------------------------------------------


def test_capture_roundtrip_over_http(tmp_path):
    """Warn and ingest arrivals land in the ring → ``/flightrecorder``
    converts to a log → the log replays against the same service with
    nothing lost."""
    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service.app import make_app

    adm = padm.AdmissionController(enabled=True, brownout=padm.BrownoutController(enabled=False))
    plat = Platform(data_dir=tmp_path / "data", capacity=1 << 10, dim=256, device="cpu")
    app = make_app(platform=plat, admission=adm)

    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            for i in range(3):
                r = await client.post("/warn", json={"app_id": f"app-{i % 2}", "prompt": f"Cite sources {i}."})
                assert r.status == 200
            r = await client.post("/ingest/batch", json={"traces": p_synth(0, "app-9", 2)})
            assert r.status == 200
            payload = await (await client.get("/flightrecorder")).json()
            ev1 = PT.from_flightrecorder(payload, seed=3)
            assert PT.from_flightrecorder(payload, seed=3) == ev1
            assert [e["klass"] for e in ev1] == ["warn"] * 3 + ["ingest"] and ev1[0]["t"] == 0.0
            p = tmp_path / "cap.jsonl"
            PT.write_log(p, ev1, meta={"source": "test"})
            _, events = PT.read_log(p)
            assert [e["t"] for e in events] == [e["t"] for e in ev1]

            async def post(path, body):
                resp = await client.post(path, json=body)
                await resp.read()
                return resp.status

            res = await PT.replay(events, post=post, speed=100.0, timeout_s=30.0)
            assert res.class_counts() == {"warn": {"ok": 3}, "ingest": {"ok": 1}}
        finally:
            await client.close()

    try:
        run(go())
    finally:
        plat.close()


def test_cli_traffic_record_and_replay_against_a_service(tmp_path):
    """``cli traffic record`` against ``python -m kakveda_tpu_torch.service
    --device cpu`` writes the ring as a log equal to ``from_flightrecorder``
    of the same dump; ``cli traffic replay --log`` drives it back with
    nothing lost or hung and exits 0."""
    from chip_smoke import _fleet_ports  # outside the ephemeral range, which keep-alive connections race for

    port = _fleet_ports(1)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "KAKVEDA_INDEX_CAPACITY": "1024"}
    out = open(tmp_path / "service.log", "wb")
    proc = subprocess.Popen([sys.executable, "-m", "kakveda_tpu_torch.service", "--device", "cpu", "--port",
                             str(port), "--data-dir", str(tmp_path / "data")], cwd=ROOT, env=env, stdout=out,
                            stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"

    def req(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        r = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, json.loads(resp.read())

    try:
        deadline = time.monotonic() + 60.0
        while True:
            try:
                if req("/healthz")[0] == 200:
                    break
            except OSError:
                if time.monotonic() > deadline or proc.poll() is not None:
                    raise AssertionError((tmp_path / "service.log").read_text()[-2000:])
                time.sleep(0.25)
        for i in range(16):
            assert req("/warn", {"app_id": f"app-{i % 4}", "prompt": f"Summarize report {i}."})[0] == 200
        for j in range(2):
            assert req("/ingest/batch", {"traces": p_synth(j, f"app-{j}", 4)})[0] == 200
        cli = [sys.executable, "-m", "kakveda_tpu_torch.cli", "traffic"]
        log = tmp_path / "cap.jsonl"
        r = subprocess.run(cli + ["record", "--url", base, "--out", str(log), "--seed", "2"], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=60)
        assert r.returncode == 0 and json.loads(r.stdout) == {"out": str(log), "events": 18}, r.stderr
        _, dump = req("/flightrecorder")
        assert PT.read_log(log)[1] == PT.from_flightrecorder(dump, seed=2)
        r = subprocess.run(cli + ["replay", "--url", base, "--log", str(log), "--speed", "1"], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=60)
        assert r.returncode == 0, r.stderr[-2000:]
        rep = json.loads(r.stdout)
        assert rep["replay"]["class_counts"] == {"warn": {"ok": 16}, "ingest": {"ok": 2}}
        assert rep["slo"]["ok"]
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        out.close()


@pytest.mark.chaos
def test_storm_smoke_slo_gated(tmp_path):
    """The storm drill as ``cli traffic storm --device cpu`` runs it, at the
    reference test's numbers (seed 5, 8 s at speed 1.5, gossip TTL 3 s),
    in a fresh interpreter: every SLO gate passes, no warn shed or hung,
    the ladder back at ``normal`` within the TTL."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, "-m", "kakveda_tpu_torch.cli", "traffic", "storm", "--device", "cpu",
                        "--seed", "5", "--duration", "8", "--speed", "1.5", "--gossip-ttl", "3", "--timeout", "15"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = json.loads(r.stdout)
    assert out["slo"]["ok"] and {g["gate"] for g in out["slo"]["gates"]} == {
        "warn_p95_x_baseline", "shed_only", "zero_hung", "zero_lost[warn]", "recovery_s"}
    rep = out["replay"]
    assert rep["generated"]["warn"] > 50
    assert not rep["class_counts"]["warn"].get("shed") and not rep["class_counts"]["warn"].get("hung")
    assert rep["ladder_recovery_s"] is not None and rep["ladder_recovery_s"] <= 3.0
