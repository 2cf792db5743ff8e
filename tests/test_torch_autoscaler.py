"""The port's elastic autoscaler (``kakveda_tpu_torch/fleet/autoscaler.py``)
against the JAX package's, on the CPU.

Twins of ``tests/test_autoscaler.py``, each run through both packages:

* the pure policy: ``decide`` / ``commit`` over the reference's cases
  (dwell, a dip, cooldown, the max / min clamps, the least-loaded victim,
  replacement before pressure, the backoff budget, fault and ok outcomes):
  every ``ScaleDecision.to_dict`` and the ``PolicyState`` after each step
  equal; ``policy_selftest`` and ``ScaleKnobs.from_env`` equal;
* the executor over fake router / supervisor seams: the
  ``fleet.scale_spawn`` / ``fleet.scale_drain`` sites, a drain's
  ``MigrationError``, the replacement, flap accounting: the decisions, the
  seams' calls in order, the ``scale_log.jsonl`` lines (``ts`` masked),
  ``info()`` and the five ``kakveda_fleet_scale_*`` families (counters
  by their deltas, gauges by their values) equal;
* then process-level drills with ``--device cpu`` replica processes at the
  reference tests' sizes (capacity 1024, dim 512): the two fault sites and
  a scale-down over a real fleet, a SIGKILLed replica replaced at its index
  with its rows healed, ``cli up --autoscale`` and the flash crowd.
"""

import asyncio
import dataclasses
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
from aiohttp.test_utils import TestClient, TestServer

from kakveda_tpu.core import faults as jfaults
from kakveda_tpu.core import metrics as jmetrics
from kakveda_tpu.fleet import autoscaler as jauto
from kakveda_tpu.fleet import ownership as jown
from kakveda_tpu_torch.core import admission as padm
from kakveda_tpu_torch.core import faults as pfaults
from kakveda_tpu_torch.core import metrics as pmetrics
from kakveda_tpu_torch.fleet import autoscaler as pauto
from kakveda_tpu_torch.fleet import ownership as pown
from kakveda_tpu_torch.fleet.router import ROUTER_KEY, make_router_app
from kakveda_tpu_torch.fleet.supervisor import FleetSupervisor
from chip_smoke import _fleet_ports  # ports outside the ephemeral range, which keep-alive connections race for

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"jax": (jauto, jown, jfaults, jmetrics), "port": (pauto, pown, pfaults, pmetrics)}
FAMILIES = ("kakveda_fleet_scale_state", "kakveda_fleet_scale_transitions_total",
            "kakveda_fleet_scale_decisions_total", "kakveda_fleet_scale_replicas",
            "kakveda_fleet_scale_flaps_total")
STUB_RESPONSE = (
    "Here is a summary with references.\n\n"
    "References:\n"
    "[1] Smith et al. (2020) A Study on Things.\n"
    "[2] Doe (2021) Another Paper.\n"
)


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def _clean_globals():
    jfaults.disarm()
    pfaults.disarm()
    padm.reset_for_tests()
    yield
    jfaults.disarm()
    pfaults.disarm()
    padm.reset_for_tests()


def snap(occs, dead=None):
    """Policy snapshot from {rid: occupancy} (+ {rid: dead_for_s})."""
    dead = dead or {}
    reps = {r: {"live": r not in dead, "occupancy": o, "dead_for_s": dead.get(r, 0.0)} for r, o in occs.items()}
    live = [o for r, o in occs.items() if r not in dead]
    return {"replicas": reps, "pressure": max(live, default=0.0)}


def _knobs(A):
    return A.ScaleKnobs(up_occ=0.8, down_occ=0.3, dwell_s=5.0, cooldown_s=15.0, min_replicas=1, max_replicas=4,
                        replace_s=10.0, replace_backoff_s=5.0, replace_max=3)


# ---------------------------------------------------------------------------
# the pure policy
# ---------------------------------------------------------------------------

HOT = snap({"r0": 0.9, "r1": 0.85})
HOT2 = snap({"r0": 0.9, "r1": 0.9})
HOT4 = snap({"r0": 0.9, "r1": 0.9, "r2": 0.9, "r3": 0.9})
DEAD1 = snap({"r0": 0.5, "r1": 0.5}, dead={"r1": 60.0})


def _backoff_steps():
    steps = []
    for a in range(3):  # replace_max = 3
        steps += [("decide", DEAD1, 1000.0 * a), ("commit", "error", 1000.0 * a),
                  ("decide", DEAD1, 1000.0 * a + 5.0 * 2 ** a - 0.1)]
    return steps + [("decide", DEAD1, 1e6)]


# name -> (steps, initial PolicyState fields); the cases of tests/test_autoscaler.py:58-170.
POLICY_CASES = {
    "dwell": ([("decide", HOT, 0.0), ("decide", HOT, 4.9), ("decide", HOT, 5.0)], {}),
    "dip": ([("decide", snap({"r0": 0.9}), 0.0), ("decide", snap({"r0": 0.5}), 4.0),
             ("decide", snap({"r0": 0.9}), 4.5), ("decide", snap({"r0": 0.9}), 9.0),
             ("decide", snap({"r0": 0.9}), 9.5)], {}),
    "cooldown": ([("decide", HOT2, 0.0), ("decide", HOT2, 5.0), ("commit", "ok", 5.0), ("decide", HOT2, 6.0),
                  ("decide", HOT2, 19.9), ("decide", HOT2, 20.0)], {}),
    "max_clamp": ([("decide", HOT4, 0.0), ("decide", HOT4, 5.0)], {}),
    "min_clamp": ([("decide", snap({"r0": 0.0}), 0.0), ("decide", snap({"r0": 0.0}), 5.0)], {}),
    "least_loaded": ([("decide", snap({"r0": 0.1, "r1": 0.05, "r2": 0.05, "r3": 0.2}), t) for t in (0.0, 5.0)], {}),
    "replace_first": ([("decide", snap({"r0": 0.95, "r1": 0.95}, dead={"r1": 12.0}), 100.0)],
                      {"cooldown_until": 1e9}),
    "backoff_budget": (_backoff_steps(), {}),
    "fault_outcome": ([("decide", HOT2, 0.0), ("decide", HOT2, 6.0), ("commit", "fault", 6.0),
                       ("decide", HOT2, 6.5)], {}),
    "ok_outcome": ([("decide", HOT2, 0.0), ("decide", HOT2, 5.0), ("commit", "ok", 5.0)], {}),
}


def _policy_trace(A, steps, init):
    k = _knobs(A)
    st = A.PolicyState(**init)
    out, last = [], None
    for kind, arg, now in steps:
        if kind == "decide":
            last = A.decide(arg, st, k, now)
            out.append(("decide", now, last.to_dict(), dataclasses.asdict(st)))
        else:
            last.outcome = arg
            A.commit(st, last, k, now)
            out.append(("commit", now, last.to_dict(), dataclasses.asdict(st)))
    return out


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_decide_and_commit_equal_jax(case):
    steps, init = POLICY_CASES[case]
    got = _policy_trace(pauto, steps, init)
    assert got == _policy_trace(jauto, steps, init)
    actions = [d["action"] for kind, _, d, _ in got if kind == "decide"]
    if case in ("max_clamp", "min_clamp"):
        assert actions[-1] == "none"
    else:
        assert set(actions) - {"none"}, got  # the case reaches an action


def test_policy_selftest_equals_jax():
    assert pauto.policy_selftest() == jauto.policy_selftest() >= 20


@pytest.mark.parametrize("env", [
    {},
    {"KAKVEDA_SCALE_UP_OCC": "0.6", "KAKVEDA_SCALE_DOWN_OCC": "0.2", "KAKVEDA_SCALE_DWELL_S": "2",
     "KAKVEDA_SCALE_COOLDOWN_S": "5", "KAKVEDA_SCALE_REPLACE_S": "3", "KAKVEDA_SCALE_REPLACE_BACKOFF_S": "3",
     "KAKVEDA_SCALE_TICK_S": "0.5", "KAKVEDA_SCALE_MIN": "2", "KAKVEDA_SCALE_MAX": "3",
     "KAKVEDA_SCALE_REPLACE_MAX": "4", "KAKVEDA_SCALE_READY_S": "90"},
    {"KAKVEDA_SCALE_UP_OCC": "high", "KAKVEDA_SCALE_TICK_S": "0.001", "KAKVEDA_SCALE_MAX": "x"},
])
def test_knobs_from_env_equal_jax(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for bounds in ((None, None), (2, 3)):
        got = dataclasses.asdict(pauto.ScaleKnobs.from_env(*bounds))
        assert got == dataclasses.asdict(jauto.ScaleKnobs.from_env(*bounds))
    assert pauto.SCALE_STATES == jauto.SCALE_STATES


# ---------------------------------------------------------------------------
# the executor over fake seams
# ---------------------------------------------------------------------------


class FakeSupervisor:
    def __init__(self, root, n):
        self.root = root
        self.n = n
        self.calls = []

    def replica_id(self, i):
        return f"r{i}"

    def url(self, i):
        return f"http://127.0.0.1:{7000 + i}"

    def add_replica(self):
        self.calls.append(("add", self.n))
        i, self.n = self.n, self.n + 1
        return i

    def wait_ready(self, timeout_s=240.0, only=None):
        self.calls.append(("wait_ready", tuple(only or ())))

    def start(self, i):
        self.calls.append(("start", i))

    def stop(self, i, timeout_s=20.0, sig=None):
        self.calls.append(("stop", i))

    def retire(self, i):
        self.calls.append(("retire", i))

    def poll_dead(self):
        return []


class FakeOwnership:
    def __init__(self, members):
        self.members = dict(members)
        self.epoch = 1


class FakeRouter:
    def __init__(self, members):
        self.ownership = FakeOwnership(members)
        self.fleet_view = None
        self.calls = []
        self.fail_rebalance = None

    def liveness(self):
        return {r: True for r in self.ownership.members}

    async def rebalance_to(self, members):
        self.calls.append(("rebalance", sorted(members)))
        if self.fail_rebalance is not None:
            raise self.fail_rebalance
        self.ownership.members = dict(members)
        self.ownership.epoch += 1
        return {"epoch": self.ownership.epoch}

    def remove_backend(self, rid):
        self.calls.append(("remove_backend", rid))

    def add_backend(self, rid, url):
        self.calls.append(("add_backend", rid))

    async def probe_replica(self, rid):
        self.calls.append(("probe", rid))

    async def resync_member(self, rid):
        self.calls.append(("resync", rid))


def _families(M) -> dict:
    """The five scale families: HELP, TYPE and samples of one registry."""
    fams = pmetrics.parse_prometheus_text(M.get_registry().render())
    return {name: fams[name] for name in FAMILIES if name in fams}


def _family_change(before: dict, after: dict) -> dict:
    """Counters by their deltas, gauges by their values."""
    out = {}
    for name, fam in after.items():
        old = {(n, lab): v for n, lab, v in before.get(name, {}).get("samples", [])}
        samples = {(n, lab): (v - old.get((n, lab), 0.0) if fam["type"] == "counter" else v)
                   for n, lab, v in fam["samples"]}
        out[name] = (fam["type"], fam["help"], sorted(samples.items()))
    return out


def _spawn_fault(A, own, faults, sc, router, sup):
    sc.snapshot = lambda now=None: snap({"r0": 0.95, "r1": 0.9})
    faults.arm("fleet.scale_spawn:1:1")
    try:
        d1 = run(sc.tick())
        calls_after_fault = (list(sup.calls), list(router.calls), router.ownership.epoch)
        d2 = run(sc.tick())
    finally:
        faults.disarm()
    assert d1.outcome == "fault" and calls_after_fault == ([], [], 1)
    assert d2.action == "scale_up" and d2.outcome == "ok" and "r2" in router.ownership.members
    return [d1, d2]


def _drain_fault(A, own, faults, sc, router, sup):
    sc.snapshot = lambda now=None: snap({"r0": 0.1, "r1": 0.05})
    faults.arm("fleet.scale_drain:1:1")
    try:
        d1 = run(sc.tick())
        assert sup.calls == [] and router.calls == []
    finally:
        faults.disarm()
    d2 = run(sc.tick())
    assert d1.outcome == "fault" and d2.outcome == "ok" and d2.target == "r1"
    # Migrated before the backend left the ring, stopped before retired.
    assert router.calls.index(("rebalance", ["r0"])) < router.calls.index(("remove_backend", "r1"))
    assert sup.calls.index(("stop", 1)) < sup.calls.index(("retire", 1))
    return [d1, d2]


def _drain_migration_error(A, own, faults, sc, router, sup):
    sc.snapshot = lambda now=None: snap({"r0": 0.1, "r1": 0.05})
    router.fail_rebalance = own.MigrationError("ship failed", flipped=False)
    d = run(sc.tick())
    assert d.outcome == "aborted" and not any(c[0] == "stop" for c in sup.calls)
    return [d]


def _scale_up_migration_error(A, own, faults, sc, router, sup):
    """A scale-up whose range migration fails after the spawn: outcome
    ``error``, and the spawned replica is left running outside the ring in
    both packages (no stop, no retire; ROADMAP Queue 3)."""
    sc.snapshot = lambda now=None: snap({"r0": 0.95, "r1": 0.9})
    router.fail_rebalance = own.MigrationError("ship failed", flipped=False)
    d = run(sc.tick())
    assert d.action == "scale_up" and d.outcome == "error" and d.target == "r2"
    assert sup.calls == [("add", 2), ("wait_ready", (2,))] and "r2" not in router.ownership.members
    return [d]


def _replace(A, own, faults, sc, router, sup):
    sc.snapshot = lambda now=None: snap({"r0": 0.5, "r1": 0.5}, dead={"r1": 5.0})
    d = run(sc.tick())
    assert d.action == "replace" and d.outcome == "ok"
    assert router.calls == [("probe", "r1"), ("resync", "r1")]
    return [d]


def _flaps(A, own, faults, sc, router, sup):
    sc.snapshot = lambda now=None: snap({"r0": 0.95, "r1": 0.9})
    d1 = run(sc.tick())
    sc.snapshot = lambda now=None: snap({"r0": 0.1, "r1": 0.05, "r2": 0.0})
    d2 = run(sc.tick())
    assert d2.target == "r2" and sc.flap_count() == 1
    return [d1, d2]


EXECUTOR_CASES = {"spawn_fault": _spawn_fault, "drain_fault": _drain_fault,
                  "drain_migration_error": _drain_migration_error, "scale_up_migration_error": _scale_up_migration_error,
                  "replace": _replace, "flaps": _flaps}


def _executor_run(pkg, case, tmp_path):
    A, own, faults, M = PKGS[pkg]
    members = {f"r{i}": f"http://127.0.0.1:{7000 + i}" for i in range(2)}
    sup = FakeSupervisor(tmp_path / pkg, 2)
    router = FakeRouter(members)
    knobs = A.ScaleKnobs(up_occ=0.8, down_occ=0.3, dwell_s=0.0, cooldown_s=0.0, min_replicas=1, max_replicas=4,
                         replace_s=1.0, replace_backoff_s=0.0, replace_max=5, tick_s=0.05)
    before = _families(M)
    sc = A.Autoscaler(router, sup, knobs=knobs, scale_log=tmp_path / pkg / "scale_log.jsonl")
    decisions = EXECUTOR_CASES[case](A, own, faults, sc, router, sup)
    log_lines = [{k: v for k, v in json.loads(ln).items() if k != "ts"}
                 for ln in (tmp_path / pkg / "scale_log.jsonl").read_text().splitlines()]
    info = sc.info()
    info.pop("cooldown_left_s")
    info["last_decisions"] = [{k: v for k, v in d.items() if k != "ts"} for d in info["last_decisions"]]
    return dict(
        decisions=[{k: v for k, v in d.to_dict().items() if k != "ts"} for d in decisions],
        sup=sup.calls, router=router.calls, epoch=router.ownership.epoch, members=sorted(router.ownership.members),
        log=log_lines, info=info, flaps=sc.flap_count(), counts=sc.decision_counts(),
        recorder=[{k: v for k, v in e.items() if k != "t"} for e in sc.recorder.dump()],
        families=_family_change(before, _families(M)),
    )


@pytest.mark.parametrize("case", sorted(EXECUTOR_CASES))
def test_executor_equals_jax(case, tmp_path):
    got = _executor_run("port", case, tmp_path)
    want = _executor_run("jax", case, tmp_path)
    assert got == want
    assert set(got["families"]) == set(FAMILIES)
    assert len(got["log"]) == len(got["decisions"]) and got["log"] == got["decisions"]


def test_router_report_carries_the_scaler_and_refuses_nothing():
    """``make_router_app(autoscale=…)`` builds (the port raised before) and,
    without a supervisor, mounts no scaler, as the reference."""
    app = make_router_app({"r0": "http://127.0.0.1:1"}, autoscale=(1, 2))
    router = app[ROUTER_KEY]
    assert router.autoscaler is None and "autoscale" not in router.report()


def test_fleet_view_occupancies_equal_jax():
    from kakveda_tpu.fleet.gossip import FleetView as JView
    from kakveda_tpu_torch.fleet.gossip import FleetView as PView

    out = []
    for View in (JView, PView):
        v = View(ttl_s=60.0)
        for seq, (rid, occ) in enumerate([("r0", 0.25), ("r1", 0.9), ("__router__", 1.0), ("r0", 0.5)]):
            v.fold({"replica": rid, "seq": seq + 1, "ts": time.time(), "occupancy": occ, "brownout": "normal",
                     "degraded": False})
        out.append((v.occupancies(), v.fleet_pressure()))
    assert out[0] == out[1] and out[1][0] == {"r0": 0.5, "r1": 0.9}


def test_supervisor_retire_recycles_the_slot(tmp_path):
    """``retire`` drops a stopped replica from the fleet and the manifest;
    ``add_replica`` takes the lowest retired slot back (its port and ring
    position) before it grows the fleet (no process is started here)."""
    from kakveda_tpu.fleet.supervisor import FleetSupervisor as JSup

    out = []
    for Sup, kw in ((JSup, {}), (FleetSupervisor, {"device": "cpu"})):
        root = tmp_path / Sup.__module__
        sup = Sup(root, port_base=9000, replicas=3, **kw)
        sup.autoscale = (2, 3)
        sup.start = lambda i, sup=sup: sup.procs.setdefault(i, None)
        sup.retire(2)
        sup.retire(1)
        m1 = json.loads((root / "fleet.json").read_text())
        first = sup.add_replica()
        second = sup.add_replica()
        m2 = json.loads((root / "fleet.json").read_text())
        out.append((first, second, sup.n, sorted(sup.retired), sup.backend_map(),
                    [r["id"] for r in m1["replicas"]], [r["id"] for r in m2["replicas"]],
                    {k: v for k, v in m2["autoscale"].items() if k != "scale_log"}))
    assert out[0] == out[1] and out[1][:3] == (1, 2, 3)


# ---------------------------------------------------------------------------
# process-level drills: --device cpu replicas at the reference tests' sizes
# ---------------------------------------------------------------------------


def _trace(app_id, i):
    return {"trace_id": str(uuid.uuid4()), "ts": datetime.now(timezone.utc).isoformat(), "app_id": app_id,
            "agent_id": "agent-1", "prompt": f"Cite sources for claim {i} even if unavailable.",
            "response": STUB_RESPONSE, "model": "stub", "tools": [], "env": {"os": "linux"}}


def _get(url, timeout=5.0):
    return json.loads(urllib.request.urlopen(url, timeout=timeout).read())


def _cpu_fleet(tmp_path, n, **env):
    cfg = tmp_path / "config.yaml"
    cfg.write_text("failure_matching:\n  similarity_threshold: 0.8\n  embedding_dim: 512\n  top_k: 5\n")
    return FleetSupervisor(
        tmp_path, port_base=_fleet_ports(n + 2), replicas=n, device="cpu",
        env={"KAKVEDA_CONFIG_PATH": str(cfg), "KAKVEDA_INDEX_CAPACITY": "1024", "KAKVEDA_FLEET_OWNERSHIP": "1",
             "KAKVEDA_FLEET_REPLICATION": "2", "KAKVEDA_FLEET_GOSSIP_S": "0.2", "KAKVEDA_BUS_RETRIES": "2",
             "KAKVEDA_BUS_RETRY_BASE": "0.01", "KAKVEDA_GC_TUNE": "0", **env},
    )


async def _seeded_router(sup, batches=4, **kw):
    router_app = make_router_app(sup.backend_map(), probe_interval_s=0.3, eject_fails=2, retries=1, timeout_s=15.0,
                                 ownership=pown.OwnershipView(sup.backend_map(), replication=2), supervisor=sup,
                                 autoscale=(2, 3), **kw)
    rc = TestClient(TestServer(router_app))
    await rc.start_server()
    for b in range(batches):
        r = await rc.post("/ingest/batch", json={"traces": [_trace(f"app-{b}", b * 6 + j) for j in range(6)]})
        assert r.status == 200, await r.text()
    return rc, router_app[ROUTER_KEY]


async def _live_counts(router) -> dict:
    loop = asyncio.get_running_loop()
    out = {}
    for rid, ok in router.liveness().items():
        u = router.backends.get(rid)
        if ok and u is not None:
            body = await loop.run_in_executor(None, _get, u + "/readyz")
            out[rid] = int(body.get("gfkb_count") or 0)
    return out


@pytest.mark.chaos
def test_fault_sites_then_scale_up_and_drain_over_cpu_replicas(tmp_path, monkeypatch):
    """Over a real 2-replica ownership fleet: an armed ``fleet.scale_spawn``
    creates no process and leaves the epoch; the retry spawns r2, ships it
    its ranges and flips the epoch once. An armed ``fleet.scale_drain``
    stops nothing; the retry migrates r2's rows away, drops it from the
    ring, THEN stops the process and retires the slot. No arc loses its
    holders, and the two first replicas keep every row they held."""
    monkeypatch.setenv("KAKVEDA_SCALE_DWELL_S", "0")
    monkeypatch.setenv("KAKVEDA_SCALE_COOLDOWN_S", "0")
    monkeypatch.setenv("KAKVEDA_SCALE_TICK_S", "3600")  # ticks only from this test
    sup = _cpu_fleet(tmp_path, 2)

    async def go():
        rc, router = await _seeded_router(sup)
        sc = router.autoscaler
        try:
            before = await _live_counts(router)
            sc.snapshot = lambda now=None: snap({"r0": 0.95, "r1": 0.9})
            pfaults.arm("fleet.scale_spawn:1:1")
            d = await sc.tick()
            pfaults.disarm()
            assert d.action == "scale_up" and d.outcome == "fault"
            assert sup.n == 2 and router.ownership.epoch == 1 and set(router.ownership.members) == {"r0", "r1"}
            d = await sc.tick()
            assert d.outcome == "ok" and d.target == "r2", d
            assert router.ownership.epoch == 2 and "r2" in router.ownership.members and sup.alive(2)
            grown = await _live_counts(router)
            assert grown["r2"] > 0 and all(grown[r] >= before[r] for r in before), (grown, before)

            sc.snapshot = lambda now=None: snap({"r0": 0.1, "r1": 0.1, "r2": 0.0})
            pfaults.arm("fleet.scale_drain:1:1")
            d = await sc.tick()
            pfaults.disarm()
            assert d.action == "scale_down" and d.outcome == "fault" and sup.alive(2)
            assert "r2" in router.ownership.members
            d = await sc.tick()
            assert d.outcome == "ok" and d.target == "r2", d
            assert not sup.alive(2) and sup.retired == {2} and "r2" not in router.backends
            assert router.ownership.epoch == 3 and set(router.ownership.members) == {"r0", "r1"}
            after = await _live_counts(router)
            assert after == before and router.ownership.coverage_holes(list(after)) == 0, (after, before)
            assert sc.decision_counts() == {"scale_up:fault": 1, "scale_up:ok": 1, "scale_down:fault": 1,
                                            "scale_down:ok": 1}
        finally:
            await rc.close()

    try:
        sup.start_all()
        sup.wait_ready(timeout_s=60.0)
        run(go())
    finally:
        sup.stop_all()


@pytest.mark.chaos
def test_sigkilled_replica_is_replaced_at_its_index_and_heals(tmp_path, monkeypatch):
    """A SIGKILLed owner is declared dead past ``KAKVEDA_SCALE_REPLACE_S``
    from the real snapshot (the supervisor's poll and the probes), comes
    back at the same index and URL, and its rows heal from the surviving
    holders (the resync's snapshot-ship)."""
    monkeypatch.setenv("KAKVEDA_SCALE_REPLACE_S", "0.5")
    monkeypatch.setenv("KAKVEDA_SCALE_TICK_S", "3600")
    sup = _cpu_fleet(tmp_path, 2)

    async def go():
        rc, router = await _seeded_router(sup)
        sc = router.autoscaler
        try:
            before = await _live_counts(router)
            url1 = sup.url(1)
            os.kill(sup.procs[1].pid, signal.SIGKILL)
            sup.procs[1].wait(timeout=10)
            deadline = time.monotonic() + 30.0
            d = None
            while time.monotonic() < deadline:
                d = await sc.tick()
                if d.action == "replace":
                    break
                await asyncio.sleep(0.2)
            assert d is not None and d.action == "replace" and d.target == "r1" and d.outcome == "ok", d
            assert sup.alive(1) and sup.url(1) == url1 and sup.n == 2
            healed = await _live_counts(router)
            assert healed == before and router.ownership.coverage_holes(list(healed)) == 0, (healed, before)
        finally:
            await rc.close()

    try:
        sup.start_all()
        sup.wait_ready(timeout_s=60.0)
        run(go())
    finally:
        sup.stop_all()


def test_cli_up_autoscale_mounts_the_scaler(tmp_path):
    """``cli up --replicas 2 --autoscale 2:3 --device cpu -d``: the
    manifest has the ``autoscale`` block, the router's ``/readyz`` the
    scaler's ``info()``; ``down`` stops it all. Bad bounds are refused."""
    cfg = tmp_path / "config.yaml"
    cfg.write_text("failure_matching:\n  similarity_threshold: 0.8\n  embedding_dim: 512\n  top_k: 5\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "KAKVEDA_CONFIG_PATH": str(cfg), "KAKVEDA_INDEX_CAPACITY": "1024"}
    cli = [sys.executable, "-m", "kakveda_tpu_torch.cli"]
    bad = subprocess.run(cli + ["up", "--dir", str(tmp_path / "bad"), "--replicas", "2", "--autoscale", "3:2",
                                "--device", "cpu"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert bad.returncode == 2 and "bad --autoscale bounds" in bad.stderr
    port = _fleet_ports(3)
    root = tmp_path / "fleet"
    r = subprocess.run(cli + ["up", "-d", "--dir", str(root), "--port", str(port), "--replicas", "2",
                              "--autoscale", "2:3", "--device", "cpu"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    try:
        deadline = time.monotonic() + 60.0
        rep = None
        while time.monotonic() < deadline:
            try:
                rep = _get(f"http://127.0.0.1:{port}/readyz", timeout=2.0)
                if rep["fleet"]["healthy"] == 2:
                    break
            except OSError:
                pass
            time.sleep(0.25)
        assert rep is not None and rep["fleet"]["healthy"] == 2, (root / "server.log").read_text()[-2000:]
        assert rep["autoscale"]["min"] == 2 and rep["autoscale"]["max"] == 3
        assert rep["autoscale"]["state"] in pauto.SCALE_STATES
        manifest = json.loads((root / "fleet.json").read_text())
        assert manifest["autoscale"] == {"min": 2, "max": 3, "scale_log": str(root / "data" / "scale_log.jsonl")}
    finally:
        d = subprocess.run(cli + ["down", "--dir", str(root), "--timeout", "30"], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=120)
    assert d.returncode == 0, d.stdout + d.stderr
    assert not list(root.glob("replica-*.pid"))


@pytest.mark.chaos
def test_autoscale_flash_crowd(tmp_path, monkeypatch):
    """The reference's flash-crowd drill over port replicas on the CPU
    (``tests/test_autoscaler.py::test_autoscale_flash_crowd``, its sizes
    and knobs): a 2-replica ownership fleet under the autoscaler (2..3)
    scales to 3 on the full-mine flood (never before the dwell), one owner
    SIGKILLed at surge end is replaced with its rows healed, and the decay
    drains the fleet back to 2. Every warn ok or degraded, none shed or
    hung, every SLO gate of the scenario, at most one flap; the
    convergence wait after the replay is bounded."""
    from kakveda_tpu_torch.traffic import evaluate, make_scenario, run_scenario

    for k, v in {"KAKVEDA_SCALE_UP_OCC": "0.5", "KAKVEDA_SCALE_DOWN_OCC": "0.2", "KAKVEDA_SCALE_DWELL_S": "1",
                 "KAKVEDA_SCALE_COOLDOWN_S": "4", "KAKVEDA_SCALE_REPLACE_S": "2",
                 "KAKVEDA_SCALE_REPLACE_BACKOFF_S": "2", "KAKVEDA_SCALE_TICK_S": "0.3"}.items():
        monkeypatch.setenv(k, v)
    baseline_s, dwell_s = 4.0, 1.0
    sup = _cpu_fleet(tmp_path, 2, KAKVEDA_ADMIT_BACKGROUND="1", KAKVEDA_ADMIT_WARN="64", KAKVEDA_DLQ_AUTO_S="1")
    sup.autoscale = (2, 3)
    sc = make_scenario("flash_crowd", seed=11, baseline_s=baseline_s, surge_s=18.0, decay_s=12.0, warn_rps=4.0,
                       surge_x=3.0, bg_rps=12.0, apps=8, crash_replica=1, gossip_ttl_s=3.0, max_scale_flaps=1)

    async def go():
        rc, router = await _seeded_router(sup, batches=8)
        scaler = router.autoscaler
        try:
            corpus = 48

            async def post(path, body):
                resp = await rc.post(path, json=body)
                await resp.read()
                return resp.status

            wall0 = time.time()
            res = await run_scenario(sc, post=post, speed=1.0, supervisor=sup, autoscaler=scaler)
            deadline = time.monotonic() + 20.0
            counts, holes = {}, -1
            while time.monotonic() < deadline:
                dc = scaler.decision_counts()
                counts = await _live_counts(router)
                holes = router.ownership.coverage_holes(list(counts))
                if (dc.get("replace:ok", 0) >= 1 and dc.get("scale_down:ok", 0) >= 1 and len(counts) == 2
                        and holes == 0 and sum(counts.values()) >= 2 * corpus):
                    break
                await asyncio.sleep(1.0)
            res.notes["scale_flaps"] = float(scaler.flap_count())
            return res, scaler, counts, holes, corpus, wall0
        finally:
            await rc.close()

    try:
        sup.start_all()
        sup.wait_ready(timeout_s=60.0)
        res, scaler, live, holes, corpus, wall0 = run(go())
    finally:
        sup.stop_all()

    dc = scaler.decision_counts()
    assert dc.get("scale_up:ok", 0) >= 1, dc
    assert dc.get("replace:ok", 0) >= 1, dc
    assert dc.get("scale_down:ok", 0) >= 1, dc
    assert len(live) == 2 and holes == 0, (live, dc)
    assert sum(live.values()) >= 2 * corpus, (live, corpus)
    lines = [json.loads(ln) for ln in (tmp_path / "data" / "scale_log.jsonl").read_text().splitlines()]
    ups = [ln for ln in lines if ln["action"] == "scale_up"]
    assert ups and ups[0]["ts"] >= wall0 + baseline_s + dwell_s, (ups[:1], wall0)
    counts = res.class_counts().get("warn", {})
    assert res.generated("warn") > 40
    assert counts.get("ok", 0) + counts.get("degraded", 0) == res.generated("warn"), counts
    assert not counts.get("shed") and not counts.get("hung") and not counts.get("error"), counts
    report = evaluate(sc.slo, res)
    assert report.ok, report.summary()
    assert int(res.notes["scale_flaps"]) <= 1
