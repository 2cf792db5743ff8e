"""The port's timed fault arming (``FaultSchedule``, ``schedule``,
``KAKVEDA_FAULTS_TIMELINE`` in ``kakveda_tpu_torch/core/faults.py``)
against the JAX package's, on the CPU.

The schedule runs on a stepped clock: ``time.monotonic`` is patched in
both modules and the schedule's stop event advances that clock by each
wait instead of sleeping, so arm and disarm times are exact and nothing
is masked. After each applied entry the armed site is fired 20 times; the
seeded RNG makes the probabilistic counts equal too. The env timeline is
read at import, so that case runs each package in a subprocess (real
time there: each probe lies 0.35 s or more from an offset, and only the
order of states is compared).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from kakveda_tpu.core import faults as jax_faults
from kakveda_tpu_torch.core import faults as port_faults

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": jax_faults, "port": port_faults}

TIMELINE = [
    {"t": 4.0, "spec": "service.handler:1.0:3"},
    {"t": 1.0, "spec": "sched.a:0.5:-1"},
    (2.5, "sched.a:0.5:-1,sched.b:1.0:2"),
    {"t": 6.0, "spec": ""},
]


@pytest.fixture(autouse=True)
def _clean():
    for m in PACKAGES.values():
        m.disarm()
    yield
    for m in PACKAGES.values():
        m.disarm()


class _SteppedStop:
    """Stands in for the schedule's stop event: a wait advances the
    patched clock by its delay and never stops."""

    def __init__(self, clock):
        self.clock = clock

    def wait(self, delay):
        self.clock["t"] += delay
        return False

    def is_set(self):
        return False

    def set(self):
        pass


def _run(m, monkeypatch, speed, seed):
    clock = {"t": 100.0}
    monkeypatch.setattr(m.time, "monotonic", lambda: clock["t"])
    applied = []
    real_arm = m.arm

    def arm(spec, seed=None):
        real_arm(spec, seed=seed)
        fired = {}
        for name in ("service.handler", "sched.a", "sched.b"):
            s = m.site(name)
            n = 0
            for _ in range(20):
                try:
                    s.fire()
                except m.FaultInjected:
                    n += 1
            fired[name] = n
        applied.append((round(clock["t"] - 100.0, 9), spec, fired))

    monkeypatch.setattr(m, "arm", arm)
    sched = m.schedule(TIMELINE, speed=speed, seed=seed, start=False)
    sched._stop = _SteppedStop(clock)
    sched._run()
    monkeypatch.setattr(m, "arm", real_arm)
    return applied, sched.applied, sched.entries


@pytest.mark.parametrize("speed,seed", [(1.0, 0), (2.0, 7), (0.5, None)])
def test_schedule_arms_and_fires_as_jax_on_a_stepped_clock(monkeypatch, speed, seed):
    jax_faults._rng.seed(11)
    port_faults._rng.seed(11)
    ref = _run(jax_faults, monkeypatch, speed, seed)
    port = _run(port_faults, monkeypatch, speed, seed)
    assert port == ref
    applied, n, entries = port
    assert n == 4 and [t for t, _, _ in applied] == [e[0] / speed for e in entries]
    assert applied[-1][2] == {"service.handler": 0, "sched.a": 0, "sched.b": 0}
    assert applied[-2][2]["service.handler"] == 3


@pytest.mark.parametrize("entries", [
    [{"t": 1.0, "spec": "site:x"}],
    [{"t": 1.0, "spec": "site:1.0:y"}],
    [{"spec": "site:1.0:1"}],
    [{"t": "soon", "spec": "site"}],
    [(1.0,)],
    [None],
])
def test_bad_specs_raise_the_same_error_types(entries):
    def err(m):
        try:
            m.FaultSchedule(entries)
        except Exception as e:  # noqa: BLE001 — the type is what is compared
            return type(e)
        return None

    assert err(port_faults) is err(jax_faults) is not None


@pytest.mark.parametrize("spec", ["", "a", "a:0.5", "a:0.5:-1,b::3", "a:q", "a:1:1.5"])
def test_arm_spec_check_matches_jax(spec):
    def res(m):
        try:
            m.arm_spec_check(spec)
        except ValueError:
            return "ValueError"
        return "ok"

    assert res(port_faults) == res(jax_faults)


_CHILD = r"""
import importlib, json, sys, time
m = importlib.import_module(sys.argv[1])
s = m.site("service.handler")
out = []
t0 = time.monotonic()
for probe in (0.2, 0.9, 1.6):
    time.sleep(max(0.0, t0 + probe - time.monotonic()))
    n = 0
    for _ in range(5):
        try:
            s.fire()
        except m.FaultInjected:
            n += 1
    out.append([probe, s.armed, n])
print(json.dumps(out))
"""


def test_env_timeline_is_read_at_import_in_both_packages():
    env = dict(os.environ)
    env["KAKVEDA_FAULTS_TIMELINE"] = json.dumps([
        {"t": 0.55, "spec": "service.handler:1.0:3"},
        {"t": 1.25, "spec": ""},
    ])
    env.pop("KAKVEDA_FAULTS", None)
    out = {}
    for name, mod in (("jax", "kakveda_tpu.core.faults"), ("port", "kakveda_tpu_torch.core.faults")):
        r = subprocess.run([sys.executable, "-c", _CHILD, mod], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        out[name] = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["port"] == out["jax"]
    assert out["port"] == [[0.2, False, 0], [0.9, False, 3], [1.6, False, 0]]
