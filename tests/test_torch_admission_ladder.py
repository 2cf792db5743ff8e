"""The port's brownout ladder and tenant quotas (``kakveda_tpu_torch/core/
admission.py``) against the JAX package's, on the CPU.

The clock is ``time.monotonic``, patched (one module object serves both
packages) to a stepped value, so no test waits for the ladder's 5 s dwell
and every time-derived number (occupancy, drain rates) compares exactly.
``KAKVEDA_ADMIT_RA_JITTER=0`` makes Retry-After deterministic. What is
masked: the flight recorders' wall-clock ``t``, and the port's extra
``sheds`` key in ``info()`` (held to the reference's ``shed_counts()``).
Every test resets both packages' process-global controllers and armed
faults in teardown.
"""

import time

import numpy as np
import pytest

from kakveda_tpu.core import admission as jax_adm
from kakveda_tpu.core import faults as jax_faults
from kakveda_tpu.core import metrics as jax_metrics
from kakveda_tpu_torch.core import admission as port_adm
from kakveda_tpu_torch.core import faults as port_faults
from kakveda_tpu_torch.core import metrics as port_metrics

PACKAGES = {
    "jax": (jax_adm, jax_faults, jax_metrics),
    "port": (port_adm, port_faults, port_metrics),
}


@pytest.fixture(autouse=True)
def _clean():
    for adm, faults, _ in PACKAGES.values():
        faults.disarm()
        adm.reset_for_tests()
    yield
    for adm, faults, _ in PACKAGES.values():
        faults.disarm()
        adm.reset_for_tests()


@pytest.fixture()
def clock(monkeypatch):
    c = {"t": 5000.0}
    monkeypatch.setattr(time, "monotonic", lambda: c["t"])
    monkeypatch.setenv("KAKVEDA_ADMIT_RA_JITTER", "0")
    return c


def _events(rec):
    return [{k: v for k, v in e.items() if k != "t"} for e in rec.dump()]


def _pressure_script(seed):
    """(pressure, seconds to advance) pairs: bursts past ENTER held long
    enough to climb the whole ladder, calm spells under EXIT long enough to
    climb down, and noise between the thresholds that must move nothing."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        for _ in range(int(rng.integers(3, 9))):
            out.append((float(rng.uniform(0.85, 1.5)), float(rng.uniform(0.5, 3.0))))
        for _ in range(int(rng.integers(1, 5))):
            out.append((float(rng.uniform(0.51, 0.84)), float(rng.uniform(0.1, 4.0))))
        for _ in range(int(rng.integers(2, 10))):
            out.append((float(rng.uniform(0.0, 0.5)), float(rng.uniform(0.5, 3.0))))
    return out


def _drive_ladder(pkg, clock, script):
    adm, _, metrics = PACKAGES[pkg]
    rec = metrics.FlightRecorder(f"ladder-{pkg}")
    b = adm.BrownoutController(recorder=rec)
    trail = []
    for p, dt in script:
        clock["t"] += dt
        b.note_pressure(p)
        trail.append((
            b.step, b.state, b.spec_allowed(), b.token_cap(),
            tuple(b.class_shed(k) for k in adm.CLASSES),
        ))
    return trail, _events(rec), b.occupancy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pressure_sequence_moves_both_ladders_alike(clock, seed):
    script = _pressure_script(seed)
    t0 = clock["t"]
    ref = _drive_ladder("jax", clock, script)
    clock["t"] = t0
    port = _drive_ladder("port", clock, script)
    assert port == ref
    trail, events, occ = port
    assert port_adm.BROWNOUT_STATES == jax_adm.BROWNOUT_STATES
    assert set(occ) == set(port_adm.BROWNOUT_STATES)
    assert {s for s, *_ in trail} >= {0, 1, 2}
    assert all(e["kind"] == "brownout" for e in events)


def test_ladder_rungs_restrict_as_the_reference(clock):
    """Held at each step in turn (the process-global controller's
    ``note_pressure`` with the dwell elapsed): the same restrictions, the
    same state gauge and transition counts on both registries."""
    out = {}
    for pkg in ("jax", "port"):
        adm, _, metrics = PACKAGES[pkg]
        b = adm.get_admission().brownout
        reg = metrics.get_registry()
        before = reg.snapshot()["kakveda_brownout_transitions_total"]["series"]
        rows = []
        for step in range(5):
            while b.step < step:
                clock["t"] += 6.0
                b.note_pressure(1.0)
            rows.append((step, b.spec_allowed(), b.token_cap(),
                         [b.class_shed(k) for k in adm.CLASSES],
                         reg.gauge("kakveda_brownout_state", "", ("state",)).labels(state=b.state).value))
        while b.step > 0:
            clock["t"] += 6.0
            b.note_pressure(0.0)
            rows.append(("down", b.step))
        fam = reg.snapshot()["kakveda_brownout_transitions_total"]["series"]
        rows.append(sorted((k, v - before.get(k, 0)) for k, v in fam.items() if v != before.get(k, 0)))
        out[pkg] = rows
    assert out["port"] == out["jax"]
    assert out["port"][1][1:3] == (False, None) and out["port"][2][2] == 32
    assert out["port"][3][3] == [False, False, False, True]
    assert out["port"][4][3] == [False, False, True, True]


def _tenant_script(seed, n=400):
    rng = np.random.default_rng(seed)
    tenants = ["noisy"] * 6 + ["victim", "t2", "t3", "t4", "t5", "t6"]
    script = []
    for _ in range(n):
        op = "admit" if rng.random() < 0.6 else "release"
        klass = ("warn", "ingest", "interactive", "background")[int(rng.integers(4))]
        script.append((op, klass, tenants[int(rng.integers(len(tenants)))], float(rng.uniform(0.0, 0.8))))
    return script


def _drive_tenants(pkg, clock, script):
    adm_mod, _, metrics = PACKAGES[pkg]
    adm = adm_mod.AdmissionController(
        limits={"warn": 6, "ingest": 4, "interactive": 4, "background": 2},
        enabled=True, brownout=adm_mod.BrownoutController(enabled=False),
        recorder=metrics.FlightRecorder(f"adm-{pkg}"),
    )
    held = []
    out = []
    for op, klass, tenant, dt in script:
        clock["t"] += dt
        if op == "admit":
            try:
                adm.try_admit(klass, tenant=tenant)
                held.append((klass, tenant))
                out.append(("ok", klass, tenant))
            except adm_mod.OverloadError as e:
                out.append((e.reason, e.klass, e.tenant, round(e.retry_after, 9)))
        else:
            match = [h for h in held if h[1] == tenant]
            if match:
                held.remove(match[0])
                adm.release(match[0][0], tenant=tenant)
                out.append(("released",) + match[0])
    info = adm.info()
    return out, info, adm.shed_counts(), _events(adm.recorder)


@pytest.mark.parametrize("table", ["512", "3"])
def test_tenant_script_admits_and_sheds_alike(clock, monkeypatch, table):
    monkeypatch.setenv("KAKVEDA_TENANT_TABLE", table)
    script = _tenant_script(11)
    t0 = clock["t"]
    ref_out, ref_info, ref_sheds, ref_ev = _drive_tenants("jax", clock, script)
    clock["t"] = t0
    out, info, sheds, ev = _drive_tenants("port", clock, script)
    assert out == ref_out
    assert info.pop("sheds") == sheds == ref_sheds
    assert info == ref_info
    assert ev == ref_ev
    reasons = {o[0] for o in out}
    assert {"ok", "tenant_quota", "queue_full"} <= reasons
    if table == "3":
        assert any(r["tenant"] == "other" for r in info["tenants"]["top_shed"])
        assert info["tenants"]["table_size"] <= 4


def test_armed_tenant_quota_fails_open_in_both(clock):
    out = {}
    for pkg in ("jax", "port"):
        adm_mod, faults, metrics = PACKAGES[pkg]
        adm = adm_mod.AdmissionController(
            limits={"warn": 4, "ingest": 1, "interactive": 1, "background": 1},
            enabled=True, brownout=adm_mod.BrownoutController(enabled=False),
        )
        degraded = metrics.get_registry().counter(
            "kakveda_admission_tenant_quota_degraded_total", "")._default()
        before = degraded.value
        for t in ("app-a", "app-a", "app-b"):
            adm.try_admit("warn", tenant=t)
        rows = []
        try:
            adm.try_admit("warn", tenant="app-a")
        except adm_mod.OverloadError as e:
            rows.append(e.reason)
        faults.arm("admission.tenant_quota:1:-1")
        adm.try_admit("warn", tenant="app-a")  # over its share: admitted
        rows.append(degraded.value - before)
        try:
            adm.try_admit("warn", tenant="app-b")
        except adm_mod.OverloadError as e:
            rows.append(e.reason)
        faults.disarm()
        out[pkg] = rows
    assert out["port"] == out["jax"] == ["tenant_quota", 1.0, "queue_full"]
