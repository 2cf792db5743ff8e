"""The port's GFKB lifecycle against the JAX package's, on the CPU.

Twins of ``tests/test_lifecycle.py`` (the replication fence's twin is in
``tests/test_torch_replication.py``): checkpoint+delta compaction, aging and organic
resurrection, duplicate collapse, the fault sites and the crash-point sweep.
Each twin runs the same calls through both packages (the JAX GFKB on a
one-device mesh) with both clocks pinned and compares what they return and
what they leave: records field for field, the failures log byte for byte,
tombstones, and ``match_batch`` ids and tie order exactly, scores within
1e-6. Also the fault harness itself, site for site against the JAX one.
"""

import json
import os
import subprocess
import sys
import time
from datetime import datetime, timezone
from pathlib import Path

import pytest

import kakveda_tpu.index.gfkb as jax_gfkb_mod
import kakveda_tpu_torch.index.gfkb as port_gfkb_mod
from kakveda_tpu.core import faults as jax_faults
from kakveda_tpu.index.gfkb import GFKB as JaxGFKB
from kakveda_tpu.parallel.mesh import create_mesh
from kakveda_tpu_torch.core import faults
from kakveda_tpu_torch.core.schemas import Severity
from kakveda_tpu_torch.index.gfkb import GFKB

ROOT = Path(__file__).resolve().parent.parent
SCORE_TOL = 1e-6
TS = datetime(2026, 1, 2, 3, 4, 5, 678901, tzinfo=timezone.utc)
FUTURE = TS.timestamp() + 10_000
PAIR = (("jax", jax_faults), ("port", faults))


@pytest.fixture(autouse=True)
def _pinned_clock_and_disarmed(monkeypatch):
    monkeypatch.setattr(jax_gfkb_mod, "utcnow", lambda: TS)
    monkeypatch.setattr(port_gfkb_mod, "utcnow", lambda: TS)
    faults.disarm()
    jax_faults.disarm()
    yield
    faults.disarm()
    jax_faults.disarm()


def _mk(kind, tmp_path, **kw):
    kw.setdefault("capacity", 64)
    kw.setdefault("dim", 256)
    d = tmp_path / kind / "data"
    if kind == "jax":
        return JaxGFKB(data_dir=d, mesh=create_mesh("data:1"), **kw)
    return GFKB(data_dir=d, device="cpu", **kw)


def _log(tmp_path, kind, name="failures.jsonl"):
    return tmp_path / kind / "data" / name


def _sig(i):
    return f"lifecycle test failure signature {i} worker shard {i % 5}"


def _seed(kb, n, apps=3):
    kb.upsert_failures_batch([
        {"failure_type": "oom" if i % 2 else "timeout",
         "signature_text": _sig(i), "app_id": f"app-{i % apps}",
         "impact_severity": Severity.high}
        for i in range(n)
    ])


def _records(g):
    with g._lock:
        return [r.model_dump(mode="json") for r in g._records]


def _tombs(g):
    with g._lock:
        return {g._records[s].failure_id: reason for s, reason in g._tombstoned.items()}


def _assert_same_matches(a, b, queries):
    ma, mb = a.match_batch(queries), b.match_batch(queries)
    for x, y in zip(ma, mb):
        assert [(m.failure_id, m.version) for m in x] == [(m.failure_id, m.version) for m in y]
        for m, n in zip(x, y):
            assert m.score == pytest.approx(n.score, abs=SCORE_TOL)


def _assert_same(j, p, queries=()):
    assert _records(p) == _records(j)
    assert _tombs(p) == _tombs(j)
    jl, pl = j.lifecycle_info(), p.lifecycle_info()
    for key in ("tombstoned", "by_reason", "compact_generation", "failures_log_bytes"):
        assert pl[key] == jl[key], key
    _assert_same_matches(j, p, list(queries))


def _both(tmp_path, **kw):
    return _mk("jax", tmp_path, **kw), _mk("port", tmp_path, **kw)


def _close(*gs):
    for g in gs:
        g.close()


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------


def test_compact_roundtrip_parity_matches_jax(tmp_path):
    j, p = _both(tmp_path)
    for g in (j, p):
        _seed(g, 12)
        _seed(g, 12)  # occurrence bumps: version-append history to fold
    before = p.match_batch([_sig(3), _sig(8)])
    bytes_before = _log(tmp_path, "port").stat().st_size
    assert _log(tmp_path, "port").read_bytes() == _log(tmp_path, "jax").read_bytes()
    outs = [g.compact() for g in (j, p)]
    assert outs[1] == outs[0]
    assert outs[1]["compacted"] and outs[1]["generation"] == 1 and outs[1]["checkpoint_rows"] == 12
    assert outs[1]["bytes_after"] < bytes_before
    _close(j, p)

    j, p = _both(tmp_path)
    assert p.lifecycle_info()["restore"]["rows"] == 12
    _assert_same(j, p, [_sig(3), _sig(8)])
    after = p.match_batch([_sig(3), _sig(8)])
    for a, b in zip(before, after):
        assert a and b and a[0].failure_id == b[0].failure_id
        assert abs(a[0].score - b[0].score) < 1e-5
    assert p.lifecycle_info()["compact_generation"] == 1
    for g in (j, p):
        _seed(g, 13)  # delta appends land after the checkpoint
    _close(j, p)
    j, p = _both(tmp_path)
    assert p.count == j.count == 13
    _assert_same(j, p, [_sig(12)])
    _close(j, p)


def test_compact_optout_is_bit_for_bit_matches_jax(tmp_path, monkeypatch):
    j, p = _both(tmp_path)
    for g in (j, p):
        _seed(g, 6)
        _seed(g, 6)
    raw = _log(tmp_path, "port").read_bytes()
    assert raw == _log(tmp_path, "jax").read_bytes()
    monkeypatch.setenv("KAKVEDA_GFKB_COMPACT", "0")
    outs = [g.compact() for g in (j, p)]
    assert outs[1] == outs[0] == {"compacted": False, "reason": "KAKVEDA_GFKB_COMPACT=0"}
    assert _log(tmp_path, "port").read_bytes() == raw  # untouched, byte for byte
    assert not (tmp_path / "port" / "data" / "snapshot").exists()
    _close(j, p)


def test_torn_tail_contract_survives_compaction_matches_jax(tmp_path):
    j, p = _both(tmp_path)
    for g in (j, p):
        _seed(g, 4)
        assert g.compact()["compacted"]
        _seed(g, 5)  # one delta line past the checkpoint
    _close(j, p)
    for kind in ("jax", "port"):
        with _log(tmp_path, kind).open("ab") as f:
            f.write(b'{"failure_type": "torn", "signa')
    j, p = _both(tmp_path)  # warns, does not raise
    assert p.count == j.count == 5
    for g in (j, p):
        _seed(g, 6)  # the next append truncates the torn bytes first
    _close(j, p)
    for line in _log(tmp_path, "port").read_text().splitlines():
        json.loads(line)
    assert _log(tmp_path, "port").read_bytes() == _log(tmp_path, "jax").read_bytes()
    j, p = _both(tmp_path)
    assert p.count == j.count == 6
    _assert_same(j, p, [_sig(5)])
    _close(j, p)


def test_midfile_corruption_in_delta_still_raises_matches_jax(tmp_path):
    j, p = _both(tmp_path)
    for g in (j, p):
        _seed(g, 3)
        assert g.compact()["compacted"]
        _seed(g, 5)  # two delta lines
    _close(j, p)
    for kind in ("jax", "port"):
        lines = _log(tmp_path, kind).read_text().splitlines()
        assert len(lines) >= 2
        lines.insert(1, '{"torn": "mid-file')
        _log(tmp_path, kind).write_text("\n".join(lines) + "\n")
    for kind in ("jax", "port"):
        with pytest.raises(ValueError, match="mid-file"):
            _mk(kind, tmp_path)


def test_auto_compact_trigger_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("KAKVEDA_GFKB_COMPACT_BYTES", "1")
    j, p = _both(tmp_path)
    for g in (j, p):
        _seed(g, 8)  # the post-batch check sees size >= 1 byte -> background compaction
    deadline = time.time() + 15
    while time.time() < deadline:
        if all(g.lifecycle_info()["compact_generation"] >= 1 for g in (j, p)):
            break
        time.sleep(0.05)
    assert p.lifecycle_info()["compact_generation"] >= 1
    assert j.lifecycle_info()["compact_generation"] >= 1
    # the compacted store still serves and still accepts appends
    assert p.match_batch([_sig(2)])[0]
    _assert_same_matches(j, p, [_sig(2)])
    monkeypatch.delenv("KAKVEDA_GFKB_COMPACT_BYTES")
    for g in (j, p):
        while g._compact_inflight:
            time.sleep(0.05)
        _seed(g, 9)
    _close(j, p)
    j, p = _both(tmp_path)
    assert p.count == j.count == 9
    _assert_same(j, p, [_sig(8)])
    _close(j, p)


def test_applied_log_stale_tmp_removed_at_the_port_s_startup(tmp_path):
    """Twin of test_applied_log_stale_tmp_removed_at_startup: the port's
    own start-up compaction removes a temp that a crashed rewrite left
    behind and still fences the event, as the JAX package's does; the log
    it leaves opens in the JAX package with the same dedup set."""
    j = _mk("jax", tmp_path)
    row = {"failure_type": "oom", "signature_text": _sig(0),
           "app_id": "app-peer", "impact_severity": "high"}
    assert j.apply_replication([row], event_id="evt-stale-tmp") == 1
    j.close()
    data = tmp_path / "jax" / "data"
    stale = data / "applied_events.tmp"
    stale.write_text('{"id": "half-written')
    applied = (data / "applied_events.jsonl").read_bytes()
    p = GFKB(data_dir=data, capacity=64, dim=256, device="cpu")
    assert not stale.exists()
    assert p.count == 1
    assert p.apply_replication([row], event_id="evt-stale-tmp") == 0
    _seed(p, 2)
    p.close()
    assert (data / "applied_events.jsonl").read_bytes() == applied
    j2 = _mk("jax", tmp_path)
    assert j2.apply_replication([row], event_id="evt-stale-tmp") == 0
    j2.close()


# ---------------------------------------------------------------------------
# aging, resurrection, collapse
# ---------------------------------------------------------------------------


def test_aging_tombstones_and_organic_resurrection_across_restart_matches_jax(tmp_path):
    j, p = _both(tmp_path)
    for g in (j, p):
        _seed(g, 6)
    outs = [g.age_rows(ttl_s=100, now=FUTURE) for g in (j, p)]
    assert outs[1] == outs[0] and outs[1]["tombstoned"] == 6
    info = p.lifecycle_info()
    assert info["tombstoned"] == 6 and info["by_reason"] == {"aged": 6}
    # tombstoned rows never match
    assert all(not m or m[0].score < 0.5 for m in p.match_batch([_sig(0), _sig(1)]))
    _assert_same(j, p, [_sig(0), _sig(1)])
    _close(j, p)

    j, p = _both(tmp_path)  # tombstones replay across restart
    assert p.lifecycle_info()["tombstoned"] == 6
    recs = [
        g.upsert_failure(failure_type="oom", signature_text=_sig(1), app_id="app-new",
                         impact_severity=Severity.high)
        for g in (j, p)
    ]
    rec, created = recs[1]
    assert not created and rec.occurrences == 2  # an organic upsert resurrects, history intact
    assert rec.model_dump(mode="json") == recs[0][0].model_dump(mode="json")
    assert p.lifecycle_info()["tombstoned"] == 5
    m = p.match_batch([_sig(1)])[0]
    assert m and m[0].failure_id == rec.failure_id and m[0].score > 0.9
    _assert_same(j, p, [_sig(1), _sig(3)])
    _close(j, p)

    j, p = _both(tmp_path)  # the "live" line replays too
    assert p.lifecycle_info()["tombstoned"] == 5
    assert p.match_batch([_sig(1)])[0][0].failure_id == rec.failure_id
    _assert_same(j, p, [_sig(1), _sig(3)])
    _close(j, p)


def test_collapse_duplicates_folds_cluster_into_exemplar_matches_jax(tmp_path):
    j, p = _both(tmp_path, dim=1024)
    family = [
        ("timeout", f"timeout while calling payments api attempt {i}", f"app-{i}") for i in range(3)
    ]
    for g in (j, p):
        for ftype, sig, app in family:
            g.upsert_failure(failure_type=ftype, signature_text=sig, app_id=app,
                             impact_severity=Severity.medium)
        g.upsert_failure(failure_type="schema", signature_text="totally different shape xyz",
                         app_id="app-solo", impact_severity=Severity.medium)
    outs = [g.collapse_duplicates(min_cluster=3) for g in (j, p)]
    assert outs[1] == outs[0] and outs[1]["clusters"] == 1 and outs[1]["collapsed"] == 2
    assert p.lifecycle_info()["by_reason"] == {"collapsed": 2}
    ex = p._records[0]
    assert ex.occurrences == 3 and set(ex.affected_apps) == {"app-0", "app-1", "app-2"}
    m = p.match_batch(["timeout while calling payments api attempt 2"])[0]
    assert m and m[0].failure_id == ex.failure_id
    assert p.match_batch(["totally different shape xyz"])[0][0].score > 0.9
    queries = ["timeout while calling payments api attempt 1", "totally different shape xyz"]
    _assert_same(j, p, queries)
    _close(j, p)
    j, p = _both(tmp_path, dim=1024)  # the fold and the tombstones replay
    assert p._records[0].occurrences == 3 and p.lifecycle_info()["tombstoned"] == 2
    _assert_same(j, p, queries)
    _close(j, p)


def test_collapse_refuses_on_stale_mine_state_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("KAKVEDA_MINE_INCREMENTAL", "0")
    j, p = _both(tmp_path)
    for g in (j, p):
        _seed(g, 4)
    outs = [g.collapse_duplicates(min_cluster=2) for g in (j, p)]
    assert outs[1] == outs[0] and outs[1]["collapsed"] == 0 and "reason" in outs[1]
    _close(j, p)


# ---------------------------------------------------------------------------
# chaos: fault sites and the crash-point sweep
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_tombstone_write_fault_leaves_rows_live_matches_jax(tmp_path):
    j, p = _both(tmp_path)
    for (kind, fmod), g in zip(PAIR, (j, p)):
        _seed(g, 4)
        fmod.arm("gfkb.tombstone:1.0:1")
        assert g.age_rows(ttl_s=100, now=FUTURE)["tombstoned"] == 0  # first write faulted
        assert g.lifecycle_info()["tombstoned"] == 0
        fmod.disarm()
    assert faults.site("gfkb.tombstone").injected >= 1
    _assert_same(j, p, [_sig(1)])
    for g in (j, p):
        assert g.age_rows(ttl_s=100, now=FUTURE)["tombstoned"] == 4
    _assert_same(j, p, [_sig(1)])
    _close(j, p)


@pytest.mark.chaos
def test_compact_fault_keeps_old_log_live_matches_jax(tmp_path):
    j, p = _both(tmp_path)
    for (kind, fmod), g in zip(PAIR, (j, p)):
        _seed(g, 5)
        raw = _log(tmp_path, kind).read_bytes()
        fmod.arm("gfkb.compact_delta:1.0:1")
        with pytest.raises(fmod.FaultInjected):
            g.compact()
        fmod.disarm()
        assert _log(tmp_path, kind).read_bytes() == raw
        assert g.lifecycle_info()["compact_generation"] == 0
    _close(j, p)
    j, p = _both(tmp_path)
    assert p.count == j.count == 5
    outs = [g.compact() for g in (j, p)]  # the next attempt succeeds cleanly
    assert outs[1] == outs[0] and outs[1]["compacted"]
    _assert_same(j, p, [_sig(2)])
    _close(j, p)


@pytest.mark.chaos
def test_crash_sweep_certifies_compaction_windows():
    """A child killed at each compaction fence boundary; the recovered
    store must equal a legal pre/mid/post oracle with top-1 parity (the
    full site list runs from ``python -m kakveda_tpu_torch.index.crashsweep``)."""
    from kakveda_tpu_torch.index.crashsweep import run_sweep

    out = run_sweep(rows=6, aged=3, sites=("gfkb.compact_fence", "gfkb.compact_swap"), device="cpu")
    assert out["corrupt_recoveries"] == 0, out["failures"]
    assert out["kill_points"] >= 2 and out["sites"] == {"gfkb.compact_fence": 1, "gfkb.compact_swap": 1}
    assert out["stable_queries"] and out["device"] == "cpu"


# ---------------------------------------------------------------------------
# the fault harness, against the JAX one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,seed", [
    ("t.site:1.0:3", 0), ("t.site:0.5:-1", 7), ("t.site:0.25:5,t.other", 3), ("t.site:1.0:0", 0),
])
def test_fault_specs_fire_alike_in_both_packages(spec, seed):
    fired = []
    for _, fmod in PAIR:
        sites = [fmod.site("t.site"), fmod.site("t.other")]
        fmod.arm(spec, seed=seed)
        seq = []
        for _ in range(40):
            for s in sites:
                try:
                    s.fire()
                    seq.append(0)
                except fmod.FaultInjected as e:
                    assert e.site == s.name
                    seq.append(1)
        fired.append((seq, sorted(fmod.armed_sites())))
        fmod.disarm()
    assert fired[1] == fired[0]
    assert not faults.armed_sites()


def test_bad_fault_specs_raise_alike():
    for _, fmod in PAIR:
        with pytest.raises(ValueError, match="bad"):
            fmod.arm("x.site:notaprob")
        with pytest.raises(ValueError, match="bad"):
            fmod.arm_crash("x.site:notanint")


@pytest.mark.parametrize("nth", [1, 3])
def test_crash_point_from_the_env_exits_137_at_the_nth_pass(nth):
    code = (
        "from kakveda_tpu_torch.core import faults\n"
        "s = faults.site('gfkb.compact_fence')\n"
        "for i in range(5):\n"
        "    print(i, flush=True)\n"
        "    s.fire()\n"
    )
    env = dict(os.environ, KAKVEDA_FAULTS_CRASH=f"gfkb.compact_fence:{nth}",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=60)
    assert r.returncode == 137
    assert r.stdout.split() == [str(i) for i in range(nth)]
    assert f"kakveda crash point: gfkb.compact_fence pass {nth}" in r.stderr
