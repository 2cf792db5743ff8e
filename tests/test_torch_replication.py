"""The port's GFKB replication against the JAX package's, on the CPU.

Twins of the replication cases of ``tests/test_fleet.py``,
``tests/test_ownership.py`` and ``tests/test_lifecycle.py``: the same
calls through both GFKBs (the JAX one on a one-device mesh, both clocks
pinned) return the same counts and leave the same records, the same
``applied_events.jsonl`` (byte for byte), the same tombstones and the same
matches (ids and tie order exactly, scores within 1e-6): idempotent apply
across a restart, the tombstone fence, the applied log's start-up
compaction with its stale temp and its opt-out, ``export_rows`` and
``shard_key_counts`` over the same data dir, and an applied log written by
either package fencing the same events in the other.
"""

import json
import time
from datetime import datetime, timezone

import pytest

import kakveda_tpu.index.gfkb as jax_gfkb_mod
import kakveda_tpu_torch.index.gfkb as port_gfkb_mod
from kakveda_tpu.index.gfkb import GFKB as JaxGFKB
from kakveda_tpu.parallel.mesh import create_mesh
from kakveda_tpu_torch.core import metrics
from kakveda_tpu_torch.core.schemas import Severity
from kakveda_tpu_torch.index.gfkb import GFKB

SCORE_TOL = 1e-6
TS = datetime(2026, 1, 2, 3, 4, 5, 678901, tzinfo=timezone.utc)


@pytest.fixture(autouse=True)
def _pinned_clock(monkeypatch):
    monkeypatch.setattr(jax_gfkb_mod, "utcnow", lambda: TS)
    monkeypatch.setattr(port_gfkb_mod, "utcnow", lambda: TS)


def _open(kind, d, **kw):
    kw.setdefault("capacity", 128)
    kw.setdefault("dim", 512)
    if kind == "jax":
        return JaxGFKB(data_dir=d, mesh=create_mesh("data:1"), **kw)
    return GFKB(data_dir=d, device="cpu", **kw)


def _rows(n, tag, app_of=lambda i: f"app-{i % 4}"):
    return [
        {
            "failure_type": "TIMEOUT",
            "signature_text": f"{tag} timeout calling service {i}",
            "app_id": app_of(i),
            "impact_severity": "medium",
            "context_signature": {},
            "root_cause": None,
            "resolution": None,
        }
        for i in range(n)
    ]


def _records(g):
    with g._lock:
        return [r.model_dump(mode="json") for r in g._records]


def _assert_same(j, p, queries):
    assert _records(p) == _records(j)
    for x, y in zip(j.match_batch(queries), p.match_batch(queries)):
        assert [m.failure_id for m in x] == [m.failure_id for m in y]
        for a, b in zip(x, y):
            assert b.score == pytest.approx(a.score, abs=SCORE_TOL)


def _both(fn, tmp_path):
    """``fn(kind, dir)`` for each package in its own dir; both results."""
    return {kind: fn(kind, tmp_path / kind) for kind in ("jax", "port")}


def _counter(name, **labels):
    fam = metrics.get_registry().snapshot().get(name, {})
    key = ",".join(f"{k}={v}" for k, v in labels.items())
    for k, v in fam.get("series", {}).items():
        if k == key or (not labels and k == ""):
            return v
    return 0.0


def test_apply_replication_idempotent_across_restart(tmp_path):
    def script(kind, d):
        kb = _open(kind, d)
        out = [kb.apply_replication(_rows(4, "ev1"), "evt-1"),
               kb.apply_replication(_rows(4, "ev1"), "evt-1"), kb.count]
        kb.close()
        kb2 = _open(kind, d)  # the dedup set replays from applied_events.jsonl
        out += [kb2.count, kb2.apply_replication(_rows(4, "ev1"), "evt-1"),
                kb2.apply_replication(_rows(2, "ev2"), "evt-2"), kb2.count,
                [r.occurrences for r in kb2.list_failures()]]
        return out, kb2

    out = _both(script, tmp_path)
    assert out["port"][0] == out["jax"][0] == [4, 0, 4, 4, 0, 2, 6, [1] * 6]
    _assert_same(out["jax"][1], out["port"][1], ["ev1 timeout calling service 2", "ev2 timeout calling service 1"])
    assert (tmp_path / "port" / "applied_events.jsonl").read_bytes() == \
        (tmp_path / "jax" / "applied_events.jsonl").read_bytes()
    for _, kb in out.values():
        kb.close()


def test_replicated_rows_take_the_organic_path(tmp_path):
    """An applied row is matched, attached to the mining state and counted
    as a new record exactly as an organic one; a repeated signature under
    a new event id bumps occurrences and widens the app list."""
    before = _counter("kakveda_gfkb_replicate_apply_total", outcome="applied")

    def script(kind, d):
        kb = _open(kind, d)
        kb.apply_replication(_rows(6, "org"), "e1")
        kb.apply_replication(_rows(2, "org", app_of=lambda i: "app-new"), "e2")
        return kb

    out = _both(script, tmp_path)
    j, p = out["jax"], out["port"]
    _assert_same(j, p, [f"org timeout calling service {i}" for i in range(6)])
    assert p.mine_state_info()["rows"] == 6
    assert [r.occurrences for r in p.list_failures()][:2] == [2, 2]
    assert p.list_failures()[0].affected_apps == ["app-0", "app-new"]
    assert _counter("kakveda_gfkb_replicate_apply_total", outcome="applied") == before + 2
    j.close()
    p.close()


def test_replicated_event_never_resurrects_tombstoned_row(tmp_path):
    fenced = _counter("kakveda_gfkb_replicate_apply_total", outcome="fenced")

    def script(kind, d):
        kb = _open(kind, d)
        kb.upsert_failures_batch(_rows(3, "tomb"))
        kb.age_rows(ttl_s=100, now=TS.timestamp() + 10_000)
        row = _rows(1, "tomb")[0]
        out = [kb.apply_replication([row], "evt-dlq-1"), kb.lifecycle_info()["tombstoned"],
               kb._records[0].occurrences]
        kb.close()
        kb2 = _open(kind, d)  # the fence holds after a restart
        out += [kb2.apply_replication([row], "evt-dlq-2"), kb2.lifecycle_info()["tombstoned"]]
        rec, _ = kb2.upsert_failure(failure_type="TIMEOUT", signature_text=row["signature_text"],
                                    app_id="app-peer", impact_severity=Severity.medium)
        out += [rec.occurrences, kb2.lifecycle_info()["tombstoned"]]
        return out, kb2

    out = _both(script, tmp_path)
    assert out["port"][0] == out["jax"][0] == [0, 3, 1, 0, 3, 2, 2]
    assert _counter("kakveda_gfkb_replicate_apply_total", outcome="fenced") == fenced + 2
    _assert_same(out["jax"][1], out["port"][1], ["tomb timeout calling service 0"])
    for _, kb in out.values():
        kb.close()


@pytest.mark.parametrize("compact", ["1", "0"])
def test_applied_log_startup_compaction_and_opt_out(tmp_path, monkeypatch, compact):
    monkeypatch.setenv("KAKVEDA_GFKB_APPLIED_MAX", "8")
    monkeypatch.setenv("KAKVEDA_GFKB_APPLIED_COMPACT", compact)

    def script(kind, d):
        kb = _open(kind, d)
        for i in range(20):
            kb.apply_replication(_rows(1, f"ev{i}"), f"evt-{i}")
        kb.close()
        kb2 = _open(kind, d)
        lines = (d / "applied_events.jsonl").read_text().splitlines()
        out = [len(lines), json.loads(lines[-1])["id"], kb2.apply_replication(_rows(1, "ev19"), "evt-19"),
               kb2.apply_replication(_rows(1, "ev0"), "evt-0"), kb2.count]
        kb2.close()
        return out

    out = _both(script, tmp_path)
    assert out["port"] == out["jax"]
    # Compacted to the retained FIFO tail (recent ids still dedup; an
    # evicted one re-applies as an occurrence bump), or left whole.
    assert out["port"] == ([8, "evt-19", 0, 1, 20] if compact == "1" else [20, "evt-19", 0, 1, 20])
    assert (tmp_path / "port" / "applied_events.jsonl").read_bytes() == \
        (tmp_path / "jax" / "applied_events.jsonl").read_bytes()


def test_applied_log_stale_tmp_removed_at_startup(tmp_path):
    def script(kind, d):
        kb = _open(kind, d)
        kb.apply_replication(_rows(1, "st"), "evt-stale-tmp")
        kb.close()
        stale = d / "applied_events.tmp"
        stale.write_text('{"id": "half-written')
        kb2 = _open(kind, d)
        out = [stale.exists(), kb2.apply_replication(_rows(1, "st"), "evt-stale-tmp"), kb2.count]
        kb2.close()
        return out

    out = _both(script, tmp_path)
    assert out["port"] == out["jax"] == [False, 0, 1]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_applied_log_crosses_between_the_packages(tmp_path, writer, reader):
    """A data dir whose events one package applied opens in the other with
    the same dedup set: the same ids fence, a new id applies."""
    d = tmp_path / "d"
    w = _open(writer, d)
    assert w.apply_replication(_rows(3, "x"), "evt-a") == 3
    assert w.apply_replication(_rows(2, "y"), "evt-b") == 2
    w.close()
    r = _open(reader, d)
    assert r.count == 5
    assert r.apply_replication(_rows(3, "x"), "evt-a") == 0
    assert r.apply_replication(_rows(2, "y"), "evt-b") == 0
    assert r.apply_replication(_rows(1, "z"), "evt-c") == 1
    assert [x.occurrences for x in r.list_failures()] == [1] * 6
    r.close()
    back = _open(writer, d)
    assert back.apply_replication(_rows(1, "z"), "evt-c") == 0 and back.count == 6
    back.close()


def test_export_rows_and_shard_key_counts_equal_the_jax_export(tmp_path):
    """Over one data dir written by the JAX package (a row two apps
    reported, a migration-shaped row carrying its app list, a tombstoned
    row), the port's export from 0 and from a watermark, and its per-key
    counts, equal the JAX package's."""
    d = tmp_path / "d"
    j = _open("jax", d)
    j.upsert_failures_batch(_rows(6, "exp", app_of=lambda i: f"app-{i % 3}"))
    j.upsert_failure(failure_type="TIMEOUT", signature_text="exp timeout calling service 0",
                     app_id="app-late", impact_severity=Severity.medium)
    mig = {**_rows(1, "mig")[0], "app_id": "app-9", "affected_apps": ["app-9", "app-8"]}
    assert j.apply_replication([mig], "mig-1") == 1
    j.close()
    with (d / "tombstones.jsonl").open("a") as f:
        f.write(json.dumps({"op": "tomb", "id": "F-0003", "reason": "aged", "ts": time.time()}) + "\n")
    out = {}
    for kind in ("jax", "port"):
        kb = _open(kind, d)
        out[kind] = (kb.export_rows(0), kb.export_rows(4), kb.shard_key_counts())
        kb.close()
    assert out["port"] == out["jax"]
    (rows, count), (tail, _), keys = out["port"]
    assert count == 7 and len(rows) == 6 and len(tail) == 3
    assert rows[0]["affected_apps"] == ["app-0", "app-late"] and rows[-1]["affected_apps"] == ["app-9", "app-8"]
    assert keys == {"app-0": 2, "app-1": 2, "app-9": 1, "app-2": 1}
