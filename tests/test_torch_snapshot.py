"""The port's GFKB snapshot and restore against the JAX package's, on the CPU.

Each case runs the same inputs through both packages (the JAX GFKB on a
one-device mesh, so its ties go to the lowest slot as the port's do) with
both clocks pinned, and compares: records field for field, tombstones,
mining labels and ``match_batch`` ids and tie order exactly, scores within
1e-6 (f32 sums in another order). Twins of ``tests/test_gfkb.py``'s
snapshot cases, ``tests/test_mine_incremental.py``'s snapshot-v4 cases and
``tests/test_chaos.py``'s snapshot cases, plus data dirs crossing between
the packages both ways.
"""

import json
import shutil
from datetime import datetime, timezone

import numpy as np
import pytest

import kakveda_tpu.index.gfkb as jax_gfkb_mod
import kakveda_tpu_torch.index.gfkb as port_gfkb_mod
from kakveda_tpu.core import faults as jax_faults
from kakveda_tpu.index.gfkb import GFKB as JaxGFKB
from kakveda_tpu.ops.featurizer import HashedNGramFeaturizer as JaxFeaturizer
from kakveda_tpu.parallel.mesh import create_mesh
from kakveda_tpu.pipeline.patterns import PatternDetector as JaxDetector
from kakveda_tpu_torch.core import faults
from kakveda_tpu_torch.core.schemas import Severity
from kakveda_tpu_torch.index.gfkb import GFKB
from kakveda_tpu_torch.ops.clustering import cluster_embeddings
from kakveda_tpu_torch.ops.featurizer import HashedNGramFeaturizer
from kakveda_tpu_torch.pipeline.patterns import PatternDetector

SCORE_TOL = 1e-6
TS = datetime(2026, 1, 2, 3, 4, 5, 678901, tzinfo=timezone.utc)


@pytest.fixture(autouse=True)
def _pinned_clock_and_disarmed(monkeypatch):
    monkeypatch.setattr(jax_gfkb_mod, "utcnow", lambda: TS)
    monkeypatch.setattr(port_gfkb_mod, "utcnow", lambda: TS)
    faults.disarm()
    jax_faults.disarm()
    yield
    faults.disarm()
    jax_faults.disarm()


def _jax(path, capacity=256, dim=1024):
    return JaxGFKB(data_dir=path, mesh=create_mesh("data:1"), capacity=capacity, dim=dim)


def _port(path, capacity=256, dim=1024):
    return GFKB(data_dir=path, capacity=capacity, dim=dim, device="cpu")


def _open(kind, path, **kw):
    return (_jax if kind == "jax" else _port)(path, **kw)


def _seed(g, n, tag="s"):
    g.upsert_failures_batch([
        {
            "failure_type": "HALLUCINATION_CITATION",
            "signature_text": f"intent:citations_required | {tag} doc {i} references",
            "app_id": f"app-{i % 5}",
            "impact_severity": "medium",
        }
        for i in range(n)
    ])


def _upsert(g, i, app="app-A", ftype=None):
    return g.upsert_failure(
        failure_type=ftype or ("oom" if i % 2 else "timeout"),
        signature_text=f"failure memory signature {i} worker pool {i % 4}",
        app_id=app, impact_severity=Severity.high,
    )


def _records(g):
    with g._lock:
        return [r.model_dump(mode="json") for r in g._records]


def _tombs(g):
    with g._lock:
        return {g._records[s].failure_id: reason for s, reason in g._tombstoned.items()}


def _assert_same_matches(a, b, queries, **kw):
    ma, mb = a.match_batch(queries, **kw), b.match_batch(queries, **kw)
    assert len(ma) == len(mb)
    for x, y in zip(ma, mb):
        assert [(m.failure_id, m.version, m.failure_type) for m in x] == [
            (m.failure_id, m.version, m.failure_type) for m in y
        ]
        for m, n in zip(x, y):
            assert m.score == pytest.approx(n.score, abs=SCORE_TOL)


def _assert_same_store(a, b, queries):
    assert _records(a) == _records(b)
    assert _tombs(a) == _tombs(b)
    assert a.lifecycle_info()["compact_generation"] == b.lifecycle_info()["compact_generation"]
    _assert_same_matches(a, b, queries)


# ---------------------------------------------------------------------------
# the fault: a compacted (or tombstoned) JAX data dir opened by the port
# ---------------------------------------------------------------------------


def test_port_opens_a_compacted_jax_dir(tmp_path):
    d = tmp_path / "d"
    j = _jax(d, capacity=64, dim=256)
    for i in range(10):
        _upsert(j, i)
    j.compact()
    _upsert(j, 10)
    j.close()
    twin = tmp_path / "twin"
    shutil.copytree(d, twin)

    p = _port(d, capacity=64, dim=256)
    assert p.count == 11
    assert p.lifecycle_info()["restore"]["rows"] == 10
    queries = [f"failure memory signature {i} worker pool {i % 4}" for i in (0, 3, 7, 10)]
    jt = _jax(twin, capacity=64, dim=256)
    _assert_same_store(p, jt, queries)
    rec, created = _upsert(p, 11)
    jrec, _ = _upsert(jt, 11)
    assert created and rec.failure_id == jrec.failure_id == "F-0012"
    p.close()
    jt.close()

    j2 = _jax(d, capacity=64, dim=256)  # the JAX package reopens what the port wrote
    ids = [r.failure_id for r in j2.list_failures()]
    assert len(ids) == 12 and len(set(ids)) == 12
    p2 = _port(d, capacity=64, dim=256)
    _assert_same_store(p2, j2, queries + ["failure memory signature 11 worker pool 3"])
    p2.close()
    j2.close()


def test_port_opens_a_jax_dir_with_tombstones(tmp_path):
    d = tmp_path / "d"
    j = _jax(d, capacity=64, dim=256)
    for i in range(10):
        _upsert(j, i)
    assert j.age_rows(ttl_s=100, now=TS.timestamp() + 10_000)["tombstoned"] == 10
    _upsert(j, 4, app="app-back")  # organic resurrection
    j.close()
    assert (d / "tombstones.jsonl").exists() and not (d / "snapshot").exists()

    p = _port(d, capacity=64, dim=256)
    assert p.lifecycle_info()["tombstoned"] == 9
    j2 = _jax(d, capacity=64, dim=256)
    queries = [f"failure memory signature {i} worker pool {i % 4}" for i in range(10)]
    _assert_same_store(p, j2, queries)
    hits = p.match_batch(queries)
    live = {m.failure_id for row in hits for m in row}
    assert live == {"F-0005"}  # only the resurrected row ever answers
    p.close()
    j2.close()


# ---------------------------------------------------------------------------
# twins of tests/test_gfkb.py's snapshot cases
# ---------------------------------------------------------------------------


def test_snapshot_restore_and_tail_replay_matches_jax(tmp_path, monkeypatch):
    for kind in ("jax", "port"):
        g = _open(kind, tmp_path / kind, capacity=512)
        _seed(g, 100, "base")
        g.snapshot()
        _seed(g, 20, "tail")  # written after the snapshot
        g.close()

    calls = {"jax": [], "port": []}
    for kind, cls in (("jax", JaxFeaturizer), ("port", HashedNGramFeaturizer)):
        orig = cls.encode_batch_sparse

        def counting(self, texts, _orig=orig, _calls=calls[kind]):
            _calls.append(len(texts))
            return _orig(self, texts)

        monkeypatch.setattr(cls, "encode_batch_sparse", counting)
    j, p = _jax(tmp_path / "jax", capacity=512), _port(tmp_path / "port", capacity=512)
    assert sum(calls["port"]) == sum(calls["jax"]) == 20  # the tail only
    assert p.count == j.count == 120
    assert p.type_aggregate("HALLUCINATION_CITATION") == j.type_aggregate("HALLUCINATION_CITATION")
    info = p.lifecycle_info()["restore"]
    assert info["rows"] == 100 and info["log_offset"] > 0
    _assert_same_store(p, j, [f"intent:citations_required | {t} doc 7 references" for t in ("base", "tail")])
    p.close()
    j.close()


def test_snapshot_invalidated_by_log_rewrite_matches_jax(tmp_path):
    for kind in ("jax", "port"):
        g = _open(kind, tmp_path / kind)
        _seed(g, 30)
        g.snapshot()
        g.close()
        lines = (tmp_path / kind / "failures.jsonl").read_text().splitlines()
        (tmp_path / kind / "failures.jsonl").write_text("\n".join(lines[:10]) + "\n")
    j, p = _jax(tmp_path / "jax"), _port(tmp_path / "port")
    assert p.count == j.count == 10  # stale snapshot refused, full replay
    assert p.lifecycle_info()["restore"] == {"rows": 0, "reason": "log shorter than the snapshot's offset"}
    _assert_same_store(p, j, ["intent:citations_required | s doc 3 references"])
    p.close()
    j.close()


def test_snapshot_tail_update_of_snapshotted_record_matches_jax(tmp_path):
    for kind in ("jax", "port"):
        g = _open(kind, tmp_path / kind)
        for app in ("app-A", "app-B"):
            g.upsert_failure(
                failure_type="HALLUCINATION_CITATION", signature_text="sig one citations",
                app_id=app, impact_severity=Severity.medium,
            )
            if app == "app-A":
                g.snapshot()  # the version bump of the SAME record lands in the tail
        g.close()
    j, p = _jax(tmp_path / "jax"), _port(tmp_path / "port")
    rec = p.list_failures()[0]
    assert p.count == 1 and rec.version == 2 and sorted(rec.affected_apps) == ["app-A", "app-B"]
    assert p.lifecycle_info()["restore"]["rows"] == 1
    _assert_same_store(p, j, ["sig one citations"])
    p.close()
    j.close()


def test_reopen_after_log_outgrows_capacity_matches_jax(tmp_path):
    for kind in ("jax", "port"):
        g = _open(kind, tmp_path / kind, capacity=8, dim=256)
        for i in range(30):
            g.upsert_failure(
                failure_type=f"T{i % 3}", signature_text=f"grown record {i} topic {i * 11}",
                app_id=f"a{i % 2}", impact_severity=Severity.low,
            )
        if kind == "port":
            g.snapshot()
        g.close()
    shutil.copytree(tmp_path / "port" / "snapshot", tmp_path / "jax" / "snapshot-port")
    j, p = _jax(tmp_path / "jax", capacity=8, dim=256), _port(tmp_path / "port", capacity=8, dim=256)
    assert p.count == j.count == 30 and p.lifecycle_info()["restore"]["rows"] == 30
    q = ["grown record 17 topic 187"]
    m = p.match(q[0], failure_type="T2", type_filter="pre")
    assert m and m[0].score > 0.9 and m[0].failure_type == "T2"
    _assert_same_matches(p, j, q, failure_type="T2", type_filter="pre")
    _assert_same_store(p, j, q)
    p.close()
    j.close()


@pytest.mark.parametrize("damage", ["none", "truncated_rows", "wrong_dtype", "missing_file"])
def test_snapshot_sparse_files_and_corruption_fallback_matches_jax(tmp_path, damage):
    sds = {}
    for kind in ("jax", "port"):
        g = _open(kind, tmp_path / kind)
        _seed(g, 40)
        sds[kind] = g.snapshot()
        g.close()
    # The payload is the reference's, file for file.
    jd, pd = sds["jax"], sds["port"]
    assert not (pd / "vectors.npy").exists()
    ji, pi = np.load(jd / "sparse_idx.npy"), np.load(pd / "sparse_idx.npy")
    assert pi.dtype == np.int32 and np.array_equal(pi, ji)
    assert np.allclose(np.load(pd / "sparse_val.npy"), np.load(jd / "sparse_val.npy"), atol=SCORE_TOL, rtol=0)
    assert (pd / "records.jsonl").read_bytes() == (jd / "records.jsonl").read_bytes()
    assert np.array_equal(np.load(pd / "clusters.npy"), np.load(jd / "clusters.npy"))
    jm, pm = json.loads((jd / "manifest.json").read_text()), json.loads((pd / "manifest.json").read_text())
    # The tiers section too: the router state is the reference's, bit for bit.
    assert {k: v for k, v in pm.items() if k not in ("checksum", "mine")} == {
        k: v for k, v in jm.items() if k not in ("checksum", "mine")
    }
    assert pm["tiers"] == {"n": 40, "hot": 40, "checksum": jm["tiers"]["checksum"]}
    for name in ("centroids.npy", "tier_assign.npy"):
        assert (pd / name).read_bytes() == (jd / name).read_bytes()
    assert pm["mine"]["n"] == jm["mine"]["n"] and pm["mine"]["threshold"] == jm["mine"]["threshold"]
    assert pm["checksum"] == GFKB._snapshot_checksum(pd)

    for sd in jd, pd:
        idx = np.load(sd / "sparse_idx.npy")
        if damage == "truncated_rows":
            np.save(sd / "sparse_idx.npy", idx[:10])
        elif damage == "wrong_dtype":
            np.save(sd / "sparse_val.npy", np.zeros((40, idx.shape[1]), np.float64))
        elif damage == "missing_file":
            (sd / "sparse_val.npy").unlink()
    j, p = _jax(tmp_path / "jax"), _port(tmp_path / "port")
    assert p.count == j.count == 40
    restore = p.lifecycle_info()["restore"]
    assert (restore["rows"] == 40) if damage == "none" else (restore["rows"] == 0 and restore["reason"])
    _assert_same_store(p, j, ["intent:citations_required | s doc 7 references"])
    p.close()
    j.close()


def test_reload_drops_the_snapshot_and_replays_like_jax(tmp_path):
    for kind in ("jax", "port"):
        g = _open(kind, tmp_path / kind)
        _seed(g, 12)
        g.snapshot()
        lines = g.failures_path.read_text().splitlines()
        g.failures_path.write_text("\n".join(lines[:5]) + "\n")  # an external purge
        g.reload()
        assert not (tmp_path / kind / "snapshot").exists() and g.count == 5
        _seed(g, 7)
        g.close()
    j, p = _jax(tmp_path / "jax"), _port(tmp_path / "port")
    assert p.count == j.count == 7
    _assert_same_store(p, j, ["intent:citations_required | s doc 6 references"])
    p.close()
    j.close()


# ---------------------------------------------------------------------------
# twins of tests/test_mine_incremental.py's snapshot-v4 cases
# ---------------------------------------------------------------------------

_CORPUS = [
    ("HALLUCINATION_CITATION", "intent:citations_required | summarize the quarterly report", "app-A"),
    ("HALLUCINATION_CITATION", "intent:citations_required | summarize the quarterly report", "app-B"),
    ("TIMEOUT", "timeout while calling payments api attempt 0", "app-A"),
    ("TIMEOUT", "timeout while calling payments api attempt 1", "app-B"),
    ("TIMEOUT", "timeout while calling payments api attempt 2", "app-C"),
    ("SCHEMA", "schema violation missing field customer_id in response", "app-D"),
    ("SCHEMA", "schema violation missing field order_id in response", "app-E"),
]


def _seed_corpus(g):
    for ftype, sig, app in _CORPUS:
        g.upsert_failure(failure_type=ftype, signature_text=sig, app_id=app, impact_severity=Severity.medium)


def _label_parity(g):
    g.mine_drain()
    _, vecs = g.records_and_embeddings()
    return np.array_equal(g._mine.labels(), cluster_embeddings(vecs, threshold=0.6))


def test_snapshot_restores_cluster_state_matches_jax(tmp_path):
    labels = {}
    for kind in ("jax", "port"):
        g = _open(kind, tmp_path / kind)
        _seed_corpus(g)
        g.mine_drain()
        labels[kind] = g._mine.labels()
        g.snapshot()
        g.close()
    assert np.array_equal(labels["port"], labels["jax"])
    j, p = _jax(tmp_path / "jax"), _port(tmp_path / "port")
    assert p.mine_usable(0.6) and j.mine_usable(0.6), p.mine_state_info()
    assert np.array_equal(p._mine.labels(), labels["port"])
    for g in (j, p):  # a post-restore ingest keeps attaching incrementally
        g.upsert_failure(
            failure_type="TIMEOUT", signature_text="timeout while calling payments api attempt 4",
            app_id="app-F", impact_severity=Severity.medium,
        )
    assert _label_parity(p)
    j.mine_drain()
    assert np.array_equal(p._mine.labels(), j._mine.labels())
    assert _records(p) == _records(j)
    p.close()
    j.close()


def test_log_tail_beyond_snapshot_degrades_to_full_remine_matches_jax(tmp_path):
    for kind in ("jax", "port"):
        g = _open(kind, tmp_path / kind)
        _seed_corpus(g)
        g.snapshot()
        g.upsert_failure(
            failure_type="SCHEMA", signature_text="tail row after the snapshot",
            app_id="app-T", impact_severity=Severity.medium,
        )
        g.close()
    j, p = _jax(tmp_path / "jax"), _port(tmp_path / "port")
    assert not p.mine_usable(0.6) and not j.mine_usable(0.6)
    (jp, jinfo), (pp, pinfo) = JaxDetector(j).mine_patterns_ex(0.6), PatternDetector(p).mine_patterns_ex(0.6)
    assert pinfo["mode"] == jinfo["mode"] == "full"  # and the sweep re-seeds:
    assert p.mine_usable(0.6) and j.mine_usable(0.6)
    assert [(x.name, x.failure_ids, x.affected_apps) for x in pp] == [
        (x.name, x.failure_ids, x.affected_apps) for x in jp
    ]
    assert np.array_equal(p._mine.labels(), j._mine.labels())
    p.close()
    j.close()


def test_corrupt_cluster_snapshot_degrades_to_full_remine_only_matches_jax(tmp_path):
    for kind in ("jax", "port"):
        g = _open(kind, tmp_path / kind)
        _seed_corpus(g)
        g.mine_drain()
        g.snapshot()
        g.close()
        cl = tmp_path / kind / "snapshot" / "clusters.npy"
        cl.write_bytes(cl.read_bytes()[:-7] + b"garbage")
    j, p = _jax(tmp_path / "jax"), _port(tmp_path / "port")
    assert p.count == j.count == 6
    assert p.lifecycle_info()["restore"]["rows"] == 6  # the record restore is untouched
    assert p.mine_state_info()["stale"] and j.mine_state_info()["stale"]
    (_, jinfo), (_, pinfo) = JaxDetector(j).mine_patterns_ex(0.6), PatternDetector(p).mine_patterns_ex(0.6)
    assert pinfo["mode"] == jinfo["mode"] == "full"
    assert _label_parity(p)
    assert np.array_equal(p._mine.labels(), j._mine.labels())
    p.close()
    j.close()


# ---------------------------------------------------------------------------
# twins of tests/test_chaos.py's snapshot cases
# ---------------------------------------------------------------------------


def _seed_chaos(g, n):
    for i in range(n):
        g.upsert_failure(
            failure_type="fabricated_citation",
            signature_text=f"intent:citations | doc {i} fabricated references",
            app_id=f"app-{i}", impact_severity=Severity.high,
        )


@pytest.mark.chaos
def test_snapshot_checksum_corruption_degrades_to_full_replay_matches_jax(tmp_path):
    for kind in ("jax", "port"):
        g = _open(kind, tmp_path / kind, capacity=64, dim=256)
        _seed_chaos(g, 4)
        sd = g.snapshot()
        g.close()
        manifest = json.loads((sd / "manifest.json").read_text())
        assert manifest["version"] == GFKB._SNAPSHOT_VERSION == JaxGFKB._SNAPSHOT_VERSION
        val = np.load(sd / "sparse_val.npy")
        np.save(sd / "sparse_val.npy", val + 1.0)  # same shape and dtype, wrong bytes
    j, p = _jax(tmp_path / "jax", capacity=64, dim=256), _port(tmp_path / "port", capacity=64, dim=256)
    assert p.count == j.count == 4
    assert p.lifecycle_info()["restore"] == {"rows": 0, "reason": "content checksum mismatch"}
    _assert_same_store(p, j, ["intent:citations | doc 2 fabricated references"])
    p.close()
    j.close()


@pytest.mark.chaos
def test_snapshot_write_fault_preserves_previous_snapshot_matches_jax(tmp_path):
    for kind, fmod in (("jax", jax_faults), ("port", faults)):
        g = _open(kind, tmp_path / kind, capacity=64, dim=256)
        _seed_chaos(g, 2)
        sd = g.snapshot()
        first = json.loads((sd / "manifest.json").read_text())
        _seed_chaos(g, 3)
        fmod.arm("gfkb.snapshot:1:1")
        with pytest.raises(fmod.FaultInjected):
            g.snapshot()
        assert json.loads((sd / "manifest.json").read_text()) == first
        assert g._snapshot_checksum(sd) == first["checksum"]
        assert not list((tmp_path / kind).glob(".snapshot-*"))
        fmod.disarm()
        g.snapshot()  # and a later attempt succeeds
        g.close()
    j, p = _jax(tmp_path / "jax", capacity=64, dim=256), _port(tmp_path / "port", capacity=64, dim=256)
    assert p.lifecycle_info()["restore"]["rows"] == 3
    _assert_same_store(p, j, ["intent:citations | doc 1 fabricated references"])
    p.close()
    j.close()


# ---------------------------------------------------------------------------
# data dirs crossing between the packages
# ---------------------------------------------------------------------------

_STATES = ("snapshot", "compacted", "aged", "collapsed")


def _cross_queries():
    return [f"timeout while calling payments api attempt {i}" for i in range(4)] + [
        f"failure memory signature {i} worker pool {i % 4}" for i in range(8)
    ]


def _build(g, state):
    """One lifecycle state through the public calls (the same in both packages)."""
    _seed_corpus(g)
    for i in range(8):
        _upsert(g, i, app=f"app-{i % 3}")
    _upsert(g, 2, app="app-x")  # a version bump
    if state == "aged":
        g.age_rows(ttl_s=100, now=TS.timestamp() + 10_000)
        _upsert(g, 5, app="app-back")  # resurrected
    elif state == "collapsed":
        assert g.collapse_duplicates(min_cluster=2)["collapsed"] > 0
    if state == "compacted":
        g.snapshot()
        _upsert(g, 6, app="app-y")
        g.compact()
        _upsert(g, 3, app="app-z")  # a delta line past the checkpoint: a version bump
    else:
        g.snapshot()
    g.close()


@pytest.mark.parametrize("state", _STATES)
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_data_dir_crosses_between_packages(tmp_path, state, writer, reader):
    d = tmp_path / "d"
    _build(_open(writer, d), state)
    shutil.copytree(d, tmp_path / "own")
    own = _open(writer, tmp_path / "own")  # the writer's own reopen is the oracle
    other = _open(reader, d)
    port = other if reader == "port" else own
    assert port.lifecycle_info()["restore"]["rows"] > 0  # the restore path, not a replay
    assert other.mine_usable(0.6) and own.mine_usable(0.6)
    assert np.array_equal(other._mine.labels(), own._mine.labels())
    if state in ("aged", "collapsed"):
        assert _tombs(other)
    _assert_same_store(other, own, _cross_queries())
    # and both keep writing the same way after the crossing
    for g in (other, own):
        _upsert(g, 20, app="app-after")
        g.close()
    again_other, again_own = _open(reader, d), _open(writer, tmp_path / "own")
    _assert_same_store(again_other, again_own, _cross_queries())
    again_other.close()
    again_own.close()


def test_applied_events_log_through_snapshot_and_compaction_equals_jax(tmp_path):
    """Replication's dedup log through snapshots, compaction and appends:
    the port reads it (so it fences ``evt-1`` itself), and after the same
    calls through both packages, and a reopen that compacts the log, it
    is byte-equal to what the JAX package writes, and the JAX package
    still fences both events."""
    row = {"failure_type": "oom", "signature_text": "replicated failure row one",
           "app_id": "app-peer", "impact_severity": "high"}
    row2 = {**row, "signature_text": "replicated failure row two"}
    logs = {}
    for kind in ("jax", "port"):
        d = tmp_path / kind
        j = _jax(d, capacity=64, dim=256)
        assert j.apply_replication([row], event_id="evt-1") == 1
        j.close()
        g = _open(kind, d, capacity=64, dim=256)
        assert g.apply_replication([row], event_id="evt-1") == 0  # fenced
        _upsert(g, 1)
        g.snapshot()
        g.compact()
        _upsert(g, 2)
        assert g.apply_replication([row2], event_id="evt-2") == 1
        g.close()
        logs[kind] = (d / "applied_events.jsonl").read_bytes()
    assert logs["port"] == logs["jax"]
    j2 = _jax(tmp_path / "port", capacity=64, dim=256)
    assert j2.apply_replication([row], event_id="evt-1") == 0  # still fenced
    assert j2.apply_replication([row2], event_id="evt-2") == 0
    assert j2.count == 4
    j2.close()


def test_restore_of_a_tiered_jax_snapshot_puts_every_row_on_the_card(tmp_path, monkeypatch):
    """A JAX store past its hot cap snapshots its overflow rows from the
    host tiers, with a router section; the port ignores the router files
    and restores every row onto its index."""
    monkeypatch.setenv("KAKVEDA_GFKB_HOT_ROWS", "16")
    d = tmp_path / "d"
    j = _jax(d, capacity=16, dim=256)
    for i in range(40):
        _upsert(j, i, app=f"app-{i % 3}")
    j.snapshot()
    j.close()
    monkeypatch.delenv("KAKVEDA_GFKB_HOT_ROWS")
    p = _port(d, capacity=16, dim=256)
    assert p.count == 40 and p.lifecycle_info()["restore"]["rows"] == 40
    assert p._knn.capacity >= 40 and bool(p._valid[:40].all())
    for i in (3, 20, 39):
        q = f"failure memory signature {i} worker pool {i % 4}"
        assert p.match(q)[0].failure_id == f"F-{i + 1:04d}"
    p.close()
