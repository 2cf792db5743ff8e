"""The port's incremental mining against the JAX package's.

* ``ClusterState`` / ``collapse_groups`` / ``centroids_from_sparse``: the
  same sequence of operations on both gives bit-identical labels,
  ``pop_dirty()`` and ``info()``; streamed through the delta top-k, the
  state equals the full sweep in the degree-cap regime, as in the JAX tests.
* The GFKB and ``PatternDetector``: port counterparts of the JAX package's
  tests of ingest-time attachment, dispatch accounting and mining modes
  (``tests/test_mine_incremental.py``), and one corpus through both GFKBs
  (the JAX one on a one-device mesh): equal labels, state counts and mined
  patterns. A replayed data dir (written by either package) is stale and
  mines a full sweep first; a delta that raises degrades, never fails.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kakveda_tpu.ops.incremental as jinc
import kakveda_tpu_torch.index.gfkb as tgfkb
import kakveda_tpu_torch.ops.incremental as tinc
from kakveda_tpu.core.schemas import Severity as JaxSeverity
from kakveda_tpu.index.gfkb import GFKB as JaxGFKB
from kakveda_tpu.ops.clustering import _corpus_pad
from kakveda_tpu.ops.clustering import cluster_embeddings as jax_cluster
from kakveda_tpu.parallel.mesh import create_mesh
from kakveda_tpu.pipeline.patterns import PatternDetector as JaxDetector
from kakveda_tpu_torch.core.schemas import Severity
from kakveda_tpu_torch.index.gfkb import GFKB
from kakveda_tpu_torch.ops.clustering import cluster_embeddings
from kakveda_tpu_torch.pipeline.patterns import PatternDetector


# ---------------------------------------------------------------------------
# ClusterState: both packages, same operations
# ---------------------------------------------------------------------------


def _clustered_corpus(rng, n_clusters, max_size, dim=64, jitter=0.04):
    rows = []
    for _ in range(n_clusters):
        c = rng.standard_normal(dim)
        c /= np.linalg.norm(c)
        for _ in range(int(rng.integers(1, max_size + 1))):
            w = c + jitter * rng.standard_normal(dim)
            rows.append(w / np.linalg.norm(w))
    return np.stack(rows).astype(np.float32)[rng.permutation(len(rows))]


def _stream(mod, vecs, threshold, k, batch):
    """Stream the corpus through one delta top-k per batch of ``mod``
    (either package) into that package's ClusterState."""
    n, dim = vecs.shape
    p = _corpus_pad(n)
    v_pad = np.concatenate([vecs, np.zeros((p - n, dim), np.float32)])
    as_arr = jnp.asarray if mod is jinc else torch.from_numpy
    v_dev = as_arr(v_pad)
    state = mod.ClusterState(threshold=threshold, k=k)
    for s in range(0, n, batch):
        e = min(s + batch, n)
        q = np.zeros((batch, dim), np.float32)
        q[: e - s] = vecs[s:e]
        sims, idx = mod.unpack_topk(mod.delta_topk_dense(as_arr(q), v_dev, e, k + 1), e - s)
        for r in range(e - s):
            state.add_row(s + r, "T", f"F-{s + r}", [f"app-{(s + r) % 3}"])
        for r in range(e - s):
            state.attach(s + r, idx[r], sims[r])
    return state


def _same_state(a, b):
    assert np.array_equal(a.labels(), b.labels())
    assert a.labels().dtype == b.labels().dtype == np.int32
    assert a.pop_dirty() == b.pop_dirty()
    assert a.info() == b.info()


@pytest.mark.parametrize("seed", range(6))
def test_streaming_state_matches_jax_and_the_sweep(seed):
    """Bit-identical states on randomized corpora and batch sizes; in the
    degree-cap regime both equal the full sweep exactly."""
    threshold, k = 0.6, 8
    rng = np.random.default_rng(seed)
    vecs = _clustered_corpus(rng, n_clusters=7, max_size=6)
    batch = int(rng.integers(3, 17))
    port = _stream(tinc, vecs, threshold, k, batch)
    ref = _stream(jinc, vecs, threshold, k, batch)
    sims = vecs @ vecs.T
    np.fill_diagonal(sims, 0.0)
    if (sims >= threshold).sum(axis=1).max() <= k:
        oracle = cluster_embeddings(vecs, threshold=threshold, device="cpu")
        assert np.array_equal(port.labels(), oracle)
        assert np.array_equal(oracle, jax_cluster(vecs, threshold=threshold))
    _same_state(port, ref)


def test_streaming_merge_of_bridged_groups():
    rng = np.random.default_rng(3)
    a = rng.standard_normal(64)
    a /= np.linalg.norm(a)
    b = rng.standard_normal(64)
    b /= np.linalg.norm(b)
    mid = (a + b) / np.linalg.norm(a + b)

    def jit(v):
        w = v + 0.03 * rng.standard_normal(64)
        return (w / np.linalg.norm(w)).astype(np.float32)

    vecs = np.stack([jit(a), jit(a), jit(b), jit(b), mid.astype(np.float32)])
    assert float(min(mid @ vecs[0], mid @ vecs[2])) >= 0.6  # the bridge clears the threshold
    port = _stream(tinc, vecs, 0.6, 8, 2)
    assert np.array_equal(port.labels(), cluster_embeddings(vecs, threshold=0.6, device="cpu"))
    assert len(np.unique(port.labels())) == 1
    _same_state(port, _stream(jinc, vecs, 0.6, 8, 2))


def _ops(state, rng):
    """A fixed random sequence of every mutation and read."""
    out = []
    n = 0
    for step in range(60):
        op = rng.integers(0, 6)
        if op <= 1 or n < 3:
            state.add_row(n, f"T{n % 3}", f"F-{n:04d}", [f"app-{n % 4}"])
            n += 1
        elif op == 2:
            slot = int(rng.integers(0, n))
            neigh = rng.integers(-1, n + 2, size=6)
            sims = rng.uniform(0.3, 1.0, size=6).astype(np.float32)
            sims[rng.integers(0, 6)] = -np.inf
            out.append(state.attach(slot, neigh, np.sort(sims)[::-1]))
        elif op == 3:
            state.note_apps(int(rng.integers(0, n + 1)), [f"app-{rng.integers(0, 6)}"])
        elif op == 4:
            out.append((state.labels().tolist(), state.pop_dirty(), state.info()))
        elif step == 41:
            labels = np.arange(n, dtype=np.int32)
            labels[1::2] = 0
            state.seed(labels, [("T0", f"F-{i:04d}", [f"app-{i % 2}"]) for i in range(n)], threshold=0.55)
        else:
            out.append((state.n_clusters, state.n_clusters_cached(), state.n_rows))
    state.add_row(n + 1)  # a gap latches stale
    out.append(state.info())
    return out


def test_cluster_state_operation_sequence_is_bit_identical():
    for seed in range(3):
        a = _ops(tinc.ClusterState(threshold=0.6, k=3), np.random.default_rng(seed))
        b = _ops(jinc.ClusterState(threshold=0.6, k=3), np.random.default_rng(seed))
        assert a == b, seed


def test_pop_dirty_only_touched_clusters():
    st = tinc.ClusterState(threshold=0.9, k=4)
    st.seed(np.zeros(3, np.int32), [("T", f"F-{i}", [f"a{i}"]) for i in range(3)])
    assert st.pop_dirty() == []
    st.add_row(3, "T", "F-3", ["a3"])
    st.attach(3, [0], [0.95])
    dirty = st.pop_dirty()
    assert [d["label"] for d in dirty] == [0]
    assert dirty[0]["n"] == 4 and "F-3" in dirty[0]["fids"]
    assert st.pop_dirty() == []


def test_cluster_state_rejects_slot_gaps():
    st = tinc.ClusterState(threshold=0.6, k=4)
    st.add_row(0)
    st.add_row(2)
    assert st.stale and "non-contiguous" in st.stale_reason


def test_collapse_groups_and_centroids_match_jax():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 12, size=300).astype(np.int32)
    exclude = rng.integers(0, 300, size=40)
    for min_size in (1, 2, 5):
        assert tinc.collapse_groups(labels, min_size, exclude) == jinc.collapse_groups(labels, min_size, exclude)
    dim = 64
    idx = rng.integers(0, dim + 1, size=(300, 9)).astype(np.int32)  # dim = a pad feature
    val = rng.standard_normal((300, 9)).astype(np.float32)

    def rows_fn(slots):
        return idx[slots], val[slots]

    a = tinc.centroids_from_sparse(labels, rows_fn, dim, chunk=64)
    b = jinc.centroids_from_sparse(labels, rows_fn, dim, chunk=64)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y


# ---------------------------------------------------------------------------
# GFKB wiring (port counterparts of the JAX package's tests)
# ---------------------------------------------------------------------------


def _mk(tmp_path, **kw):
    kw.setdefault("capacity", 256)
    kw.setdefault("dim", 1024)
    return GFKB(data_dir=tmp_path / "data", device="cpu", **kw)


def _mk_jax(tmp_path, **kw):
    kw.setdefault("capacity", 256)
    kw.setdefault("dim", 1024)
    return JaxGFKB(data_dir=tmp_path / "jax", mesh=create_mesh("data:1"), **kw)


_CORPUS = [
    ("HALLUCINATION_CITATION", "intent:citations_required | summarize the quarterly report", "app-A"),
    ("HALLUCINATION_CITATION", "intent:citations_required | summarize the quarterly report", "app-B"),
    ("TIMEOUT", "timeout while calling payments api attempt 0", "app-A"),
    ("TIMEOUT", "timeout while calling payments api attempt 1", "app-B"),
    ("TIMEOUT", "timeout while calling payments api attempt 2", "app-C"),
    ("SCHEMA", "totally different failure shape xyz", "app-D"),
]


def _seed_corpus(g, sev=Severity):
    for ftype, sig, app in _CORPUS:
        g.upsert_failure(failure_type=ftype, signature_text=sig, app_id=app, impact_severity=sev.medium)


def _label_parity(g, threshold=0.6):
    g.mine_drain()
    _, vecs = g.records_and_embeddings()
    return np.array_equal(g._mine.labels(), cluster_embeddings(vecs, threshold=threshold))


def _key(pats):
    return {(p.name, tuple(p.failure_ids), tuple(sorted(p.affected_apps)), p.description) for p in pats}


def test_gfkb_ingest_attachment_matches_full_sweep(tmp_path):
    g = _mk(tmp_path)
    _seed_corpus(g)
    assert _label_parity(g)
    info = g.mine_state_info()
    assert info["enabled"] and not info["stale"] and info["covers_all_rows"]
    assert info["delta_dispatches"] == len(_CORPUS) - 1  # one record repeats
    records, vecs = g.records_and_embeddings()
    assert len(records) == 5 and isinstance(vecs, torch.Tensor) and vecs.shape == (5, 1024)
    g.close()


def test_mine_patterns_incremental_equals_full(tmp_path):
    def run(base, mode):
        g = _mk(base)
        det = PatternDetector(g)
        _seed_corpus(g)
        pats, info = det.mine_patterns_ex(0.6, mode)
        g.close()
        return _key(pats), info

    inc, inc_info = run(tmp_path / "inc", "auto")
    full, full_info = run(tmp_path / "full", "full")
    assert inc_info["mode"] == "incremental" and full_info["mode"] == "full"
    assert inc == full and inc
    assert inc_info["wall_ms"] >= 0 and inc_info["covers_all_rows"]


def test_incremental_mine_reemits_only_dirty_clusters(tmp_path):
    g = _mk(tmp_path)
    det = PatternDetector(g)
    _seed_corpus(g)
    first, info = det.mine_patterns_ex(0.6)
    assert info["mode"] == "incremental" and first
    again, info = det.mine_patterns_ex(0.6)
    assert info["mode"] == "incremental" and again == []
    g.upsert_failure(
        failure_type="TIMEOUT", signature_text="timeout while calling payments api attempt 3",
        app_id="app-E", impact_severity=Severity.medium,
    )
    third, info = det.mine_patterns_ex(0.6)
    assert info["mode"] == "incremental" and third
    assert all("timeout" in p.name.lower() for p in third)
    g.close()


def test_warn_topk_reuse_skips_delta_dispatch(tmp_path):
    g = _mk(tmp_path)
    _seed_corpus(g)
    base = g.mine_delta_dispatches
    sig = "timeout while calling payments api attempt 9"
    g.match(sig)  # a pre-flight warn fetches and caches the neighbours
    g.upsert_failure(failure_type="TIMEOUT", signature_text=sig, app_id="app-Z",
                     impact_severity=Severity.medium)
    assert g.mine_delta_dispatches == base
    assert _label_parity(g)
    g.upsert_failure(failure_type="SCHEMA", signature_text="another unseen failure shape pqr",
                     app_id="app-Z", impact_severity=Severity.medium)
    assert g.mine_delta_dispatches == base + 1
    assert _label_parity(g)
    # A typed match fills no cache entry.
    g.match("typed query never cached", failure_type="SCHEMA")
    assert "typed query never cached" not in g._match_cache
    g.close()


def test_match_cache_is_an_lru(tmp_path, monkeypatch):
    monkeypatch.setenv("KAKVEDA_MINE_MATCH_CACHE", "2")
    g = _mk(tmp_path)
    _seed_corpus(g)
    for sig in ("a one", "b two", "c three"):
        g.match(sig)
    assert list(g._match_cache) == ["b two", "c three"]
    g.close()


def test_incremental_disabled_reproduces_full_behavior(tmp_path, monkeypatch):
    monkeypatch.setenv("KAKVEDA_MINE_INCREMENTAL", "0")
    g = _mk(tmp_path)
    det = PatternDetector(g)
    _seed_corpus(g)
    assert g._mine is None and g.mine_delta_dispatches == 0
    assert g.mine_state_info() == {"enabled": False}
    pats, info = det.mine_patterns_ex(0.6, "incremental")
    assert info["mode"] == "full" and info["fallback"] == "disabled"
    monkeypatch.delenv("KAKVEDA_MINE_INCREMENTAL")
    g2 = _mk(tmp_path / "on")
    det2 = PatternDetector(g2)
    _seed_corpus(g2)
    assert _key(pats) == _key(det2.mine_patterns_ex(0.6)[0])
    g.close()
    g2.close()


def test_threshold_change_full_sweep_then_reseeds(tmp_path):
    g = _mk(tmp_path)
    det = PatternDetector(g)
    _seed_corpus(g)
    assert det.mine_patterns_ex(0.6)[1]["mode"] == "incremental"
    _, info = det.mine_patterns_ex(0.5, "incremental")
    assert info["mode"] == "full" and info["fallback"]
    assert det.mine_patterns_ex(0.5)[1]["mode"] == "incremental"
    g.close()


def test_mine_mode_validation(tmp_path):
    g = _mk(tmp_path)
    with pytest.raises(ValueError):
        PatternDetector(g).mine_patterns(mode="bogus")
    g.close()


def test_pending_deltas_drain_past_their_cap(tmp_path, monkeypatch):
    monkeypatch.setenv("KAKVEDA_MINE_PENDING_MAX", "1")
    g = _mk(tmp_path)
    _seed_corpus(g)
    assert g.mine_state_info()["pending"] <= 1
    assert _label_parity(g)
    g.close()


def test_growth_rebuild_still_attaches(tmp_path):
    g = _mk(tmp_path, capacity=4)
    items = [
        dict(failure_type="TIMEOUT", signature_text=f"timeout while calling api {i % 7} attempt {i}",
             app_id=f"app-{i % 3}", impact_severity="medium")
        for i in range(20)
    ]
    for lo in (0, 3, 9):
        g.upsert_failures_batch(items[lo: lo + 6 if lo < 9 else 20])
    assert g._knn.capacity == 32 and g.count == 20
    assert not g.mine_state_info()["stale"] and _label_parity(g)
    g.close()


def test_delta_fault_degrades_to_one_full_sweep(tmp_path, monkeypatch):
    g = _mk(tmp_path)
    det = PatternDetector(g)
    _seed_corpus(g)

    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(tgfkb, "delta_topk_sparse", boom)
    rec, created = g.upsert_failure(
        failure_type="TIMEOUT", signature_text="timeout while calling payments api attempt 5",
        app_id="app-G", impact_severity=Severity.medium,
    )
    assert created and rec.failure_id == "F-0006"  # the ingest survived
    st = g.mine_state_info()
    assert st["stale"] and st["stale_reason"] == "attach failed: RuntimeError" and st["pending"] == 0
    monkeypatch.undo()
    _, info = det.mine_patterns_ex(0.6, "incremental")
    assert info["mode"] == "full" and info["fallback"]  # read after the sweep re-seeded, as in JAX
    assert g.mine_usable(0.6) and _label_parity(g)  # re-seeded, trustworthy again
    g.close()


def test_drain_fault_marks_stale(tmp_path, monkeypatch):
    g = _mk(tmp_path)
    _seed_corpus(g)
    monkeypatch.setattr(tgfkb, "unpack_topk", lambda *a: (_ for _ in ()).throw(ValueError("bad copy")))
    assert g.mine_drain() == 0
    st = g.mine_state_info()
    assert st["stale"] and st["stale_reason"] == "drain failed: ValueError"
    g.close()


# ---------------------------------------------------------------------------
# one corpus through both packages
# ---------------------------------------------------------------------------


def _stream_items(lo, hi):
    out = []
    for i in range(lo, hi):
        fam = i % 5
        out.append(dict(
            failure_type=["TIMEOUT", "SCHEMA", "HALLUCINATION_CITATION"][fam % 3],
            signature_text=f"family {fam} failure while calling service {fam} variant {i % 4}",
            app_id=f"app-{i % 6}", impact_severity="medium",
        ))
    return out


def test_gfkb_and_patterns_match_jax(tmp_path):
    jg, tg = _mk_jax(tmp_path), _mk(tmp_path)
    jd, td = JaxDetector(jg), PatternDetector(tg)
    for g in (jg, tg):
        g.match_batch(["family 1 failure while calling service 1 variant 0", "unseen signature"])
        g.upsert_failures_batch(_stream_items(0, 12))
    _seed_corpus(jg, JaxSeverity)
    _seed_corpus(tg)
    for g in (jg, tg):
        g.upsert_failures_batch(_stream_items(12, 40))
    jg.mine_drain()
    tg.mine_drain()
    assert np.array_equal(tg._mine.labels(), jg._mine.labels())
    ji, ti = jg.mine_state_info(), tg.mine_state_info()
    for key in ("rows", "clusters", "dirty", "attached", "evictions", "merges", "stale",
                "pending", "covers_all_rows", "delta_dispatches", "threshold", "k", "enabled"):
        assert ti[key] == ji[key], key
    for mode in ("auto", "auto", "full"):
        jp, jinfo = jd.mine_patterns_ex(0.6, mode)
        tp, tinfo = td.mine_patterns_ex(0.6, mode)
        assert [(p.pattern_id, p.name, p.failure_ids, p.affected_apps, p.description) for p in tp] == [
            (p.pattern_id, p.name, p.failure_ids, p.affected_apps, p.description) for p in jp]
        assert (tinfo["mode"], tinfo["dirty_clusters"]) == (jinfo["mode"], jinfo["dirty_clusters"])
    jg.close()
    tg.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_replayed_data_dir_is_stale_then_full_in_both(tmp_path, writer):
    d = tmp_path / "data"
    w = JaxGFKB(data_dir=d, mesh=create_mesh("data:1"), capacity=256, dim=1024) if writer == "jax" \
        else GFKB(data_dir=d, device="cpu", capacity=256, dim=1024)
    _seed_corpus(w, JaxSeverity if writer == "jax" else Severity)
    w.close()
    outs = []
    for g, det in ((jg := JaxGFKB(data_dir=d, mesh=create_mesh("data:1"), capacity=256, dim=1024)),
                   JaxDetector(jg)), ((tg := GFKB(data_dir=d, device="cpu", capacity=256, dim=1024)),
                                      PatternDetector(tg)):
        st = g.mine_state_info()
        assert st["stale"] and not st["covers_all_rows"] and not g.mine_usable(0.6)
        _, info = det.mine_patterns_ex(0.6)
        assert info["mode"] == "full" and g.mine_usable(0.6)
        outs.append((g._mine.labels().tolist(), [(p.name, p.failure_ids, p.affected_apps) for p in g.list_patterns()]))
        assert det.mine_patterns_ex(0.6)[1]["mode"] == "incremental"
    assert outs[0] == outs[1]
    jg.close()
    tg.close()
