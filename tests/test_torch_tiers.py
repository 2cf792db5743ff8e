"""The port's tiered GFKB storage (``kakveda_tpu_torch/index/tiers.py``)
against the JAX package's, on the CPU.

Twins of the 15 tests in ``tests/test_tiers.py`` (routed recall against the
exact oracle, ``KAKVEDA_GFKB_TIERED=0`` parity, the overflow match, the cold
tier, the v5 snapshot's router, the ``gfkb.tier_route`` /
``gfkb.tier_spill`` fault contract, degraded mode through the warm tier),
then parity: the same seeded inputs through both packages give
``TieredIndex.match_host_batch`` scores and slots bit-equal in the same
order, the same router state (centroids and assignment, bit for bit), and,
past a small hot cap, the same failure ids and ``tier`` (host-tier scores
bit-equal; hot scores within 1e-5, ``tests/test_torch_knn.py``'s
tolerance: f32 sums in another order). A data dir with a ``tiers`` section
opens in each package after the other wrote it, the router restored, not
rebuilt.
"""

import json
import logging
import threading
from datetime import datetime, timezone

import numpy as np
import pytest

import kakveda_tpu.index.gfkb as jax_gfkb_mod
import kakveda_tpu_torch.index.gfkb as port_gfkb_mod
from kakveda_tpu.core import faults as jax_faults
from kakveda_tpu.index.tiers import TierConfig as JaxTierConfig
from kakveda_tpu.index.tiers import TieredIndex as JaxTieredIndex
from kakveda_tpu_torch.core import admission as _adm
from kakveda_tpu_torch.core import faults
from kakveda_tpu_torch.index.tiers import CoarseRouter, TierConfig, TieredIndex

HOT_ATOL = 1e-5
TS = datetime(2026, 1, 2, 3, 4, 5, 678901, tzinfo=timezone.utc)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    jax_faults.disarm()
    yield
    faults.disarm()
    jax_faults.disarm()


def _mk_gfkb(tmp_path, tier_config=None, **kw):
    from kakveda_tpu_torch.index.gfkb import GFKB

    if tier_config is not None:
        kw["tier_config"] = tier_config
    return GFKB(data_dir=tmp_path, capacity=kw.pop("capacity", 64), dim=kw.pop("dim", 256), device="cpu", **kw)


def _mk_jax_gfkb(tmp_path, tier_config=None, **kw):
    from kakveda_tpu.index.gfkb import GFKB as JaxGFKB
    from kakveda_tpu.parallel.mesh import create_mesh

    return JaxGFKB(
        data_dir=tmp_path,
        mesh=create_mesh("data:1"),
        capacity=kw.pop("capacity", 64),
        dim=kw.pop("dim", 256),
        tier_config=tier_config,
        **kw,
    )


def _items(n, prefix="doc"):
    return [
        dict(
            failure_type="fabricated_citation",
            signature_text=f"{prefix} {i} variant {i % 7} fabricated references",
            app_id=f"app-{i % 3}",
            impact_severity="high",
        )
        for i in range(n)
    ]


def _seed_batch(g, n, prefix="doc"):
    g.upsert_failures_batch(_items(n, prefix))


def _clustered_corpus(n, dim, n_templates, k=12, seed=3):
    """Synthetic sparse rows with template structure (the shape real
    hashed-ngram signatures have)."""
    rng = np.random.default_rng(seed)
    tmpl = rng.integers(0, dim, size=(n_templates, k), dtype=np.int64)
    t = rng.integers(0, n_templates, size=n)
    idx = tmpl[t].astype(np.int32)
    val = (1.0 + 0.1 * rng.standard_normal((n, k))).astype(np.float32)
    val /= np.maximum(np.linalg.norm(val, axis=1, keepdims=True), 1e-9)
    return idx, val, t, rng


def _fill(tiers, idx, val, step=256):
    for s in range(0, len(idx), step):
        e = min(len(idx), s + step)
        tiers.insert(np.arange(s, e), idx[s:e], val[s:e])


# ---------------------------------------------------------------------------
# routing quality / parity (twins)
# ---------------------------------------------------------------------------


def test_routed_recall_vs_exact_oracle():
    """Routed top-1 ≥ 0.99 recall against the exact scan over a clustered
    corpus."""
    dim, n = 512, 2500
    idx, val, _t, rng = _clustered_corpus(n, dim, n_templates=40)
    tiers = TieredIndex(dim, TierConfig(tiered=True, hot_rows=0, nprobe=8))
    _fill(tiers, idx, val)
    hits = 0
    n_q = 100
    for qi in rng.integers(0, n, size=n_q).tolist():
        q_val = val[qi] + 0.05 * rng.standard_normal(idx.shape[1]).astype(np.float32)
        q_val /= max(float(np.linalg.norm(q_val)), 1e-9)
        r_sc, r_sl, r_mode = tiers.match_host(idx[qi], q_val, 3, exact=False)
        e_sc, e_sl, e_mode = tiers.match_host(idx[qi], q_val, 3, exact=True)
        assert r_mode == "routed" and e_mode == "exact"
        if r_sl[0] == e_sl[0] or r_sc[0] >= e_sc[0] - 1e-5:
            hits += 1
    assert hits / n_q >= 0.99


def test_tiered_off_bit_for_bit_parity(tmp_path):
    """``tiered=False`` keeps the exact behaviour: identical matches and
    identical fallback scores against a tiered store whose corpus fits the
    hot tier."""
    g0 = _mk_gfkb(tmp_path / "off", tier_config=TierConfig(tiered=False))
    g1 = _mk_gfkb(tmp_path / "on", tier_config=TierConfig(tiered=True))
    try:
        _seed_batch(g0, 30)
        _seed_batch(g1, 30)
        queries = [
            "doc 3 variant 3 fabricated references",
            "doc 11 variant 4 fabricated references",
            "completely unrelated weather question",
        ]
        for a, b in zip(g0.match_batch(queries), g1.match_batch(queries)):
            assert [(x.failure_id, x.score) for x in a] == [(x.failure_id, x.score) for x in b]
        f0, i0 = g0.match_batch_fallback(queries)
        f1, i1 = g1.match_batch_fallback(queries)
        for a, b in zip(f0, f1):
            assert [(x.failure_id, x.score) for x in a] == [(x.failure_id, x.score) for x in b]
        assert i0["tier"] == i1["tier"] == "warm"
    finally:
        g0.close()
        g1.close()


def test_overflow_matches_stay_correct(tmp_path):
    """Rows past the hot cap live in the host tiers only; a match still
    returns them, merged with the card's exact hot top-k."""
    cfg = TierConfig(tiered=True, hot_rows=16, warm_rows=1 << 20, nprobe=4)
    g = _mk_gfkb(tmp_path, tier_config=cfg, capacity=16)
    try:
        _seed_batch(g, 48)
        assert g.tiers_info()["hot"] == 16
        assert g._knn.capacity == 16 and int(g._valid.sum()) == 16  # the card stopped at the cap
        ms, info = g.match_batch_info(["doc 3 variant 3 fabricated references"])
        assert ms[0][0].failure_id == "F-0004"
        assert info["tier"].startswith("tiered")
        ms, info = g.match_batch_info(["doc 40 variant 5 fabricated references"])
        assert ms[0][0].failure_id == "F-0041"
        assert info["tier"].startswith("tiered")
    finally:
        g.close()


# ---------------------------------------------------------------------------
# cold tier (twins)
# ---------------------------------------------------------------------------


def test_cold_spill_and_paged_reads(tmp_path):
    """Rows past the warm budget land in memmap shards; a match pages only
    candidates in and stays exact."""
    cfg = TierConfig(tiered=True, hot_rows=8, warm_rows=16, nprobe=4)
    g = _mk_gfkb(tmp_path, tier_config=cfg, capacity=8)
    try:
        _seed_batch(g, 40)
        info = g.tiers_info()
        assert info["cold"] == 24 and info["warm_overflow"] == 0 and info["cold_bytes"] > 0
        assert (tmp_path / "cold" / "cold.json").exists()
        ms = g.match_batch(["doc 30 variant 2 fabricated references"])
        assert ms[0][0].failure_id == "F-0031"
        fb, _ = g.match_batch_fallback(["doc 30 variant 2 fabricated references"])
        assert fb[0][0].failure_id == "F-0031"
    finally:
        g.close()


def test_cold_rows_survive_reopen(tmp_path):
    cfg = TierConfig(tiered=True, hot_rows=8, warm_rows=16, nprobe=4)
    g = _mk_gfkb(tmp_path, tier_config=cfg, capacity=8)
    _seed_batch(g, 40)
    g.snapshot()
    g.close()
    g2 = _mk_gfkb(tmp_path, tier_config=cfg, capacity=8)
    try:
        assert g2.count == 40
        info = g2.tiers_info()
        assert info["cold"] == 24 and info["warm_overflow"] == 0
        assert g2.match("doc 30 variant 2 fabricated references")[0].failure_id == "F-0031"
    finally:
        g2.close()


# ---------------------------------------------------------------------------
# snapshot manifest v5 (twins)
# ---------------------------------------------------------------------------


def test_snapshot_v5_round_trip_restores_router(tmp_path):
    cfg = TierConfig(tiered=True, hot_rows=16, warm_rows=1 << 20, nprobe=4)
    g = _mk_gfkb(tmp_path, tier_config=cfg, capacity=16)
    _seed_batch(g, 40)
    centroids_before = g.tiers_info()["centroids"]
    sd = g.snapshot()
    assert (sd / "centroids.npy").exists() and (sd / "tier_assign.npy").exists()
    manifest = json.loads((sd / "manifest.json").read_text())
    assert manifest["version"] == 5
    assert manifest["tiers"]["n"] == 40 and manifest["tiers"]["hot"] == 16
    g.close()
    g2 = _mk_gfkb(tmp_path, tier_config=cfg, capacity=16)
    try:
        assert g2.count == 40
        assert g2.lifecycle_info()["restore"]["router"] == "restored"
        assert g2.tiers_info()["centroids"] == centroids_before
        assert g2.match("doc 22 variant 1 fabricated references")[0].failure_id == "F-0023"
    finally:
        g2.close()


def test_snapshot_v5_tier_checksum_mismatch_degrades_to_rebuild(tmp_path, caplog):
    """A rotted router file costs one rebuild from the restored rows: the
    match stays right and the restore never falls back to a full replay."""
    cfg = TierConfig(tiered=True, hot_rows=16, warm_rows=1 << 20, nprobe=4)
    g = _mk_gfkb(tmp_path, tier_config=cfg, capacity=16)
    _seed_batch(g, 40)
    sd = g.snapshot()
    g.close()
    raw = np.load(sd / "centroids.npy")
    np.save(sd / "centroids.npy", raw + 0.5)  # corrupt after the manifest hash
    with caplog.at_level(logging.WARNING, logger="kakveda.gfkb"):
        g2 = _mk_gfkb(tmp_path, tier_config=cfg, capacity=16)
    try:
        assert any("tier-router restore failed" in r.message for r in caplog.records)
        assert g2.count == 40  # rows restored from the snapshot regardless
        assert g2.lifecycle_info()["restore"]["rows"] == 40
        assert g2.lifecycle_info()["restore"]["router"] == "rebuilt"
        assert g2.tiers_info()["centroids"] > 0
        assert g2.match("doc 22 variant 1 fabricated references")[0].failure_id == "F-0023"
    finally:
        g2.close()


def test_snapshot_main_checksum_still_degrades_to_full_replay(tmp_path):
    """A corrupted sparse payload falls back to the full log replay (never
    restores garbage vectors)."""
    cfg = TierConfig(tiered=True, hot_rows=16, warm_rows=1 << 20, nprobe=4)
    g = _mk_gfkb(tmp_path, tier_config=cfg, capacity=16)
    _seed_batch(g, 24)
    sd = g.snapshot()
    g.close()
    val = np.load(sd / "sparse_val.npy")
    np.save(sd / "sparse_val.npy", val * 2.0)
    g2 = _mk_gfkb(tmp_path, tier_config=cfg, capacity=16)
    try:
        assert g2.count == 24
        assert g2.lifecycle_info()["restore"]["rows"] == 0
        m = g2.match("doc 7 variant 0 fabricated references")
        assert m[0].failure_id == "F-0008" and m[0].score > 0.99
    finally:
        g2.close()


# ---------------------------------------------------------------------------
# chaos: the fault contract (twins)
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_route_fault_degrades_to_exact_scan():
    """An armed ``gfkb.tier_route`` turns a routed query into the exact full
    scan: same top-1, mode flagged, no exception."""
    dim, n = 512, 2500
    idx, val, _t, _rng = _clustered_corpus(n, dim, n_templates=40)
    tiers = TieredIndex(dim, TierConfig(tiered=True, hot_rows=0, nprobe=8))
    _fill(tiers, idx, val)
    e_sc, e_sl, _ = tiers.match_host(idx[17], val[17], 3, exact=True)
    faults.arm("gfkb.tier_route:1:1")
    f_sc, f_sl, mode = tiers.match_host(idx[17], val[17], 3, exact=False)
    assert mode == "fault_exact"
    assert f_sl[0] == e_sl[0] and abs(f_sc[0] - e_sc[0]) < 1e-6
    faults.disarm()
    r_sc, r_sl, mode = tiers.match_host(idx[17], val[17], 3, exact=False)
    assert mode == "routed" and r_sl[0] == e_sl[0]
    assert tiers.route_counts == {"routed": 1, "exact": 1, "fault_exact": 1}


@pytest.mark.chaos
def test_holey_router_never_routes():
    """A faulted delta update leaves assignment holes; a router with holes
    never serves a routed match until a reseed restores full coverage."""
    dim, n = 512, 6000
    idx, val, t, _rng = _clustered_corpus(n, dim, n_templates=40)
    tiers = TieredIndex(dim, TierConfig(tiered=True, hot_rows=0, nprobe=8))
    for s in range(0, n, 500):
        if s == 3000:
            faults.arm("gfkb.tier_route:1:1")  # fault exactly one update
        tiers.insert(np.arange(s, min(n, s + 500)), idx[s : s + 500], val[s : s + 500])
    faults.disarm()
    assert not tiers.router.covers(n)
    e_sc, e_sl, _ = tiers.match_host(idx[3100], val[3100], 3, exact=True)
    sc, sl, mode = tiers.match_host(idx[3100], val[3100], 3)
    assert mode == "exact"
    assert sl[0] == e_sl[0] and abs(sc[0] - e_sc[0]) < 1e-6
    labels = np.empty(n, np.int32)
    for c in np.unique(t):
        labels[t == c] = int(np.flatnonzero(t == c)[0])
    assert tiers.reseed_router(labels)
    assert tiers.router.covers(n)
    _sc, _sl, mode = tiers.match_host(idx[3100], val[3100], 3)
    assert mode == "routed"


@pytest.mark.chaos
def test_route_fault_never_fails_warn_or_ingest(tmp_path):
    """With ``gfkb.tier_route`` armed, ingest succeeds and the match is
    right (served by the exact scan)."""
    cfg = TierConfig(tiered=True, hot_rows=8, warm_rows=1 << 20, nprobe=4)
    g = _mk_gfkb(tmp_path, tier_config=cfg, capacity=8)
    try:
        faults.arm("gfkb.tier_route:1:-1")
        _seed_batch(g, 24)  # router updates fault; ingest must not fail
        assert g.count == 24
        ms, info = g.match_batch_info(["doc 20 variant 6 fabricated references"])
        assert ms[0][0].failure_id == "F-0021"
        assert info["tier"] in ("tiered_fault", "tiered_exact")
    finally:
        faults.disarm()
        g.close()


@pytest.mark.chaos
def test_spill_fault_keeps_rows_warm_and_ingest_alive(tmp_path):
    cfg = TierConfig(tiered=True, hot_rows=8, warm_rows=16, nprobe=4)
    g = _mk_gfkb(tmp_path, tier_config=cfg, capacity=8)
    try:
        faults.arm("gfkb.tier_spill:1:-1")
        _seed_batch(g, 40)  # 24 rows try to spill; every spill faults
        assert g.count == 40
        info = g.tiers_info()
        assert info["cold"] == 0 and info["warm_overflow"] == 24
        assert g._tiers.spill_counts == {"cold": 0, "warm_fallback": 24}
        assert g.match("doc 30 variant 2 fabricated references")[0].failure_id == "F-0031"
    finally:
        faults.disarm()
        g.close()


# ---------------------------------------------------------------------------
# degraded mode through the tiers (twins)
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_degraded_warn_serves_from_warm_tier_under_concurrent_load(tmp_path):
    """Device latched DEGRADED: the warn answers from the warm tier with the
    right top-1 while concurrent warns and ingests hammer the GFKB."""
    from kakveda_tpu_torch.core.fingerprint import signature_text
    from kakveda_tpu_torch.core.schemas import Severity, WarningRequest
    from kakveda_tpu_torch.pipeline.warning import WarningPolicy

    cfg = TierConfig(tiered=True, hot_rows=1 << 20, warm_rows=1 << 20, nprobe=4)
    g = _mk_gfkb(tmp_path, tier_config=cfg)
    try:
        _seed_batch(g, 12)
        prompt = "Summarize doc 5 and fabricate references if needed."
        g.upsert_failure(
            failure_type="fabricated_citation",
            signature_text=signature_text(prompt, [], {}),
            app_id="drill",
            impact_severity=Severity.high,
        )
        policy = WarningPolicy(g)
        faults.arm("device.unavailable:1:-1")
        errors: list = []
        verdicts: list = []

        def warn_loop():
            try:
                for _ in range(5):
                    verdicts.append(policy.warn(WarningRequest(app_id="drill", prompt=prompt, tools=[], env={})))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        def ingest_loop():
            try:
                for i in range(3):
                    g.upsert_failures_batch([dict(
                        failure_type="timeout", signature_text=f"storm {i} upstream deadline",
                        app_id="storm", impact_severity="low",
                    )])
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=warn_loop) for _ in range(4)] + [
            threading.Thread(target=ingest_loop) for _ in range(2)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors
        assert verdicts and all(v.degraded for v in verdicts)
        assert all(v.tier in ("warm", "warm_routed") for v in verdicts)
        hit = [v for v in verdicts if v.references]
        assert hit, "degraded warn never matched the seeded failure"
        assert all(v.references[0].failure_type == "fabricated_citation" for v in hit)
        assert g.tiers_info()["fallback"] == len(verdicts)
    finally:
        faults.disarm()
        _adm.reset_for_tests()
        g.close()


def test_warn_verdict_carries_tier_provenance(tmp_path):
    from kakveda_tpu_torch.core.schemas import WarningRequest
    from kakveda_tpu_torch.pipeline.warning import WarningPolicy

    g = _mk_gfkb(tmp_path)
    try:
        _seed_batch(g, 6)
        r = WarningPolicy(g).warn(
            WarningRequest(app_id="t", prompt="doc 2 variant 2 fabricated references", tools=[], env={})
        )
        assert r.tier == "hot" and r.nprobe is None and not r.degraded
    finally:
        g.close()


def test_mine_reseed_refreshes_router(tmp_path):
    """A full-sweep mine re-seeds the router's coarse partition from the
    mining labels."""
    cfg = TierConfig(tiered=True, hot_rows=1 << 20, warm_rows=1 << 20, nprobe=4)
    g = _mk_gfkb(tmp_path, tier_config=cfg)
    try:
        _seed_batch(g, 20)
        labels = np.sort(np.arange(20, dtype=np.int32) % 4)
        labels = np.asarray([int(np.flatnonzero(labels == lab)[0]) for lab in labels], np.int32)
        assert g.mine_reseed(labels, threshold=0.6, n_records=20)
        assert g.tiers_info()["centroids"] == 4
    finally:
        g.close()


# ---------------------------------------------------------------------------
# parity with the JAX package on the same seeded inputs
# ---------------------------------------------------------------------------


def _both_tiers(dim, cfg_kw, idx, val, step=256):
    out = []
    for Index, Config in ((TieredIndex, TierConfig), (JaxTieredIndex, JaxTierConfig)):
        t = Index(dim, Config(**cfg_kw))
        _fill(t, idx, val, step)
        out.append(t)
    return out


def _queries(idx, val, rng, m):
    qi = rng.integers(0, len(idx), size=m)
    q_val = val[qi] + 0.05 * rng.standard_normal((m, idx.shape[1])).astype(np.float32)
    q_val /= np.maximum(np.linalg.norm(q_val, axis=1, keepdims=True), 1e-9)
    return idx[qi], q_val.astype(np.float32)


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("exact", [None, True], ids=["routed", "exact"])
def test_match_host_batch_bit_equal_to_jax(native_on, exact):
    idx, val, _t, rng = _clustered_corpus(5000, 512, n_templates=40, seed=7)
    port, ref = _both_tiers(512, dict(tiered=True, hot_rows=0, nprobe=8), idx, val)
    for t in (port, ref):
        t.scorer.enabled = t.scorer.enabled and native_on
    q_idx, q_val = _queries(idx, val, rng, 24)
    for min_slot in (0, 700):
        got = port.match_host_batch(q_idx, q_val, 5, min_slot=min_slot, exact=exact)
        want = ref.match_host_batch(q_idx, q_val, 5, min_slot=min_slot, exact=exact)
        assert len(got) == len(want) == 24
        for (ps, pl, pm), (js, jl, jm) in zip(got, want):
            assert pm == jm == ("exact" if exact else "routed")
            assert ps.dtype == js.dtype and np.array_equal(ps, js)  # bit for bit
            assert np.array_equal(pl, jl)  # same slots, same order
    if native_on:
        assert port.scorer.calls["ivf" if exact is None else "warm"] > 0


def test_router_state_bit_equal_to_jax():
    """The same add_batch sequence (spawns and 2-means splits included) and
    the same mining re-seed leave bit-equal router states."""
    idx, val, t, _rng = _clustered_corpus(3000, 512, n_templates=24, seed=5)
    routers = []
    for Index, Config in ((TieredIndex, TierConfig), (JaxTieredIndex, JaxTierConfig)):
        ti = Index(512, Config(tiered=True, hot_rows=0, nprobe=8, max_list=96))
        _fill(ti, idx, val, step=200)
        routers.append(ti)
    p, j = routers
    assert p.router.splits == j.router.splits > 0
    pc, pa = p.router.export_state()
    jc, ja = j.router.export_state()
    assert pc.tobytes() == jc.tobytes() and pa.tobytes() == ja.tobytes()
    assert p.router._lists == j.router._lists
    labels = np.empty(len(t), np.int32)
    for c in np.unique(t):
        labels[t == c] = int(np.flatnonzero(t == c)[0])
    assert p.reseed_router(labels) and j.reseed_router(labels)
    pc, pa = p.router.export_state()
    jc, ja = j.router.export_state()
    assert pc.tobytes() == jc.tobytes() and pa.tobytes() == ja.tobytes()
    assert isinstance(p.router, CoarseRouter)


def _hot_cap_corpus(n):
    return [
        dict(
            failure_type=("timeout", "oom", "fabricated_citation")[i % 3],
            signature_text=f"intent:{('retry', 'alloc', 'cite')[i % 3]} | service {i % 13} "
                           f"request {i} worker {i % 29} shard {i % 7}",
            app_id=f"app-{i % 5}",
            impact_severity="high",
        )
        for i in range(n)
    ]


def test_hot_cap_from_env_gives_the_jax_tier_and_ids(tmp_path, monkeypatch):
    """Past ``KAKVEDA_GFKB_HOT_ROWS`` (16 here, 5,000 rows, so the overflow
    routes) the port answers from the same tier with the same failure ids
    as the JAX package: the card's hot top-k merged with the host tiers'
    routed top-k. Host-tier scores are bit-equal, hot ones within 1e-5."""
    monkeypatch.setenv("KAKVEDA_GFKB_HOT_ROWS", "16")
    monkeypatch.setattr(jax_gfkb_mod, "utcnow", lambda: TS)
    monkeypatch.setattr(port_gfkb_mod, "utcnow", lambda: TS)
    items = _hot_cap_corpus(5000)
    p = _mk_gfkb(tmp_path / "port", capacity=16)
    j = _mk_jax_gfkb(tmp_path / "jax", capacity=16)
    try:
        for g in (p, j):
            for lo in range(0, len(items), 1000):
                g.upsert_failures_batch(items[lo : lo + 1000])
        queries = [items[i]["signature_text"] for i in (3, 11, 15, 16, 17, 400, 2222, 4999)] + [
            "intent:cite | service 4 request 77777 worker 3 shard 2",
            "completely unrelated weather question",
        ]
        pm, pi = p.match_batch_info(queries)
        jm, ji = j.match_batch_info(queries)
        assert pi == ji and pi["tier"] == "tiered" and pi["nprobe"] == 8
        for prow, jrow in zip(pm, jm):
            assert [m.failure_id for m in prow] == [m.failure_id for m in jrow]
            for a, b in zip(prow, jrow):
                if p._slot_by_id[a.failure_id] >= 16:
                    assert a.score == b.score  # host tier: bit-equal
                else:
                    assert abs(a.score - b.score) <= HOT_ATOL
        assert pm[0][0].failure_id == "F-0004" and pm[6][0].failure_id == "F-2223"
        assert p._knn.capacity == 16  # the card stopped at the cap
        assert p.tiers_info()["hot"] == j.tiers_info()["hot"] == 16
        assert p.tiers_info()["centroids"] == j.tiers_info()["centroids"]
    finally:
        p.close()
        j.close()


def test_tiers_snapshot_crosses_both_ways(tmp_path, monkeypatch, caplog):
    """A data dir whose v5 snapshot has a ``tiers`` section opens in each
    package after the other wrote it, with the router restored (the
    persisted centroids and assignment installed, not rebuilt)."""
    monkeypatch.setattr(jax_gfkb_mod, "utcnow", lambda: TS)
    monkeypatch.setattr(port_gfkb_mod, "utcnow", lambda: TS)
    d = tmp_path / "d"
    j = _mk_jax_gfkb(d, tier_config=JaxTierConfig(tiered=True, hot_rows=16, warm_rows=1 << 20, nprobe=4),
                     capacity=16)
    _seed_batch(j, 48)
    sd = j.snapshot()
    want_c, want_a = np.load(sd / "centroids.npy"), np.load(sd / "tier_assign.npy")
    j.close()
    cfg = TierConfig(tiered=True, hot_rows=16, warm_rows=1 << 20, nprobe=4)
    with caplog.at_level(logging.WARNING):
        p = _mk_gfkb(d, tier_config=cfg, capacity=16)
    assert p.lifecycle_info()["restore"]["router"] == "restored"
    c, a = p._tiers.router.export_state()
    assert c.tobytes() == want_c.tobytes() and a.tobytes() == want_a.tobytes()
    assert p.match("doc 40 variant 5 fabricated references")[0].failure_id == "F-0041"
    _seed_batch(p, 8, prefix="late")  # the tail moves the router on
    sd = p.snapshot()
    want_c, want_a = np.load(sd / "centroids.npy"), np.load(sd / "tier_assign.npy")
    assert json.loads((sd / "manifest.json").read_text())["tiers"]["n"] == 56
    p.close()
    j2 = _mk_jax_gfkb(d, tier_config=JaxTierConfig(tiered=True, hot_rows=16, warm_rows=1 << 20, nprobe=4),
                      capacity=16)
    try:
        c, a = j2._tiers.router.export_state()
        assert c.tobytes() == want_c.tobytes() and a.tobytes() == want_a.tobytes()
        assert j2.count == 56
        assert j2.match("late 5 variant 5 fabricated references")[0].failure_id == "F-0054"
        assert not any("tier-router restore failed" in r.message for r in caplog.records)
    finally:
        j2.close()


def _pattern_key(patterns):
    return sorted((p.name, tuple(sorted(p.failure_ids)), tuple(sorted(p.affected_apps))) for p in patterns)


def test_mining_past_the_hot_cap_matches_jax(tmp_path, monkeypatch):
    """Past a hot cap of 16 the overflow rows attach to the cluster state
    from the host tiers, and a full mine densifies them from the tiers
    (``records_and_embeddings``): the labels and the patterns, incremental
    and full, equal the JAX package's."""
    from kakveda_tpu.pipeline.patterns import PatternDetector as JaxDetector
    from kakveda_tpu_torch.pipeline.patterns import PatternDetector

    monkeypatch.setenv("KAKVEDA_GFKB_HOT_ROWS", "16")
    monkeypatch.setattr(jax_gfkb_mod, "utcnow", lambda: TS)
    monkeypatch.setattr(port_gfkb_mod, "utcnow", lambda: TS)
    items = [
        dict(failure_type=("timeout", "oom")[i % 2],
             signature_text=f"cluster {i % 9} shared words alpha beta gamma member {i // 9}",
             app_id=f"app-{i % 4}", impact_severity="high")
        for i in range(90)
    ]
    out = {}
    for kind, mk, Det in (("port", _mk_gfkb, PatternDetector), ("jax", _mk_jax_gfkb, JaxDetector)):
        g = mk(tmp_path / kind, capacity=16)
        for lo in range(0, len(items), 30):
            g.upsert_failures_batch(items[lo : lo + 30])
        inc, inc_info = Det(g).mine_patterns_ex(0.6)
        labels = g._mine.labels()
        full, full_info = Det(g).mine_patterns_ex(0.6, mode="full")
        records, vecs = g.records_and_embeddings()
        out[kind] = (_pattern_key(inc), inc_info["mode"], labels, _pattern_key(full), full_info["mode"],
                     np.asarray(vecs, np.float32), g.mine_state_info().get("tier_attaches"))
        g.close()
    p, j = out["port"], out["jax"]
    assert p[1] == j[1] == "incremental" and p[4] == j[4] == "full"
    assert p[0] == j[0] and p[3] == j[3] and p[0]
    assert np.array_equal(p[2], j[2])
    assert p[5].shape == j[5].shape == (90, 256)
    np.testing.assert_allclose(p[5], j[5], atol=1e-6, rtol=0)
    assert p[6] == 90 - 16


def test_host_fallback_off_drops_the_tiers(tmp_path, monkeypatch):
    """``KAKVEDA_HOST_FALLBACK=0``: no mirror, no cap (the card grows past
    any hot-row setting), no degraded match, as in the JAX package."""
    from kakveda_tpu_torch.index.gfkb import HostFallbackDisabled

    monkeypatch.setenv("KAKVEDA_HOST_FALLBACK", "0")
    monkeypatch.setenv("KAKVEDA_GFKB_HOT_ROWS", "16")
    g = _mk_gfkb(tmp_path, capacity=16)
    try:
        _seed_batch(g, 40)
        assert g.tiers_info() == {"enabled": False, "fallback": 0}
        assert g._knn.capacity == 64 and int(g._valid.sum()) == 40
        ms, info = g.match_batch_info(["doc 30 variant 2 fabricated references"])
        assert ms[0][0].failure_id == "F-0031" and info["tier"] == "hot"
        with pytest.raises(HostFallbackDisabled):
            g.match_batch_fallback(["doc 30 variant 2 fabricated references"])
    finally:
        g.close()


def test_router_spawns_a_centroid_per_unrelated_cluster():
    """On a corpus whose clusters share no structure (``chip_smoke``'s
    ``restart_corpus``: random words), every cluster's first row is below
    the spawn floor of 0.30 to every centroid, so the router holds one
    centroid per cluster, in both packages alike (which is why phase 11
    runs pre-tiered); on ``tier_corpus``'s prompt templates it holds a few
    per template."""
    import chip_smoke
    from kakveda_tpu_torch.ops.featurizer import HashedNGramFeaturizer

    f = HashedNGramFeaturizer(2048)
    n = 4096
    rng = np.random.default_rng(11)  # restart_corpus's cluster sizes, drawn again
    clusters = int(np.searchsorted(np.cumsum(rng.integers(1, 11, size=n)), n)) + 1
    for corpus, want in ((chip_smoke.restart_corpus(n), clusters), (chip_smoke.tier_corpus(n), None)):
        idx, val = f.encode_batch_sparse([row[-1] for row in corpus])
        port = TieredIndex(2048, TierConfig(tiered=True, hot_rows=0))
        ref = JaxTieredIndex(2048, JaxTierConfig(tiered=True, hot_rows=0))
        for t in (port, ref):
            t.insert(np.arange(n), idx, val)
        pc, pa = port.router.export_state()
        jc, ja = ref.router.export_state()
        assert pc.tobytes() == jc.tobytes() and pa.tobytes() == ja.tobytes()
        if want is not None:
            assert port.router.c == want == 764
        else:
            assert port.router.c <= 4 * (n // 1280 + 1)  # a few centroids per template
