"""The port's native host-tier scorers (``kkv_score_block`` /
``kkv_score_candidates`` / ``kkv_score_gather`` in
``kakveda_tpu_torch/native/src/native.cc``), on the CPU.

Twins of the 8 tests in ``tests/test_native_score.py``: C++ against numpy
over the warm, cold and routed paths (top-k ids equal, scores within 1e-5:
f32 sums in another order), the ``KAKVEDA_NATIVE=0`` bit-for-bit contract,
the ``require`` smoke, the ``native.score`` fault site (armed: the numpy
path, never a failed match) and the row floor. Then each scorer against
the JAX package's library on the same inputs: bit-equal.
"""

import numpy as np
import pytest

from kakveda_tpu import native as jax_native
from kakveda_tpu_torch import native
from kakveda_tpu_torch.core import faults
from kakveda_tpu_torch.index.tiers import TierConfig, TieredIndex


@pytest.fixture
def needs_native():
    """Decided in the test, not at import: every worker collects the same tests."""
    if native.load() is None:
        pytest.skip("native library unavailable (no g++, or KAKVEDA_NATIVE=0)")


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    yield
    faults.disarm()


def _clustered_corpus(n, dim, n_templates, k=12, seed=11):
    rng = np.random.default_rng(seed)
    tmpl = rng.integers(0, dim, size=(n_templates, k), dtype=np.int64)
    t = rng.integers(0, n_templates, size=n)
    idx = tmpl[t].astype(np.int32)
    val = (1.0 + 0.1 * rng.standard_normal((n, k))).astype(np.float32)
    val /= np.maximum(np.linalg.norm(val, axis=1, keepdims=True), 1e-9)
    return idx, val, rng


def _build(n, dim, cfg, data_dir=None, seed=11):
    idx, val, rng = _clustered_corpus(n, dim, n_templates=40, seed=seed)
    tiers = TieredIndex(dim, cfg, data_dir)
    for s in range(0, n, 256):
        e = min(n, s + 256)
        tiers.insert(np.arange(s, e), idx[s:e], val[s:e])
    return tiers, idx, val, rng


def _queries(idx, val, rng, m):
    out = []
    for qi in rng.integers(0, len(idx), size=m).tolist():
        q_val = val[qi] + 0.05 * rng.standard_normal(idx.shape[1]).astype(np.float32)
        q_val /= max(float(np.linalg.norm(q_val)), 1e-9)
        out.append((idx[qi], q_val))
    return out


def _run(tiers, queries, *, exact):
    return [tiers.match_host(q_idx, q_val, 5, exact=exact) for q_idx, q_val in queries]


def _assert_topk_parity(res_a, res_b):
    """Same top-k ids and scores within 1e-5; an id swap only where the
    scores tie within the tolerance."""
    for (sc_a, sl_a, _), (sc_b, sl_b, _) in zip(res_a, res_b):
        np.testing.assert_allclose(sc_a, sc_b, atol=1e-5)
        for j, (a, b) in enumerate(zip(sl_a, sl_b)):
            assert a == b or abs(float(sc_a[j]) - float(sc_b[j])) <= 1e-5


# ---------------------------------------------------------------------------
# native against numpy, per path (twins)
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("needs_native")
def test_warm_exact_scan_parity():
    tiers, idx, val, rng = _build(2500, 512, TierConfig(tiered=True, hot_rows=0, nprobe=8))
    assert tiers.scorer.enabled
    qs = _queries(idx, val, rng, 32)
    before = tiers.scorer.calls["warm"]
    res_native = _run(tiers, qs, exact=True)
    assert tiers.scorer.calls["warm"] > before, "native warm path never ran"
    tiers.scorer.enabled = False
    res_numpy = _run(tiers, qs, exact=True)
    tiers.scorer.enabled = True
    _assert_topk_parity(res_native, res_numpy)


@pytest.mark.usefixtures("needs_native")
def test_ivf_routed_parity_single_and_batch():
    tiers, idx, val, rng = _build(2500, 512, TierConfig(tiered=True, hot_rows=0, nprobe=8))
    qs = _queries(idx, val, rng, 32)
    res_native = _run(tiers, qs, exact=False)
    q_idx = np.stack([q[0] for q in qs])
    q_val = np.stack([q[1] for q in qs])
    before = tiers.scorer.calls["ivf"]
    res_batch_native = tiers.match_host_batch(q_idx, q_val, 5, exact=False)
    assert tiers.scorer.calls["ivf"] > before, "native ivf path never ran"
    tiers.scorer.enabled = False
    res_numpy = _run(tiers, qs, exact=False)
    res_batch_numpy = tiers.match_host_batch(q_idx, q_val, 5, exact=False)
    tiers.scorer.enabled = True
    _assert_topk_parity(res_native, res_numpy)
    _assert_topk_parity(res_batch_native, res_batch_numpy)
    _assert_topk_parity(res_batch_native, res_native)


@pytest.mark.usefixtures("needs_native")
def test_cold_shard_scan_parity(tmp_path):
    cfg = TierConfig(tiered=True, hot_rows=0, warm_rows=512, nprobe=4, cold_dir=tmp_path / "cold")
    tiers, idx, val, rng = _build(2000, 512, cfg, data_dir=tmp_path)
    assert tiers.info()["cold"] > 0, "corpus never spilled to cold"
    qs = _queries(idx, val, rng, 16)
    before = tiers.scorer.calls["cold"]
    res_native = _run(tiers, qs, exact=True)
    assert tiers.scorer.calls["cold"] > before, "native cold path never ran"
    tiers.scorer.enabled = False
    res_numpy = _run(tiers, qs, exact=True)
    tiers.scorer.enabled = True
    _assert_topk_parity(res_native, res_numpy)


@pytest.mark.usefixtures("needs_native")
def test_score_block_clamps_pad_and_negative_ids():
    """Pad (== dim) and negative ids score 0 exactly as the numpy clamp
    does: a malformed row degrades a score, never reads out of bounds."""
    rng = np.random.default_rng(0)
    dim, n, k = 64, 300, 8
    idx = rng.integers(-3, dim + 1, size=(n, k)).astype(np.int32)
    val = rng.standard_normal((n, k)).astype(np.float32)
    qd = np.zeros(dim + 1, np.float32)
    qd[:dim] = rng.standard_normal(dim).astype(np.float32)
    out = native.score_block(qd, idx, val, dim)
    assert out is not None
    clamped = np.where((idx < 0) | (idx >= dim), dim, idx)
    np.testing.assert_allclose(out, (qd[clamped] * val).sum(axis=1), atol=1e-5)


# ---------------------------------------------------------------------------
# KAKVEDA_NATIVE=0 / require / fault contracts (twins)
# ---------------------------------------------------------------------------


def test_native_off_bit_for_bit(monkeypatch):
    """``KAKVEDA_NATIVE=0``: the scorer stays off and the batch path's numpy
    fallback gives the per-query numpy path's results bit for bit."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    monkeypatch.setenv("KAKVEDA_NATIVE", "0")
    try:
        tiers, idx, val, rng = _build(1500, 512, TierConfig(tiered=True, hot_rows=0, nprobe=8))
        assert not tiers.scorer.enabled
        qs = _queries(idx, val, rng, 16)
        res_single = _run(tiers, qs, exact=False)
        res_batch = tiers.match_host_batch(
            np.stack([q[0] for q in qs]), np.stack([q[1] for q in qs]), 5, exact=False,
        )
        for (sc_a, sl_a, mode_a), (sc_b, sl_b, mode_b) in zip(res_single, res_batch):
            assert mode_a == mode_b
            np.testing.assert_array_equal(sl_a, sl_b)
            np.testing.assert_array_equal(sc_a, sc_b)
        for sc, sl, mode in _run(tiers, qs, exact=True):
            assert mode == "exact" and len(sl) == 5
    finally:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_load_attempted", False)


@pytest.mark.usefixtures("needs_native")
def test_native_require_smoke(monkeypatch):
    """``KAKVEDA_NATIVE=require`` loads (the build works here), the scorers
    are bound and ``status()`` reports it."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    monkeypatch.setenv("KAKVEDA_NATIVE", "require")
    try:
        lib2 = native.load()
        assert lib2 is not None and lib2.kkv_score_gather.restype is not None
        st = native.status()
        assert st["available"] and st["mode"] == "require" and native.score_threads() >= 1
    finally:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_load_attempted", False)


@pytest.mark.usefixtures("needs_native")
def test_require_routed_and_exact_matches_run_native_on_both_tiers(monkeypatch, tmp_path):
    """Under ``KAKVEDA_NATIVE=require`` a routed match and the exact scan
    over warm and cold rows run every scoring call in C++: the ``ivf``,
    ``warm`` and ``cold`` counts move and no fallback is counted."""
    monkeypatch.setenv("KAKVEDA_NATIVE", "require")
    cfg = TierConfig(tiered=True, hot_rows=0, warm_rows=1024, nprobe=4, cold_dir=tmp_path / "cold")
    tiers, idx, val, rng = _build(3000, 512, cfg, data_dir=tmp_path)
    assert tiers.scorer.require and tiers.scorer.enabled and tiers.info()["cold"] > 0
    qs = _queries(idx, val, rng, 16)
    q_idx, q_val = np.stack([q[0] for q in qs]), np.stack([q[1] for q in qs])
    routed = tiers.match_host_batch(q_idx, q_val, 5, exact=False)
    exact = tiers.match_host_batch(q_idx, q_val, 5, exact=True)
    assert {m for *_, m in routed} == {"routed"} and {m for *_, m in exact} == {"exact"}
    assert min(tiers.scorer.calls.values()) > 0, tiers.scorer.calls
    assert sum(tiers.scorer.fallbacks.values()) == 0, tiers.scorer.fallbacks


@pytest.mark.usefixtures("needs_native")
@pytest.mark.parametrize("mode", ["require", "auto"])
def test_failed_native_call_raises_under_require_else_falls_back(monkeypatch, mode):
    """A native call that fails raises under ``require``; otherwise the
    match takes the numpy path with the same top-k and counts an error."""
    tiers, idx, val, rng = _build(2500, 512, TierConfig(tiered=True, hot_rows=0, nprobe=8))
    qs = _queries(idx, val, rng, 4)
    q_idx, q_val = np.stack([q[0] for q in qs]), np.stack([q[1] for q in qs])
    want = tiers.match_host_batch(q_idx, q_val, 5, exact=False)
    monkeypatch.setenv("KAKVEDA_NATIVE", mode)
    tiers.scorer.require = mode == "require"  # read at construction, as the reference's env
    monkeypatch.setattr(native, "score_gather", lambda *a, **k: None)
    if mode == "require":
        with pytest.raises(RuntimeError, match="kkv_score_gather"):
            tiers.match_host_batch(q_idx, q_val, 5, exact=False)
        return
    _assert_topk_parity(want, tiers.match_host_batch(q_idx, q_val, 5, exact=False))
    assert tiers.scorer.fallbacks["error"] > 0


def test_require_raises_when_the_scorer_cannot_load(monkeypatch, tmp_path):
    """``require`` and a library that cannot be built: constructing the
    tiers raises, as the featurizer's load does, instead of scoring in
    numpy unannounced."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setenv("KAKVEDA_NATIVE", "require")
    try:
        with pytest.raises(RuntimeError, match="require"):
            TieredIndex(512, TierConfig(tiered=True, hot_rows=0))
    finally:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_load_attempted", False)


@pytest.mark.chaos
@pytest.mark.usefixtures("needs_native")
def test_native_score_fault_falls_back():
    """``native.score`` armed: every scoring call takes the numpy path, the
    results are the same, the fallback count moves, the match never fails."""
    tiers, idx, val, rng = _build(2500, 512, TierConfig(tiered=True, hot_rows=0, nprobe=8))
    qs = _queries(idx, val, rng, 8)
    res_native = _run(tiers, qs, exact=True)
    before = tiers.scorer.fallbacks["fault"]
    faults.arm("native.score:1:-1")
    try:
        res_fault = _run(tiers, qs, exact=True)
        r_sc, r_sl, r_mode = tiers.match_host(qs[0][0], qs[0][1], 5, exact=False)
        assert r_mode == "routed" and len(r_sl)
    finally:
        faults.disarm()
    assert tiers.scorer.fallbacks["fault"] > before
    _assert_topk_parity(res_native, res_fault)
    _assert_topk_parity(res_native[:2], _run(tiers, qs[:2], exact=True))


@pytest.mark.usefixtures("needs_native")
def test_min_rows_floor_keeps_tiny_scans_numpy():
    """Scans under ``KAKVEDA_NATIVE_MIN_ROWS`` stay on the numpy path: a
    policy choice, so no fallback is counted either."""
    tiers, idx, val, rng = _build(64, 256, TierConfig(tiered=True, hot_rows=0, nprobe=4))
    tiers.scorer.min_rows = 1 << 20
    calls_before = sum(tiers.scorer.calls.values())
    fb_before = sum(tiers.scorer.fallbacks.values())
    sc, sl, _mode = tiers.match_host(idx[5], val[5], 3, exact=True)
    assert len(sl)
    assert sum(tiers.scorer.calls.values()) == calls_before
    assert sum(tiers.scorer.fallbacks.values()) == fb_before


# ---------------------------------------------------------------------------
# each scorer against the JAX package's library: bit-equal
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("needs_native")
@pytest.mark.parametrize("threads", [1, 4])
def test_scorers_bit_equal_to_jax_library(threads):
    if jax_native.load() is None:
        pytest.skip("the JAX package's native library is unavailable")
    rng = np.random.default_rng(3)
    dim, n, k, b = 512, 40000, 64, 3
    idx = rng.integers(0, dim + 1, size=(n, k)).astype(np.int32)
    val = rng.standard_normal((n, k)).astype(np.float32)
    qd = np.zeros((b, dim + 1), np.float32)
    qd[:, :dim] = rng.standard_normal((b, dim)).astype(np.float32)
    got = native.score_block(qd, idx, val, dim, threads=threads)
    assert np.array_equal(got, jax_native.score_block(qd, idx, val, dim, threads=threads))
    offsets = np.asarray([0, 100, 20000, n], np.int64)
    got = native.score_candidates(qd, idx, val, offsets, dim, threads=threads)
    assert np.array_equal(got, jax_native.score_candidates(qd, idx, val, offsets, dim, threads=threads))
    rows = rng.integers(0, n, size=25000).astype(np.int64)
    got = native.score_gather(qd[1], idx, val, rows, dim, threads=threads)
    assert np.array_equal(got, jax_native.score_gather(qd[1], idx, val, rows, dim, threads=threads))
    assert native.score_gather(qd[1], idx, val, np.asarray([n]), dim) is None  # out of range: refused
