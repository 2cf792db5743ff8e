"""The port's clustering against the JAX package's, on the same inputs.

* ``_block_topk`` and the delta top-ks (``delta_topk_dense`` /
  ``delta_topk_sparse`` + ``unpack_topk``) against the JAX functions (whose
  ``approx_max_k`` is exact on the CPU): scores within 1e-5 (both f32, only
  the summation order differs); ids equal wherever the neighbouring JAX
  scores differ by more than 1e-5, and equal on exact ties (lowest row
  first) — duplicated rows, invalid rows (-inf) and the pad rows past a
  ragged index. At k = 1 XLA's CPU ``approx_max_k`` keeps the LAST row of
  a tie within each ``_BLOCK`` (at k ≥ 2 the first), so there the port is
  held to the first rank of the JAX function at k = 2: the lowest row of
  the best score, the rule of every other k (mining runs at k ≥ 2).
* ``build_knn_edges`` / ``cluster_embeddings`` in all three tiers, with the
  tier constants shrunk in both packages as the JAX tests shrink them: the
  same partition (and in the exact tiers the same edges) on corpora that
  keep every pair more than 1e-4 from the threshold (asserted). The
  projection tier takes the JAX matrix through
  ``convert.mine_projection_from_jax``; with the port's own generator it is
  held to the reference's recall test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kakveda_tpu.ops.clustering as jcl
import kakveda_tpu.ops.incremental as jinc
import kakveda_tpu_torch.ops.clustering as tcl
import kakveda_tpu_torch.ops.incremental as tinc
from kakveda_tpu_torch.convert import mine_projection_from_jax

ATOL = 1e-5
MARGIN = 1e-4  # least distance of any pair's cosine from the threshold


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture
def shrink(monkeypatch):
    """Set tier constants in both packages; the JAX sweep re-traces."""

    def set_(**kw):
        for name, value in kw.items():
            monkeypatch.setattr(jcl, name, value, raising=False)
            monkeypatch.setattr(tcl, name, value)
        jcl._block_topk.clear_cache()

    yield set_
    jcl._block_topk.clear_cache()


def _assert_topk_equal(jv, ji, tv, ti):
    """Scores within ATOL (equal infinities), ids equal where the JAX
    scores of neighbouring ranks differ by more than ATOL or not at all."""
    assert jv.shape == tv.shape and ji.shape == ti.shape
    fin = np.isfinite(jv)
    assert np.array_equal(fin, np.isfinite(tv))
    assert np.array_equal(jv[~fin], tv[~fin])
    assert np.abs(jv[fin] - tv[fin]).max(initial=0.0) <= ATOL
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(jv, axis=1))
    gap = np.where(np.isnan(gap), 0.0, gap)  # -inf next to -inf: an exact tie
    near = (gap > 0) & (gap <= ATOL)
    loose = np.zeros_like(fin)
    loose[:, :-1] |= near
    loose[:, 1:] |= near
    bad = (ji != ti) & ~loose
    assert not bad.any(), np.argwhere(bad)[:5]


def _index(n, d, seed, dup=False, invalid=0.0):
    rng = np.random.default_rng(seed)
    v = _unit(rng.standard_normal((n, d)))
    if dup:  # the second half repeats rows of the first, across column blocks
        half = n // 2
        v[half:] = v[rng.integers(0, half, n - half)]
    valid = rng.random(n) >= invalid
    return v, valid


def _jax_block_topk(q, v, valid, k):
    pad = (-len(v)) % jcl._BLOCK  # the JAX sweep takes a _BLOCK-padded index
    vp = np.concatenate([v, np.zeros((pad, v.shape[1]), np.float32)])
    okp = np.concatenate([valid, np.zeros(pad, bool)])
    out = np.asarray(jcl._block_topk(jnp.asarray(q), jnp.asarray(vp), jnp.asarray(okp), max(k, 2)))
    return out[:, [0, 2]] if k == 1 else out


def _jax_unpacked(fn, k):
    """(scores, ids) of a JAX delta at ``k`` (at k = 1: the first rank at 2)."""
    s, i = fn(max(k, 2))
    return (s[:, :1], i[:, :1]) if k == 1 else (s, i)


TOPK_CASES = {
    # name: (n, d, seed, dup, invalid fraction, score-block bytes)
    "ragged": (3000, 64, 0, False, 0.0, None),
    "dup_invalid": (3000, 64, 1, True, 0.3, None),
    "dup_column_blocks": (2500, 32, 2, True, 0.1, 4 * 7 * 301),  # 301-column blocks
    "tiny_index": (5, 16, 3, False, 0.4, None),  # n < k + 1: pad rows fill the width
    "mostly_invalid": (1500, 32, 4, True, 0.995, None),
}


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
@pytest.mark.parametrize("k", [1, 8, 33])
def test_block_topk_matches_jax(case, k, monkeypatch):
    n, d, seed, dup, invalid, block_bytes = TOPK_CASES[case]
    if block_bytes:
        monkeypatch.setattr(tcl, "_SCORE_BLOCK_BYTES", block_bytes)
    v, valid = _index(n, d, seed, dup, invalid)
    q = v[np.random.default_rng(seed).integers(0, n, 7)]
    want = _jax_block_topk(q, v, valid, k)
    got = tcl._block_topk(torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(valid), k).numpy()
    kw = want.shape[1] // 2
    assert got.shape == want.shape
    _assert_topk_equal(want[:, :kw], want[:, kw:], got[:, :kw], got[:, kw:])
    if dup and k == 33:  # a duplicated query meets its copies at one score, lowest row first
        row = got[:, kw:]
        same = got[:, :kw] == got[:, :1]
        for r in range(len(q)):
            ids = row[r][same[r]]
            assert np.array_equal(ids, np.sort(ids))


def test_block_topk_blocks_never_change_the_answer(monkeypatch):
    v, valid = _index(2000, 32, 5, dup=True, invalid=0.2)
    q, vt, okt = torch.from_numpy(v[:40]), torch.from_numpy(v), torch.from_numpy(valid)
    one = tcl._block_topk(q, vt, okt, 33).numpy()
    for width in (1, 33, 34, 257, 1999):  # BLAS sums narrow blocks in another order
        monkeypatch.setattr(tcl, "_SCORE_BLOCK_BYTES", 4 * 40 * width)
        got = tcl._block_topk(q, vt, okt, 33).numpy()
        _assert_topk_equal(one[:, :33], one[:, 33:], got[:, :33], got[:, 33:])


@pytest.mark.parametrize("k", [1, 8, 33])
def test_delta_topk_dense_matches_jax(k):
    v, _ = _index(700, 48, 6, dup=True)
    p = jcl._corpus_pad(700)
    vp = np.concatenate([v, np.zeros((p - 700, 48), np.float32)])
    q = np.zeros((16, 48), np.float32)
    q[:11] = v[300:311]
    js, ji = _jax_unpacked(
        lambda kk: jinc.unpack_topk(jinc.delta_topk_dense(jnp.asarray(q), jnp.asarray(vp), 311, kk), 11), k)
    ts, ti = tinc.unpack_topk(tinc.delta_topk_dense(torch.from_numpy(q), torch.from_numpy(vp), 311, k), 11)
    assert ti.dtype == np.int64
    _assert_topk_equal(js, ji, ts, ti)


@pytest.mark.parametrize("k", [1, 8, 33])
@pytest.mark.parametrize("cap,n_live,batch", [(256, 200, 5), (16, 12, 3), (2048, 1500, 64)])
def test_delta_topk_sparse_matches_jax(k, cap, n_live, batch):
    from kakveda_tpu.ops.featurizer import HashedNGramFeaturizer

    dim = 256
    feat = HashedNGramFeaturizer(dim=dim)
    texts = [f"timeout calling service {i % 37} attempt {i % 5}" for i in range(n_live)]
    idx, val = feat.encode_batch_sparse(texts)
    dense = np.zeros((n_live, dim + 1), np.float32)
    np.add.at(dense, (np.arange(n_live)[:, None], idx), val)
    emb = np.zeros((cap, dim), np.float32)
    emb[:n_live] = dense[:, :dim]
    valid = np.zeros(cap, bool)
    valid[:n_live] = True
    qi, qv = idx[-batch:], val[-batch:]
    js, ji = _jax_unpacked(lambda kk: jinc.unpack_topk(
        jinc.delta_topk_sparse(jnp.asarray(emb), jnp.asarray(valid), qi, qv, kk), batch), k)
    ts, ti = tinc.unpack_topk(
        tinc.delta_topk_sparse(torch.from_numpy(emb), torch.from_numpy(valid), qi, qv, k), batch)
    _assert_topk_equal(js, ji, ts, ti)


# ---------------------------------------------------------------------------
# build_knn_edges / cluster_embeddings, all three tiers
# ---------------------------------------------------------------------------


def _clustered(seed, n_clusters=3, per=40, dim=64, noise=0.05, threshold=0.8):
    rng = np.random.default_rng(seed)
    centers = _unit(rng.normal(size=(n_clusters, dim)))
    pts = np.concatenate([centers[i] + noise * rng.normal(size=(per, dim)) for i in range(n_clusters)])
    pts = _unit(pts)
    cos = pts.astype(np.float64) @ pts.T.astype(np.float64)
    assert np.abs(cos - threshold).min() > MARGIN, "corpus has a pair at the threshold"
    return pts


def _hub(threshold=0.9):
    rng = np.random.default_rng(2)
    hub = _unit(rng.normal(size=64))
    pts = _unit(np.concatenate([[hub], hub + 0.02 * rng.normal(size=(20, 64))]))
    cos = pts.astype(np.float64) @ pts.T.astype(np.float64)
    assert np.abs(cos - threshold).min() > MARGIN
    return pts


def _edge_set(rows, cols):
    return set(zip(np.asarray(rows).tolist(), np.asarray(cols).tolist()))


TIERS = {
    # name: (constants, corpus, threshold, knn_k)
    "dense": ({}, lambda: _clustered(0), 0.8, None),
    "dense_hub_k2": ({}, _hub, 0.9, 2),
    "sweep": (dict(_DENSE_MAX=0, _BLOCK=32, _QBLOCK=48), lambda: _clustered(0), 0.8, None),
    "sweep_hub_k2": (dict(_DENSE_MAX=0, _BLOCK=16, _QBLOCK=8), _hub, 0.9, 2),
    "sweep_many_small": (dict(_DENSE_MAX=0, _BLOCK=64, _QBLOCK=100),
                         lambda: _clustered(3, n_clusters=25, per=9, dim=96, noise=0.04), 0.8, None),
}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_exact_tiers_match_jax(tier, shrink):
    consts, corpus, thr, knn_k = TIERS[tier]
    shrink(**consts)
    pts = corpus()
    kw = {} if knn_k is None else {"knn_k": knn_k}
    want = jcl.cluster_embeddings(pts, threshold=thr, **kw)
    got = tcl.cluster_embeddings(pts, threshold=thr, device="cpu", **kw)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    if tier.startswith("sweep"):
        k = knn_k or jcl._KNN_K
        jr, jc = jcl.build_knn_edges(pts, k=k, threshold=thr)
        tr, tc = tcl.build_knn_edges(pts, k=k, threshold=thr, device="cpu")
        assert tr.dtype == np.int64 and _edge_set(tr, tc) == _edge_set(jr, jc)


def test_dense_and_sweep_tiers_agree(shrink):
    pts = _clustered(0)
    dense = tcl.cluster_embeddings(pts, threshold=0.8, device="cpu")
    shrink(_DENSE_MAX=0, _BLOCK=32, _QBLOCK=48)
    assert np.array_equal(tcl.cluster_embeddings(pts, threshold=0.8, device="cpu"), dense)
    assert len(set(dense.tolist())) == 3


@pytest.mark.parametrize("natural", [True, False], ids=["tier_switch", "forced"])
def test_projection_tier_with_the_jax_matrix_matches_jax(natural, shrink):
    pts = _clustered(1, dim=512, per=30)
    if natural:
        shrink(_DENSE_MAX=0, _EXACT_SWEEP_MAX=0, _MINE_DIM=64)
        kw = {}
    else:
        shrink(_MINE_DIM=64, _BLOCK=64, _QBLOCK=40)
        kw = {"force_projection": True}
    r = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (512, 64), jnp.float32))
    proj = mine_projection_from_jax(r, "cpu")
    assert proj.dtype == torch.float32 and proj.shape == (512, 64)
    want = jcl.cluster_embeddings(pts, threshold=0.8, **kw)
    got = tcl.cluster_embeddings(pts, threshold=0.8, projection=proj, device="cpu", **kw)
    assert np.array_equal(got, want)
    # The candidates' re-scored edges: the same set as the JAX sweep's.
    jr, jc = jcl.build_knn_edges(pts, threshold=0.8, **kw)
    tr, tc = tcl.build_knn_edges(pts, threshold=0.8, projection=proj, device="cpu", **kw)
    assert _edge_set(tr, tc) == _edge_set(jr, jc)


def test_projection_tier_recall_on_separable_data():
    """The reference's recall test at its own size, on the port's own
    generator: every edge same-cluster (exact re-score), every row on an
    edge, every true cluster one component."""
    rng = np.random.default_rng(42)
    c, per, dim = 24, 512, 2048
    seeds = _unit(rng.standard_normal((c, dim)))
    truth = np.repeat(np.arange(c), per)
    noise = (0.3 / np.sqrt(dim)) * rng.standard_normal((c * per, dim)).astype(np.float32)
    vecs = _unit(seeds[truth] + noise)
    stats = {}
    rows, cols = tcl.build_knn_edges(vecs, threshold=0.6, force_projection=True, device="cpu", stats=stats)
    assert len(rows) > 0 and {"project_ms", "sweep_ms", "rescore_ms"} <= set(stats)
    assert np.all(truth[rows] == truth[cols])
    connected = np.zeros(len(vecs), bool)
    connected[rows] = True
    connected[cols] = True
    assert connected.all()
    labels = tcl.cluster_embeddings(vecs, threshold=0.6, force_projection=True, device="cpu")
    for k in range(c):
        assert len(np.unique(labels[truth == k])) == 1, f"cluster {k} split"
    assert len(np.unique(labels)) == c


def test_threshold_zero_ignores_pad_rows(shrink):
    vecs = np.eye(8, dtype=np.float32)[:5]  # orthogonal rows: every cosine is exactly 0
    shrink(_DENSE_MAX=0)
    want = jcl.cluster_embeddings(vecs, threshold=0.0)
    got = tcl.cluster_embeddings(vecs, threshold=0.0, device="cpu")
    assert np.array_equal(got, want) and len(np.unique(got)) == 1


def test_cluster_embeddings_edge_cases():
    assert tcl.cluster_embeddings(np.zeros((0, 8), np.float32), device="cpu").shape == (0,)
    one = tcl.cluster_embeddings(_unit(np.ones((1, 8))), device="cpu")
    assert one.tolist() == [0]
    # A tensor runs on its own device; the labels are the min member.
    pts = _clustered(0)
    t = tcl.cluster_embeddings(torch.from_numpy(pts), threshold=0.8)
    assert np.array_equal(t, jcl.cluster_embeddings(pts, threshold=0.8))
    assert np.array_equal(tcl._sparse_components(4, np.array([3, 1]), np.array([2, 0])), [0, 0, 2, 2])


def test_numpy_input_wants_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcl.cluster_embeddings(_clustered(0), threshold=0.8)
