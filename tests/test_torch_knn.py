"""The port's top-k and index against the JAX package, on the same inputs.

* ``fused_topk_reference`` (the CUDA kernel's plain version and CPU path)
  against the Pallas ``fused_topk`` run in interpret mode: ids identical,
  including exact ties and the -2.0 pad candidates; scores within 1e-5
  (both f32 on the CPU; only the summation order differs).
* ``Knn`` against ``ShardedKnn`` on a one-device mesh (same tie order as
  the single-device port), and a state carried from an 8-shard index.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kakveda_tpu.ops import pallas_knn
from kakveda_tpu.ops.knn import ShardedKnn
from kakveda_tpu.parallel.mesh import create_mesh
from kakveda_tpu_torch.convert import knn_state_from_jax
from kakveda_tpu_torch.ops.fused_topk import fused_topk, fused_topk_reference
from kakveda_tpu_torch.ops.knn import Knn, batch_bucket, pow2_bucket

ATOL = 1e-5


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _random_case():
    rng = np.random.default_rng(0)
    emb = _unit(rng.standard_normal((256, 128)))
    valid = np.zeros(256, bool)
    valid[rng.permutation(256)[:200]] = True
    return emb, valid, _unit(rng.standard_normal((6, 128))), 5


def _ties_case():
    rng = np.random.default_rng(3)
    base = _unit(rng.standard_normal((4, 128)))
    return np.tile(base, (32, 1)), np.ones(128, bool), base[:2].copy(), 4


def _fewer_valid_case():
    rng = np.random.default_rng(0)
    emb = _unit(rng.standard_normal((128, 128)))
    valid = np.zeros(128, bool)
    valid[7] = True
    return emb, valid, _unit(rng.standard_normal((6, 128))), 5


CASES = {"random": _random_case, "ties": _ties_case, "fewer_valid": _fewer_valid_case}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kplus", [0, 3])
def test_reference_matches_pallas_interpret(case, kplus):
    emb, valid, q, k = CASES[case]()
    k = min(k + kplus, 8)
    jv, ji = pallas_knn.fused_topk(
        jnp.asarray(emb), jnp.asarray(valid), jnp.asarray(q), k=k, row_tile=64, interpret=True
    )
    tv, ti = fused_topk_reference(
        torch.from_numpy(emb), torch.from_numpy(valid), torch.from_numpy(q), k,
        row_tile=64, chunk_tiles=1,
    )
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    if case == "ties":
        assert ti[0].tolist()[:4] == [0, 4, 8, 12] and ti[1].tolist()[:4] == [1, 5, 9, 13]
    if case == "fewer_valid":
        assert (ti[:, 0] == 7).all() and (tv[:, 1:] == -2.0).all()


def test_reference_ragged_tile_never_selects_missing_rows():
    # 100 rows in tiles of 64: the last tile is ragged and its missing rows
    # must never appear, even as -2.0 fill.
    rng = np.random.default_rng(1)
    emb = torch.from_numpy(_unit(rng.standard_normal((100, 32))))
    valid = torch.zeros(100, dtype=torch.bool)
    valid[70] = True
    v, i = fused_topk_reference(emb, valid, emb[:3], 8, row_tile=64)
    assert (i < 100).all()
    assert i[:, 0].tolist() == [70, 70, 70] and i[0, 1:].tolist() == [0] * 7
    # the CPU wrapper is the reference at the kernel's tile
    wv, wi = fused_topk(emb, valid, emb[:3], 8)
    rv, ri = fused_topk_reference(emb, valid, emb[:3], 8)
    assert torch.equal(wi, ri) and torch.equal(wv, rv)


def _sparse_rows(rng, n, dim, nnz, width=16):
    """(idx, val) rows of 1..nnz unique buckets, padded to `width` with the
    `dim` sentinel."""
    idx = np.full((n, width), dim, np.int32)
    val = np.zeros((n, width), np.float32)
    for r in range(n):
        m = int(rng.integers(1, nnz + 1))
        idx[r, :m] = rng.choice(dim, size=m, replace=False)
        val[r, :m] = rng.standard_normal(m)
        val[r, :m] /= np.linalg.norm(val[r, :m])
    return idx, val


@pytest.mark.parametrize("dim,nnz,lo,hi", [(128, 12, 0, 150), (128, 80, 7, 90), (40, 40, 0, 60), (128, 12, 5, 5)])
def test_sparse_rows_is_the_reference_sparsify_of_the_dense_rows(dim, nnz, lo, hi):
    """The snapshot's on-device sparsify gives the JAX package's
    ``dense_rows_to_sparse`` of the same rows, bit for bit: columns
    ascending, (dim, 0) pads, K a power of two ≥ max(64, the widest row),
    also past dim and for an empty range."""
    from kakveda_tpu.ops.featurizer import dense_rows_to_sparse

    rng = np.random.default_rng(dim + nnz)
    tk = Knn(256, dim, device="cpu")
    emb, valid = tk.alloc()
    types = tk.alloc_i32()
    idx, val = _sparse_rows(rng, 150, dim, nnz, width=max(16, nnz))
    tk.insert_sparse(emb, valid, types, idx, val, np.arange(150, dtype=np.int32), np.zeros(150, np.int32))
    got_i, got_v = tk.sparse_rows(emb, lo, hi)
    want_i, want_v = dense_rows_to_sparse(tk.gather_slots(emb, np.arange(lo, hi)), dim)
    assert got_i.dtype == np.int32 and got_v.dtype == np.float32
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_v, want_v)


@pytest.fixture
def one_device_mesh():
    return create_mesh("data:1")


def _both(mesh, capacity, dim, k):
    jk = ShardedKnn(mesh, capacity, dim, k=k)
    tk = Knn(capacity, dim, k=k, device="cpu")
    assert jk.capacity == tk.capacity and jk.store_dtype == jnp.float32
    return jk, tk


def test_knn_insert_sparse_and_topk_match_jax(one_device_mesh):
    rng = np.random.default_rng(11)
    dim, cap, k = 128, 256, 5
    jk, tk = _both(one_device_mesh, cap, dim, k)
    je, jv = jk.alloc()
    jt = jk.alloc_i32()
    te, tv = tk.alloc()
    tt = tk.alloc_i32()
    idx, val = _sparse_rows(rng, 150, dim, 12)
    tids = rng.integers(0, 3, 150).astype(np.int32)
    # ragged batches (padded to pow2 buckets inside JAX) incl. a re-write
    for lo, hi in [(0, 37), (37, 101), (101, 150), (10, 13)]:
        slots = np.arange(lo, hi, dtype=np.int32)
        je, jv, jt = jk.insert_sparse(je, jv, jt, idx[lo:hi], val[lo:hi], slots, tids[lo:hi])
        te, tv, tt = tk.insert_sparse(te, tv, tt, idx[lo:hi], val[lo:hi], slots, tids[lo:hi])
    # a pad row (slot == capacity) is dropped
    tk.insert_sparse(te, tv, tt, idx[:1], val[:1], np.array([cap], np.int32), tids[:1])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-7, rtol=0)
    np.testing.assert_allclose(
        tk.gather_slots(te, np.arange(20)), jk.gather_slots(je, np.arange(20)), atol=1e-7
    )

    qi, qv = idx[[3, 77, 120, 5, 140]], val[[3, 77, 120, 5, 140]]
    for b in (1, 3, 5):  # ragged query batches pad to a pow2 bucket
        jp = jk.topk_async_sparse(je, jv, qi[:b], qv[:b])
        tp = tk.topk_async_sparse(te, tv, qi[:b], qv[:b])
        assert tuple(tp.shape) == (batch_bucket(b), 2 * k) == tuple(jp.shape)
        js, jsl = jk.topk_result(jp)
        ts, tsl = tk.topk_result(tp)
        np.testing.assert_array_equal(tsl[:b], jsl[:b])
        np.testing.assert_allclose(ts[:b], js[:b], atol=ATOL, rtol=0)
        assert tsl[:b, 0].tolist() == [3, 77, 120, 5, 140][:b]

    # type pre-filter: mask_valid, then the same top-k (≥ k rows per type)
    for tid in range(3):
        jm = jk.mask_valid(jv, jt, tid)
        tm = tk.mask_valid(tv, tt, tid)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        js, jsl = jk.topk_result(jk.topk_async_sparse(je, jm, qi, qv))
        ts, tsl = tk.topk_result(tk.topk_async_sparse(te, tm, qi, qv))
        np.testing.assert_array_equal(tsl[:5], jsl[:5])
        np.testing.assert_allclose(ts[:5], js[:5], atol=ATOL, rtol=0)

    # dense insert (a version re-write of three slots) lands like the JAX one
    dense = np.random.default_rng(2).standard_normal((3, dim)).astype(np.float32)
    je, jv = jk.insert(je, jv, dense, np.array([4, 200, 255], np.int32))
    te, tv = tk.insert(te, tv, dense, np.array([4, 200, 255], np.int32))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=0, rtol=0)

    # scatter_i32 re-tags slots; out-of-range slots are dropped
    slots = np.array([0, 1, 2, cap + 3], np.int32)
    vals = np.array([7, 7, 7, 7], np.int32)
    jt = jk.scatter_i32(jt, slots, vals)
    tt = tk.scatter_i32(tt, slots, vals)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_knn_matches_pallas_path_with_fewer_valid_than_k(one_device_mesh, monkeypatch):
    # With fewer live rows than k the -2.0 fill ids follow the tile rule;
    # the JAX index on its Pallas path (interpreted) must agree exactly.
    monkeypatch.setenv("KAKVEDA_PALLAS", "interpret")
    rng = np.random.default_rng(5)
    dim, cap, k = 128, 2048, 5
    jk, tk = _both(one_device_mesh, cap, dim, k)
    assert jk.use_pallas
    je, jv = jk.alloc()
    jt = jk.alloc_i32()
    te, tv = tk.alloc()
    tt = tk.alloc_i32()
    idx, val = _sparse_rows(rng, 40, dim, 10)
    slots = np.array([3, 1500, 1501, *range(1030, 1067)], np.int32)
    tids = np.array([1, 1, 1] + [0] * 37, np.int32)
    je, jv, jt = jk.insert_sparse(je, jv, jt, idx, val, slots, tids)
    tk.insert_sparse(te, tv, tt, idx, val, slots, tids)
    q_i, q_v = idx[:4], val[:4]
    js, jsl = jk.topk_result(jk.topk_async_sparse(je, jk.mask_valid(jv, jt, 1), q_i, q_v))
    ts, tsl = tk.topk_result(tk.topk_async_sparse(te, tk.mask_valid(tv, tt, 1), q_i, q_v))
    np.testing.assert_array_equal(tsl, jsl)
    np.testing.assert_allclose(ts, js, atol=ATOL, rtol=0)
    assert (ts[:, 3:] == -2.0).all()


def test_state_from_8_shard_index_gives_same_topk():
    mesh = create_mesh("data:-1")
    rng = np.random.default_rng(9)
    dim, k = 128, 5
    jk = ShardedKnn(mesh, 200, dim, k=k)
    assert jk.n_shards == 8
    je, jv = jk.alloc()
    jt = jk.alloc_i32()
    # Dense rows: no exact score ties, whose order on 8 shards follows the
    # shard-major merge rather than the slot.
    idx, val = _sparse_rows(rng, 150, dim, 64, width=64)
    tids = rng.integers(0, 2, 150).astype(np.int32)
    je, jv, jt = jk.insert_sparse(je, jv, jt, idx, val, np.arange(150, dtype=np.int32), tids)
    te, tv, tt = knn_state_from_jax(
        np.asarray(je), np.asarray(jv), np.asarray(jt), jk.n_shards, jk.rows_per_shard, "cpu"
    )
    tk = Knn(jk.capacity, dim, k=k, device="cpu")
    np.testing.assert_array_equal(tt[:150].numpy(), tids)
    qi, qv = idx[[0, 9, 64, 149]], val[[0, 9, 64, 149]]
    js, jsl = jk.topk_result(jk.topk_async_sparse(je, jv, qi, qv))
    ts, tsl = tk.topk_result(tk.topk_async_sparse(te, tv, qi, qv))
    np.testing.assert_array_equal(tsl, jsl)
    np.testing.assert_allclose(ts, js, atol=ATOL, rtol=0)
    assert tsl[:, 0].tolist() == [0, 9, 64, 149]


def test_buckets_and_capacity_cap():
    assert [pow2_bucket(n) for n in (1, 2, 3, 5, 64, 65)] == [1, 2, 4, 8, 64, 128]
    assert pow2_bucket(3, floor=8) == 8 and pow2_bucket(300, cap=256) == 256
    assert batch_bucket(9) == 16
    with pytest.raises(ValueError, match="2\\^24"):
        Knn((1 << 24) + 1, 16, device="cpu")
