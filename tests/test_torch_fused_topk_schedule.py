"""The fused_topk kernel's persistent schedule on the CPU, against the JAX package.

The CUDA kernel runs one block per SM; each block walks a contiguous range
of row tiles, keeps a stable running top-k of the candidates its tiles emit
and writes only those, and a second kernel merges the blocks' candidates.
Its plain version, ``fused_topk_schedule_reference``, is held here bit for
bit to ``fused_topk_reference`` (the CPU path and the kernel's oracle) and
to the Pallas kernel in interpret mode at a small ``row_tile``. Against
the plain version scores and row ids are equal (``assert_array_equal``):
both select from the same per-tile candidates and only the order of the
merge differs. Against the Pallas kernel the row ids are equal and the
scores within 1e-5 (f32 sums of the same terms in another order, as in
``test_torch_knn.py``). The layout helpers the kernel's wrapper uses (the
query padding, the blocks' tile ranges, the workspace shape) are checked
as plain functions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kakveda_tpu.ops import pallas_knn
from kakveda_tpu_torch.ops.fused_topk import (
    KPAD,
    cta_count,
    cta_tile_ranges,
    fused_topk_reference,
    fused_topk_schedule_reference,
    query_pad,
    workspace_shape,
)

TILE = 64  # rows per tile in these cases: 4-40 tiles from a few hundred rows


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _random(rows, dim=128, b=6, frac=0.8, seed=0):
    rng = np.random.default_rng(seed)
    emb = _unit(rng.standard_normal((rows, dim)))
    valid = rng.random(rows) < frac
    return emb, valid, _unit(rng.standard_normal((b, dim)))


def _fewer_valid():  # 3 valid rows of 640: every tile fills with -2.0
    emb, valid, q = _random(640)
    valid[:] = False
    valid[[5, 200, 601]] = True
    return emb, valid, q


def _all_invalid():
    emb, valid, q = _random(384)
    valid[:] = False
    return emb, valid, q


def _below_sentinel():
    # Rows opposite the query, 5x its length: scores near -5. One tile of all
    # rows below -2.0 (the max, then that column again at -2.0), one with
    # invalid rows at exactly -2.0, one with ordinary rows.
    emb, valid, q = _random(192, b=2)
    rng = np.random.default_rng(7)
    emb[:128] = -5 * q[0] + 0.01 * rng.standard_normal((128, 128)).astype(np.float32)
    valid[:] = True
    valid[64:128:3] = False
    q[1] = q[0]
    return emb, valid, q


def _duplicates():  # 16 distinct rows repeated across 20 tiles: ties everywhere
    base = _unit(np.random.default_rng(3).standard_normal((16, 128)))
    emb = np.tile(base, (80, 1))
    return emb, np.ones(len(emb), bool), base[:5].copy()


CASES = {
    "random": lambda: _random(1280),
    "ragged": lambda: _random(1000, frac=0.9, seed=1),
    "ragged_short": lambda: _random(150, frac=0.5, seed=2),
    "fewer_valid_than_k": _fewer_valid,
    "all_invalid": _all_invalid,
    "below_sentinel": _below_sentinel,
    "duplicates": _duplicates,
}
N_CTA = [1, 2, 3, 7, 132, "past_tiles"]


def _n_cta(n_cta, rows):
    return -(-rows // TILE) + 5 if n_cta == "past_tiles" else n_cta


def _torch(emb, valid, q):
    return torch.from_numpy(emb), torch.from_numpy(valid), torch.from_numpy(q)


@pytest.mark.parametrize("n_cta", N_CTA)
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_equals_reference(case, k, n_cta):
    emb, valid, q = _torch(*CASES[case]())
    want_v, want_i = fused_topk_reference(emb, valid, q, k, row_tile=TILE)
    got_v, got_i = fused_topk_schedule_reference(emb, valid, q, k, _n_cta(n_cta, len(emb)), row_tile=TILE)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), want_v.numpy())
    np.testing.assert_array_equal(got_i.numpy(), want_i.numpy())
    assert (got_i < len(emb)).all() and torch.isfinite(got_v).all()


@pytest.mark.parametrize("n_cta", [1, 3, 7, "past_tiles"])
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("case", ["random", "fewer_valid_than_k", "all_invalid", "below_sentinel", "duplicates"])
def test_schedule_equals_pallas_interpret(case, k, n_cta):
    emb, valid, q = CASES[case]()  # rows a multiple of TILE, as the Pallas kernel needs
    jv, ji = pallas_knn.fused_topk(
        jnp.asarray(emb), jnp.asarray(valid), jnp.asarray(q), k=k, row_tile=TILE, interpret=True
    )
    tv, ti = fused_topk_schedule_reference(*_torch(emb, valid, q), k, _n_cta(n_cta, len(emb)), row_tile=TILE)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


def test_fill_and_tie_cases_select_what_the_rule_says():
    emb, valid, q = _torch(*_fewer_valid())
    v, i = fused_topk_schedule_reference(emb, valid, q, 5, 3, row_tile=TILE)
    # The 3 valid rows first (in score order), then (-2.0, tile 0's lowest
    # column): the fill rounds of the first tile come before any later tile's.
    assert sorted(i[:, :3].flatten().tolist()) == sorted([5, 200, 601] * q.shape[0])
    assert (v[:, 3:] == -2.0).all() and (i[:, 3:] == 0).all()
    emb, valid, q = _torch(*_all_invalid())
    v, i = fused_topk_schedule_reference(emb, valid, q, 8, 2, row_tile=TILE)
    assert (v == -2.0).all() and (i == 0).all()  # every round of tile 0 takes column 0 again
    emb, valid, q = _torch(*_below_sentinel())
    v, i = fused_topk_schedule_reference(emb, valid, q[:1], 3, 2, row_tile=TILE)
    assert (v[0] > -1).all() and (i[0] >= 128).all()  # the ordinary tile's rows win
    emb, valid, q = _torch(*_duplicates())
    _, i = fused_topk_schedule_reference(emb, valid, q, 8, 7, row_tile=TILE)
    assert torch.equal(i.long(), torch.arange(5)[:, None] + 16 * torch.arange(8)[None, :])


def test_scores_below_sentinel_take_the_max_then_repeat_it():
    emb, valid, q = _below_sentinel()
    valid[64:128] = True  # tiles 0 and 1 are now all below -2.0
    emb, q = emb[:128], q[:1]
    s = emb @ q[0]
    best = [int(np.argmax(s[:64])), 64 + int(np.argmax(s[64:]))]
    # One tile, k = 8: round 0 takes the max, rounds 1-7 its column at -2.0,
    # and the merge puts those first.
    v, i = fused_topk_schedule_reference(*_torch(emb[:64], valid[:64], q), 8, 1, row_tile=TILE)
    assert (v[0, :7] == -2.0).all() and v[0, 7] == float(s[best[0]]) < -2.0 and (i[0] == best[0]).all()
    # k = 1: tile 0's pad lanes (-2.0, 0) outrank both tiles' maxima.
    v, i = fused_topk_schedule_reference(*_torch(emb, valid[:128], q), 1, 2, row_tile=TILE)
    assert v[0, 0] == -2.0 and i[0, 0] == 0
    # k = 4: tile 0's lanes 1-3, then its pad lane 4, before anything of tile 1.
    v, i = fused_topk_schedule_reference(*_torch(emb, valid[:128], q), 4, 2, row_tile=TILE)
    assert (v[0] == -2.0).all() and i[0].tolist() == [best[0]] * 3 + [0]


@pytest.mark.parametrize("n_tiles,n_cta", [(1, 1), (7, 3), (1024, 132), (1025, 132), (5, 132), (132, 132), (263, 8)])
def test_cta_ranges_cover_every_tile_once(n_tiles, n_cta):
    ranges = cta_tile_ranges(n_tiles, n_cta)
    assert len(ranges) == n_cta and ranges[0][0] == 0 and ranges[-1][1] == n_tiles
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # contiguous, in tile order
    sizes = [stop - start for start, stop in ranges]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)
    used = cta_count(n_tiles, n_cta)
    assert used == min(n_tiles, n_cta) and all(s > 0 for s in sizes[:used])


def test_main_path_schedule_is_seven_or_eight_tiles_a_block():
    sizes = {stop - start for start, stop in cta_tile_ranges(1024, 132)}
    assert sizes == {7, 8}


@pytest.mark.parametrize("b", [1, 7, 8, 9, 16, 17, 32, 33, 64, 65, 100, 128, 129])
def test_query_pad(b):
    n = query_pad(b)
    assert n >= b and (n in (8, 16, 32, 64) or (n % 64 == 0 and b > 64))
    assert n < 2 * b or n == 8  # the smallest such width
    if b <= 64:
        assert n == max(8, 1 << (b - 1).bit_length())


def test_workspace_shape():
    assert workspace_shape(1, 1 << 20, 132) == (8, 132, KPAD)
    assert workspace_shape(64, 1 << 20, 132) == (64, 132, KPAD)
    assert workspace_shape(65, 1030, 132) == (128, 2, KPAD)  # fewer tiles than SMs
    assert workspace_shape(3, 5, 132) == (8, 1, KPAD)
    with pytest.raises(ValueError):
        query_pad(0)
