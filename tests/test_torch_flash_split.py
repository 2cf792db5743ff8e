"""The flash kernel's split schedule on the CPU, against the JAX package.

The CUDA kernel splits each (b·kv, q block)'s cache across blocks and
combines the splits' (m, l, acc); it skips the tiles that no query row of a
block can see. Its plain version of the split schedule,
``flash_gqa_cache_split_reference``, is held here to the unsplit plain
version ``flash_gqa_cache_reference`` (unchanged, the CPU path of every
parity test) and to the Pallas kernel in interpret mode, on the same numpy
inputs as ``test_torch_attention.py`` (its ``CASES``), with 16-row tiles so
that those 32-64-row caches make 2-4 tiles, and on longer caches at the
kernel's own 64-row tile. The split count and the live-tile predicate are
checked as plain functions.

Tolerances: 1e-5 in f32 — the same terms, summed per split and rescaled by
e^(mᵢ−m*) before they are added, round in another order; 2e-2 in bf16 —
one bf16 step of |out| ≲ 3 is ≤ 1.6e-2, and P is cast to bf16 relative to
each split's own running max, so a probability may round the other way.
Rows that see no slot are exact zeros in every version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_attention import CASES, _inputs, _np, _t

from kakveda_tpu.models.attention import flash_gqa_cache as jax_flash
from kakveda_tpu.models.llama import _kv_quant_rows as jax_quant
from kakveda_tpu_torch.models import attention as port
from kakveda_tpu_torch.models.llama import _kv_quant_rows

torch.set_num_threads(2)

TOL = {"f32": 1e-5, "bf16": 2e-2}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
TILE = 16
SPLITS = [1, 2, 3, "per_tile"]

LONG_CASES = [
    # (B, S, H, KV, L, D, pos0, valid, window) at the kernel's 64-row tile
    (3, 1, 8, 2, 300, 16, 300, "slots", 0),  # decode, ragged last tile, slot 0 empty
    (2, 4, 8, 2, 200, 16, 150, "leftpad", 40),  # prefill under a window and left pad
    (2, 1, 8, 4, 520, 32, 520, None, 0),  # ragged last split
]


def _n_split(n_split, l, tile):
    return -(-l // tile) if n_split == "per_tile" else n_split


def _torch_case(b, s, h, kv, l, d, valid, seed, dtype, kv8):
    q, k, v, kv_valid = _inputs(b, s, h, kv, l, d, valid, seed)
    tdt = TDT[dtype]
    tq, tk, tv = _t(q, tdt), _t(k, tdt), _t(v, tdt)
    kw = {}
    if kv8:
        tk, ks = _kv_quant_rows(tk)
        tv, vs = _kv_quant_rows(tv)
        kw = dict(k_scale=ks, v_scale=vs)
    tvalid = None if kv_valid is None else torch.from_numpy(kv_valid)
    return tq, tk, tv, tvalid, kw


def _seen(s, l, pos0, window, kv_valid):
    """[B, S] whether query position i sees any slot."""
    q_pos = pos0 + np.arange(s)[:, None]
    keep = q_pos >= np.arange(l)[None, :]
    if window:
        keep &= (q_pos - np.arange(l)[None, :]) < window
    keep = keep[None] & (kv_valid[:, None, :] if kv_valid is not None else True)
    return keep.any(-1)


def _check_zeros(got, s, l, pos0, window, kv_valid, valid):
    if kv_valid is None:
        return
    seen = _seen(s, l, pos0, window, kv_valid.numpy())
    assert not got.float().numpy()[~seen].any()
    if valid == "slots":
        assert not seen[0].any()


@pytest.mark.parametrize("kv8", [False, True], ids=["float_cache", "int8_cache"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_split", SPLITS, ids=[f"split{n}" for n in SPLITS])
@pytest.mark.parametrize("b,s,h,kv,l,d,pos0,valid,window", CASES)
def test_split_reference_matches_reference(b, s, h, kv, l, d, pos0, valid, window, n_split, dtype, kv8):
    tq, tk, tv, tvalid, kw = _torch_case(b, s, h, kv, l, d, valid, b * 7 + s + l, dtype, kv8)
    n = _n_split(n_split, l, TILE)
    got = port.flash_gqa_cache_split_reference(tq, tk, tv, pos0, tvalid, window=window, n_split=n, tile=TILE, **kw)
    want = port.flash_gqa_cache_reference(tq, tk, tv, pos0, tvalid, window=window, **kw)
    assert got.dtype == want.dtype and got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=TOL[dtype], rtol=TOL[dtype])
    _check_zeros(got, s, l, pos0, window, tvalid, valid)


@pytest.mark.parametrize("kv8", [False, True], ids=["float_cache", "int8_cache"])
@pytest.mark.parametrize("n_split", [2, 3, "per_tile"], ids=["split2", "split3", "per_tile"])
@pytest.mark.parametrize("b,s,h,kv,l,d,pos0,valid,window", LONG_CASES)
def test_split_reference_long_cache(b, s, h, kv, l, d, pos0, valid, window, n_split, kv8):
    """Caches of several 64-row tiles, split as the kernel splits them."""
    tq, tk, tv, tvalid, kw = _torch_case(b, s, h, kv, l, d, valid, l, "f32", kv8)
    n = _n_split(n_split, l, port.KERNEL_L_BLK)
    assert len(port.flash_split_plan(l, n)) > 1
    got = port.flash_gqa_cache_split_reference(tq, tk, tv, pos0, tvalid, window=window, n_split=n, **kw)
    want = port.flash_gqa_cache_reference(tq, tk, tv, pos0, tvalid, window=window, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    _check_zeros(got, s, l, pos0, window, tvalid, valid)


@pytest.mark.parametrize("kv8", [False, True], ids=["float_cache", "int8_cache"])
@pytest.mark.parametrize("b,s,h,kv,l,d,pos0,valid,window", CASES + LONG_CASES)
def test_one_split_is_the_reference_bit_for_bit(b, s, h, kv, l, d, pos0, valid, window, kv8):
    tq, tk, tv, tvalid, kw = _torch_case(b, s, h, kv, l, d, valid, 3, "f32", kv8)
    got = port.flash_gqa_cache_split_reference(tq, tk, tv, pos0, tvalid, window=window, n_split=1, **kw)
    assert torch.equal(got, port.flash_gqa_cache_reference(tq, tk, tv, pos0, tvalid, window=window, **kw))


@pytest.mark.parametrize("kv8", [False, True], ids=["float_cache", "int8_cache"])
@pytest.mark.parametrize("b,s,h,kv,l,d,pos0,valid,window", CASES)
def test_split_reference_matches_pallas_interpret(b, s, h, kv, l, d, pos0, valid, window, kv8):
    q, k, v, kv_valid = _inputs(b, s, h, kv, l, d, valid, seed=b * 7 + s + l)
    jq, jk, jv = (jnp.asarray(x, jnp.float32) for x in (q, k, v))
    jvalid = None if kv_valid is None else jnp.asarray(kv_valid)
    tvalid = None if kv_valid is None else torch.from_numpy(kv_valid)
    n = _n_split("per_tile", l, TILE)
    if kv8:
        k8, ks = jax_quant(jk)
        v8, vs = jax_quant(jv)
        want = jax_flash(jq, k8, v8, jnp.asarray(pos0), jvalid, k_scale=ks, v_scale=vs,
                         q_blk=8, l_blk=16, window=window, interpret=True)
        got = port.flash_gqa_cache_split_reference(
            _t(q), _np(k8), _np(v8), pos0, tvalid, k_scale=_np(ks), v_scale=_np(vs),
            window=window, n_split=n, tile=TILE,
        )
    else:
        want = jax_flash(jq, jk, jv, jnp.asarray(pos0), jvalid, q_blk=8, l_blk=16,
                         window=window, interpret=True)
        got = port.flash_gqa_cache_split_reference(_t(q), _t(k), _t(v), pos0, tvalid, window=window,
                                                   n_split=n, tile=TILE)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    if kv_valid is not None:
        seen = _seen(s, l, pos0, window, kv_valid)
        assert not got.numpy()[~seen].any() and not want[~seen].any()


@pytest.mark.parametrize(
    "bkv,sr,l,sms",
    [
        (64, 4, 512, 132),  # serving decode: 8 slots × 8 kv heads
        (64, 4, 8192, 132),  # long cache
        (8, 256, 512, 132),  # admission: 4 q blocks of 64 rows
        (512, 4, 256, 132),  # enough blocks already: one split
        (8, 4, 40, 132),  # L < 64: one tile, one split
        (8, 4, 7 * 64, 132),  # 7 tiles: no one-tile last split
        (8, 4, 1000, 132),  # ragged last tile
        (1, 8, 200_000, 132),  # the 64-split cap sets the count
        (256, 4, 64 * 1000, 132),  # the 256-tile cap sets the count
        (2, 16, 64 * 513, 16),  # the cap against a one-tile last split
        (3, 48, 640, 132),  # S·R between one 16-row tile and 64
    ],
)
def test_split_count_covers_every_row_once(bkv, sr, l, sms):
    n = port.flash_split_count(bkv, sr, l, sms)
    plan = port.flash_split_plan(l, n)
    assert len(plan) == n  # the count is already normalized: no empty split
    assert plan[0][0] == 0 and plan[-1][1] == l
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))  # contiguous, no overlap
    tiles = [-(-(l1 - l0) // port.KERNEL_L_BLK) for l0, l1 in plan]
    assert all(l0 % port.KERNEL_L_BLK == 0 for l0, _ in plan)
    assert max(tiles) <= port.KERNEL_MAX_TILES_PER_SPLIT and n <= port.KERNEL_MAX_SPLITS
    n_tiles = -(-l // port.KERNEL_L_BLK)
    if n_tiles >= 2 and -(-n_tiles // max(1, n - 1)) <= port.KERNEL_MAX_TILES_PER_SPLIT:
        assert min(tiles) >= 2 or n == 1
    blocks = bkv * -(-sr // port.kernel_q_rows(sr))
    if blocks >= 2 * sms:
        assert n == 1
    if n > -(-n_tiles // port.KERNEL_MAX_TILES_PER_SPLIT):  # unless the tile cap sets n
        assert blocks * n <= max(blocks, 2 * sms)  # one wave of two blocks per SM


@pytest.mark.parametrize("l,pos0,s,want", [(512, 0, 64, 1), (512, 200, 64, 2), (512, 512, 1, 4), (8192, 0, 64, 1)])
def test_split_count_counts_only_reachable_tiles(l, pos0, s, want):
    """Tiles past ``pos0 + S`` are dead for every block and ask for no split."""
    n = port.flash_split_count(8, s * 4, l, 132, reach=pos0 + s)
    assert n == want
    plan = port.flash_split_plan(l, n)
    assert len(plan) == n and plan[-1][1] == l


def test_split_count_at_the_serving_shapes():
    assert port.flash_split_count(64, 4, 512, 132) == 4  # decode: 256 blocks
    assert port.flash_split_count(64, 4, 8192, 132) == 4  # long cache: 256 blocks, one wave
    assert port.flash_split_plan(512, 4) == [(0, 128), (128, 256), (256, 384), (384, 512)]


@pytest.mark.parametrize("d,blocks_per_sm", [(64, 2), (96, 2), (128, 2), (256, 1)])
def test_split_count_plans_the_blocks_each_head_dim_keeps_resident(d, blocks_per_sm):
    """At D = 256 one block fits an SM (its bf16 ring is 202,752 bytes), so
    the wave the split count fills is one block per SM: half the splits of
    D <= 128 at the same grid (Gemma-2-9B's decode, B 8 × 8 KV heads). The
    wrapper reads each head_dim's figure from the kernel's library
    (``kernel_blocks_per_sm``); the card tests hold it to these."""
    n = port.flash_split_count(64, 2, 8192, 132, blocks_per_sm=blocks_per_sm)
    assert n == (2 if d == 256 else 4)
    assert 64 * n <= blocks_per_sm * 132


def test_build_makes_one_flash_library_per_head_dim():
    """The flash source builds once per head_dim the wrapper takes, each
    with its own define into its own library, so the four compile in
    parallel."""
    from kakveda_tpu_torch.ops import _build

    names = _build.targets()
    assert [n for n in names if n.partition(":")[0] == "flash_gqa_cache"] == [
        f"flash_gqa_cache:{d}" for d in port.KERNEL_HEAD_DIMS
    ]
    assert [n for n in names if n.partition(":")[0] == "flash_gqa_cache_f32"] == [
        f"flash_gqa_cache_f32:{d}" for d in port.KERNEL_F32_HEAD_DIMS
    ]
    assert "fused_topk" in names
    libs = {_build._target(n) for n in names}
    assert len(libs) == len(names)  # a library each
    assert _build._flags("flash_gqa_cache:96")[-1] == "-DKKV_HEAD_DIM=96"
    assert _build._flags("flash_gqa_cache_f32:128")[-1] == "-DKKV_HEAD_DIM=128"
    assert _build._flags("fused_topk") == _build.NVCC_FLAGS


def _brute_live(l, pos0, r, row0, row1, kv_valid, window, tile):
    q_pos = pos0 + np.arange(row0, row1)[:, None] // r
    col = np.arange(l)[None, :]
    keep = q_pos >= col
    if window:
        keep &= (q_pos - col) < window
    keep = keep[None] & (kv_valid[:, None, :] if kv_valid is not None else True)
    seen = keep.any(1)  # [B, L]
    n_tiles = -(-l // tile)
    seen = np.pad(seen, ((0, 0), (0, n_tiles * tile - l)))
    return seen.reshape(seen.shape[0], n_tiles, tile).any(-1)


@pytest.mark.parametrize("b,s,h,kv,l,d,pos0,valid,window", CASES + LONG_CASES)
def test_live_tiles_are_exact_to_drop(b, s, h, kv, l, d, pos0, valid, window):
    """Per q block of the kernel's height: the predicate equals "some row of
    the block keeps some slot of the tile" wherever there is no window (and
    covers it with one), and dropping the tiles it marks dead leaves the
    plain online softmax bit-identical."""
    tq, tk, tv, tvalid, _ = _torch_case(b, s, h, kv, l, d, valid, 9, "f32", False)
    r = h // kv
    sr = s * r
    tile = TILE if l <= 64 else port.KERNEL_L_BLK
    qf = tq.reshape(b, s, kv, r, d).permute(0, 2, 1, 3, 4).reshape(b, kv, sr, d)
    qb = min(port.kernel_q_rows(sr), 8)  # small blocks, so that some see less than others
    n_dead = 0
    for row0 in range(0, sr, qb):
        row1 = min(sr, row0 + qb)
        live = port.flash_live_tiles(l, pos0, r, row0, row1, tvalid, window, tile).expand(b, -1)
        brute = _brute_live(l, pos0, r, row0, row1, None if tvalid is None else tvalid.numpy(), window, tile)
        if window:
            assert (live.numpy() | ~np.broadcast_to(brute, live.shape)).all()  # a superset
        else:
            assert np.array_equal(live.numpy(), np.broadcast_to(brute, live.shape))
        n_dead += int((~live).sum())
        q_pos = pos0 + torch.arange(row0, row1) // r
        args = (qf[:, :, row0:row1], tk, tv, q_pos, tvalid, window, 0, l, tile)
        full = port._online_softmax(*args)
        dropped = port._online_softmax(*args, live=live)
        for x, y in zip(full, dropped):
            assert torch.equal(x, y)
    if valid is not None or pos0 < l - 1:
        assert n_dead > 0  # the case exercises a dead tile
