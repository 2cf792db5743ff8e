"""Speculative decoding in the port against the JAX package, on the same
weights and the same numpy-seeded inputs.

* Drafting: ``copy_run``, ``NgramIndex`` and a slot's drafts
  (``ContinuousBatcher._draft_slot``, ``_draft_slot_stale``) equal the JAX
  package's (the reference's cases of
  ``tests/test_serving_spec.py``, period-1 runs and empty histories), and
  a slot drafts out of a registered prefix's ids alike.
* Attention at per-slot positions: the plain kernel versions with a
  ``[B]`` ``pos0`` (``flash_gqa_cache_reference``, its split schedule and,
  under a softcap, ``gqa_grouped``) equal the JAX ``gqa_cache_attention``
  with the ``[B, S, L]`` ``full_mask`` that ``_forward_wide`` builds, f32,
  within 2e-5 (sums in another order), the window band and the int8 cache
  included.
* ``_forward_wide`` at S = 5: logits within 1e-4 of the JAX forward's
  (f32 through two layers and the vocab projection), and the same cache
  rows, past the window too.
* The solo path: ``generate_tokens_speculative`` tokens equal the JAX
  package's and plain greedy's; ``KAKVEDA_SPEC=1`` through the runtime.
* The engine: ``ContinuousBatcher(spec_k=4)`` and ``ServingEngine`` under
  ``KAKVEDA_SERVE_SPEC`` in each mode (plain, pipelined, int8 KV, sliding
  window, sampled fallback, a prefix hit with streaming, the gate on / off
  / re-probe, adaptive k, cancel and admission around a chunk in flight):
  the tokens and the whole ``spec_stats`` equal the JAX package's. The gate
  reads chunk walls, so both packages' serving modules run on a frozen
  clock (every wall 0 s): the gate then takes the same path in both, the
  prior until a plain chunk was measured, and the reference tests' env
  knobs steer it.

The JAX twins of two acceptance tests are red in the reference (its
acceptance rate falls short of its own bar): their twins here hold the
port's outcome to the JAX package's, not to that bar.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kakveda_tpu.models import generate as JG
from kakveda_tpu.models import serving as JS
from kakveda_tpu.models import speculative as JSP
from kakveda_tpu.models.attention import gqa_cache_attention as j_attention
from kakveda_tpu.models.llama import LlamaConfig as JConfig, init_params as jinit
from kakveda_tpu.models.quant import quantize_params_int8 as j_quant
from kakveda_tpu_torch.convert import llama_params_from_jax
from kakveda_tpu_torch.models import attention as TA
from kakveda_tpu_torch.models import generate as TG
from kakveda_tpu_torch.models import serving as TS
from kakveda_tpu_torch.models import speculative as TSP
from kakveda_tpu_torch.models.llama import LlamaConfig as TConfig
from kakveda_tpu_torch.models.quant import quantize_params_int8 as t_quant

torch.set_num_threads(2)

# The reference tests' config (tests/test_serving_spec.py): f32, d_model 64, head_dim 16.
KW = dict(vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128)
JCFG, TCFG = JConfig(**KW, dtype=jnp.float32), TConfig(**KW, dtype=torch.float32)
PROMPTS = [[5, 6, 7], [10, 11, 12, 13, 14], [42], [9, 8]]
LOOP = [7, 8, 9, 7, 8, 9, 7, 8, 9]  # seed 2 settles into a period-1 run on it


def _cfgs(**kw):
    import dataclasses

    return dataclasses.replace(JCFG, **kw), dataclasses.replace(TCFG, **kw)


_WEIGHTS = {}


def _weights(seed, **kw):
    key = (seed, tuple(sorted(kw.items())))
    if key not in _WEIGHTS:
        jcfg, tcfg = _cfgs(**kw)
        jp = jinit(jax.random.PRNGKey(seed), jcfg)
        _WEIGHTS[key] = (jcfg, tcfg, jp, llama_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return _WEIGHTS[key]


class _FrozenClock:
    """``time`` with a ``perf_counter`` that stands still: every chunk wall
    is 0 s, in both packages alike."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def perf_counter():
        return 0.0


@pytest.fixture
def frozen(monkeypatch):
    monkeypatch.setattr(JS, "time", _FrozenClock())
    monkeypatch.setattr(TS, "time", _FrozenClock())


# ---------------------------------------------------------------------------
# drafting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("toks,start,count,period,n", [
    ([1, 2, 3, 4], 1, 2, 2, None),
    ([1, 2, 3, 4], 2, 7, 2, None),  # wraps twice
    ([5, 5, 5], 2, 5, 1, None),  # period 1 tiles the run
    ([1, 2, 3], 1, 5, 0, None),  # another corpus: stops at the end
    ([1, 2, 3, 9, 9], 2, 6, 2, 3),  # a frozen boundary inside a longer list
    ([], 0, 3, 0, None),
])
def test_copy_run_matches_jax(toks, start, count, period, n):
    assert TSP.copy_run(toks, start, count, period, n=n) == JSP.copy_run(toks, start, count, period, n=n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_index_matches_jax(seed):
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, 4 + 3 * seed, size=200).tolist() + [7] * 9 + [1, 2] * 6
    ti, ji = TSP.NgramIndex(), JSP.NgramIndex()
    for t in stream:
        ti.append(t)
        ji.append(t)
        assert ti.anchor == ji.anchor
    for _ in range(50):
        tail = rng.integers(0, 8, size=int(rng.integers(0, 5))).tolist()
        assert ti.lookup(tail) == ji.lookup(tail)
    assert ti.toks == ji.toks and TSP.NgramIndex(stream).anchor == ji.anchor


@pytest.mark.parametrize("hist,k", [
    ([7, 8, 3, 9, 4, 5, 7, 8, 3], 4), ([1, 3, 6, 2, 5, 3], 3), ([9, 8, 3, 1, 3, 2, 8, 3], 2),
    ([1, 2, 3], 3), ([5], 2), ([], 2), ([4, 6, 4], 4),
    ([5, 5, 5, 5, 5], 4), ([9, 3, 7, 7, 7], 3), ([1, 2, 1, 2, 1, 2], 3), ([3, 3], 1),
])
def test_draft_matches_jax(hist, k):
    """A slot's drafts from its own history equal the JAX package's: its
    synchronous drafts (``_draft_slot``) and those of a slot whose chain
    broke with a chunk in flight (``_draft_slot_stale``, which skips the
    token that chunk commits), with the cursor and the prediction. A
    prediction without a cursor (a run that ran short) breaks the chain
    whatever the chunk emits; the port returns None for it."""
    jcfg, tcfg, jp, tp = _weights(0)
    got = []
    for mod, params, cfg in ((JS, jp, jcfg), (TS, tp, tcfg)):
        cb = mod.ContinuousBatcher(params, cfg, batch_slots=1, max_len=128, chunk_steps=4, spec_k=4)
        res = []
        for draft in (cb._draft_slot, cb._draft_slot_stale):
            st = mod._Slot(req_id=0, prompt_len=len(hist), max_new=8, prompt_ids=list(hist))
            drafts, cursor, pred = draft(st, k)
            res.append((drafts, None if cursor is None else cursor[1:], None if cursor is None else pred))
        got.append(res)
    assert got[1] == got[0]


def test_prefix_slab_drafting_matches_jax():
    """A slot with no self-anchor drafts out of a registered prefix's ids,
    literally, in both packages."""
    jcfg, tcfg, jp, tp = _weights(5)
    head = list(range(40, 56))
    got = []
    for cb in (JS.ContinuousBatcher(jp, jcfg, batch_slots=1, max_len=128, chunk_steps=4, spec_k=4),
               TS.ContinuousBatcher(tp, tcfg, batch_slots=1, max_len=128, chunk_steps=4, spec_k=4)):
        assert cb.register_prefix(head)
        cb.admit([7, 43, 44], max_new_tokens=8)
        st = list(cb.slots.values())[0]
        drafts, cursor, pred = cb._draft_slot(st, 4)
        got.append((st.index.anchor, drafts, pred, cursor[1:] if cursor else None))
        while cb.slots:
            cb.step_spec()
    assert got[0] == got[1]
    assert got[1][1] == [46, 47, 48, 49] and got[1][2] == [45, 46, 47, 48, 49]


# ---------------------------------------------------------------------------
# attention at per-slot positions
# ---------------------------------------------------------------------------


def _verify_inputs(seed, b, s, h, kv, l, d, kv8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, kv, l, d), dtype=np.float32)
    v = rng.standard_normal((b, kv, l, d), dtype=np.float32)
    off = rng.integers(0, l // 4, size=b)
    slot_pos = np.minimum(off + rng.integers(1, l, size=b), l - s).astype(np.int32)
    ar = np.arange(l)
    kv_valid = (ar[None] >= off[:, None]) & (ar[None] < (slot_pos + s)[:, None])
    ks = vs = None
    if kv8:
        from kakveda_tpu_torch.models.llama import _kv_quant_rows

        ki, ksc = _kv_quant_rows(torch.from_numpy(k))
        vi, vsc = _kv_quant_rows(torch.from_numpy(v))
        k, v, ks, vs = ki.numpy(), vi.numpy(), ksc.numpy(), vsc.numpy()
    return q, k, v, ks, vs, slot_pos, kv_valid


def _full_mask(slot_pos, kv_valid, s, window):
    """The [B, S, L] mask the JAX ``_forward_wide`` builds."""
    col = np.arange(kv_valid.shape[1])[None, None, :]
    qpos = (slot_pos[:, None] + np.arange(s)[None, :])[:, :, None]
    mask = kv_valid[:, None, :] & (col <= qpos)
    if window:
        mask &= col > qpos - window
    return mask


@pytest.mark.parametrize("b,s,h,kv,l,d,window,kv8,softcap", [
    (4, 5, 4, 2, 200, 16, 0, False, 0.0),  # the reference tests' heads, the verify width
    (4, 5, 4, 2, 200, 16, 0, True, 0.0),  # int8 cache
    (3, 5, 8, 4, 300, 32, 24, False, 0.0),  # the default preset's heads (D 32), the band
    (3, 5, 8, 4, 300, 32, 24, True, 0.0),
    (2, 3, 8, 2, 150, 16, 0, False, 30.0),  # a softcap: gqa_grouped on the CPU
    (2, 9, 16, 2, 130, 16, 0, False, 0.0),  # S*R past one q block
])
def test_per_slot_positions_match_the_jax_full_mask(b, s, h, kv, l, d, window, kv8, softcap):
    q, k, v, ks, vs, slot_pos, kv_valid = _verify_inputs(b * 7 + s, b, s, h, kv, l, d, kv8)
    want = np.asarray(j_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(l), None, softcap=softcap,
        k_scale=None if ks is None else jnp.asarray(ks), v_scale=None if vs is None else jnp.asarray(vs),
        full_mask=jnp.asarray(_full_mask(slot_pos, kv_valid, s, window)),
    ))
    t = {n: None if x is None else torch.from_numpy(np.asarray(x)) for n, x in
         dict(q=q, k=k, v=v, ks=ks, vs=vs, pos=slot_pos, valid=kv_valid).items()}
    kw = dict(k_scale=t["ks"], v_scale=t["vs"], window=window, softcap=softcap)
    outs = [TA.gqa_cache_attention(t["q"], t["k"], t["v"], t["pos"], t["valid"], **kw)]
    if not softcap:
        outs += [TA.flash_gqa_cache_reference(t["q"], t["k"], t["v"], t["pos"], t["valid"], **kw),
                 TA.flash_gqa_cache_split_reference(t["q"], t["k"], t["v"], t["pos"], t["valid"], n_split=3, **kw)]
    for out in outs:
        np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=2e-5)
    # Per-row positions equal one scalar call per batch row.
    for i in range(b):
        one = TA.gqa_cache_attention(t["q"][i : i + 1], t["k"][i : i + 1], t["v"][i : i + 1], int(slot_pos[i]),
                                     t["valid"][i : i + 1],
                                     **dict(kw, k_scale=None if ks is None else t["ks"][i : i + 1],
                                            v_scale=None if vs is None else t["vs"][i : i + 1]))
        torch.testing.assert_close(outs[0][i : i + 1], one, rtol=0, atol=1e-6)


@pytest.mark.parametrize("h,kv,d,window,kv8,softcap", [
    (4, 2, 16, 0, False, 0.0), (4, 2, 16, 0, True, 0.0), (8, 4, 32, 24, False, 0.0), (8, 4, 32, 24, True, 0.0),
    (8, 2, 16, 24, False, 30.0),
])
def test_decode_step_per_row_positions_equal_the_mask_form(h, kv, d, window, kv8, softcap):
    """``_forward_wide``'s decode step (S = 1) passes the slots' positions
    as the per-row ``pos0``; the same attention as a ``[B, L]`` mask
    (validity, causal and band folded in) under a scalar ``pos0`` past
    every row, the form the JAX package's decode and the port's decode
    took before, is bit for bit the same."""
    b, l = 4, 200
    q, k, v, ks, vs, slot_pos, kv_valid = _verify_inputs(h * 3 + d, b, 1, h, kv, l, d, kv8)
    t = {n: None if x is None else torch.from_numpy(np.asarray(x)) for n, x in
         dict(q=q, k=k, v=v, ks=ks, vs=vs, pos=slot_pos, valid=kv_valid).items()}
    mask = torch.from_numpy(_full_mask(slot_pos, kv_valid, 1, window)[:, 0])
    kw = dict(k_scale=t["ks"], v_scale=t["vs"], softcap=softcap)
    per_row = TA.gqa_cache_attention(t["q"], t["k"], t["v"], t["pos"], t["valid"], window=window, **kw)
    masked = TA.gqa_cache_attention(t["q"], t["k"], t["v"], l, mask, **kw)
    assert torch.equal(per_row, masked)


def test_live_tiles_take_per_row_positions():
    """The kernel's dead-tile test with a [B] pos0 equals the scalar test
    row by row."""
    rng = np.random.default_rng(3)
    kv_valid = torch.from_numpy(rng.random((4, 700)) < 0.9)
    pos = torch.tensor([10, 300, 650, 699], dtype=torch.int32)
    for r, rows, window in ((4, (0, 20), 0), (4, (16, 20), 100), (1, (0, 5), 64)):
        got = TA.flash_live_tiles(700, pos, r, *rows, kv_valid, window)
        want = torch.cat([TA.flash_live_tiles(700, int(p), r, *rows, kv_valid[i : i + 1], window)
                          for i, p in enumerate(pos.tolist())])
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the wide forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"kv_quant": "int8"}, {"sliding_window": 12}], ids=["f32", "int8_kv", "window"])
def test_forward_wide_at_s5_matches_jax(kw):
    """S = 5 from per-slot positions: a slot in the middle of the window, one
    whose last two rows fall past it (dropped), one whose position passed
    the window (a retired slot: JAX drops every row, the port rewrites its
    last row, which admission replaces) and one at its prompt's end."""
    jcfg, tcfg, jp, tp = _weights(1, **kw)
    b, s, ml = 4, 5, 64
    rng = np.random.default_rng(11)
    kq = kw.get("kv_quant") == "int8"
    shape = (b, jcfg.n_kv_heads, ml, jcfg.head_dim)
    if kq:
        ck = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(jcfg.n_layers)]
        cv = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(jcfg.n_layers)]
        cks = [rng.random(shape[:3], dtype=np.float32) / 50 for _ in range(jcfg.n_layers)]
        cvs = [rng.random(shape[:3], dtype=np.float32) / 50 for _ in range(jcfg.n_layers)]
    else:
        ck = [rng.standard_normal(shape, dtype=np.float32) for _ in range(jcfg.n_layers)]
        cv = [rng.standard_normal(shape, dtype=np.float32) for _ in range(jcfg.n_layers)]
        cks = cvs = []
    tokens = rng.integers(0, 259, (b, s))
    slot_pos = np.array([30, ml - 3, ml + 2, 16])
    pos_offset = np.array([3, 0, 5, 8])
    ar = np.arange(ml)
    kv_valid = (ar[None] >= pos_offset[:, None]) & (ar[None] < np.minimum(slot_pos + s, ml)[:, None])
    jl, jk, jv, jks, jvs = JS._forward_wide(
        jp, jcfg, [jnp.asarray(x) for x in ck], [jnp.asarray(x) for x in cv],
        [jnp.asarray(x) for x in cks], [jnp.asarray(x) for x in cvs], jnp.asarray(tokens, jnp.int32),
        jnp.asarray(slot_pos, jnp.int32), jnp.asarray(kv_valid), jnp.asarray(pos_offset, jnp.int32),
    )
    cache = {"pos": 0, "k": [torch.from_numpy(x.copy()) for x in ck], "v": [torch.from_numpy(x.copy()) for x in cv]}
    if kq:
        cache["ks"] = [torch.from_numpy(x.copy()) for x in cks]
        cache["vs"] = [torch.from_numpy(x.copy()) for x in cvs]
    tl = TS._forward_wide(
        tp, tcfg, cache, torch.from_numpy(tokens), torch.from_numpy(slot_pos), torch.from_numpy(kv_valid),
        torch.from_numpy(pos_offset), reach=int(slot_pos.max()) + s,
    )
    assert tl.shape == (b, s, tcfg.vocab_size)
    # Rows the port writes for a slot past the window: its last row only.
    keep = np.ones((b, ml), bool)
    keep[2, ml - 1] = False
    for name, jx in (("k", jk), ("v", jv)) + ((("ks", jks), ("vs", jvs)) if kq else ()):
        for li in range(jcfg.n_layers):
            got, want = np.moveaxis(cache[name][li].numpy(), 2, 1), np.moveaxis(np.asarray(jx[li]), 2, 1)
            np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=0 if kq and name in ("k", "v") else 2e-6)
    # Logits of the rows that exist (slot 2's are the garbage of a retired slot).
    live = np.ones((b, s), bool)
    live[2] = False
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], rtol=0, atol=1e-4)


def test_spec_chunk_matches_jax():
    """One verify chunk on a batcher's own state: tokens, counts, the new
    positions and the next chunk's logits equal ``_spec_chunk_jit``'s."""
    jcfg, tcfg, jp, tp = _weights(2)
    jb = JS.ContinuousBatcher(jp, jcfg, batch_slots=2, max_len=128, chunk_steps=4, spec_k=4)
    tb = TS.ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=128, chunk_steps=4, spec_k=4)
    for cb in (jb, tb):
        cb.admit(LOOP, max_new_tokens=40)
        cb.admit([5, 6, 7], max_new_tokens=40)
        cb._grow_valid(5)
    drafts = np.array([[7, 8, 9, 7], [1, 2, 3, 4]])
    jout = JS._spec_chunk_jit(
        jp, jcfg, jb.cache, jb.last, jnp.asarray(jb._pos_np), jnp.asarray(jb._kv_np),
        jnp.asarray(jb._off_np), jnp.asarray(drafts, jnp.int32), 4,
    )[1:]
    dev = torch.device("cpu")
    tout = TS._spec_chunk(
        tp, tcfg, tb.cache, tb.last, TS._h2d(tb._pos_np, dev), TS._h2d(tb._kv_np, dev),
        TS._h2d(tb._off_np, dev), torch.from_numpy(drafts),
    )
    for j, t in zip(jout[1:], tout[1:]):
        assert np.asarray(j).tolist() == t.tolist()
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the solo path
# ---------------------------------------------------------------------------

SOLO_KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=48, max_seq_len=256)


@pytest.fixture(scope="module")
def solo_weights():
    jcfg, tcfg = JConfig(**SOLO_KW, dtype=jnp.float32), TConfig(**SOLO_KW, dtype=torch.float32)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, llama_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("prompt", [list(range(5, 25)), [7, 8, 9, 10] * 6, [3] * 8, [11, 12]],
                         ids=["arbitrary", "periodic", "constant", "short"])
def test_speculative_matches_jax_and_greedy(solo_weights, prompt, k):
    jcfg, tcfg, jp, tp = solo_weights
    want, jstats = JSP.generate_tokens_speculative(jp, jcfg, prompt, max_new_tokens=24, k=k, return_stats=True)
    got, stats = TSP.generate_tokens_speculative(tp, tcfg, prompt, max_new_tokens=24, k=k, return_stats=True)
    assert got == want == TG.generate_tokens(tp, tcfg, prompt, max_new_tokens=24)
    assert stats == jstats


def test_speculative_eos_window_and_int8_weights(solo_weights):
    """EOS stops both alike; a prompt near the window truncates alike and a
    prompt with no room raises; int8 weight-only weights."""
    import dataclasses

    jcfg, tcfg, jp, tp = solo_weights
    prompt = list(range(5, 15))
    plain = TG.generate_tokens(tp, tcfg, prompt, max_new_tokens=20)
    eos = plain[5]
    assert TSP.generate_tokens_speculative(tp, tcfg, prompt, max_new_tokens=20, eos_id=eos) == \
        JSP.generate_tokens_speculative(jp, jcfg, prompt, max_new_tokens=20, eos_id=eos) == plain[:5]
    jc64, tc64 = dataclasses.replace(jcfg, max_seq_len=64), dataclasses.replace(tcfg, max_seq_len=64)
    long = list(range(5, 45))
    got = TSP.generate_tokens_speculative(tp, tc64, long, max_new_tokens=100, k=4)
    assert got == JSP.generate_tokens_speculative(jp, jc64, long, max_new_tokens=100, k=4)
    assert got == TG.generate_tokens(tp, tc64, long, max_new_tokens=100)[: len(got)]
    with pytest.raises(ValueError, match="room"):
        TSP.generate_tokens_speculative(tp, tc64, list(range(3, 62)), max_new_tokens=8, k=4)
    jq, tq = j_quant(jp), t_quant(tp)
    p = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6]
    assert TSP.generate_tokens_speculative(tq, tcfg, p, max_new_tokens=12) == \
        JSP.generate_tokens_speculative(jq, jcfg, p, max_new_tokens=12) == \
        TG.generate_tokens(tq, tcfg, p, max_new_tokens=12)


def test_runtime_spec_mode_matches_jax(monkeypatch):
    """KAKVEDA_SPEC=1 routes LlamaRuntime.generate through the solo
    speculative path: the same text as without it and as the JAX runtime's,
    and the same ``speculative`` / ``tokens_per_round`` meta."""
    cfg_kw = dict(SOLO_KW, vocab_size=264)
    jcfg, tcfg = JConfig(**cfg_kw, dtype=jnp.float32), TConfig(**cfg_kw, dtype=torch.float32)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    jrt = JG.LlamaRuntime(cfg=jcfg, params=jp)
    trt = TG.LlamaRuntime(cfg=tcfg, params=llama_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu"),
                          device="cpu")
    try:
        monkeypatch.delenv("KAKVEDA_SPEC", raising=False)
        plain = trt.generate("hello failure world", max_tokens=16)
        monkeypatch.setenv("KAKVEDA_SPEC", "1")
        spec, want = trt.generate("hello failure world", max_tokens=16), jrt.generate("hello failure world", max_tokens=16)
        assert spec.text == plain.text == want.text
        assert spec.meta["speculative"] is True and "speculative" not in plain.meta
        assert spec.meta["tokens_per_round"] == want.meta["tokens_per_round"] >= 1.0
    finally:
        jrt.retire()
        trt.close()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _drain_pipelined_spec(cb, prompts, max_new=12):
    """The engine loop's pipelined order, inline (the reference test's):
    verify chunk i+1 before chunk i's acceptance is read, a drain before any
    admission, pipelined plain chunks when ``spec_ready`` says so."""
    pending = list(enumerate(prompts))
    order, handle, spec_handle = {}, None, None
    while pending or cb.slots or handle is not None or spec_handle is not None:
        if pending and cb.free and spec_handle is not None:
            cb.process_spec_chunk(spec_handle)
            spec_handle = None
        while pending and cb.free:
            i, p = pending.pop(0)
            order[cb.admit(p, max_new_tokens=max_new)] = i
        if cb.spec_ready():
            cb.process_chunk(handle)
            handle = None
            if spec_handle is not None and cb.spec_pipeline_ready():
                nxt = cb.step_spec_async()
                cb.process_spec_chunk(spec_handle)
                spec_handle = nxt
            else:
                cb.process_spec_chunk(spec_handle)
                spec_handle = None
                if cb.slots and cb.spec_ready():
                    spec_handle = cb.step_spec_async()
        elif cb.slots:
            cb.process_spec_chunk(spec_handle)
            spec_handle = None
            nxt = cb.step_async()
            cb.process_chunk(handle)
            handle = nxt
        else:
            cb.process_chunk(handle)
            cb.process_spec_chunk(spec_handle)
            handle = spec_handle = None
    outs = [None] * len(prompts)
    for rid, i in order.items():
        outs[i] = cb.results.pop(rid)
    return outs


def _run_spec_loop(cb, prompts, max_new):
    """Admit each prompt and verify until it is done, one after another."""
    outs = []
    for p in prompts:
        rid = cb.admit(p, max_new_tokens=max_new)
        while cb.slots:
            cb.step_spec()
        outs.append(cb.results.pop(rid))
    return outs


def _run_prefix_stream(cb, prompts, max_new):
    """The reference's all-levers composite: a registered head, streaming
    callbacks, step() (verify chunks for a greedy pool)."""
    assert cb.register_prefix(list(range(40, 56)))
    streamed = {i: [] for i in range(len(prompts))}
    rids, pending = {}, list(enumerate(prompts))
    while pending or cb.slots:
        while pending and cb.free:
            i, p = pending.pop(0)
            rids[cb.admit(p, max_new_tokens=max_new,
                          on_tokens=(lambda i: lambda new, done: streamed[i].extend(new))(i))] = i
        cb.step()
    outs = [None] * len(prompts)
    for rid, i in rids.items():
        outs[i] = cb.results.pop(rid)
        assert streamed[i] == outs[i]
    return outs


HEAD = list(range(40, 56))
BATCHER_MODES = {
    # mode: (seed, config flags, env, runner, prompts, max_new, passes)
    "plain": (0, {}, {}, "run_all", PROMPTS, 12, 1),
    "int8_kv": (2, {"kv_quant": "int8"}, {}, "run_all", PROMPTS, 8, 1),
    "sliding_window": (3, {"sliding_window": 12}, {}, "run_all", PROMPTS, 10, 1),
    "pipelined": (0, {}, {"KAKVEDA_SERVE_SPEC_CALIB": "0", "KAKVEDA_SERVE_SPEC_BREAKEVEN": "0"},
                  "pipelined", PROMPTS, 12, 1),
    # Twins of the two reference-red tests (test_spec_acceptance_on_repetitive_traffic,
    # test_pipelined_spec_cursor_continues_accepted_run): the outcome equals the JAX
    # package's; the reference's rate > 1.3 is its own bar, not held here.
    "repetitive": (2, {}, {}, "spec_loop", [LOOP], 40, 1),
    "pipelined_repetitive": (2, {}, {"KAKVEDA_SERVE_SPEC_CALIB": "0", "KAKVEDA_SERVE_SPEC_BREAKEVEN": "0"},
                             "pipelined", [LOOP], 40, 1),
    "prefix_stream": (5, {"kv_quant": "int8"}, {}, "prefix_stream",
                      [HEAD + [5, 6], HEAD + list(range(80, 95)), HEAD], 10, 1),
    "gate_off": (0, {}, {"KAKVEDA_SERVE_SPEC_CALIB": "0", "KAKVEDA_SERVE_SPEC_WARMUP": "2",
                         "KAKVEDA_SERVE_SPEC_BREAKEVEN": "1000"}, "run_all", PROMPTS, 12, 2),
    "gate_on": (2, {}, {"KAKVEDA_SERVE_SPEC_CALIB": "0", "KAKVEDA_SERVE_SPEC_WARMUP": "2",
                        "KAKVEDA_SERVE_SPEC_BREAKEVEN": "0"}, "run_all", [LOOP], 40, 1),
    "gate_reprobe": (0, {}, {"KAKVEDA_SERVE_SPEC_CALIB": "0", "KAKVEDA_SERVE_SPEC_WARMUP": "1",
                             "KAKVEDA_SERVE_SPEC_BREAKEVEN": "1000", "KAKVEDA_SERVE_SPEC_REPROBE": "2"},
                     "run_all", PROMPTS, 12, 2),
    "adaptive_k": (1, {}, {"KAKVEDA_SERVE_SPEC_CALIB": "0", "KAKVEDA_SERVE_SPEC_BREAKEVEN": "0"},
                   "run_all", [LOOP], 24, 1),
}


@pytest.mark.parametrize("mode", list(BATCHER_MODES))
def test_batcher_spec_matches_jax(mode, frozen, monkeypatch):
    seed, flags, env, runner, prompts, max_new, passes = BATCHER_MODES[mode]
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    jcfg, tcfg, jp, tp = _weights(seed, **flags)
    solo = [TG.generate_tokens(tp, tcfg, p, max_new_tokens=max_new, max_len=128) for p in prompts]
    results = []
    for cb in (JS.ContinuousBatcher(jp, jcfg, batch_slots=2 if len(prompts) > 1 else 1, max_len=128,
                                    chunk_steps=4, spec_k=4),
               TS.ContinuousBatcher(tp, tcfg, batch_slots=2 if len(prompts) > 1 else 1, max_len=128,
                                    chunk_steps=4, spec_k=4)):
        outs = []
        for _ in range(passes):
            if runner == "run_all":
                outs.append(cb.run_all(prompts, max_new_tokens=max_new))
            elif runner == "pipelined":
                outs.append(_drain_pipelined_spec(cb, prompts, max_new))
            elif runner == "spec_loop":
                outs.append(_run_spec_loop(cb, prompts, max_new))
            else:
                outs.append(_run_prefix_stream(cb, prompts, max_new))
        assert cb._spec_pending == 0
        results.append((outs, cb.stats_snapshot()))
    (jouts, jstats), (touts, tstats) = results
    assert touts == jouts and all(o == solo for o in touts)
    assert tstats == jstats
    assert tstats["spec"]["chunks"] > 0 and tstats["spec"]["emitted"] >= tstats["spec"]["slot_chunks"]
    if mode == "gate_off":
        assert tstats["spec"]["gate_state"] == "off"
    elif mode == "gate_on":
        assert tstats["spec"]["gate_state"] == "on" and tstats["spec"]["tokens_per_verify"] > 1.0
    elif mode == "adaptive_k":
        assert tstats["spec"]["k_trace"][0] == 4 and 1 in tstats["spec"]["k_trace"]
    elif mode == "prefix_stream":
        assert tstats["prefix"]["hits"] == len(prompts)


@pytest.mark.parametrize("what", ["cancel", "admit"])
def test_around_a_verify_chunk_in_flight_matches_jax(what):
    """A cancel between dispatch and processing: the stale snapshot skips
    the cancelled slot, the survivor and a re-admission stay exact. An
    admission with a verify chunk in flight is refused, then taken."""
    jcfg, tcfg, jp, tp = _weights(0)
    got = []
    for cb in (JS.ContinuousBatcher(jp, jcfg, batch_slots=3, max_len=128, chunk_steps=4, spec_k=4),
               TS.ContinuousBatcher(tp, tcfg, batch_slots=3, max_len=128, chunk_steps=4, spec_k=4)):
        rid_c = cb.admit([5, 6, 7], max_new_tokens=12)
        rid_k = cb.admit([10, 11, 12, 13, 14], max_new_tokens=12)
        h = cb.step_spec_async()
        if what == "cancel":
            assert cb.cancel_request(rid_c) == []
            assert rid_c not in cb.process_spec_chunk(h)
        else:
            with pytest.raises(RuntimeError, match="in flight"):
                cb.admit([1, 2, 3], max_new_tokens=8)
            with pytest.raises(RuntimeError, match="in flight"):
                cb.step_async()
            cb.process_spec_chunk(h)
        while cb.slots:
            cb.step_spec()
        rid2 = cb.admit([1, 2, 3], max_new_tokens=8)
        while cb.slots:
            cb.step_spec()
        got.append(([cb.results.get(r) for r in (rid_c, rid_k, rid2)], cb.stats_snapshot()["spec"]))
    assert got[0] == got[1]
    assert got[1][0][1] == TG.generate_tokens(tp, tcfg, [10, 11, 12, 13, 14], max_new_tokens=12, max_len=128)


ENGINE_MODES = {
    # mode: (seed, config flags, env, requests as (prompt, max_new, temperature))
    "plain": (0, {}, {}, [(p, 12, 0.0) for p in PROMPTS]),
    "unpipelined": (0, {}, {"KAKVEDA_SERVE_PIPELINE": "0"}, [(p, 12, 0.0) for p in PROMPTS]),
    "pipelined_repetitive": (2, {}, {"KAKVEDA_SERVE_SPEC_CALIB": "0", "KAKVEDA_SERVE_SPEC_BREAKEVEN": "0"},
                             [(LOOP, 40, 0.0), (PROMPTS[0], 12, 0.0)]),
    "int8_kv": (2, {"kv_quant": "int8"}, {}, [(p, 8, 0.0) for p in PROMPTS]),
    "sliding_window": (3, {"sliding_window": 12}, {}, [(p, 10, 0.0) for p in PROMPTS]),
    "sampled_fallback": (0, {}, {}, [(PROMPTS[0], 12, 0.0), ([5, 6, 7], 8, 0.9), (PROMPTS[1], 12, 0.0)]),
    "prefix_stream": (5, {}, {}, [(HEAD + [5, 6], 10, 0.0), (HEAD + list(range(80, 95)), 10, 0.0)]),
    "gate_off_reprobe": (0, {}, {"KAKVEDA_SERVE_SPEC_CALIB": "0", "KAKVEDA_SERVE_SPEC_WARMUP": "1",
                                 "KAKVEDA_SERVE_SPEC_BREAKEVEN": "1000", "KAKVEDA_SERVE_SPEC_REPROBE": "2"},
                         [(p, 12, 0.0) for p in PROMPTS + PROMPTS]),
    "gate_on": (2, {}, {"KAKVEDA_SERVE_SPEC_CALIB": "0", "KAKVEDA_SERVE_SPEC_WARMUP": "2",
                        "KAKVEDA_SERVE_SPEC_BREAKEVEN": "0"}, [(LOOP, 40, 0.0)]),
}


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engine_spec_matches_jax(mode, frozen, monkeypatch):
    """``ServingEngine`` under ``KAKVEDA_SERVE_SPEC=4``, one request at a
    time (so both loops see the same pool): greedy tokens equal solo
    decoding and the JAX engine's, streamed tokens equal the results, and
    ``stats()["spec"]`` equals the JAX engine's. A sampled request turns the
    pool to plain chunks (its draws come from each package's own
    generator); the flight recorders hold the same gate transitions."""
    seed, flags, env, reqs = ENGINE_MODES[mode]
    monkeypatch.setenv("KAKVEDA_SERVE_SPEC", "4")
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    jcfg, tcfg, jp, tp = _weights(seed, **flags)
    results = []
    for eng in (JS.ServingEngine(jp, jcfg, batch_slots=2, max_len=128, chunk_steps=4, name=f"spec-{mode}"),
                TS.ServingEngine(tp, tcfg, batch_slots=2, max_len=128, chunk_steps=4, name=f"spec-{mode}")):
        try:
            assert eng.cb.spec_k == 4
            if mode == "prefix_stream":
                assert eng.register_prefix(HEAD)
            outs = []
            for p, n, temp in reqs:
                streamed = []
                toks = eng.submit(p, n, temperature=temp, on_tokens=lambda new, done: streamed.extend(new)).result()
                assert streamed == toks
                outs.append(toks if temp <= 0 else len(toks) > 0)
            gates = [(e["from"], e["to"]) for e in eng.recorder.dump() if e["kind"] == "gate"]
            results.append((outs, eng.stats()["spec"], gates))
        finally:
            eng.close()
    assert results[1] == results[0]
    solo = [TG.generate_tokens(tp, tcfg, p, max_new_tokens=n, max_len=128) for p, n, t in reqs if t <= 0]
    assert [o for o, (_, _, t) in zip(results[1][0], reqs) if t <= 0] == solo
    assert results[1][1]["chunks"] > 0


def test_engine_spec_concurrent_requests_are_exact(monkeypatch):
    """Concurrent submits (the reference's engine test): every greedy
    output equals solo decoding, a rebuild keeps ``spec_k``, and the spec
    metric families move with ``spec_stats``."""
    from kakveda_tpu_torch.core import metrics

    monkeypatch.setenv("KAKVEDA_SERVE_SPEC", "4")
    jcfg, tcfg, jp, tp = _weights(0)
    solo = [TG.generate_tokens(tp, tcfg, p, max_new_tokens=12, max_len=128) for p in PROMPTS]
    eng = TS.ServingEngine(tp, tcfg, batch_slots=2, max_len=128, chunk_steps=4, name="spec-concurrent")
    try:
        with ThreadPoolExecutor(max_workers=len(PROMPTS)) as ex:
            assert list(ex.map(lambda p: eng.generate_ids(p, 12), PROMPTS)) == solo
        st = eng.stats()["spec"]
        assert st["chunks"] > 0
        text = metrics.get_registry().render()
        for fam, key in (("drafted", "drafted"), ("accepted", "accepted")):
            assert f'kakveda_serving_spec_{fam}_total{{engine="spec-concurrent"}} {st[key]}\n' in text
        assert eng._cb_kw["spec_k"] == 4
    finally:
        eng.close()
