"""Chunked prefill and ``DecodeSession`` in the port against the JAX
package, f32 on the CPU, on the same weights (``convert.llama_params_from_
jax``): the chunked prefill is the one-piece prefill (last logits within
ATOL, cache rows within CACHE_ATOL, both in the port and against JAX
``prefill(chunk=)``), greedy session tokens equal the JAX session's over
ragged prompts, and the runtime's solo path at window 512 (where no judge
prompt fits the engine) gives the JAX runtime's texts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kakveda_tpu.models import generate as JG
from kakveda_tpu.models.llama import LlamaConfig as JConfig
from kakveda_tpu.models.llama import init_cache as jinit_cache
from kakveda_tpu.models.llama import init_params as jinit
from kakveda_tpu_torch.convert import llama_params_from_jax
from kakveda_tpu_torch.models import generate as TG
from kakveda_tpu_torch.models.llama import LlamaConfig as TConfig
from kakveda_tpu_torch.models.llama import init_cache

torch.set_num_threads(2)

# f32 sums of one piece vs several taken in another order: logits of |x|
# ~ 1 agree to ~1e-6; K/V rows of later pieces see the same inputs.
ATOL = 1e-4
CACHE_ATOL = 1e-5

JCFG = JConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=256, dtype=jnp.float32,
)
TCFG = TConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=256, dtype=torch.float32,
)


@pytest.fixture(scope="module")
def weights():
    jp = jinit(jax.random.PRNGKey(3), JCFG)
    return jp, llama_params_from_jax(jax.tree.map(np.asarray, jp), TCFG, "cpu")


def _ragged(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 259, size=n).tolist() for n in lengths]


@pytest.mark.parametrize("kv_quant", ["", "int8"])
@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_prefill_equals_one_piece(weights, chunk, kv_quant):
    jp, tp = weights
    jcfg, tcfg = dataclasses.replace(JCFG, kv_quant=kv_quant), dataclasses.replace(TCFG, kv_quant=kv_quant)
    prompts = _ragged(chunk, [29, 7, 40, 17])
    width = TG._prefill_width(max(map(len, prompts)), chunk)
    assert width % chunk == 0 and width == JG._prefill_width(40, chunk)
    ml = 64
    toks, valid, offs, plen = TG._pack_prompts(prompts, ml, plen=width)
    jt, jv, jo, jplen = JG._pack_prompts(prompts, ml, plen=width)
    assert plen == jplen == width and (toks == jt).all() and (valid == jv).all() and (offs == jo).all()
    t_toks, t_valid, t_offs = map(torch.from_numpy, (toks, valid, offs))

    def port(c):
        cache = init_cache(tcfg, batch=len(prompts), max_len=ml, device="cpu")
        return TG.prefill(tp, tcfg, t_toks, cache, t_valid, t_offs, chunk=c)

    one, one_cache = port(0)
    many, many_cache = port(chunk)
    assert many_cache["pos"] == one_cache["pos"] == width
    np.testing.assert_allclose(many.numpy(), one.numpy(), atol=ATOL, rtol=0)
    rows = torch.from_numpy(valid[:, :width])  # real prompt rows; pad rows are never read
    for key in ("k", "v"):
        for a, b in zip(many_cache[key], one_cache[key]):
            da = a.float()[..., :width, :].permute(0, 2, 1, 3)[rows]
            db = b.float()[..., :width, :].permute(0, 2, 1, 3)[rows]
            tol = 1 if kv_quant else CACHE_ATOL  # int8: a value may round to the next step
            assert (da - db).abs().max().item() <= tol

    jlast, jcache = JG.prefill(
        jp, jcfg, jnp.asarray(jt), jinit_cache(jcfg, batch=len(prompts), max_len=ml),
        jnp.asarray(jv), jnp.asarray(jo), chunk=chunk,
    )
    assert int(jcache["pos"]) == width
    np.testing.assert_allclose(many.numpy(), np.asarray(jlast), atol=ATOL, rtol=0)
    if not kv_quant:
        for a, b in zip(many_cache["k"], jcache["k"]):
            da = a[..., :width, :].permute(0, 2, 1, 3)[rows]
            db = torch.from_numpy(np.array(b))[..., :width, :].permute(0, 2, 1, 3)[rows]
            assert (da - db).abs().max().item() <= CACHE_ATOL


def test_width_not_a_chunk_multiple_raises(weights):
    _, tp = weights
    cache = init_cache(TCFG, batch=1, max_len=64, device="cpu")
    with pytest.raises(ValueError, match="multiple of chunk=8"):
        TG.prefill(tp, TCFG, torch.ones((1, 20), dtype=torch.long), cache, None, None, chunk=8)
    # A prompt no wider than one chunk takes one piece, whatever its width.
    last, cache = TG.prefill(tp, TCFG, torch.ones((1, 5), dtype=torch.long), cache, None, None, chunk=8)
    assert cache["pos"] == 5 and last.shape == (1, 264)
    with pytest.raises(ValueError, match="leaves no room"):
        TG.DecodeSession(tp, TCFG, [[5] * 60], max_len=64, prefill_chunk=16)
    with pytest.raises(ValueError, match="empty"):
        TG.DecodeSession(tp, TCFG, [])


@pytest.mark.parametrize("chunk", [0, 8, 16])
def test_decode_session_matches_jax(weights, chunk):
    jp, tp = weights
    prompts = _ragged(100 + chunk, [23, 5, 37, 12, 1])
    ml = 128
    js = JG.DecodeSession(jp, JCFG, prompts, chunk_steps=8, max_len=ml, prefill_chunk=chunk)
    ts = TG.DecodeSession(tp, TCFG, prompts, chunk_steps=8, max_len=ml, prefill_chunk=chunk)
    assert ts.steps_left == js.steps_left == ml - 1 - TG._prefill_width(37, chunk)
    for n in (None, 5, 16):
        a, b = ts.step_chunk(n), js.step_chunk(n)
        assert isinstance(a, np.ndarray) and a.shape == (len(prompts), n or 8)
        assert a.tolist() == np.asarray(b).tolist()
    assert ts.steps_left == js.steps_left
    while ts.steps_left:
        ts.step_chunk(64)
    assert ts.step_chunk() is None


def test_decode_session_rows_equal_solo_decode(weights):
    _, tp = weights
    prompts = _ragged(7, [19, 4, 33])
    ts = TG.DecodeSession(tp, TCFG, prompts, chunk_steps=6, max_len=64, prefill_chunk=16)
    toks = np.concatenate([ts.step_chunk(), ts.step_chunk(4)], axis=1)
    for row, p in zip(toks.tolist(), prompts):
        assert row == TG.generate_tokens(tp, TCFG, p, max_new_tokens=10, max_len=64)


def test_decode_session_samples_from_the_generator(weights):
    _, tp = weights
    cfg = dataclasses.replace(TCFG, effective_vocab=259)
    prompts = _ragged(9, [11, 6])

    def draw(seed):
        s = TG.DecodeSession(tp, cfg, prompts, chunk_steps=8, max_len=64, temperature=1.0,
                             generator=torch.Generator().manual_seed(seed))
        return s.step_chunk().tolist()

    a = draw(0)
    assert a == draw(0) and all(0 <= t < 259 for row in a for t in row)
    greedy = TG.DecodeSession(tp, cfg, prompts, chunk_steps=8, max_len=64).step_chunk().tolist()
    assert a != greedy


@pytest.mark.parametrize("pchunk", ["", "8"])
def test_generate_ids_chunked_ragged_with_eos_matches_jax(weights, pchunk, monkeypatch):
    """The solo path over a ragged batch with an EOS that some rows emit:
    each row stops at its first EOS (left out of its tokens), the others run
    to max_tokens, and every row equals the JAX runtime's on the same
    weights, in one piece and in KAKVEDA_PREFILL_CHUNK pieces."""
    jp, tp = weights
    if pchunk:
        monkeypatch.setenv("KAKVEDA_PREFILL_CHUNK", pchunk)
    prompts = _ragged(21, [23, 5, 37, 12])
    trt = TG.LlamaRuntime(cfg=TCFG, params=tp, device="cpu")
    jrt = JG.LlamaRuntime(cfg=JCFG, params=jp)
    try:
        trt.tokenizer.EOS = -1  # no row stops: the rows' whole greedy runs
        full = trt._generate_ids_chunked(prompts, 20)
        assert all(len(r) == 20 for r in full)
        eos = full[1][6]
        trt.tokenizer.EOS = jrt.tokenizer.EOS = eos
        got = trt._generate_ids_chunked(prompts, 20)
        assert got == jrt._generate_ids_chunked(prompts, 20)
        assert got == [r[: r.index(eos)] if eos in r else r for r in full]
        assert len(got[1]) <= 6 and any(len(r) == 20 for r in got)
    finally:
        jrt.retire()
        trt.close()


JUDGE_HEAD = "You are a failure auditor for LLM applications. The user asked:\n---\n"


@pytest.mark.parametrize("pchunk", ["", "64"])
def test_runtime_judge_prompts_at_window_512_take_the_solo_path(weights, pchunk, monkeypatch):
    """Judge-length prompts (the template alone is 261 bytes, so p ≥ 262
    tokens and the admission bucket is 511 of a 512 window) never fit the
    engine: generate_batch takes the DecodeSession path, in KAKVEDA_PREFILL_
    CHUNK pieces when set, and gives the JAX runtime's texts."""
    jp, tp = weights
    jcfg = dataclasses.replace(JCFG, max_seq_len=2048)
    tcfg = dataclasses.replace(TCFG, max_seq_len=2048)
    if pchunk:
        monkeypatch.setenv("KAKVEDA_PREFILL_CHUNK", pchunk)
    from kakveda_tpu_torch.pipeline.classifier import _JUDGE_PROMPT

    prompts = [
        _JUDGE_PROMPT.format(prompt=f"Summarize report {i} with citations.", response="Smith says so. " * i)
        for i in (1, 4, 9)
    ]
    assert all(p.startswith(JUDGE_HEAD) for p in prompts)
    trt = TG.LlamaRuntime(cfg=tcfg, params=tp, device="cpu")
    jrt = JG.LlamaRuntime(cfg=jcfg, params=jp)
    try:
        eng = trt.engine()
        ids = [trt.tokenizer.encode(p) for p in prompts]
        assert min(map(len, ids)) >= 262 and eng.cb.max_len == 512
        assert not any(eng.fits(len(i), 4) for i in ids)
        got = trt.generate_batch(prompts, max_tokens=4)
        want = jrt.generate_batch(prompts, max_tokens=4)
        assert [g.text for g in got] == [w.text for w in want]
        assert all("continuous" not in g.meta and g.meta["batched"] == 3 for g in got)
        assert all(g.meta["provider"] == "torch" for g in got)
        assert eng.cb.forwards == 0 and eng.cb.prefix_stats["registered"] == 0
    finally:
        jrt.retire()
        trt.close()
