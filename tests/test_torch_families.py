"""The model families' flags in the port against the JAX package.

Per family (Qwen2 biases, Qwen3 q/k norms, Gemma GeGLU and embedding scale,
Gemma-2 alternating window, softcaps, query scale and sandwich norms, Phi-3
longrope), the same JAX ``init_params`` tree (its biases and gains drawn
away from 0 and 1 with numpy, so every flag moves the logits) goes through
``convert.llama_params_from_jax`` into the port, and the same numpy token
ids through both packages' ``decode_step``, chunked ``prefill``,
``DecodeSession``, the continuous batcher and ``generate_tokens``.
Tolerances as ``tests/test_torch_llama.py`` states them: logits within
1e-4 in f32 (sums in another order); greedy tokens exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kakveda_tpu.models import generate as JG
from kakveda_tpu.models import llama as J
from kakveda_tpu.models.attention import _gqa_xla
from kakveda_tpu.models.serving import ContinuousBatcher as JBatcher
from kakveda_tpu_torch.convert import llama_params_from_jax
from kakveda_tpu_torch.models import attention as TA
from kakveda_tpu_torch.models import generate as TG
from kakveda_tpu_torch.models import llama as T
from kakveda_tpu_torch.models.serving import ContinuousBatcher

torch.set_num_threads(2)

BASE = dict(vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=256)
_rng = np.random.default_rng(14)
FAMILIES = {
    "qwen2": dict(attn_bias=True),
    "qwen3": dict(qk_norm=True, head_dim_opt=32),
    "gemma": dict(act_fn="gelu_tanh", scale_embed=True, head_dim_opt=32, norm_eps=1e-6),
    "gemma2": dict(
        act_fn="gelu_tanh", scale_embed=True, head_dim_opt=32, norm_eps=1e-6, sliding_window=6,
        alt_window=True, attn_softcap=20.0, final_softcap=10.0, query_scale=64**-0.5, post_norms=True,
    ),
    "phi3": dict(
        rope_dim_factors=tuple(float(x) for x in _rng.uniform(1.0, 1.5, 8)),
        rope_dim_factors_long=tuple(float(x) for x in _rng.uniform(2.0, 6.0, 8)),
        rope_original_max_len=32, rope_attn_scaling=1.19,
    ),
}
PROMPTS = [[5, 6, 7, 8, 9, 10, 11, 12], [40, 41, 42], list(range(60, 80)), [9, 8, 7, 6, 5]]


def cfgs(family, **kw):
    flags = {**BASE, **FAMILIES[family], **kw}
    return J.LlamaConfig(dtype=jnp.float32, **flags), T.LlamaConfig(dtype=torch.float32, **flags)


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """(name, JAX cfg, port cfg, JAX params, port params)."""
    name = request.param
    jcfg, tcfg = cfgs(name)
    rng = np.random.default_rng(1)
    tree = jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(0), jcfg))
    for layer in tree["layers"]:
        for k in layer:
            if k.startswith("b"):
                layer[k] = rng.normal(0.0, 0.5, layer[k].shape).astype(np.float32)
            elif k.endswith("norm"):
                layer[k] = (1.0 + rng.normal(0.0, 0.2, layer[k].shape)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    return name, jcfg, tcfg, jp, llama_params_from_jax(tree, tcfg, "cpu")


def _np(t):
    return np.asarray(t)


def test_init_params_family_keys():
    """The port's ``init_params`` draws every family key the JAX package
    draws, at its shape, f32 like the JAX tree (matrices at cfg.dtype)."""
    for name in FAMILIES:
        jcfg, tcfg = cfgs(name)
        jl = J.init_params(jax.random.PRNGKey(0), jcfg)["layers"][0]
        tl = T.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")["layers"][0]
        assert set(jl) == set(tl), name
        for k, w in tl.items():
            assert tuple(w.shape) == jl[k].shape, (name, k)
            if k.startswith("b") or k.endswith("norm"):
                assert w.dtype == torch.float32 and np.array_equal(w.numpy(), _np(jl[k])), (name, k)


def test_layer_window_and_head_dim():
    _, g2 = cfgs("gemma2")
    jg2, _ = cfgs("gemma2")
    assert [g2.layer_window(i) for i in range(4)] == [jg2.layer_window(i) for i in range(4)] == [6, 0, 6, 0]
    assert g2.head_dim == 32 and cfgs("qwen2")[1].head_dim == 16


@pytest.mark.parametrize("seq_len", [None, "override"])
def test_longrope_tables_match(seq_len):
    jcfg, tcfg = cfgs("phi3")
    pos = np.stack([np.arange(20, 44), np.arange(0, 24)]).astype(np.int64)  # rows in both regimes
    sl = np.array([10, 50]) if seq_len else None  # the override flips each row's regime
    jc, js = J._rope_freqs(jcfg, jnp.asarray(pos, jnp.int32), None if sl is None else jnp.asarray(sl, jnp.int32))
    tc, ts = T._rope_freqs(tcfg, torch.from_numpy(pos), None if sl is None else torch.from_numpy(sl))
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=1e-5)


def test_blocks_match(family):
    """qkv_proj (biases, q/k norms, the query-scale fold), embed_tokens (the
    Gemma scale) and mlp_block (GeGLU) within 1e-5."""
    _, jcfg, tcfg, jp, tp = family
    x = np.random.default_rng(3).standard_normal((2, 5, 64)).astype(np.float32)
    jl, tl = jp["layers"][0], tp["layers"][0]
    for a, b in zip(T.qkv_proj(torch.from_numpy(x), tl, tcfg, torch.float32),
                    J.qkv_proj(jnp.asarray(x), jl, jcfg, jnp.float32)):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-5)
    np.testing.assert_allclose(T.mlp_block(torch.from_numpy(x), tl, tcfg).numpy(),
                               _np(J.mlp_block(jnp.asarray(x), jl, jcfg)), atol=1e-5)
    ids = np.array([[3, 100, 263]])
    np.testing.assert_allclose(T.embed_tokens(tp, tcfg, torch.from_numpy(ids)).numpy(),
                               _np(J.embed_tokens(jp, jcfg, jnp.asarray(ids))), atol=1e-6)


def test_decode_step_logits_match(family):
    """Left-padded prefill then three cached decode steps; last-position
    logits of every call within 1e-4 of the JAX decode_step."""
    _, jcfg, tcfg, jp, tp = family
    toks = np.random.default_rng(2).integers(3, 259, size=(2, 12)).astype(np.int64)
    off = np.array([0, 5])
    ml = 64
    valid = np.arange(ml)[None, :] >= off[:, None]
    jc, tc = J.init_cache(jcfg, batch=2, max_len=ml), T.init_cache(tcfg, batch=2, max_len=ml, device="cpu")
    jv, tv = jnp.asarray(valid), torch.from_numpy(valid)
    jo, to = jnp.asarray(off, jnp.int32), torch.from_numpy(off)
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    for step in range(4):
        jl, jc = J.decode_step(jp, jcfg, jt, jc, kv_valid=jv, pos_offset=jo, last_only=True)
        tl, tc = T.decode_step(tp, tcfg, tt, tc, kv_valid=tv, pos_offset=to, last_only=True)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4, err_msg=f"step {step}")
        nxt = _np(jnp.argmax(jl[:, -1], axis=-1))
        jt, tt = jnp.asarray(nxt[:, None], jnp.int32), torch.from_numpy(nxt[:, None].astype(np.int64))


def _prefill(pkg, params, cfg, prompts, ml, chunk, plen):
    if pkg is JG:
        toks, valid, offs, _ = JG._pack_prompts(prompts, ml, plen=plen)
        cache = J.init_cache(cfg, batch=len(prompts), max_len=ml)
        last, _ = JG.prefill(params, cfg, jnp.asarray(toks), cache, jnp.asarray(valid), jnp.asarray(offs), chunk=chunk)
        return _np(last)
    toks, valid, offs, _ = TG._pack_prompts(prompts, ml, plen=plen)
    cache = T.init_cache(cfg, batch=len(prompts), max_len=ml, device="cpu")
    last, _ = TG.prefill(params, cfg, torch.from_numpy(toks), cache, torch.from_numpy(valid),
                         torch.from_numpy(offs), chunk=chunk)
    return last.numpy()


def test_chunked_prefill_matches_jax(family):
    """Chunked prefill (pieces of 16 over a 48-wide window, a 40-token and a
    12-token prompt: under Phi-3 longrope one row past the original 32
    tokens and one inside) against the JAX package's, and against the
    port's own single-shot prefill (``seq_total`` makes them one function)."""
    _, jcfg, tcfg, jp, tp = family
    rng = np.random.default_rng(7)
    prompts = [[int(x) for x in rng.integers(5, 250, 40)], [int(x) for x in rng.integers(5, 250, 12)]]
    chunked = _prefill(TG, tp, tcfg, prompts, 128, 16, 48)
    np.testing.assert_allclose(chunked, _prefill(JG, jp, jcfg, prompts, 128, 16, 48), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(chunked, _prefill(TG, tp, tcfg, prompts, 128, 0, 48), atol=2e-5, rtol=0)


def test_decode_session_tokens_match(family):
    """DecodeSession with chunked prefill: greedy tokens equal the JAX
    DecodeSession's."""
    _, jcfg, tcfg, jp, tp = family
    kw = dict(chunk_steps=4, max_len=128, prefill_chunk=8)
    js = JG.DecodeSession(jp, jcfg, PROMPTS, **kw)
    ts = TG.DecodeSession(tp, tcfg, PROMPTS, **kw)
    for _ in range(3):
        np.testing.assert_array_equal(ts.step_chunk(), np.asarray(js.step_chunk()))


def test_engine_and_solo_tokens_match(family):
    """The continuous batcher (2 slots, so slots retire and are reused) and
    the solo ``generate_tokens``: greedy tokens equal the JAX package's."""
    _, jcfg, tcfg, jp, tp = family
    want = JBatcher(jp, jcfg, batch_slots=2, max_len=64, chunk_steps=4).run_all(PROMPTS, max_new_tokens=10)
    got = ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=64, chunk_steps=4).run_all(PROMPTS, max_new_tokens=10)
    assert got == want
    solo = [TG.generate_tokens(tp, tcfg, p, max_new_tokens=10) for p in PROMPTS]
    assert solo == [JG.generate_tokens(jp, jcfg, p, max_new_tokens=10) for p in PROMPTS]
    assert got == solo


def test_engine_int8_cache_tokens_match(family):
    """The same through the int8 KV cache."""
    _, jcfg, tcfg, jp, tp = family
    jcfg, tcfg = dataclasses.replace(jcfg, kv_quant="int8"), dataclasses.replace(tcfg, kv_quant="int8")
    want = JBatcher(jp, jcfg, batch_slots=2, max_len=64, chunk_steps=4).run_all(PROMPTS, max_new_tokens=8)
    got = ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=64, chunk_steps=4).run_all(PROMPTS, max_new_tokens=8)
    assert got == want


@pytest.fixture(scope="module")
def phi3():
    jcfg, tcfg = cfgs("phi3")
    tree = jax.tree.map(np.asarray, J.init_params(jax.random.PRNGKey(5), jcfg))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), llama_params_from_jax(tree, tcfg, "cpu")


def test_longrope_mixed_regime_batch_matches_solo(phi3):
    """A slot that crosses the original 32 tokens while it decodes beside a
    short one: the regime is picked per row, so the batched tokens equal
    each prompt's solo tokens, in the port and in the JAX package."""
    jcfg, tcfg, jp, tp = phi3
    rng = np.random.default_rng(2)
    long_p = [int(x) for x in rng.integers(5, 250, 30)]
    short_p = [int(x) for x in rng.integers(5, 250, 6)]
    solo = [TG.generate_tokens(tp, tcfg, p, max_new_tokens=10) for p in (long_p, short_p)]
    got = ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=128).run_all([long_p, short_p], max_new_tokens=10)
    assert got == solo
    assert solo == [JG.generate_tokens(jp, jcfg, p, max_new_tokens=10) for p in (long_p, short_p)]


def test_register_prefix_refuses_longrope(phi3):
    _, tcfg, _, tp = phi3
    cb = ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=128)
    assert cb.register_prefix(list(range(5, 25))) is False and not cb._prefixes
    plain = dataclasses.replace(tcfg, rope_dim_factors=(), rope_dim_factors_long=(), rope_attn_scaling=1.0)
    assert ContinuousBatcher(tp, plain, batch_slots=2, max_len=128).register_prefix(list(range(5, 25)))


def test_runtime_generate_batch_matches_jax(family):
    """LlamaRuntime.generate_batch through the engine, on the CPU: texts
    equal the JAX LlamaRuntime's on the same weights."""
    _, jcfg, tcfg, jp, tp = family
    prompts = ["explain the theory", "quick brown fox jumps", "hi"]
    want = [r.text for r in JG.LlamaRuntime(cfg=jcfg, params=jp).generate_batch(prompts, max_tokens=6)]
    rt = TG.LlamaRuntime(cfg=tcfg, params=tp, device="cpu")
    try:
        got = rt.generate_batch(prompts, max_tokens=6)
        assert [r.text for r in got] == want and all(r.meta.get("continuous") for r in got)
    finally:
        rt.close()


@pytest.mark.parametrize("d", [96, 256])
@pytest.mark.parametrize("window", [0, 40])
def test_gqa_grouped_softcap_matches_xla(d, window):
    """Softcap attention at Phi-3's and Gemma's head dims: the port's
    ``gqa_grouped`` against ``_gqa_xla`` within 1e-5, and the flash
    kernel's plain version (the card's oracle, capping in the same order)
    against it on every row that sees a slot."""
    rng = np.random.default_rng(d + window)
    b, s, h, kv, l, pos0 = 2, 5, 4, 2, 96, 70
    q = (rng.standard_normal((b, s, h, d)) * 2).astype(np.float32)
    k = (rng.standard_normal((b, kv, l, d)) * 2).astype(np.float32)
    v = rng.standard_normal((b, kv, l, d)).astype(np.float32)
    valid = np.arange(l)[None, :] >= np.array([[0], [30]])
    want = _np(_gqa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos0, jnp.asarray(valid),
                        window=window, softcap=5.0))
    tq, tk, tv, tvalid = map(torch.from_numpy, (q, k, v, valid))
    got = TA.gqa_grouped(tq, tk, tv, pos0, tvalid, window=window, softcap=5.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    ref = TA.flash_gqa_cache_reference(tq, tk, tv, pos0, tvalid, window=window, softcap=5.0)
    np.testing.assert_allclose(ref.numpy(), want, atol=1e-5)
    split = TA.flash_gqa_cache_split_reference(tq, tk, tv, pos0, tvalid, window=window, softcap=5.0, n_split=2)
    np.testing.assert_allclose(split.numpy(), want, atol=1e-5)
    # The cap moves the result: without it the rows differ.
    assert np.abs(TA.gqa_grouped(tq, tk, tv, pos0, tvalid, window=window).numpy() - want).max() > 1e-3
