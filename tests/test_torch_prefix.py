"""The port's prefix cache against the JAX package's, case for case with
``tests/test_serving_prefix.py``: requests that share a registered prompt
head prefill only their suffix, and their greedy tokens equal both the
port's solo ``generate_tokens`` and the JAX batcher's on the same weights
(the JAX tree carried across by ``convert.llama_params_from_jax``), f32.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kakveda_tpu.models import generate as JG
from kakveda_tpu.models.llama import LlamaConfig as JConfig, init_params as jinit
from kakveda_tpu.models.serving import ContinuousBatcher as JBatcher
from kakveda_tpu_torch.convert import llama_params_from_jax
from kakveda_tpu_torch.models import generate as TG
from kakveda_tpu_torch.models.llama import LlamaConfig as TConfig
from kakveda_tpu_torch.models.serving import ContinuousBatcher, ServingEngine

torch.set_num_threads(2)

JCFG = JConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=128, dtype=jnp.float32,
)
TCFG = TConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=128, dtype=torch.float32,
)
PREFIX = list(range(40, 56))  # 16 shared tokens


def _prompts():
    return [
        PREFIX + [5, 6, 7],
        PREFIX + list(range(100, 121)),  # long suffix: a wider suffix chunk
        PREFIX + [9],
        list(PREFIX),  # the prompt is the prefix (the tail is recomputed)
        [7, 8, 9],  # no shared prefix: a plain admission
    ]


def _weights(seed, **kw):
    jcfg, tcfg = dataclasses.replace(JCFG, **kw), dataclasses.replace(TCFG, **kw)
    jp = jinit(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, llama_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def base():
    return _weights(0)


@pytest.mark.parametrize(
    "seed,kw,n,new",
    [(0, {}, 5, 10), (1, {"kv_quant": "int8"}, 3, 8), (4, {"sliding_window": 12}, 3, 8)],
    ids=["f32", "int8_kv", "sliding_window"],
)
def test_prefix_admission_matches_solo_and_jax(seed, kw, n, new):
    jcfg, tcfg, jp, tp = _weights(seed, **kw)
    prompts = _prompts()[:n]
    solo = [TG.generate_tokens(tp, tcfg, p, max_new_tokens=new, max_len=128) for p in prompts]
    jb = JBatcher(jp, jcfg, batch_slots=2, max_len=128, chunk_steps=4)
    assert jb.register_prefix(PREFIX)
    want = jb.run_all(prompts, max_new_tokens=new)
    cb = ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=128, chunk_steps=4)
    assert cb.register_prefix(PREFIX)
    assert cb.run_all(prompts, max_new_tokens=new) == solo == want
    assert cb.prefix_stats == jb.prefix_stats
    assert cb.prefix_stats["registered"] == 1 and cb.prefix_stats["hits"] == min(n, 4)
    assert cb.prefix_stats["hit_tokens_saved"] > 0
    # One forward for the registration, one per admission, 4 per chunk.
    assert (cb.forwards - 1 - n) % 4 == 0


def test_prefix_stats_equal_jax_key_for_key(base):
    """Hits and saved tokens at each suffix width, the LRU order after each
    match, and the no-reuse case (the suffix covers the whole prompt)."""
    jcfg, tcfg, jp, tp = base
    jb = JBatcher(jp, jcfg, batch_slots=8, max_len=128, chunk_steps=4)
    cb = ContinuousBatcher(tp, tcfg, batch_slots=8, max_len=128, chunk_steps=4)
    longer = PREFIX + [77, 78, 79, 80]
    prompts = [PREFIX + list(range(60, 60 + k)) for k in (1, 7, 9, 16, 17, 40)] + [longer + [5], [3] * 12]
    for b in (jb, cb):
        assert b.register_prefix(PREFIX) and b.register_prefix(longer)
    for p in prompts:
        jm, tm = jb._match_prefix(p), cb._match_prefix(p)
        assert (jm is None) == (tm is None)
        if tm is not None:
            assert tm[0].ids == jm[0].ids and tm[1:] == jm[1:]
        assert list(cb._prefixes) == list(jb._prefixes)
    assert jb.run_all(prompts, max_new_tokens=3) == cb.run_all(prompts, max_new_tokens=3)
    assert cb.prefix_stats == jb.prefix_stats
    assert set(cb.prefix_stats) == {"registered", "hits", "hit_tokens_saved"}


def test_prefix_matching_rules(base):
    _, tcfg, _, tp = base
    cb = ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=64, chunk_steps=4)
    # Too short to matter / too long for the slot window: refused.
    assert not cb.register_prefix([1, 2, 3])
    assert not cb.register_prefix(list(range(60)))
    assert not cb.register_prefix(list(range(55)))  # 55 + 9 reaches the window
    # Registered twice: idempotent, one prefill.
    f0 = cb.forwards
    assert cb.register_prefix(PREFIX)
    assert cb.register_prefix(PREFIX)
    assert cb.prefix_stats["registered"] == 1 and cb.forwards == f0 + 1
    # Non-matching prompt: no hit.
    assert cb._match_prefix([1, 2, 3, 4]) is None
    # Longest registered prefix wins.
    longer = PREFIX + [77, 78, 79, 80]
    assert cb.register_prefix(longer)
    m = cb._match_prefix(longer + [5])
    assert m is not None and list(m[0].ids) == longer
    # The slabs hold the prefix's rows at its exact length.
    assert m[0].kv["k"][0].shape == (1, tcfg.n_kv_heads, len(longer), tcfg.head_dim)


def test_prefix_refused_for_longrope(base):
    """A config whose RoPE regime depends on the whole sequence length
    (Phi-3 longrope) never registers: a slab computed at its own length
    could rotate in the wrong regime."""
    _, tcfg, _, tp = base
    half = tcfg.head_dim // 2
    cfg = dataclasses.replace(tcfg, rope_dim_factors=(1.0,) * half, rope_dim_factors_long=(2.0,) * half)
    cb = ContinuousBatcher(tp, cfg, batch_slots=2, max_len=64, chunk_steps=4)
    assert not cb.register_prefix(PREFIX)
    assert cb.prefix_stats["registered"] == 0


def test_prefix_lru_bound(base, monkeypatch):
    monkeypatch.setenv("KAKVEDA_SERVE_PREFIX_MAX", "2")
    jcfg, tcfg, jp, tp = base
    p1, p2, p3 = [10] * 12, [20] * 12, [30] * 12
    for b in (JBatcher(jp, jcfg, batch_slots=2, max_len=128, chunk_steps=4),
              ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=128, chunk_steps=4)):
        assert b.register_prefix(p1)
        assert b.register_prefix(p2)
        # Touch p1 so that p2 becomes the least recently used.
        assert b._match_prefix(p1 + [1, 2]) is not None
        assert b.register_prefix(p3)
        assert list(b._prefixes) == [tuple(p1), tuple(p3)]
        assert b.prefix_stats["registered"] == 3


def test_prefix_disabled_by_env(base, monkeypatch):
    monkeypatch.setenv("KAKVEDA_SERVE_PREFIX", "0")
    _, tcfg, _, tp = base
    cb = ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=128, chunk_steps=4)
    assert cb.register_prefix(PREFIX)
    out = cb.run_all([PREFIX + [5, 6, 7]], max_new_tokens=4)
    assert cb.prefix_stats["hits"] == 0
    assert out == [TG.generate_tokens(tp, tcfg, PREFIX + [5, 6, 7], max_new_tokens=4, max_len=128)]


def test_engine_register_prefix_concurrent(base):
    """Registration runs on the loop thread, and concurrent submits keep
    exact solo parity with the prefix cache active."""
    _, tcfg, _, tp = base
    prompts = _prompts()
    solo = [TG.generate_tokens(tp, tcfg, p, max_new_tokens=10, max_len=128) for p in prompts]
    eng = ServingEngine(tp, tcfg, batch_slots=2, max_len=128, chunk_steps=4)
    try:
        with ThreadPoolExecutor(max_workers=len(prompts) + 1) as ex:
            reg = ex.submit(eng.register_prefix, PREFIX)
            assert reg.result(timeout=120)
            outs = list(ex.map(lambda p: eng.submit(p, max_new_tokens=10).result(timeout=120), prompts))
        assert outs == solo
        assert eng.cb.prefix_stats["hits"] == 4
        assert eng.register_prefix(PREFIX)  # idempotent through the engine too
        assert eng.cb.prefix_stats["registered"] == 1
    finally:
        eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.register_prefix(PREFIX)


def test_generate_batch_auto_registers_common_head(base, monkeypatch):
    """generate_batch registers the batch's common token head (16 or more
    tokens, 2 or more prompts), and its texts equal the JAX runtime's and
    the port's own per-prompt generate."""
    jcfg, tcfg, jp, tp = base
    monkeypatch.setenv("KAKVEDA_SERVE_CONTINUOUS", "1")
    trt = TG.LlamaRuntime(cfg=tcfg, params=tp, device="cpu")
    jrt = JG.LlamaRuntime(cfg=jcfg, params=jp)
    try:
        head = "Shared judge instruction template: "
        prompts = [head + t for t in ("a", "b", "c")]
        solo = [trt.generate(p, max_tokens=6).text for p in prompts]
        outs = trt.generate_batch(prompts, max_tokens=6)
        want = jrt.generate_batch(prompts, max_tokens=6)
        assert [o.text for o in outs] == solo == [w.text for w in want]
        assert all(o.meta["continuous"] for o in outs)
        stats = trt._engine.cb.prefix_stats
        assert stats == jrt._engine.cb.prefix_stats
        assert stats["registered"] == 1 and stats["hits"] >= 2
        # One prompt, or a head under 16 tokens, registers nothing new.
        trt.generate_batch([head + "d"], max_tokens=2)
        trt.generate_batch(["short a", "short b"], max_tokens=2)
        assert trt._engine.cb.prefix_stats["registered"] == 1
        # register_prefix on the runtime: encoded with the tokenizer's BOS.
        assert trt.register_prefix("An explicit preamble of some length. ")
        assert trt._engine.cb.prefix_stats["registered"] == 2
        assert not trt.register_prefix("tiny")
    finally:
        jrt.retire()
        trt.close()
    # A closed engine: the runtime builds a fresh one on the next call.
    try:
        assert trt.register_prefix("An explicit preamble of some length. ")
    finally:
        trt.close()


def test_runtime_register_prefix_without_engine(base, monkeypatch):
    monkeypatch.setenv("KAKVEDA_SERVE_CONTINUOUS", "0")
    _, tcfg, _, tp = base
    trt = TG.LlamaRuntime(cfg=tcfg, params=tp, device="cpu")
    assert trt.engine() is None
    assert trt.register_prefix("An explicit preamble of some length. ") is False
