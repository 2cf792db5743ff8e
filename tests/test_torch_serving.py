"""The port's serving path against the JAX package: greedy tokens and texts
identical in f32, for the float cache and the int8 cache.

``ContinuousBatcher.run_all`` (with retirement, slot reuse and late
admission), an admission in mid-flight, and
``LlamaRuntime.generate_batch`` through the engine, on the same weights
(the JAX tree carried across by ``convert.llama_params_from_jax``). Pad
rows are the one place the two differ (zeros here, a uniform average in the
JAX CPU path), and they never reach a real token, so the tokens are equal.
"""

import dataclasses

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
from kakveda_tpu_torch.models.serving import ContinuousBatcher, EngineDeadError, ServingEngine

torch.set_num_threads(2)

JCFG = JConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=128, dtype=jnp.float32,
)
TCFG = TConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=128, dtype=torch.float32,
)
PROMPTS = [[5, 6, 7], [10, 11, 12, 13, 14], [42], [9, 8], [100, 101, 102, 103]]


@pytest.fixture(scope="module")
def weights():
    jp = jinit(jax.random.PRNGKey(0), JCFG)
    return jp, llama_params_from_jax(jax.tree.map(np.asarray, jp), TCFG, "cpu")


def _cfgs(kv_quant, **kw):
    kw["kv_quant"] = kv_quant
    return dataclasses.replace(JCFG, **kw), dataclasses.replace(TCFG, **kw)


@pytest.mark.parametrize("kv_quant,window", [("", 0), ("int8", 0), ("", 4)])
def test_run_all_matches_jax(weights, kv_quant, window):
    jp, tp = weights
    jcfg, tcfg = _cfgs(kv_quant, sliding_window=window)
    want = JBatcher(jp, jcfg, batch_slots=2, max_len=64, chunk_steps=4).run_all(PROMPTS, max_new_tokens=10)
    cb = ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=64, chunk_steps=4)
    assert cb.run_all(PROMPTS, max_new_tokens=10) == want
    # Solo decode of the port agrees too, and every forward was counted:
    # 5 admissions + 9 chunks of 4 steps.
    assert [TG.generate_tokens(tp, tcfg, p, max_new_tokens=10, max_len=64) for p in PROMPTS] == want
    assert cb.forwards == 5 + 9 * 4


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_admit_mid_flight_matches_jax(weights, kv_quant):
    jp, tp = weights
    jcfg, tcfg = _cfgs(kv_quant)
    a, b = [5, 6, 7, 8], [50, 51]
    outs = []
    for cb in (JBatcher(jp, jcfg, batch_slots=3, max_len=64, chunk_steps=3),
               ContinuousBatcher(tp, tcfg, batch_slots=3, max_len=64, chunk_steps=3)):
        ra = cb.admit(a, max_new_tokens=12)
        cb.step()  # a decodes a chunk alone
        rb = cb.admit(b, max_new_tokens=6)  # b joins mid-flight
        while cb.active:
            cb.step()
        outs.append((cb.results[ra], cb.results[rb]))
    assert outs[0] == outs[1]
    assert len(outs[1][0]) == 12 and len(outs[1][1]) == 6


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_runtime_generate_batch_matches_jax(weights, kv_quant, monkeypatch):
    jp, tp = weights
    if kv_quant:
        monkeypatch.setenv("KAKVEDA_KV_QUANT", kv_quant)
    prompts = ["hello world", "the quick brown fox", "x"]
    jrt = JG.LlamaRuntime(cfg=JCFG, params=jp)
    trt = TG.LlamaRuntime(cfg=TCFG, params=tp, device="cpu")
    try:
        assert trt.cfg.kv_quant == jrt.cfg.kv_quant == kv_quant
        assert trt.cfg.effective_vocab == jrt.cfg.effective_vocab == 259
        want = jrt.generate_batch(prompts, max_tokens=12)
        got = trt.generate_batch(prompts, max_tokens=12)
        assert [r.text for r in got] == [r.text for r in want]
        for g, w in zip(got, want):
            assert set(g.meta) == set(w.meta) and g.meta["tokens_generated"] == w.meta["tokens_generated"]
            assert g.meta["continuous"] is True and g.meta["batched"] == 3
        one = trt.generate(prompts[1], max_tokens=12)
        assert one.text == want[1].text and one.meta["continuous"] is True
    finally:
        jrt.retire()
        trt.close()


def test_runtime_solo_fallback_matches_engine(weights):
    """A request whose bucket + budget overruns the engine window takes the
    solo path (the JAX runtime's chunked DecodeSession): its text equals the
    JAX runtime's, and its tokens equal a solo generate_tokens up to the
    session's last row (a DecodeSession keeps one row of its window free,
    so it stops one token before generate_tokens at a full window)."""
    jp, tp = weights
    trt = TG.LlamaRuntime(cfg=TCFG, params=tp, device="cpu")
    jrt = JG.LlamaRuntime(cfg=JCFG, params=jp)
    try:
        ids = trt.tokenizer.encode("a prompt of some length")
        assert not trt.engine().fits(len(ids), 120)
        r = trt.generate("a prompt of some length", max_tokens=120)
        assert "continuous" not in r.meta
        assert r.text == jrt.generate("a prompt of some length", max_tokens=120).text
        want = TG.generate_tokens(tp, trt.cfg, ids, max_new_tokens=120, eos_id=trt.tokenizer.EOS)
        got = trt._generate_ids_chunked([ids], 120)[0]
        assert trt.tokenizer.decode(got) == r.text
        assert got == want[: len(got)] and len(got) == min(len(want), TCFG.max_seq_len - 1 - len(ids))
    finally:
        jrt.retire()
        trt.close()


def test_engine_loop_failure_fails_pending_futures(weights, monkeypatch):
    """Twin of ``tests/test_serving.py::test_serving_engine_loop_death_fails_futures_not_hangs``:
    with no restart budget a loop death fails the pending future with
    ``EngineDeadError`` ("died terminally") instead of leaving it to hang,
    and later ``submit`` and ``register_prefix`` raise it at once."""
    monkeypatch.setenv("KAKVEDA_SERVE_RESTARTS", "0")
    _, tp = weights
    eng = ServingEngine(tp, TCFG, batch_slots=2, max_len=64, chunk_steps=2)

    def boom():
        raise RuntimeError("injected")

    eng.cb.step_async = boom
    fut = eng.submit([5, 6, 7], max_new_tokens=4)
    with pytest.raises(EngineDeadError, match="died terminally.*injected"):
        fut.result(timeout=60)
    assert eng._dead.wait(timeout=10)
    eng._thread.join(timeout=10)
    assert not eng._thread.is_alive()
    with pytest.raises(EngineDeadError):
        eng.submit([1, 2], max_new_tokens=2)
    with pytest.raises(EngineDeadError):
        eng.register_prefix(list(range(16)))
    eng.close()


def test_engine_close_fails_waiting_requests(weights):
    _, tp = weights
    eng = ServingEngine(tp, TCFG, batch_slots=1, max_len=64, chunk_steps=2)
    futs = [eng.submit([5, 6, 7], max_new_tokens=40) for _ in range(4)]
    eng.close()
    for f in futs:
        assert f.done()
        assert f.exception() is None or isinstance(f.exception(), RuntimeError)
    assert not eng._thread.is_alive()


def test_sampled_slot_leaves_greedy_slots_exact(weights):
    _, tp = weights
    cfg = dataclasses.replace(TCFG, effective_vocab=259)
    greedy = TG.generate_tokens(tp, cfg, [9, 8], max_new_tokens=8, max_len=64)
    cb = ContinuousBatcher(tp, cfg, batch_slots=2, max_len=64, chunk_steps=4,
                           generator=torch.Generator().manual_seed(1))
    rs = cb.admit([5, 6, 7], max_new_tokens=8, temperature=1.0)
    rg = cb.admit([9, 8], max_new_tokens=8)
    while cb.active:
        cb.step()
    assert cb.results[rg] == greedy
    assert len(cb.results[rs]) == 8 and all(0 <= t < 259 for t in cb.results[rs])


def test_temperature_sampling_draws_from_the_generator(weights):
    _, tp = weights
    cfg = dataclasses.replace(TCFG, effective_vocab=259)

    def draw(seed):
        return TG.generate_tokens(tp, cfg, [5, 6, 7], max_new_tokens=12, temperature=1.0,
                                  generator=torch.Generator().manual_seed(seed))

    a = draw(0)
    assert a == draw(0) and len(a) == 12 and all(0 <= t < 259 for t in a)
    assert a != TG.generate_tokens(tp, cfg, [5, 6, 7], max_new_tokens=12)  # not the greedy path
