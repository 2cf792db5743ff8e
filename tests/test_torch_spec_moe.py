"""MoE under speculation in the port against the JAX package.

* The solo path: the twin of ``tests/test_speculative.py::
  test_speculative_int8_and_moe`` (its MoE config, f32, 4 experts top-2),
  with int8 weight-only experts too: ``generate_tokens_speculative`` gives
  the JAX package's tokens and ``generate_tokens``' greedy ones.
* The engine's verify chunks (``ContinuousBatcher(spec_k=4)`` and
  ``ServingEngine`` under ``KAKVEDA_SERVE_SPEC=4``, every slot greedy, the
  gate held open): tokens equal to the JAX package's and to greedy decoding,
  and the whole ``spec_stats`` equal to the JAX package's (the pipelined
  engine's chunk count follows its loop's timing in both packages: there the
  tokens only).
* With ``expert_capacity_factor`` > 0 a verify chunk's capacity follows its
  B·(k+1) tokens (``kakveda_tpu/models/moe.py:51``) and drops assignments
  past it: the port keeps the same capacity and drops the same assignments,
  so its tokens and stats equal the JAX package's (they need not equal
  greedy decoding: a drop depends on the batch).

Both serving modules run on a frozen clock, as in
``tests/test_torch_spec.py``.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kakveda_tpu.models import generate as JG
from kakveda_tpu.models import moe as JM
from kakveda_tpu.models import serving as JS
from kakveda_tpu.models import speculative as JSP
from kakveda_tpu.models.llama import LlamaConfig as JConfig, init_params as jinit
from kakveda_tpu.models.quant import quantize_params_int8 as j_quant
from kakveda_tpu_torch.convert import llama_params_from_jax
from kakveda_tpu_torch.models import generate as TG
from kakveda_tpu_torch.models import moe as TM
from kakveda_tpu_torch.models import serving as TS
from kakveda_tpu_torch.models import speculative as TSP
from kakveda_tpu_torch.models.llama import LlamaConfig as TConfig
from kakveda_tpu_torch.models.quant import quantize_params_int8 as t_quant

torch.set_num_threads(2)

# tests/test_speculative.py:70-74, the reference's MoE config.
SOLO_KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=48, max_seq_len=256,
               n_experts=4, n_experts_per_tok=2)
# tests/test_torch_spec.py's engine config, with 4 experts top-2.
ENGINE_KW = dict(vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128,
                 n_experts=4, n_experts_per_tok=2)
PROMPTS = [[5, 6, 7], [10, 11, 12, 13, 14], [42], [9, 8]]
LOOP = [7, 8, 9, 7, 8, 9, 7, 8, 9]
OPEN_GATE = {"KAKVEDA_SERVE_SPEC_CALIB": "0", "KAKVEDA_SERVE_SPEC_BREAKEVEN": "0"}


class _FrozenClock:
    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def perf_counter():
        return 0.0


@pytest.fixture
def frozen(monkeypatch):
    monkeypatch.setattr(JS, "time", _FrozenClock())
    monkeypatch.setattr(TS, "time", _FrozenClock())


_WEIGHTS = {}


def _weights(kw, seed, quant=False):
    key = (tuple(sorted(kw.items())), seed, quant)
    if key not in _WEIGHTS:
        jcfg, tcfg = JConfig(**kw, dtype=jnp.float32), TConfig(**kw, dtype=torch.float32)
        jp = jinit(jax.random.PRNGKey(seed), jcfg)
        tp = llama_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        if quant:
            jp, tp = j_quant(jp), t_quant(tp)
        _WEIGHTS[key] = (jcfg, tcfg, jp, tp)
    return _WEIGHTS[key]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("prompt", [[5, 6, 7, 8, 5, 6, 7, 8, 5, 6], list(range(5, 25)), [3] * 8],
                         ids=["reference", "arbitrary", "constant"])
@pytest.mark.parametrize("k", [1, 4])
def test_moe_speculative_solo_matches_jax_and_greedy(prompt, k, quant):
    jcfg, tcfg, jp, tp = _weights(SOLO_KW, 2, quant)
    want, jstats = JSP.generate_tokens_speculative(jp, jcfg, prompt, max_new_tokens=12, k=k, return_stats=True)
    got, stats = TSP.generate_tokens_speculative(tp, tcfg, prompt, max_new_tokens=12, k=k, return_stats=True)
    greedy = TG.generate_tokens(tp, tcfg, prompt, max_new_tokens=12)
    assert got == want == greedy == JG.generate_tokens(jp, jcfg, prompt, max_new_tokens=12)
    assert stats == jstats


def _batcher_pair(jp, jcfg, tp, tcfg, prompts, slots):
    return (JS.ContinuousBatcher(jp, jcfg, batch_slots=slots, max_len=128, chunk_steps=4, spec_k=4),
            TS.ContinuousBatcher(tp, tcfg, batch_slots=slots, max_len=128, chunk_steps=4, spec_k=4))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("prompts", [PROMPTS, [LOOP, PROMPTS[1]]], ids=["mixed", "repetitive"])
def test_moe_batcher_verify_chunks_match_jax_and_greedy(prompts, quant, frozen, monkeypatch):
    """Verify chunks over 2 slots, B·(k+1) = 10 tokens a chunk through
    ``moe_mlp``: tokens equal the JAX batcher's and solo greedy decoding's,
    the stats equal the JAX batcher's."""
    for key, val in OPEN_GATE.items():
        monkeypatch.setenv(key, val)
    jcfg, tcfg, jp, tp = _weights(ENGINE_KW, 3, quant)
    results = []
    for cb in _batcher_pair(jp, jcfg, tp, tcfg, prompts, 2):
        outs = cb.run_all(prompts, max_new_tokens=16)
        assert cb._spec_pending == 0
        results.append((outs, cb.stats_snapshot()))
    (jouts, jstats), (touts, tstats) = results
    solo = [TG.generate_tokens(tp, tcfg, p, max_new_tokens=16, max_len=128) for p in prompts]
    assert touts == jouts == solo
    assert tstats == jstats and tstats["spec"]["chunks"] > 0


@pytest.mark.parametrize("pipeline", ["1", "0"], ids=["pipelined", "unpipelined"])
def test_moe_engine_spec_matches_jax_and_greedy(pipeline, frozen, monkeypatch):
    """``ServingEngine`` under ``KAKVEDA_SERVE_SPEC=4`` with the gate held
    open, greedy requests one at a time: each equals the JAX engine's and
    solo greedy decoding. Unpipelined, ``stats()["spec"]`` equals the JAX
    engine's too. Pipelined, how many verify chunks the loop dispatches
    ahead of a request's end depends on the loop's timing, in both packages
    alike (the JAX engine gave 70 and 71 chunks on this traffic in two
    runs), so only the tokens are held there."""
    monkeypatch.setenv("KAKVEDA_SERVE_SPEC", "4")
    monkeypatch.setenv("KAKVEDA_SERVE_PIPELINE", pipeline)
    for key, val in OPEN_GATE.items():
        monkeypatch.setenv(key, val)
    jcfg, tcfg, jp, tp = _weights(ENGINE_KW, 3)
    reqs = [LOOP] + PROMPTS
    results = []
    for eng in (JS.ServingEngine(jp, jcfg, batch_slots=2, max_len=128, chunk_steps=4, name="moe-spec"),
                TS.ServingEngine(tp, tcfg, batch_slots=2, max_len=128, chunk_steps=4, name="moe-spec")):
        try:
            assert eng.cb.spec_k == 4
            results.append(([eng.submit(p, 16).result() for p in reqs], eng.stats()["spec"]))
        finally:
            eng.close()
    assert results[1][0] == results[0][0]
    assert results[1][0] == [TG.generate_tokens(tp, tcfg, p, max_new_tokens=16, max_len=128) for p in reqs]
    assert results[1][1]["chunks"] > 0
    if pipeline == "0":
        assert results[1][1] == results[0][1]


def test_moe_verify_chunk_capacity_follows_its_tokens(frozen, monkeypatch):
    """At ``expert_capacity_factor`` 0.5 a verify chunk of B·(k+1) tokens
    has the capacity the JAX package gives those tokens, and some
    assignments drop: the port's tokens and stats equal the JAX package's."""
    for key, val in OPEN_GATE.items():
        monkeypatch.setenv(key, val)
    kw = dict(ENGINE_KW, expert_capacity_factor=0.5)
    jcfg, tcfg, jp, tp = _weights(kw, 3)
    for t in (5, 10, 15):  # one slot's verify chunk, two slots', three
        assert TM.expert_capacity(t, tcfg) == JM.expert_capacity(t, jcfg) < t
    seen = []
    orig = TM.expert_capacity

    def spy(n_tokens, cfg):
        seen.append(n_tokens)
        return orig(n_tokens, cfg)

    monkeypatch.setattr(TM, "expert_capacity", spy)
    prompts = [LOOP, PROMPTS[1], PROMPTS[0]]
    results = []
    for cb in _batcher_pair(jp, jcfg, tp, tcfg, prompts, 3):
        results.append((cb.run_all(prompts, max_new_tokens=16), cb.stats_snapshot()))
    assert results[1] == results[0]
    assert results[1][1]["spec"]["chunks"] > 0
    assert 3 * 5 in seen  # a verify chunk over all three slots: B·(k+1) = 15 tokens


def test_moe_drops_in_a_verify_chunk_equal_jax():
    """One MoE block at T = B·(k+1) = 10 tokens and capacity factor 0.5:
    the port's output equals the JAX ``moe_mlp``'s within 1e-5 (f32), the
    same assignments dropped (rows whose every expert dropped are zero in
    both)."""
    kw = dict(ENGINE_KW, expert_capacity_factor=0.5)
    jcfg, tcfg, jp, tp = _weights(kw, 3)
    x = np.random.default_rng(0).standard_normal((2, 5, kw["d_model"])).astype(np.float32)
    want = np.asarray(JM.moe_mlp(jnp.asarray(x), jp["layers"][0], jcfg))
    got = TM.moe_mlp(torch.from_numpy(x), tp["layers"][0], tcfg).numpy()
    assert np.abs(got - want).max() <= 1e-5
    assert TM.expert_capacity(10, tcfg) < 10
    assert np.array_equal(np.abs(got).sum(-1) == 0, np.abs(want).sum(-1) == 0)
