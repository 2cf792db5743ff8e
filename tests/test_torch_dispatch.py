"""The card's attention dispatch, held to the JAX package on the CPU.

``card_path`` sends each call to a body of the flash kernel (bf16, or f32
at D 64 / 128) or to ``gqa_grouped`` (another dtype, a head_dim no body
takes, a ``full_mask``, an f32 model over an int8 cache), where the JAX
package runs ``_gqa_xla``. Here the CPU follows the card's choice (the
dispatch's ``_path`` patched to ``card_path``), with the plain versions in
place of the kernels:

* ``gqa_cache_attention`` at f32, D ∈ {64, 80, 128}, with a per-slot
  ``full_mask`` and without, and at f16, D = 64, equals the JAX
  ``gqa_cache_attention`` (its default on the CPU: XLA) and, where
  ``_flash_ok`` holds, its Pallas kernel in interpret mode. Tolerances:
  2e-5 in f32 (sums in another order), 1e-2 in f16 (one f16 step of
  |out| ≲ 3 is ≤ 2e-3; probabilities round to f16 before P·V).
* Whole models, the weights crossing with ``convert.llama_params_from_jax``:
  an f32 tiny config and one at head_dim 80 give the JAX package's greedy
  tokens through ``generate_tokens``, the engine (``ServingEngine``, with
  and without ``KAKVEDA_SERVE_SPEC``) and the solo ``DecodeSession``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kakveda_tpu.models import generate as JG
from kakveda_tpu.models import serving as JS
from kakveda_tpu.models.attention import _flash_ok, flash_gqa_cache as jax_flash
from kakveda_tpu.models.attention import gqa_cache_attention as j_attention
from kakveda_tpu.models.llama import LlamaConfig as JConfig, init_params as jinit
from kakveda_tpu_torch.convert import llama_params_from_jax
from kakveda_tpu_torch.models import attention as port
from kakveda_tpu_torch.models import generate as TG
from kakveda_tpu_torch.models import serving as TS
from kakveda_tpu_torch.models.llama import LlamaConfig as TConfig

torch.set_num_threads(2)

TOL = {torch.float32: 2e-5, torch.float16: 1e-2}
JDT = {torch.float32: jnp.float32, torch.float16: jnp.float16}


@pytest.fixture
def as_on_the_card(monkeypatch):
    """The CPU takes the card's paths: ``gqa_grouped`` where ``card_path``
    says so, the kernels' plain versions elsewhere; counts each."""
    taken = []

    def path(q, full_mask, kv8, softcap):
        taken.append(port.card_path(q.dtype, q.shape[-1], full_mask, kv8))
        return taken[-1]

    monkeypatch.setattr(port, "_path", path)
    return taken


@pytest.mark.parametrize(
    "dtype,d,full_mask,kv8,want",
    [
        (torch.bfloat16, 32, False, False, "flash"),
        (torch.bfloat16, 96, False, True, "flash"),
        (torch.bfloat16, 256, False, False, "flash"),
        (torch.bfloat16, 80, False, False, "grouped"),
        (torch.bfloat16, 128, True, False, "grouped"),
        (torch.float32, 64, False, False, "flash"),
        (torch.float32, 128, False, False, "flash"),
        (torch.float32, 80, False, False, "grouped"),
        (torch.float32, 32, False, False, "grouped"),
        (torch.float32, 256, False, False, "grouped"),
        (torch.float32, 128, False, True, "grouped"),  # an f32 model over an int8 cache
        (torch.float32, 64, True, False, "grouped"),
        (torch.float16, 64, False, False, "grouped"),
        (torch.float16, 128, False, True, "grouped"),
    ],
)
def test_card_path_is_a_function_of_dtype_head_dim_mask_and_cache(dtype, d, full_mask, kv8, want):
    assert port.card_path(dtype, d, full_mask, kv8) == want


def _inputs(b, s, h, kv, l, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, l, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, l, d)).astype(np.float32)
    off = rng.integers(0, 8, size=(b, 1))
    valid = np.arange(l)[None, :] >= off
    return q, k, v, valid


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.float32, 80), (torch.float32, 128),
                                     (torch.float16, 64)])
@pytest.mark.parametrize("full", [False, True], ids=["causal", "full_mask"])
def test_card_dispatch_equals_jax_gqa_cache_attention(as_on_the_card, dtype, d, full):
    b, s, h, kv, l = 3, 5, 8, 2, 128
    q, k, v, valid = _inputs(b, s, h, kv, l, d, seed=d + 7 * full)
    jdt = JDT[dtype]
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    if full:  # the verify chunk's mask: slot b's query i at slot_pos[b] + i
        slot_pos = np.array([40, 90, 17])
        q_pos = slot_pos[:, None] + np.arange(s)[None, :]
        mask = (np.arange(l)[None, None, :] <= q_pos[..., None]) & valid[:, None, :]
        want = j_attention(jq, jk, jv, jnp.asarray(0), jnp.asarray(valid), full_mask=jnp.asarray(mask))
        got = port.gqa_cache_attention(tq, tk, tv, 0, torch.from_numpy(valid), full_mask=torch.from_numpy(mask))
        per_row = port.gqa_cache_attention(  # the same mask as per-row positions: a kernel body where one takes D
            tq, tk, tv, torch.from_numpy(slot_pos).to(torch.int32), torch.from_numpy(valid))
        np.testing.assert_allclose(per_row.float().numpy(), np.asarray(want, np.float32), atol=TOL[dtype], rtol=0)
    else:
        pos0 = 60
        want = j_attention(jq, jk, jv, jnp.asarray(pos0), jnp.asarray(valid))
        got = port.gqa_cache_attention(tq, tk, tv, pos0, torch.from_numpy(valid))
        if _flash_ok(s, h, kv, l, d) and dtype == torch.float32:
            pallas = jax_flash(jq, jk, jv, jnp.asarray(pos0), jnp.asarray(valid), q_blk=8, l_blk=64,
                               interpret=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=TOL[dtype], rtol=0)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dtype], rtol=0)
    path = port.card_path(dtype, d, full, False)
    assert as_on_the_card[0] == path
    assert (path == "flash") == (dtype == torch.float32 and d in (64, 128) and not full)


def test_f32_model_over_an_int8_cache_dequantizes_as_kv_dequant(as_on_the_card):
    """An f32 model with ``KAKVEDA_KV_QUANT=int8``: the card dequantizes the
    cache to f32 as ``_kv_dequant`` does and takes ``gqa_grouped``, the JAX
    dispatch's XLA path over the dequantized cache."""
    from kakveda_tpu.models.llama import _kv_quant_rows as jquant
    from kakveda_tpu_torch.models.llama import _kv_quant_rows

    q, k, v, valid = _inputs(2, 3, 8, 2, 128, 128, seed=5)
    tk8, tks = _kv_quant_rows(torch.from_numpy(k))
    tv8, tvs = _kv_quant_rows(torch.from_numpy(v))
    jk8, jks = jquant(jnp.asarray(k))
    jv8, jvs = jquant(jnp.asarray(v))
    want = j_attention(jnp.asarray(q), jk8, jv8, jnp.asarray(50), jnp.asarray(valid), k_scale=jks, v_scale=jvs,
                       use_flash=False)
    got = port.gqa_cache_attention(torch.from_numpy(q), tk8, tv8, 50, torch.from_numpy(valid),
                                   k_scale=tks, v_scale=tvs)
    assert as_on_the_card == ["grouped"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


MODELS = {
    # the tests' tiny config, f32: head_dim 16, a size no body takes
    "f32_tiny": dict(vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128),
    # head_dim 64: the f32 body's
    "f32_d64": dict(vocab_size=264, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256, max_seq_len=128),
    # head_dim 80, no body at any dtype
    "f32_d80": dict(vocab_size=264, d_model=320, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256, max_seq_len=128),
}
PROMPTS = [[5, 6, 7], [10, 11, 12, 13, 14], [42], [9, 8] * 5]


@pytest.mark.parametrize("spec", ["0", "4"])
@pytest.mark.parametrize("name", list(MODELS))
def test_whole_model_on_the_cards_paths_gives_the_jax_tokens(as_on_the_card, monkeypatch, name, spec):
    kw = MODELS[name]
    jcfg, tcfg = JConfig(**kw, dtype=jnp.float32), TConfig(**kw, dtype=torch.float32)
    jp = jinit(jax.random.PRNGKey(4), jcfg)
    tp = llama_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    want = [np.asarray(JG.generate_tokens(jp, jcfg, p, max_new_tokens=12)).tolist() for p in PROMPTS]
    assert [TG.generate_tokens(tp, tcfg, p, max_new_tokens=12) for p in PROMPTS] == want
    monkeypatch.setenv("KAKVEDA_SERVE_SPEC", spec)
    monkeypatch.setenv("KAKVEDA_SERVE_SPEC_CALIB", "0")
    monkeypatch.setenv("KAKVEDA_SERVE_SPEC_BREAKEVEN", "0")
    engines = []
    for eng in (JS.ServingEngine(jp, jcfg, batch_slots=2, max_len=128, chunk_steps=4, name=f"dispatch-{name}"),
                TS.ServingEngine(tp, tcfg, batch_slots=2, max_len=128, chunk_steps=4, name=f"dispatch-{name}")):
        try:
            futs = [eng.submit(p, 12) for p in PROMPTS]
            engines.append([f.result() for f in futs])
        finally:
            eng.close()
    assert engines[1] == engines[0] == [w[: len(e)] for w, e in zip(want, engines[0])]
    js = JG.DecodeSession(jp, jcfg, PROMPTS, chunk_steps=6, max_len=64, prefill_chunk=8)
    ts = TG.DecodeSession(tp, tcfg, PROMPTS, chunk_steps=6, max_len=64, prefill_chunk=8)
    for n in (None, 6):
        assert ts.step_chunk(n).tolist() == np.asarray(js.step_chunk(n)).tolist()
    hd = tcfg.head_dim
    assert set(as_on_the_card) == {"flash" if hd in port.KERNEL_F32_HEAD_DIMS else "grouped"}


def test_runtime_with_int8_cache_on_the_cards_paths_gives_the_jax_text(as_on_the_card, monkeypatch):
    """``LlamaRuntime`` at f32, head_dim 80, ``KAKVEDA_KV_QUANT=int8``: the
    same texts as the JAX runtime's, every layer through ``gqa_grouped``."""
    monkeypatch.setenv("KAKVEDA_KV_QUANT", "int8")
    kw = MODELS["f32_d80"]
    jcfg, tcfg = JConfig(**kw, dtype=jnp.float32), TConfig(**kw, dtype=torch.float32)
    jp = jinit(jax.random.PRNGKey(6), jcfg)
    trt = TG.LlamaRuntime(cfg=tcfg, params=llama_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu"),
                          device="cpu")
    jrt = JG.LlamaRuntime(cfg=jcfg, params=jp)
    try:
        prompts = ["hello there", "the quick brown fox"]
        assert [r.text for r in trt.generate_batch(prompts, max_tokens=10)] == \
            [r.text for r in jrt.generate_batch(prompts, max_tokens=10)]
    finally:
        trt.close()
        jrt.retire()
    assert trt.cfg.kv_quant == "int8" and set(as_on_the_card) == {"grouped"}


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
    assert dataclasses.is_dataclass(TConfig)
