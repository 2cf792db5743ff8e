"""The port's int8 weight-only weights against the JAX package.

``quantize_tensor_int8`` / ``quantize_params_int8`` bit-identical on the
same f32 input (a zero column, exact .5 ties, 2-D and stacked experts); the
JAX quantized tree carried across bit for bit; ``wmat``'s dequantize equal
to JAX's in f32 and bf16; greedy tokens of an int8 dense and an int8 MoE
model equal to JAX's through ``generate_tokens`` and
``ContinuousBatcher.run_all`` (f32 compute, sums in another order, so
logits agree within 1e-4 and the tokens exactly); ``KAKVEDA_QUANT`` routing
and its refusal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kakveda_tpu.models import generate as JG
from kakveda_tpu.models import llama as J
from kakveda_tpu.models import quant as JQ
from kakveda_tpu.models.serving import ContinuousBatcher as JBatcher
from kakveda_tpu_torch.convert import llama_params_from_jax
from kakveda_tpu_torch.models import generate as TG
from kakveda_tpu_torch.models import llama as T
from kakveda_tpu_torch.models import quant as TQ
from kakveda_tpu_torch.models.serving import ContinuousBatcher

torch.set_num_threads(2)

BASE = dict(vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128)
MOE = dict(BASE, d_model=32, d_ff=48, n_experts=4, n_experts_per_tok=2)
PROMPTS = [[5, 6, 7], [10, 11, 12, 13, 14], [42], [9, 8]]


def _cfgs(kw):
    return J.LlamaConfig(dtype=jnp.float32, **kw), T.LlamaConfig(dtype=torch.float32, **kw)


def _pair(kw, seed=0):
    """(JAX f32 params, the port's f32 params carried across)."""
    jcfg, tcfg = _cfgs(kw)
    jp = J.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, llama_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _quant_cases():
    rng = np.random.default_rng(0)
    w2 = rng.standard_normal((48, 24)).astype(np.float32)
    w2[:, 3] = 0.0  # an all-zero column: scale 1.0, values 0
    # Column 5 has absmax 127, so its scale is exactly 1.0 and these values
    # are exact .5 ties: round half to even.
    w2[:, 5] = 0.25
    w2[:6, 5] = [127.0, 2.5, -0.5, 3.5, -126.5, 1.5]
    stacked = (rng.standard_normal((3, 40, 16)) * rng.uniform(0.1, 10, (3, 1, 16))).astype(np.float32)
    stacked[1, :, 2] = 0.0
    return {"2d": w2, "stacked": stacked}


@pytest.mark.parametrize("case", ["2d", "stacked"])
def test_quantize_tensor_bit_identical(case):
    w = _quant_cases()[case]
    want = JQ.quantize_tensor_int8(jnp.asarray(w))
    for consume in (False, True):
        got = TQ.quantize_tensor_int8(torch.from_numpy(w.copy()), consume=consume)
        assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    if case == "2d":
        q = TQ.quantize_tensor_int8(torch.from_numpy(w))["q"].numpy()
        assert q[:6, 5].tolist() == [127, 2, 0, 4, -126, 2]  # half to even
        assert not q[:, 3].any()
    # A bf16 input quantizes from its f32 value, as JAX's astype(f32) does.
    wb = torch.from_numpy(w).to(torch.bfloat16)
    want_b = JQ.quantize_tensor_int8(jnp.asarray(wb.float().numpy()).astype(jnp.bfloat16))
    got_b = TQ.quantize_tensor_int8(wb)
    np.testing.assert_array_equal(got_b["q"].numpy(), np.asarray(want_b["q"]))
    np.testing.assert_array_equal(got_b["s"].numpy(), np.asarray(want_b["s"]))
    assert torch.equal(wb, torch.from_numpy(w).to(torch.bfloat16))  # the caller's tensor is kept


@pytest.mark.parametrize("kw", [BASE, MOE], ids=["dense", "moe"])
def test_quantize_params_bit_identical_and_keeps_the_rest(kw):
    jp, tp = _pair(kw)
    jq = JQ.quantize_params_int8(jp)
    tq = TQ.quantize_params_int8(tp)
    carried = llama_params_from_jax(jax.tree.map(np.asarray, jq), _cfgs(kw)[1], "cpu")
    for got in (tq, carried):
        for jl, tl in zip(jq["layers"], got["layers"]):
            assert set(jl) == set(tl)
            for k, v in tl.items():
                if k in TQ._DENSE_KEYS:
                    np.testing.assert_array_equal(v["q"].numpy(), np.asarray(jl[k]["q"]))
                    np.testing.assert_array_equal(v["s"].numpy(), np.asarray(jl[k]["s"]))
                else:
                    assert v.dtype == torch.float32
                    np.testing.assert_array_equal(v.numpy(), np.asarray(jl[k]))
        np.testing.assert_array_equal(got["lm_head"]["q"].numpy(), np.asarray(jq["lm_head"]["q"]))
    # Norms, the router and the embedding are the same tensors, unquantized.
    assert tq["embed"] is tp["embed"] and tq["final_norm"] is tp["final_norm"]
    for ql, pl in zip(tq["layers"], tp["layers"]):
        for k in ("attn_norm", "mlp_norm", "router"):
            if k in pl:
                assert ql[k] is pl[k]
    # Already-quantized leaves are kept, not quantized again.
    again = TQ.quantize_params_int8(tq)
    assert again["layers"][0]["wq"] is tq["layers"][0]["wq"]
    err = TQ.quantization_error(tp, tq)
    assert err < 0.01
    assert err == pytest.approx(JQ.quantization_error(jp, jq), rel=1e-6)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_wmat_dequantizes_as_jax(dt):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dt]
    w = _quant_cases()["stacked"]
    jq = JQ.quantize_tensor_int8(jnp.asarray(w))
    tq = TQ.quantize_tensor_int8(torch.from_numpy(w))
    want = np.asarray(J.wmat(jq, jdt).astype(jnp.float32))
    got = T.wmat(tq, dt)
    assert got.dtype == dt
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_init_params_int8_quantizes_each_f32_draw():
    """Drawn with quant="int8", every dense matrix equals the quantization of
    the f32 matrix the same generator draws; norms, router and embedding as
    in the unquantized draw."""
    cfg = T.LlamaConfig(dtype=torch.float32, **MOE)
    f32 = T.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    q = T.init_params(torch.Generator().manual_seed(3), cfg, "cpu", quant="int8")
    want = TQ.quantize_params_int8(f32)
    assert torch.equal(q["embed"], f32["embed"]) and torch.equal(q["lm_head"]["q"], want["lm_head"]["q"])
    for ql, wl in zip(q["layers"], want["layers"]):
        assert ql["router"].dtype == torch.float32
        for k, v in ql.items():
            if isinstance(v, dict):
                assert v["q"].dtype == torch.int8
                assert torch.equal(v["q"], wl[k]["q"]) and torch.equal(v["s"], wl[k]["s"])
            else:
                assert torch.equal(v, wl[k])
    with pytest.raises(ValueError, match="quant"):
        T.init_params(torch.Generator(), cfg, "cpu", quant="int4")


@pytest.mark.parametrize("kw", [BASE, MOE], ids=["dense", "moe"])
def test_int8_greedy_tokens_match_jax(kw):
    jcfg, tcfg = _cfgs(kw)
    jp, _ = _pair(kw, seed=1)
    jq = JQ.quantize_params_int8(jp)
    tq = llama_params_from_jax(jax.tree.map(np.asarray, jq), tcfg, "cpu")
    want = [JG.generate_tokens(jq, jcfg, p, max_new_tokens=10, max_len=64) for p in PROMPTS]
    assert [TG.generate_tokens(tq, tcfg, p, max_new_tokens=10, max_len=64) for p in PROMPTS] == want
    run = JBatcher(jq, jcfg, batch_slots=2, max_len=64, chunk_steps=4).run_all(PROMPTS, max_new_tokens=10)
    assert ContinuousBatcher(tq, tcfg, batch_slots=2, max_len=64, chunk_steps=4).run_all(
        PROMPTS, max_new_tokens=10) == run


@pytest.mark.parametrize("kw", [BASE, MOE], ids=["dense", "moe"])
def test_int8_decode_logits_match_jax(kw):
    jcfg, tcfg = _cfgs(kw)
    jp, _ = _pair(kw, seed=2)
    jq = JQ.quantize_params_int8(jp)
    tq = llama_params_from_jax(jax.tree.map(np.asarray, jq), tcfg, "cpu")
    toks = np.random.default_rng(4).integers(3, 259, size=(2, 9)).astype(np.int64)
    jl, _ = J.decode_step(jq, jcfg, jnp.asarray(toks, jnp.int32), J.init_cache(jcfg, batch=2, max_len=32))
    tl, _ = T.decode_step(tq, tcfg, torch.from_numpy(toks), T.init_cache(tcfg, batch=2, max_len=32, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


def test_runtime_quant_int8_matches_jax_runtime():
    """Given the same f32 params, both runtimes quantize them and serve the
    same texts through their engines."""
    jcfg, tcfg = _cfgs(MOE)
    jp, tp = _pair(MOE, seed=5)
    jrt = JG.LlamaRuntime(cfg=jcfg, params=jp, quant="int8")
    trt = TG.LlamaRuntime(cfg=tcfg, params=tp, quant="int8", device="cpu")
    try:
        assert trt.quant == "int8" and trt.params["layers"][0]["we_up"]["q"].dtype == torch.int8
        prompts = ["hello world", "the quick brown fox", "x"]
        want = [r.text for r in jrt.generate_batch(prompts, max_tokens=10)]
        got = trt.generate_batch(prompts, max_tokens=10)
        assert [r.text for r in got] == want and all(r.meta["continuous"] for r in got)
    finally:
        jrt.retire()
        trt.close()


def test_kakveda_quant_env_routes_and_refuses(monkeypatch):
    monkeypatch.setenv("KAKVEDA_QUANT", "int8")
    rt = TG.LlamaRuntime.from_env(device="cpu")
    try:
        assert rt.quant == "int8"
        assert rt.params["layers"][0]["w_gate"]["q"].dtype == torch.int8
        assert rt.params["lm_head"]["s"].dtype == torch.float32
        assert rt.params["embed"].dtype == torch.bfloat16
        assert isinstance(rt.generate("hello", max_tokens=4).text, str)
    finally:
        rt.close()
    monkeypatch.setenv("KAKVEDA_QUANT", "none")
    rt = TG.LlamaRuntime.from_env(device="cpu")
    assert rt.quant == "none" and isinstance(rt.params["layers"][0]["wq"], torch.Tensor)
    rt.close()
    monkeypatch.setenv("KAKVEDA_QUANT", "int4")
    with pytest.raises(ValueError, match="KAKVEDA_QUANT"):
        TG.LlamaRuntime.from_env(device="cpu")
    with pytest.raises(ValueError, match="quant"):
        TG.LlamaRuntime(cfg=T.LlamaConfig(dtype=torch.float32), quant="fp8", device="cpu")


def test_convert_carries_int8_leaves_bit_for_bit():
    jcfg, tcfg = _cfgs(BASE)
    jp, _ = _pair(BASE)
    jq = JQ.quantize_params_int8(jp)
    tq = llama_params_from_jax(jax.tree.map(np.asarray, jq), dataclasses.replace(tcfg, dtype=torch.bfloat16), "cpu")
    leaf = tq["layers"][1]["wo"]
    assert leaf["q"].dtype == torch.int8 and leaf["s"].dtype == torch.float32  # never cast to cfg.dtype
    np.testing.assert_array_equal(leaf["q"].numpy(), np.asarray(jq["layers"][1]["wo"]["q"]))
    np.testing.assert_array_equal(leaf["s"].numpy(), np.asarray(jq["layers"][1]["wo"]["s"]))
    bad = jax.tree.map(np.asarray, jq)
    bad["lm_head"] = dict(bad["lm_head"], zp=np.zeros(264, np.int8))
    with pytest.raises(NotImplementedError):
        llama_params_from_jax(bad, tcfg, "cpu")
