"""The port's MultiModelRuntime against the JAX package's.

Twins of ``tests/test_hf_convert.py``'s
``test_multi_model_runtime_hbm_budget_evicts_then_refuses`` and
``test_multi_model_runtime_routes_by_label``, on the CPU (``device="cpu"``),
with the same checkpoints from the same builders; plus the KV-pool charge
of an int8 cache, the gauges on the metrics plane, and the config-only
estimate held to the exact bytes of what the loader makes.
"""

import os

import pytest
import torch

import test_hf_convert as H
from kakveda_tpu.models.runtime import MultiModelRuntime as JMulti
from kakveda_tpu_torch.core import metrics as M
from kakveda_tpu_torch.models import runtime as TR
from kakveda_tpu_torch.models.llama import LlamaConfig

transformers = pytest.importorskip("transformers")
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("KAKVEDA_HBM_BUDGET", "KAKVEDA_KV_QUANT", "KAKVEDA_SERVE_WINDOW", "KAKVEDA_SERVE_SLOTS"):
        monkeypatch.delenv(var, raising=False)
    TR.clear_runtimes()
    yield
    TR.clear_runtimes()


def test_multi_model_runtime_hbm_budget_evicts_then_refuses(tmp_path):
    """A load that would pass the budget evicts idle models, least recently
    used first; when eviction cannot make room it raises HBMBudgetError
    before any weight is read. The pre-load estimate comes from config.json
    alone."""
    d1, d2 = tmp_path / "m-one", tmp_path / "m-two"
    for d, seed in ((d1, 30), (d2, 31)):
        H._make_hf_checkpoint(d, vocab=256, seed=seed)
        H._write_tokenizer(d)

    mm = TR.MultiModelRuntime([str(d1), str(d2)], device="cpu")
    one_cost = mm._estimate_bytes(str(d1))
    mm._get("m-one")
    exact = mm.loaded_bytes()
    assert 0.5 * exact <= one_cost <= 2.0 * exact, (one_cost, exact)
    mm.close()

    mm2 = TR.MultiModelRuntime([str(d1), str(d2)], hbm_budget_bytes=int(exact * 1.5), device="cpu")
    rt_one = mm2._get("m-one")
    assert set(mm2._loaded) == {"m-one"}
    mm2._get("m-two")
    assert set(mm2._loaded) == {"m-two"}, "LRU eviction did not run"
    assert mm2.loaded_bytes() <= int(exact * 1.5)
    assert mm2.generate("hi", model="m-two").text is not None
    # The evicted runtime is retired: it never rebuilds a KV pool behind the
    # budget's back, but a caller holding it still gets the solo path.
    assert rt_one._retired and rt_one.engine() is None
    assert rt_one.generate("still works", max_tokens=4).text is not None
    stats = mm2.serving_stats()
    assert stats["runtime"] == "torch-multi" and set(stats["models"]) == {"m-two"}
    assert stats["available"] == ["m-one", "m-two"] and stats["loaded_bytes"] == mm2.loaded_bytes()
    mm2.close()

    mm3 = TR.MultiModelRuntime([str(d1)], hbm_budget_bytes=1024, device="cpu")
    with pytest.raises(TR.HBMBudgetError, match="HBM budget"):
        mm3._get("m-one")
    assert mm3._loaded == {}


def test_multi_model_runtime_routes_by_label(tmp_path, monkeypatch):
    """Labels are the directories' names, loads are lazy, the first path is
    the default, requests route to their model's weights, and
    ``get_runtime`` builds the router from ``KAKVEDA_HF_CKPTS``. The texts
    equal the JAX MultiModelRuntime's on the same checkpoints (both load
    bf16; on these the greedy tokens agree)."""
    d1, d2 = tmp_path / "llama-tiny", tmp_path / "qwen3-tiny"
    H._make_hf_checkpoint(d1, vocab=256, seed=20)
    H._write_tokenizer(d1)
    hf_cfg = transformers.Qwen3Config(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=32, max_position_embeddings=128, tie_word_embeddings=False,
    )
    torch.manual_seed(21)
    transformers.Qwen3ForCausalLM(hf_cfg).eval().save_pretrained(str(d2), safe_serialization=True)
    H._write_tokenizer(d2)

    rt = TR.MultiModelRuntime([str(d1), str(d2)], device="cpu")
    try:
        assert rt.list_models() == ["llama-tiny", "qwen3-tiny"]
        assert not rt._loaded  # lazy: nothing loaded yet
        r1 = rt.generate("the quick brown fox", model="llama-tiny", max_tokens=6)
        assert set(rt._loaded) == {"llama-tiny"}
        r2 = rt.generate("the quick brown fox", model="qwen3-tiny", max_tokens=6)
        assert r1.meta["provider"] == r2.meta["provider"] == "torch"
        assert r1.meta["model"] == "llama-tiny" and r2.meta["model"] == "qwen3-tiny"
        assert rt.generate("the quick brown fox", max_tokens=6).text == r1.text  # the default is the first
        with pytest.raises(TR.UnknownModelError, match="available"):
            rt.generate("x", model="nope")
        batch = rt.generate_batch(["the quick", "brown fox"], model="qwen3-tiny", max_tokens=4)
        assert len(batch) == 2 and all(b.meta["model"] == "qwen3-tiny" for b in batch)
        assert "".join(rt.generate_stream("the quick brown fox", model="llama-tiny", max_tokens=6)) == r1.text
        jm = JMulti([str(d1), str(d2)])
        for label, res in (("llama-tiny", r1), ("qwen3-tiny", r2)):
            assert jm.generate("the quick brown fox", model=label, max_tokens=6).text == res.text
    finally:
        rt.close()

    monkeypatch.setenv("KAKVEDA_MODEL_RUNTIME", "tpu")
    monkeypatch.setenv("KAKVEDA_HF_CKPTS", os.pathsep.join([str(d1), str(d2)]))
    env_rt = TR.get_runtime(device="cpu")
    assert isinstance(env_rt, TR.MultiModelRuntime) and not env_rt._loaded
    assert TR.list_models(env_rt) == ["llama-tiny", "qwen3-tiny"]
    assert TR.get_runtime("torch", device="cpu") is env_rt


def test_engine_pool_bytes_reflects_kv_quant(monkeypatch):
    """An int8 pool is charged 1 + 4 / head_dim bytes an element, a bf16 one
    2, as in the reference."""
    cfg = LlamaConfig()
    dense = TR.MultiModelRuntime._engine_pool_bytes(cfg)
    monkeypatch.setenv("KAKVEDA_KV_QUANT", "int8")
    int8 = TR.MultiModelRuntime._engine_pool_bytes(cfg)
    assert abs(int8 / dense - (1.0 + 4.0 / cfg.head_dim) / 2) < 1e-6
    monkeypatch.setenv("KAKVEDA_SERVE_WINDOW", "128")
    monkeypatch.delenv("KAKVEDA_KV_QUANT")
    assert TR.MultiModelRuntime._engine_pool_bytes(cfg) == 8 * 128 * cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2


@pytest.mark.parametrize("family", ["qwen2", "gemma2", "mixtral", "phi3"])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_estimate_covers_the_loaded_bytes(tmp_path, family, quant):
    """The config-only estimate of the weights is never below what the
    loader and the quantizer make, and within 5 % of it (it charges norms
    and biases at f32)."""
    from kakveda_tpu_torch.models.hf_convert import load_hf_checkpoint
    from kakveda_tpu_torch.models.quant import quantize_params_int8

    build = {"qwen2": H._make_qwen2_checkpoint, "gemma2": H._make_gemma2_checkpoint,
             "mixtral": H._make_mixtral_checkpoint, "phi3": H._make_phi3_checkpoint}[family]
    build(tmp_path)
    params, cfg = load_hf_checkpoint(str(tmp_path), device="cpu")
    if quant:
        params = quantize_params_int8(params)
    exact = TR._tree_bytes(params)
    est = TR._param_bytes_estimate(cfg, quant)
    assert exact <= est <= 1.05 * exact, (est, exact)


def test_hbm_gauges_on_the_metrics_plane(tmp_path):
    reg = M.get_registry()
    TR.MultiModelRuntime([str(tmp_path / "a")], hbm_budget_bytes=12345, device="cpu")
    text = reg.render()
    assert "# TYPE kakveda_hbm_budget_bytes gauge" in text and "kakveda_hbm_budget_bytes 12345" in text
    assert "# TYPE kakveda_hbm_loaded_bytes gauge" in text
    with pytest.raises(ValueError, match="quant"):
        TR.MultiModelRuntime([str(tmp_path / "a")], quant="fp8")
    with pytest.raises(ValueError, match="duplicate"):
        TR.MultiModelRuntime([str(tmp_path / "x" / "a"), str(tmp_path / "a")])
