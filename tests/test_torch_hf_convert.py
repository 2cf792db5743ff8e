"""The port's HF checkpoint converter against the JAX package's.

The checkpoints are genuine ``transformers`` models with random weights,
built by ``tests/test_hf_convert.py``'s own builders (Llama, Mistral,
Qwen2, Qwen3, Gemma, Gemma-2, Phi-3 with and without longrope, Mixtral) and
saved as the Hub lays them out. Both packages load each one: the leaves are
equal in value and dtype (bf16 as loaded for serving, Gemma's 1 + w gains
f32), the configs equal field for field, and the port's logits from one
``decode_step`` over the prompt (f32 load) match the JAX ``forward``'s and
HF's within 2e-4, the JAX test's tolerance. The port reads ``.safetensors``
itself: its reader equals the ``safetensors`` package's, and ``.bin`` and
sharded checkpoints load to the same leaves. Refusals carry the reference's
messages.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_hf_convert as H
from kakveda_tpu.models import generate as JG
from kakveda_tpu.models.hf_convert import hf_config_to_llama as j_hf_config
from kakveda_tpu.models.hf_convert import load_hf_checkpoint as j_load
from kakveda_tpu.models.llama import forward as j_forward
from kakveda_tpu_torch.convert import llama_params_from_jax
from kakveda_tpu_torch.models import generate as TG
from kakveda_tpu_torch.models import llama as T
from kakveda_tpu_torch.models.hf_convert import hf_config_to_llama, load_hf_checkpoint, read_safetensors

transformers = pytest.importorskip("transformers")
torch.set_num_threads(2)


def _qwen3(path, seed=17):
    cfg = transformers.Qwen3Config(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=32, max_position_embeddings=128, rms_norm_eps=1e-6, rope_theta=10000.0,
        tie_word_embeddings=False,
    )
    torch.manual_seed(seed)
    model = transformers.Qwen3ForCausalLM(cfg).eval()
    with torch.no_grad():
        for lyr in model.model.layers:
            lyr.self_attn.q_norm.weight.normal_(1.0, 0.2)
            lyr.self_attn.k_norm.weight.normal_(1.0, 0.2)
    model.save_pretrained(str(path), safe_serialization=True)
    return model


BUILDERS = {
    "llama": lambda p: H._make_hf_checkpoint(p, seed=1),
    "llama_tied": lambda p: H._make_hf_checkpoint(p, tie=True, seed=2),
    "mistral": lambda p: H._make_mistral_checkpoint(p, sliding_window=8, seed=7),
    "mixtral": lambda p: H._make_mixtral_checkpoint(p, seed=10),
    "qwen2": lambda p: H._make_qwen2_checkpoint(p, seed=6),
    "qwen3": _qwen3,
    "gemma": lambda p: H._make_gemma_checkpoint(p, seed=12),
    "gemma2": lambda p: H._make_gemma2_checkpoint(p, seed=14),
    "phi3": lambda p: H._make_phi3_checkpoint(p, seed=22),
    "phi3_longrope": lambda p: H._make_phi3_checkpoint(p, seed=23, long_context=True),
}


@pytest.fixture(scope="module", params=list(BUILDERS))
def ckpt(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(request.param)
    return request.param, path, BUILDERS[request.param](path)


def _leaves(params):
    out = [("embed", params["embed"]), ("final_norm", params["final_norm"]), ("lm_head", params["lm_head"])]
    out += [(f"{i}.{k}", w) for i, layer in enumerate(params["layers"]) for k, w in layer.items()]
    return out


def _same_cfg(tcfg, jcfg):
    for f in dataclasses.fields(jcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def test_leaves_equal_the_jax_loader(ckpt):
    """Every leaf, bf16 as both load for serving: the same keys, dtype and
    value (Gemma's materialized 1 + w gains f32, everything else bf16)."""
    _, path, _ = ckpt
    tp, tcfg = load_hf_checkpoint(str(path), device="cpu")
    jp, jcfg = j_load(str(path))
    _same_cfg(tcfg, jcfg)
    assert tcfg.dtype == torch.bfloat16
    tl, jl = _leaves(tp), _leaves(jp)
    assert [n for n, _ in tl] == [n for n, _ in jl]
    for (name, t), (_, j) in zip(tl, jl):
        j = np.asarray(j)
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), name
        assert tuple(t.shape) == j.shape and t.is_contiguous(), name
        np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32), err_msg=name)


def test_logits_match_jax_and_hf(ckpt):
    """f32 loads: the port's decode_step over the whole prompt against the
    JAX forward and HF's model, within 2e-4; and the JAX tree carried by
    ``llama_params_from_jax`` gives the same logits as the port's load."""
    name, path, model = ckpt
    tp, tcfg = load_hf_checkpoint(str(path), param_dtype=torch.float32, device="cpu")
    jp, jcfg = j_load(str(path), param_dtype=jnp.float32)
    ids = np.random.default_rng(0).integers(0, 256, size=(2, 17), dtype=np.int64)
    cache = T.init_cache(tcfg, batch=2, max_len=17, device="cpu")
    ours, _ = T.decode_step(tp, tcfg, torch.from_numpy(ids), cache)
    ours = ours[:, :, :256].numpy()
    np.testing.assert_allclose(ours, np.asarray(j_forward(jp, jcfg, jnp.asarray(ids)))[:, :, :256],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ours, H._hf_logits(model, ids), rtol=2e-4, atol=2e-4)
    carried = llama_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    again, _ = T.decode_step(carried, tcfg, torch.from_numpy(ids), T.init_cache(tcfg, 2, 17, device="cpu"))
    np.testing.assert_array_equal(again[:, :, :256].numpy(), ours)


def test_greedy_tokens_match_jax(ckpt):
    """f32 loads: ``generate_tokens`` and the continuous batcher give the JAX
    package's greedy tokens."""
    _, path, _ = ckpt
    tp, tcfg = load_hf_checkpoint(str(path), param_dtype=torch.float32, device="cpu")
    jp, jcfg = j_load(str(path), param_dtype=jnp.float32)
    prompts = [list(range(5, 20)), [30, 31, 32], list(range(40, 65))]
    want = [JG.generate_tokens(jp, jcfg, p, max_new_tokens=8) for p in prompts]
    assert [TG.generate_tokens(tp, tcfg, p, max_new_tokens=8) for p in prompts] == want
    from kakveda_tpu_torch.models.serving import ContinuousBatcher

    assert ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=96).run_all(prompts, max_new_tokens=8) == want


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "b.bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "a.f32": torch.randn(7, generator=g),
        "c.f16": torch.randn(2, 2, 2, generator=g).to(torch.float16),
        "d.i64": torch.arange(6).reshape(2, 3),
        "e.u8": torch.arange(9, dtype=torch.uint8),
        "f.scalar": torch.tensor(2.5),
        "g.empty": torch.zeros(0, 4),
    }
    fn = tmp_path / "x.safetensors"
    save_file(tensors, str(fn), metadata={"format": "pt"})
    got = dict(read_safetensors(str(fn)))
    with safe_open(str(fn), framework="pt") as f:
        want = {k: f.get_tensor(k) for k in f.keys()}
    assert set(got) == set(want) == set(tensors)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape and torch.equal(got[k], t), k


@pytest.mark.parametrize("layout", ["bin", "sharded"])
def test_bin_and_sharded_checkpoints_load_the_same_leaves(tmp_path, layout):
    model = H._make_qwen2_checkpoint(tmp_path / "st", seed=3)
    kw = dict(safe_serialization=False) if layout == "bin" else dict(safe_serialization=True, max_shard_size="40KB")
    model.save_pretrained(str(tmp_path / layout), **kw)
    names = {p.name for p in (tmp_path / layout).iterdir()}
    assert ("pytorch_model.bin" in names) if layout == "bin" else ("model.safetensors.index.json" in names)
    want, _ = load_hf_checkpoint(str(tmp_path / "st"), device="cpu")
    got, _ = load_hf_checkpoint(str(tmp_path / layout), device="cpu")
    jp, _ = j_load(str(tmp_path / layout))
    for (name, a), (_, b), (_, j) in zip(_leaves(got), _leaves(want), _leaves(jp)):
        assert torch.equal(a, b), name
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(j).astype(np.float32), err_msg=name)


def _message(fn, *a, **kw):
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return str(e.value)


BASE_HF = dict(vocab_size=8, hidden_size=8, num_hidden_layers=2, num_attention_heads=1, intermediate_size=8)


@pytest.mark.parametrize("hf", [
    {"model_type": "gpt2", "vocab_size": 8},
    dict(BASE_HF, model_type="llama", rope_scaling={"rope_type": "yarn", "factor": 2.0}),
    dict(BASE_HF, model_type="qwen2", sliding_window=4, use_sliding_window=True, max_window_layers=1),
    dict(BASE_HF, model_type="gemma2", sliding_window=4, layer_types=["full_attention", "sliding_attention"]),
    dict(BASE_HF, model_type="phi3", max_position_embeddings=64, original_max_position_embeddings=32,
         rope_scaling={"type": "longrope", "short_factor": [1.0] * 3, "long_factor": [2.0] * 4}),
], ids=["family", "rope_type", "qwen2_mixed_windows", "gemma2_layer_types", "longrope_factors"])
def test_config_refusals_match_the_reference(hf):
    assert _message(hf_config_to_llama, hf) == _message(j_hf_config, hf)


def test_config_mapping_matches_the_reference():
    """Every family's config maps field for field as the reference maps it
    (windows resolved, canonical head_dim and query scale dropped)."""
    cases = [
        dict(BASE_HF, model_type="mistral", sliding_window=4, head_dim=8),
        dict(BASE_HF, model_type="qwen2", sliding_window=4, use_sliding_window=True, max_window_layers=2),
        dict(BASE_HF, model_type="qwen2", sliding_window=4, use_sliding_window=True, max_window_layers=0),
        dict(BASE_HF, model_type="gemma2", sliding_window=4, head_dim=4, query_pre_attn_scalar=4,
             attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
             layer_types=["sliding_attention", "full_attention"]),
        dict(BASE_HF, model_type="gemma2", sliding_window=4, head_dim=4, query_pre_attn_scalar=16),
        dict(BASE_HF, model_type="phi3", vocab_size=250, max_position_embeddings=64, original_max_position_embeddings=32,
             rope_scaling={"type": "longrope", "short_factor": [1.0] * 4, "long_factor": [2.0] * 4}),
        dict(BASE_HF, model_type="llama", rope_scaling={"rope_type": "llama3", "factor": 8.0}),
        dict(BASE_HF, model_type="mixtral", num_local_experts=4, num_experts_per_tok=2),
    ]
    for hf in cases:
        _same_cfg(hf_config_to_llama(hf), j_hf_config(hf))


def _write(path, config, tensors):
    from safetensors.torch import save_file

    path.mkdir()
    (path / "config.json").write_text(json.dumps(config))
    save_file(tensors, str(path / "model.safetensors"))


@pytest.mark.parametrize("case", ["untied_without_head", "bias_without_flag", "unknown_tensor", "unknown_layer_tensor",
                                  "missing_tensor", "expert_out_of_range"])
def test_loader_refusals_match_the_reference(tmp_path, case):
    """A checkpoint the config cannot hold raises the reference's message."""
    cfg = dict(BASE_HF, model_type="llama", num_hidden_layers=1, tie_word_embeddings=False)
    z = lambda *s: torch.zeros(*s)  # noqa: E731
    t = {"model.embed_tokens.weight": z(8, 8), "model.norm.weight": z(8), "lm_head.weight": z(8, 8)}
    layer = {"input_layernorm.weight": z(8), "post_attention_layernorm.weight": z(8),
             "self_attn.q_proj.weight": z(8, 8), "self_attn.k_proj.weight": z(8, 8),
             "self_attn.v_proj.weight": z(8, 8), "self_attn.o_proj.weight": z(8, 8),
             "mlp.gate_proj.weight": z(8, 8), "mlp.up_proj.weight": z(8, 8), "mlp.down_proj.weight": z(8, 8)}
    t.update({f"model.layers.0.{k}": v for k, v in layer.items()})
    if case == "untied_without_head":
        del t["lm_head.weight"]
    elif case == "bias_without_flag":
        t["model.layers.0.self_attn.q_proj.bias"] = z(8)
    elif case == "unknown_tensor":
        t["vision_tower.weight"] = z(2)
    elif case == "unknown_layer_tensor":
        t["model.layers.0.self_attn.rope.weight"] = z(2)
    elif case == "missing_tensor":
        del t["model.layers.0.mlp.up_proj.weight"]
    else:
        cfg = dict(cfg, model_type="mixtral", num_local_experts=2)
        for k in ("mlp.gate_proj.weight", "mlp.up_proj.weight", "mlp.down_proj.weight"):
            del t[f"model.layers.0.{k}"]
        t["model.layers.0.block_sparse_moe.gate.weight"] = z(2, 8)
        t["model.layers.0.block_sparse_moe.experts.5.w1.weight"] = z(8, 8)
    _write(tmp_path / "ck", cfg, t)
    assert _message(load_hf_checkpoint, str(tmp_path / "ck"), device="cpu") == _message(j_load, str(tmp_path / "ck"))


def test_no_weights_raises(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(dict(BASE_HF, model_type="llama")))
    with pytest.raises(FileNotFoundError, match="no model weights"):
        load_hf_checkpoint(str(tmp_path), device="cpu")


def test_vocab_padding_masks_sampling(tmp_path):
    """Vocab 250 pads to 256: the pad rows are zeros, and sampling never
    emits an id past 250."""
    H._make_hf_checkpoint(tmp_path, vocab=250, seed=3)
    params, cfg = load_hf_checkpoint(str(tmp_path), param_dtype=torch.float32, device="cpu")
    assert cfg.vocab_size == 256 and cfg.effective_vocab == 250
    assert not params["embed"][250:].any() and not params["lm_head"][:, 250:].any()
    g = torch.Generator().manual_seed(0)
    out = TG.generate_tokens(params, cfg, list(range(5, 14)), max_new_tokens=24, temperature=0.8, generator=g)
    assert out and all(t < 250 for t in out)


def test_runtime_from_hf_and_from_env(tmp_path, monkeypatch):
    """``LlamaRuntime.from_hf`` (an ``HFTokenizer`` from the checkpoint's
    own files, labelled by its directory) serves the same greedy text as a
    runtime over the JAX loader's leaves; ``quant="int8"`` quantizes them;
    ``from_env`` takes ``KAKVEDA_HF_CKPT`` before its alias
    ``KAKVEDA_HF_DIR``; ``KAKVEDA_LLAMA_CKPT`` (orbax) raises."""
    from kakveda_tpu_torch.models.tokenizer import HFTokenizer

    ck, other = tmp_path / "qwen2-tiny", tmp_path / "other"
    H._make_qwen2_checkpoint(ck, seed=5)
    H._write_tokenizer(ck)
    H._make_hf_checkpoint(other, seed=6)
    H._write_tokenizer(other)
    rt = TG.LlamaRuntime.from_hf(str(ck), device="cpu")
    jp, _ = j_load(str(ck))
    ref = TG.LlamaRuntime(cfg=rt.cfg, params=llama_params_from_jax(jax.tree.map(np.asarray, jp), rt.cfg, "cpu"),
                          tokenizer=HFTokenizer(str(ck)), device="cpu")
    try:
        res = rt.generate("summarize the article", max_tokens=6)
        assert res.meta["model"] == "qwen2-tiny" and res.meta["provider"] == "torch" and rt.quant is None
        assert res.text == ref.generate("summarize the article", max_tokens=6).text
        assert rt.tokenizer.vocab_size <= rt.cfg.vocab_size and rt.device.type == "cpu"
    finally:
        rt.close()
        ref.close()
    q8 = TG.LlamaRuntime.from_hf(str(ck), quant="int8", device="cpu")
    assert q8.quant == "int8" and set(q8.params["layers"][0]["wq"]) == {"q", "s"}
    q8.close()
    monkeypatch.setenv("KAKVEDA_HF_DIR", str(other))
    assert TG.LlamaRuntime.from_env(device="cpu").model_label == "other"
    monkeypatch.setenv("KAKVEDA_HF_CKPT", str(ck))
    assert TG.LlamaRuntime.from_env(device="cpu").model_label == "qwen2-tiny"
    monkeypatch.delenv("KAKVEDA_HF_CKPT")
    monkeypatch.delenv("KAKVEDA_HF_DIR")
    monkeypatch.setenv("KAKVEDA_LLAMA_CKPT", str(ck))
    with pytest.raises(NotImplementedError, match="orbax"):
        TG.LlamaRuntime.from_env(device="cpu")
