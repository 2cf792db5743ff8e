"""The port's sparse-MoE MLP against the JAX package.

Same weights in both (the JAX tree carried across by
``convert.llama_params_from_jax``), same numpy inputs, f32 compute at a tiny
width (d_model 32, 2 layers, E = 4, k = 2). Tolerances: routing indices
equal, ties included (lowest expert first); routing weights within 1e-6
(f32 softmax sums in another order); ``moe_mlp`` outputs within 1e-5 (f32
expert products summed in another order); the same assignments dropped at
a capacity factor of 0.3; ``decode_step`` logits within 1e-4 as in
``test_torch_llama.py``; greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kakveda_tpu.models import generate as JG
from kakveda_tpu.models import llama as J
from kakveda_tpu.models import moe as JM
from kakveda_tpu.models.hf_convert import hf_config_to_llama
from kakveda_tpu.models.serving import ContinuousBatcher as JBatcher
from kakveda_tpu_torch.convert import llama_params_from_jax
from kakveda_tpu_torch.models import generate as TG
from kakveda_tpu_torch.models import llama as T
from kakveda_tpu_torch.models import moe as TM
from kakveda_tpu_torch.models.serving import ContinuousBatcher

torch.set_num_threads(2)

KW = dict(vocab_size=264, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=48, max_seq_len=128,
          n_experts=4, n_experts_per_tok=2)
JCFG = J.LlamaConfig(dtype=jnp.float32, **KW)
TCFG = T.LlamaConfig(dtype=torch.float32, **KW)
PROMPTS = [[5, 6, 7], [10, 11, 12, 13, 14], [42], [9, 8], [100, 101, 102, 103]]


@pytest.fixture(scope="module")
def params():
    jp = J.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, llama_params_from_jax(jax.tree.map(np.asarray, jp), TCFG, "cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_moe_layer_layout(params):
    jp, tp = params
    layer = tp["layers"][0]
    assert set(layer) == set(jp["layers"][0]) and "w_gate" not in layer
    assert layer["router"].dtype == torch.float32 and tuple(layer["router"].shape) == (32, 4)
    assert tuple(layer["we_gate"].shape) == (4, 32, 48) and tuple(layer["we_down"].shape) == (4, 48, 32)
    drawn = T.init_params(torch.Generator().manual_seed(0), dataclasses.replace(TCFG, dtype=torch.bfloat16), "cpu")
    dl = drawn["layers"][1]
    assert set(dl) == set(layer)
    assert dl["router"].dtype == torch.float32 and dl["we_up"].dtype == torch.bfloat16
    for k in dl:
        assert dl[k].shape == layer[k].shape


@pytest.mark.parametrize("k", [1, 2, 3])
def test_router_topk_matches_jax(k):
    logits = _x((40, 6)) * 2
    jw, ji, jprobs = JM.router_topk(jnp.asarray(logits), k)
    tw, ti, tprobs = TM.router_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=1e-6)
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, atol=1e-6)


def test_router_ties_go_to_the_lowest_expert(params):
    """Duplicated router columns give exactly equal logits: both packages
    take the lower expert first, through the router's own matmul."""
    jp, tp = params
    router = np.asarray(jp["layers"][0]["router"]).copy()
    router[:, 2] = router[:, 0]
    router[:, 3] = router[:, 1]
    x = _x((16, 32), seed=3)
    jl = jnp.asarray(x) @ jnp.asarray(router)
    tl = torch.from_numpy(x) @ torch.from_numpy(router)
    assert (tl[:, 2] == tl[:, 0]).all() and (tl[:, 3] == tl[:, 1]).all()
    for k in (1, 2, 3):
        _, ji, _ = JM.router_topk(jl, k)
        _, ti, _ = TM.router_topk(tl, k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _, ti, _ = TM.router_topk(tl, 2)
    # The top two are one duplicated pair: lowest id first.
    lo = torch.where(tl[:, 0] >= tl[:, 1], 0, 1)
    assert (ti[:, 0] == lo).all() and (ti[:, 1] == lo + 2).all()
    # Through moe_mlp: the tied layer's outputs agree too.
    jl0 = dict(jp["layers"][0], router=jnp.asarray(router))
    tl0 = dict(tp["layers"][0], router=torch.from_numpy(router))
    xs = _x((2, 8, 32), seed=4)
    np.testing.assert_allclose(
        TM.moe_mlp(torch.from_numpy(xs), tl0, TCFG).numpy(),
        np.asarray(JM.moe_mlp(jnp.asarray(xs), jl0, JCFG)), atol=1e-5,
    )


@pytest.mark.parametrize("n_tokens,factor", [(1, 0.0), (64, 0.0), (8, 0.3), (64, 0.3), (64, 1.25), (3, 0.1)])
def test_expert_capacity_matches_jax(n_tokens, factor):
    jcfg = dataclasses.replace(JCFG, expert_capacity_factor=factor)
    tcfg = dataclasses.replace(TCFG, expert_capacity_factor=factor)
    assert TM.expert_capacity(n_tokens, tcfg) == JM.expert_capacity(n_tokens, jcfg)


def _jax_keep(idx: np.ndarray, cap: int, e: int) -> np.ndarray:
    """Which (token, choice) assignments the JAX dispatch keeps, in flat
    order: position priority within each expert (``moe.py:84-98``)."""
    e_flat = idx.reshape(-1)
    order = np.argsort(e_flat, kind="stable")
    counts = np.bincount(e_flat, minlength=e)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(e_flat.size) - starts[e_flat[order]]
    keep = np.zeros(e_flat.size, bool)
    keep[order] = pos < cap
    return keep


@pytest.mark.parametrize("factor", [0.0, 0.3])
@pytest.mark.parametrize("shape", [(1, 1), (2, 5), (8, 1), (1, 64)])
def test_moe_mlp_matches_jax(params, factor, shape):
    jp, tp = params
    jcfg = dataclasses.replace(JCFG, expert_capacity_factor=factor)
    tcfg = dataclasses.replace(TCFG, expert_capacity_factor=factor)
    x = _x((*shape, 32), seed=shape[1])
    for li in range(2):
        want = np.asarray(JM.moe_mlp(jnp.asarray(x), jp["layers"][li], jcfg))
        got = TM.moe_mlp(torch.from_numpy(x), tp["layers"][li], tcfg)
        assert got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, err_msg=f"layer {li}")
    # The dispatch plan: the same assignments kept as the JAX rule.
    t = shape[0] * shape[1]
    logits = torch.from_numpy(x.reshape(t, 32)) @ tp["layers"][0]["router"]
    _, idx, _ = TM.router_topk(logits, 2)
    cap = TM.expert_capacity(t, tcfg)
    order, tok_sorted, slot, keep = TM.dispatch_slots(idx, cap, 4)
    flat_keep = torch.empty_like(keep).index_copy_(0, order, keep)
    np.testing.assert_array_equal(flat_keep.numpy(), _jax_keep(idx.numpy(), cap, 4))
    assert (tok_sorted == order // 2).all()
    kept = slot[keep]
    assert len(set(kept.tolist())) == len(kept) and (kept < 4 * cap).all() and (slot[~keep] == 4 * cap).all()
    if factor and t >= 8:
        assert not flat_keep.all()  # this case drops something


def test_dropped_tokens_give_zero_rows_in_both(params):
    jp, tp = params
    jcfg = dataclasses.replace(JCFG, expert_capacity_factor=0.3)
    tcfg = dataclasses.replace(TCFG, expert_capacity_factor=0.3)
    x = _x((1, 64, 32), seed=9)
    want = np.asarray(JM.moe_mlp(jnp.asarray(x), jp["layers"][0], jcfg))[0]
    got = TM.moe_mlp(torch.from_numpy(x), tp["layers"][0], tcfg).numpy()[0]
    zero_j, zero_t = ~want.any(-1), ~got.any(-1)
    assert zero_t.any()  # some token lost both of its assignments
    np.testing.assert_array_equal(zero_t, zero_j)


def test_mlp_block_routes_moe_layers(params):
    jp, tp = params
    x = _x((2, 3, 32), seed=5)
    np.testing.assert_allclose(
        T.mlp_block(torch.from_numpy(x), tp["layers"][1], TCFG).numpy(),
        np.asarray(J.mlp_block(jnp.asarray(x), jp["layers"][1], JCFG)), atol=1e-5,
    )


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_moe_decode_step_logits_match(params, kv_quant):
    """Left-padded prefill then three cached decode steps of a MoE model;
    last-position logits of every call within 1e-4 of JAX's."""
    jp, tp = params
    jcfg = dataclasses.replace(JCFG, kv_quant=kv_quant)
    tcfg = dataclasses.replace(TCFG, kv_quant=kv_quant)
    rng = np.random.default_rng(2)
    ml, plen = 64, 12
    toks = rng.integers(3, 259, size=(2, plen)).astype(np.int64)
    off = np.array([0, 5])
    valid = np.arange(ml)[None, :] >= off[:, None]
    jc = J.init_cache(jcfg, batch=2, max_len=ml)
    tc = T.init_cache(tcfg, batch=2, max_len=ml, device="cpu")
    jv, tv = jnp.asarray(valid), torch.from_numpy(valid)
    jo, to = jnp.asarray(off, jnp.int32), torch.from_numpy(off)
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    for step in range(4):
        jl, jc = J.decode_step(jp, jcfg, jt, jc, kv_valid=jv, pos_offset=jo, last_only=True)
        tl, tc = T.decode_step(tp, tcfg, tt, tc, kv_valid=tv, pos_offset=to, last_only=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4, err_msg=f"step {step}")
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
        jt, tt = jnp.asarray(nxt[:, None], jnp.int32), torch.from_numpy(nxt[:, None].astype(np.int64))


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_moe_greedy_tokens_match_jax(params, kv_quant):
    jp, tp = params
    jcfg = dataclasses.replace(JCFG, kv_quant=kv_quant)
    tcfg = dataclasses.replace(TCFG, kv_quant=kv_quant)
    want = JBatcher(jp, jcfg, batch_slots=2, max_len=64, chunk_steps=4).run_all(PROMPTS, max_new_tokens=10)
    cb = ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=64, chunk_steps=4)
    assert cb.run_all(PROMPTS, max_new_tokens=10) == want
    solo = [JG.generate_tokens(jp, jcfg, p, max_new_tokens=10, max_len=64) for p in PROMPTS]
    assert [TG.generate_tokens(tp, tcfg, p, max_new_tokens=10, max_len=64) for p in PROMPTS] == solo


def test_moe_runtime_generate_batch_matches_jax(params):
    jp, tp = params
    jrt = JG.LlamaRuntime(cfg=JCFG, params=jp)
    trt = TG.LlamaRuntime(cfg=TCFG, params=tp, device="cpu")
    try:
        prompts = ["hello world", "the quick brown fox", "x"]
        want = [r.text for r in jrt.generate_batch(prompts, max_tokens=12)]
        got = trt.generate_batch(prompts, max_tokens=12)
        assert [r.text for r in got] == want and all(r.meta["continuous"] for r in got)
    finally:
        jrt.retire()
        trt.close()


# Mixtral-8x7B-v0.1's published config.json (mistralai/Mixtral-8x7B-v0.1 on
# the Hugging Face Hub), written out here: nothing is downloaded.
MIXTRAL_CONFIG_JSON = {
    "architectures": ["MixtralForCausalLM"],
    "attention_dropout": 0.0,
    "bos_token_id": 1,
    "eos_token_id": 2,
    "hidden_act": "silu",
    "hidden_size": 4096,
    "initializer_range": 0.02,
    "intermediate_size": 14336,
    "max_position_embeddings": 32768,
    "model_type": "mixtral",
    "num_attention_heads": 32,
    "num_experts_per_tok": 2,
    "num_hidden_layers": 32,
    "num_key_value_heads": 8,
    "num_local_experts": 8,
    "output_router_logits": False,
    "rms_norm_eps": 1e-05,
    "rope_theta": 1000000.0,
    "router_aux_loss_coef": 0.02,
    "sliding_window": None,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
    "use_cache": True,
    "vocab_size": 32000,
}


def test_chip_smoke_mixtral_config_equals_hf_config_to_llama():
    """Every field of the port's LlamaConfig that phase 9 builds equals the
    JAX package's mapping of the published config.json."""
    want = hf_config_to_llama(MIXTRAL_CONFIG_JSON)
    got = T.LlamaConfig(**chip_smoke.MIXTRAL_8X7B)
    dtypes = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    for f in dataclasses.fields(T.LlamaConfig):
        g = getattr(got, f.name)
        if f.name == "dtype":
            g = dtypes[g]
        assert g == getattr(want, f.name), f.name
    assert got.head_dim == want.head_dim == 128
    assert (got.n_experts, got.n_experts_per_tok, got.expert_capacity_factor) == (8, 2, 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
def test_moe_mlp_matches_the_per_token_oracle(params, dtype, quant):
    """The oracle that the card's run holds moe_mlp to, here on the CPU: the
    same experts, and each output row within 1e-5 in f32, or within two bf16
    steps of its largest oracle value (2^-6 of it) in bf16."""
    from kakveda_tpu_torch.models.quant import quantize_params_int8

    _, tp = params
    layer = tp["layers"][0]
    if dtype != torch.float32:
        layer = {k: v if k.endswith("norm") or k == "router" else v.to(dtype) for k, v in layer.items()}
    if quant:
        layer = quantize_params_int8({"embed": None, "final_norm": None, "lm_head": layer["wq"],
                                      "layers": [layer]})["layers"][0]
    x = torch.from_numpy(_x((1, 64, 32), seed=11)).to(dtype)
    got = TM.moe_mlp(x, layer, TCFG)
    want, experts = TM.moe_mlp_reference(x, layer, TCFG)
    _, idx, _ = TM.router_topk(x.reshape(64, 32).float() @ layer["router"], 2)
    assert torch.equal(idx, experts)
    diff = (got.float() - want.float()).abs()[0]
    if dtype == torch.float32:
        assert diff.max().item() < 1e-5
    else:
        bound = 2.0**-6 * want.float()[0].abs().amax(dim=-1, keepdim=True)
        assert (diff <= bound).all(), (diff / bound).max().item()
