"""The port's Llama blocks, cache and decode step against the JAX package.

Same weights in both (the JAX tree carried across by
``convert.llama_params_from_jax``), same numpy token ids. Tolerances: the
int8 KV quantizer is bit-identical; last-position logits of ``decode_step``
within 1e-4 in f32 (sums in another order), for the float cache, the int8
cache, a sliding window and the softcaps; rope tables within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kakveda_tpu.models import llama as J
from kakveda_tpu_torch.convert import llama_params_from_jax
from kakveda_tpu_torch.models import llama as T

torch.set_num_threads(2)

JCFG = J.LlamaConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=128, dtype=jnp.float32,
)
TCFG = T.LlamaConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=128, dtype=torch.float32,
)


@pytest.fixture(scope="module")
def params():
    jp = J.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, llama_params_from_jax(jax.tree.map(np.asarray, jp), TCFG, "cpu")


def test_presets_match():
    for name in ("head_dim", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff",
                 "vocab_size", "max_seq_len", "rope_theta", "norm_eps"):
        assert getattr(T.LlamaConfig.llama3_8b(), name) == getattr(J.LlamaConfig.llama3_8b(), name)
        assert getattr(T.LlamaConfig.tiny(), name) == getattr(J.LlamaConfig.tiny(), name)
    assert T.LlamaConfig.llama3_8b().dtype == torch.bfloat16


def test_kv_quant_rows_bit_identical():
    rows = np.random.default_rng(0).standard_normal((2, 4, 9, 16)).astype(np.float32) * 3
    rows[0, 0, 0] = 0.0  # an all-zero row: scale 0, values 0
    jq, js = J._kv_quant_rows(jnp.asarray(rows))
    tq, ts = T._kv_quant_rows(torch.from_numpy(rows))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(J._kv_dequant(jq, js, jdt), np.float32)
        np.testing.assert_array_equal(T._kv_dequant(tq, ts, tdt).float().numpy(), want)


@pytest.mark.parametrize("factor", [1.0, 8.0])
def test_rope_tables_match(factor):
    kw = dict(rope_factor=factor, rope_theta=500000.0, rope_original_max_len=64)
    jcfg, tcfg = dataclasses.replace(JCFG, **kw), dataclasses.replace(TCFG, **kw)
    pos = np.arange(0, 400, 3, dtype=np.int64)[None, :]
    jc, js = J._rope_freqs(jcfg, jnp.asarray(pos, jnp.int32))
    tc, ts = T._rope_freqs(tcfg, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_init_params_layout():
    jp = J.init_params(jax.random.PRNGKey(0), JCFG)
    cfg = dataclasses.replace(TCFG, dtype=torch.bfloat16)
    tp = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    jl, tl = jp["layers"][0], tp["layers"][0]
    assert set(jl) == set(tl) and len(tp["layers"]) == JCFG.n_layers
    for name, w in tl.items():
        assert tuple(w.shape) == jl[name].shape
        assert w.dtype == (torch.float32 if name.endswith("norm") else torch.bfloat16)
    assert tuple(tp["embed"].shape) == jp["embed"].shape and tp["final_norm"].dtype == torch.float32
    # N(0, 1) / sqrt(fan_in), as in the JAX package.
    assert abs(tp["lm_head"].float().std().item() * 8.0 - 1.0) < 0.05


def test_convert_refuses_what_the_port_does_not_run(params):
    # MoE layers and int8 {"q", "s"} leaves cross (tests/test_torch_moe.py,
    # tests/test_torch_quant.py), and so do the family flags' keys, each set
    # whole, their dtypes as the JAX tree holds them (a bf16 q/k norm from
    # the HF loader stays bf16; tests/test_torch_families.py runs them). A
    # part of a set, a router on a dense layer and other leaf pairs raise.
    jp, _ = params
    np_tree = jax.tree.map(np.asarray, jp)
    bf16 = np.asarray(jnp.ones(16, jnp.bfloat16))
    for extra in ({"bq": np.zeros(64, np.float32), "bk": np.zeros(32, np.float32), "bv": np.zeros(32, np.float32)},
                  {"q_norm": bf16, "k_norm": bf16},
                  {"post_attn_norm": np.ones(64, np.float32), "post_ffw_norm": np.ones(64, np.float32)}):
        tree = dict(np_tree, layers=[dict(np_tree["layers"][0], **extra)])
        layer = llama_params_from_jax(tree, TCFG, "cpu")["layers"][0]
        for name, a in extra.items():
            want = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
            assert layer[name].dtype == want and np.array_equal(layer[name].float().numpy(), np.asarray(a, np.float32))
    for extra in ({"bq": np.zeros(64, np.float32)}, {"q_norm": np.ones(16, np.float32)},
                  {"post_attn_norm": np.ones(64, np.float32)}, {"router": np.zeros((64, 4), np.float32)}):
        tree = dict(np_tree, layers=[dict(np_tree["layers"][0], **extra)])
        with pytest.raises(NotImplementedError):
            llama_params_from_jax(tree, TCFG, "cpu")
    quant = dict(np_tree, lm_head={"q": np.zeros((64, 264), np.int8), "zero": np.ones(264, np.float32)})
    with pytest.raises(NotImplementedError):
        llama_params_from_jax(quant, TCFG, "cpu")


def test_blocks_match(params):
    jp, tp = params
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jl, tl = jp["layers"][0], tp["layers"][0]
    np.testing.assert_allclose(
        T.rms_norm(torch.from_numpy(x), tl["attn_norm"], 1e-5).numpy(),
        np.asarray(J.rms_norm(jnp.asarray(x), jl["attn_norm"], 1e-5)), atol=1e-6,
    )
    np.testing.assert_allclose(
        T.mlp_block(torch.from_numpy(x), tl, TCFG).numpy(),
        np.asarray(J.mlp_block(jnp.asarray(x), jl, JCFG)), atol=1e-5,
    )
    jq, jk, jv = J.qkv_proj(jnp.asarray(x), jl, JCFG, jnp.float32)
    tq, tk, tv = T.qkv_proj(torch.from_numpy(x), tl, TCFG, torch.float32)
    for a, b in ((tq, jq), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


VARIANTS = {
    "plain": {},
    "int8_cache": {"kv_quant": "int8"},
    "sliding_window": {"sliding_window": 6},
    "softcaps": {"attn_softcap": 5.0, "final_softcap": 3.0},  # the grouped path on the CPU
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_step_logits_match(params, variant):
    """Left-padded prefill then three cached decode steps; last-position
    logits of every call within 1e-4 of the JAX decode_step."""
    jp, tp = params
    kw = VARIANTS[variant]
    kv_quant = kw.get("kv_quant", "")
    jcfg = dataclasses.replace(JCFG, **kw)
    tcfg = dataclasses.replace(TCFG, **kw)
    rng = np.random.default_rng(2)
    ml, plen = 64, 12
    toks = rng.integers(3, 259, size=(2, plen)).astype(np.int64)
    off = np.array([0, 5])
    valid = np.arange(ml)[None, :] >= off[:, None]
    jc = J.init_cache(jcfg, batch=2, max_len=ml)
    tc = T.init_cache(tcfg, batch=2, max_len=ml, device="cpu")
    if kv_quant:
        assert tc["k"][0].dtype == torch.int8 and tc["ks"][0].shape == (2, 2, ml)
    jv, tv = jnp.asarray(valid), torch.from_numpy(valid)
    jo, to = jnp.asarray(off, jnp.int32), torch.from_numpy(off)
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    for step in range(4):
        jl, jc = J.decode_step(jp, jcfg, jt, jc, kv_valid=jv, pos_offset=jo, last_only=True)
        tl, tc = T.decode_step(tp, tcfg, tt, tc, kv_valid=tv, pos_offset=to, last_only=True)
        assert tl.shape == (2, 1, 264) and tc["pos"] == int(jc["pos"])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4, err_msg=f"step {step}")
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
        jt, tt = jnp.asarray(nxt[:, None], jnp.int32), torch.from_numpy(nxt[:, None].astype(np.int64))
    if kv_quant:
        # Real rows only: pad rows differ from layer 1 on (a pad query sees
        # nothing: zeros here, a uniform average in the JAX CPU path). The
        # quantizer is bit-identical on equal inputs (test above), but the
        # rows it gets differ in the last f32 bits (matmuls summed in
        # another order), so a scale may move an ulp and a value one step.
        for key in ("k", "v", "ks", "vs"):
            for li in range(2):
                got, want = tc[key][li].numpy(), np.asarray(jc[key][li])
                for b in range(2):
                    g, w = got[b, :, valid[b]], want[b, :, valid[b]]
                    if key in ("ks", "vs"):
                        np.testing.assert_allclose(g, w, rtol=1e-5)
                    else:
                        assert np.abs(g.astype(np.int32) - w).max() <= 1


def test_decode_step_overrun_raises(params):
    _, tp = params
    cache = T.init_cache(TCFG, batch=1, max_len=8, device="cpu")
    with pytest.raises(ValueError):
        T.decode_step(tp, TCFG, torch.zeros((1, 9), dtype=torch.long), cache)


def test_mask_pad_vocab_and_softcap():
    cfg = dataclasses.replace(TCFG, effective_vocab=259)
    x = torch.zeros(2, 264)
    T.mask_pad_vocab(x, cfg)
    assert torch.isinf(x[:, 259:]).all() and not x[:, :259].any()
    y = np.linspace(-50, 50, 11, dtype=np.float32)
    np.testing.assert_allclose(
        T.softcap_logits(torch.from_numpy(y), 30.0).numpy(), np.asarray(J.softcap_logits(jnp.asarray(y), 30.0)),
        atol=1e-5,
    )
