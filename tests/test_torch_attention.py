"""The port's cached attention against the JAX package on the CPU.

``flash_gqa_cache_reference`` (the plain version of the CUDA kernel, and the
CPU path of ``flash_gqa_cache``) is held to the Pallas kernel run in
interpret mode at ``q_blk=8, l_blk=16``, on the same numpy inputs: bf16 and
int8 caches, decode (S = 1, S·R padded), prefill at ``pos0 > 0``, left-pad
``kv_valid``, rows and slots that see nothing (zeros in both), a sliding
window, and caches of several L blocks. Tolerances: 1e-5 in f32 (sums in
another order), 2e-2 in bf16 (one bf16 step of |out| ≲ 3 is ≤ 1.6e-2; the
tile schedules differ, so a probability may round the other way).
``gqa_grouped`` is held to ``_gqa_xla`` at 1e-5, and the plain version to
``gqa_grouped`` on a ragged cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kakveda_tpu.models.attention import _gqa_xla, flash_gqa_cache as jax_flash
from kakveda_tpu.models.llama import _kv_quant_rows as jax_quant
from kakveda_tpu_torch.models import attention as port

torch.set_num_threads(2)

TOL = {"f32": 1e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}

CASES = [
    # (B, S, H, KV, L, D, pos0, valid, window)
    (3, 1, 8, 2, 64, 16, 40, "leftpad", 0),  # decode: S·R = 4 pads to 8
    (2, 8, 4, 2, 64, 16, 17, None, 0),  # prefill at pos0 > 0, 4 L blocks
    (2, 8, 4, 2, 32, 16, 0, "leftpad", 0),  # left pad: early rows see nothing
    (4, 1, 8, 4, 48, 32, 48, "slots", 0),  # serving decode regime, slot 0 empty
    (2, 8, 4, 2, 64, 16, 20, None, 5),  # sliding window
    (2, 4, 8, 1, 32, 16, 3, None, 0),  # MQA: R = 8
]


def _inputs(b, s, h, kv, l, d, valid, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, l, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, l, d)).astype(np.float32)
    kv_valid = None
    ar = np.arange(l)[None, :]
    if valid == "leftpad":
        kv_valid = ar >= rng.integers(0, 4, size=(b, 1))
    elif valid == "slots":
        kv_valid = (ar >= rng.integers(0, l // 2, size=(b, 1))) & (ar < rng.integers(l // 2, l + 1, size=(b, 1)))
        kv_valid[0] = False
    return q, k, v, kv_valid


def _np(x):
    return torch.from_numpy(np.array(x))  # a writable copy of a JAX array


def _t(x, dt=None):
    t = torch.from_numpy(np.asarray(x, dtype=np.float32) if x.dtype != bool else np.asarray(x))
    return t.to(dt) if dt is not None else t


@pytest.mark.parametrize("kv8", [False, True], ids=["float_cache", "int8_cache"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,kv,l,d,pos0,valid,window", CASES)
def test_reference_matches_pallas_interpret(b, s, h, kv, l, d, pos0, valid, window, dtype, kv8):
    q, k, v, kv_valid = _inputs(b, s, h, kv, l, d, valid, seed=b * 7 + s + l)
    jdt, tdt = JDT[dtype], TDT[dtype]
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    jvalid = None if kv_valid is None else jnp.asarray(kv_valid)
    tvalid = None if kv_valid is None else torch.from_numpy(kv_valid)
    if kv8:
        k8, ks = jax_quant(jk)
        v8, vs = jax_quant(jv)
        want = jax_flash(jq, k8, v8, jnp.asarray(pos0), jvalid, k_scale=ks, v_scale=vs,
                         q_blk=8, l_blk=16, window=window, interpret=True)
        got = port.flash_gqa_cache(
            _t(q, tdt), _np(k8), _np(v8), pos0, tvalid,
            k_scale=_np(ks), v_scale=_np(vs), window=window,
        )
    else:
        want = jax_flash(jq, jk, jv, jnp.asarray(pos0), jvalid, q_blk=8, l_blk=16,
                         window=window, interpret=True)
        got = port.flash_gqa_cache(_t(q, tdt), _t(k, tdt), _t(v, tdt), pos0, tvalid, window=window)
    assert got.dtype == tdt and got.shape == (b, s, h, d)
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    if kv_valid is not None:
        # Rows that see no slot are exact zeros in both (no case here
        # combines kv_valid with a window).
        q_pos = pos0 + np.arange(s)
        seen = ((q_pos[None, :, None] >= np.arange(l)[None, None, :]) & kv_valid[:, None, :]).any(-1)
        assert not got[~seen].any() and not want[~seen].any()
        if valid == "slots":
            assert not seen[0].any()


def test_reference_ragged_cache_matches_grouped():
    """L = 200 ends in a ragged 64-row tile; the plain version still equals
    the grouped path (itself held to ``_gqa_xla`` below) on every row that
    sees a slot."""
    q, k, v, kv_valid = _inputs(2, 4, 8, 2, 200, 32, "leftpad", seed=5)
    args = (_t(q), _t(k), _t(v), 150, torch.from_numpy(kv_valid))
    a = port.flash_gqa_cache_reference(*args)
    b = port.gqa_grouped(*args)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("softcap,full", [(0.0, False), (30.0, False), (0.0, True), (5.0, True)])
def test_grouped_matches_gqa_xla(softcap, full):
    b, s, h, kv, l, d = 2, 4, 8, 2, 32, 16
    q, k, v, kv_valid = _inputs(b, s, h, kv, l, d, "leftpad", seed=11)
    full_mask = None
    if full:
        rng = np.random.default_rng(3)
        full_mask = rng.random((b, s, l)) < 0.7
        full_mask[:, :, 0] = True
    want = _gqa_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(9), jnp.asarray(kv_valid),
        window=0, softcap=softcap, full_mask=None if full_mask is None else jnp.asarray(full_mask),
    )
    got = port.gqa_grouped(
        _t(q), _t(k), _t(v), 9, torch.from_numpy(kv_valid), softcap=softcap,
        full_mask=None if full_mask is None else torch.from_numpy(full_mask),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_dispatch_on_cpu():
    """Plain shapes take the flash path (its reference on the CPU), an int8
    cache included; softcap takes the grouped path over the dequantized
    cache, as in the JAX dispatch."""
    from kakveda_tpu_torch.models.llama import _kv_dequant, _kv_quant_rows

    q, k, v, _ = _inputs(2, 4, 4, 2, 32, 16, None, seed=2)
    tq, tk, tv = _t(q), _t(k), _t(v)
    assert torch.equal(
        port.gqa_cache_attention(tq, tk, tv, 3), port.flash_gqa_cache_reference(tq, tk, tv, 3, None)
    )
    k8, ks = _kv_quant_rows(tk)
    v8, vs = _kv_quant_rows(tv)
    got = port.gqa_cache_attention(tq, k8, v8, 3, None, softcap=20.0, k_scale=ks, v_scale=vs)
    want = port.gqa_grouped(tq, _kv_dequant(k8, ks, tq.dtype), _kv_dequant(v8, vs, tq.dtype), 3, None, softcap=20.0)
    assert torch.equal(got, want)


def test_cpu_wrapper_never_builds(monkeypatch):
    from kakveda_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("built on CPU"))
    before = (port.flash_gqa_cache.launches, port.flash_gqa_cache.launches_kv8)
    q, k, v, _ = _inputs(1, 1, 4, 2, 16, 16, None, seed=0)
    port.flash_gqa_cache(_t(q), _t(k), _t(v), 16, None)
    assert (port.flash_gqa_cache.launches, port.flash_gqa_cache.launches_kv8) == before


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
