"""The brownout ladder inside the port's serving engine, held to the JAX
package's on the CPU.

A tiny f32 config (the speculation tests' own), weights drawn by the JAX
package and carried across by ``convert.llama_params_from_jax``. Both
engines speculate (``KAKVEDA_SERVE_SPEC=2``, the gate held open with
``KAKVEDA_SERVE_SPEC_CALIB=0`` and ``_BREAKEVEN=0``) on both packages'
serving modules with a frozen ``perf_counter`` (every chunk wall 0 s, as
``tests/test_torch_spec.py`` runs them). The process-global ladder is held
at each step in turn: ``KAKVEDA_BROWNOUT_DWELL=0`` lets ``note_pressure``
climb one step per sample and ``KAKVEDA_BROWNOUT_EXIT=-1`` keeps the
engine's own zero-pressure samples from stepping it down.

At every step both engines must give the same tokens, the same
``spec_stats`` and the same sheds: verify chunks at step 0 only, the
plain greedy tokens from step 1, outputs cut at the cap of 32 from step 2
(a prefix of the uncapped ones), ``OverloadError(reason="brownout")`` for
the background class from step 3 and the interactive class at step 4.
Each completed request's ``serving.request`` span is parented on the
submitter's span; its attributes match with the times masked.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kakveda_tpu.core import admission as jax_adm
from kakveda_tpu.core import trace as jax_trace
from kakveda_tpu.models import serving as JS
from kakveda_tpu.models.llama import LlamaConfig as JConfig, init_params as jinit
from kakveda_tpu_torch.convert import llama_params_from_jax
from kakveda_tpu_torch.core import admission as port_adm
from kakveda_tpu_torch.core import trace as port_trace
from kakveda_tpu_torch.models import generate as TG
from kakveda_tpu_torch.models import serving as TS
from kakveda_tpu_torch.models.llama import LlamaConfig as TConfig

torch.set_num_threads(2)

KW = dict(vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128)
JCFG, TCFG = JConfig(**KW, dtype=jnp.float32), TConfig(**KW, dtype=torch.float32)
LOOP = [7, 8, 9, 7, 8, 9, 7, 8, 9]
OTHER = [10, 11, 12, 13, 14]
MASKED = ("queue_wait_ms", "prefill_ms", "ttft_ms")


class _FrozenClock:
    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def perf_counter():
        return 0.0


@pytest.fixture(scope="module")
def weights():
    jp = jinit(jax.random.PRNGKey(2), JCFG)
    return jp, llama_params_from_jax(jax.tree.map(np.asarray, jp), TCFG, "cpu")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setattr(JS, "time", _FrozenClock())
    monkeypatch.setattr(TS, "time", _FrozenClock())
    for k, v in {"KAKVEDA_SERVE_SPEC": "2", "KAKVEDA_SERVE_SPEC_CALIB": "0", "KAKVEDA_SERVE_SPEC_BREAKEVEN": "0",
                 "KAKVEDA_BROWNOUT_DWELL": "0", "KAKVEDA_BROWNOUT_EXIT": "-1"}.items():
        monkeypatch.setenv(k, v)
    for adm, tr in ((jax_adm, jax_trace), (port_adm, port_trace)):
        adm.reset_for_tests()
        tr.get_tracer().reset()
    yield
    for adm, tr in ((jax_adm, jax_trace), (port_adm, port_trace)):
        adm.reset_for_tests()
        tr.get_tracer().reset()


def _run_at_step(pkg, step, weights):
    adm_mod, tr_mod, serving = {"jax": (jax_adm, jax_trace, JS), "port": (port_adm, port_trace, TS)}[pkg]
    params = weights[0] if pkg == "jax" else weights[1]
    cfg = JCFG if pkg == "jax" else TCFG
    b = adm_mod.get_admission().brownout
    for _ in range(step):
        b.note_pressure(1.0)
    assert b.step == step
    tracer = tr_mod.get_tracer()
    eng = serving.ServingEngine(params, cfg, batch_slots=2, max_len=128, chunk_steps=4, name=f"brown-{step}")
    out = []
    try:
        assert eng.cb.spec_k == 2
        for prompt, n, klass in ((LOOP, 40, "interactive"), (OTHER, 36, "background")):
            with tracer.start_span("caller", klass=klass) as caller:
                try:
                    toks = eng.submit(prompt, n, klass=klass).result()
                    out.append(("ok", toks))
                except adm_mod.OverloadError as e:
                    out.append(("shed", e.reason, e.klass))
            assert b.step == step
        spec = eng.stats()["spec"]
    finally:
        eng.close()
    spans = tracer.dump()
    by_id = {s["span_id"]: s for s in spans}
    served = []
    for s in spans:
        if s["name"] == "serving.request":
            parent = by_id.get(s["parent_id"])
            served.append((parent["name"] if parent else None, parent["attrs"]["klass"] if parent else None,
                           {k: v for k, v in s["attrs"].items() if k not in MASKED}, s["outcome"]))
    tracer.reset()
    adm_mod.reset_for_tests()
    return out, spec, served


@pytest.mark.parametrize("step", range(5))
def test_engine_under_each_ladder_step_matches_jax(step, weights):
    ref = _run_at_step("jax", step, weights)
    port = _run_at_step("port", step, weights)
    assert port == ref
    out, spec, served = port
    plain = [TG.generate_tokens(weights[1], TCFG, p, max_new_tokens=n, max_len=128)
             for p, n in ((LOOP, 40), (OTHER, 36))]
    if step == 0:
        assert spec["chunks"] > 0 and [o[1] for o in out] == plain
    else:
        assert spec["chunks"] == 0
    if step == 1:
        assert [o[1] for o in out] == plain
    if step == 2:
        assert [o[1] for o in out] == [t[:32] for t in plain]
    if step == 3:
        assert out[0] == ("ok", plain[0][:32]) and out[1] == ("shed", "brownout", "background")
    if step == 4:
        assert out == [("shed", "brownout", "interactive"), ("shed", "brownout", "background")]
    assert len(served) == sum(o[0] == "ok" for o in out)
    assert all(parent == "caller" for parent, *_ in served)
