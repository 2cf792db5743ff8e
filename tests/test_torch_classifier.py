"""The judge tier in the port against the JAX package: ``parse_judge_verdict``,
the stub runtime, the tiered classifier with scripted judges, the runtime
registry, and a whole ingest with the in-tree Llama as the judge — the JAX
``Platform`` and the port's on the same traces and the same model weights
(f32, carried across by ``convert.llama_params_from_jax``).
"""

import asyncio
import dataclasses
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kakveda_tpu.core.schemas import TracePayload as JTrace
from kakveda_tpu.models import generate as JG
from kakveda_tpu.models import runtime as JR
from kakveda_tpu.models.llama import LlamaConfig as JConfig, init_params as jinit
from kakveda_tpu.parallel.mesh import create_mesh
from kakveda_tpu.pipeline import classifier as JC
from kakveda_tpu.platform import Platform as JaxPlatform
from kakveda_tpu_torch.convert import llama_params_from_jax
from kakveda_tpu_torch.core.schemas import TracePayload
from kakveda_tpu_torch.models import generate as TG
from kakveda_tpu_torch.models import runtime as TR
from kakveda_tpu_torch.models.llama import LlamaConfig as TConfig
from kakveda_tpu_torch.pipeline import classifier as TC
from kakveda_tpu_torch.platform import Platform

torch.set_num_threads(2)

VERDICTS = [
    "YES", "yes.", "No", "no", "NO.", "Well, YES, clearly", "Maybe", "", "YESNO", "NOPE yes",
    "  no,  YES", "y e s", "Yes!", "YES.NO", "The answer: no.", "NO, YES", "yes,no", "nO",
    "\u00dcber YES", JR.STUB_RESPONSE,
]


@pytest.mark.parametrize("text", VERDICTS)
def test_parse_judge_verdict_matches_jax(text):
    assert TC.parse_judge_verdict(text) == JC.parse_judge_verdict(text)


def test_judge_prompt_and_stub_runtime_are_byte_identical():
    assert TC._JUDGE_PROMPT == JC._JUDGE_PROMPT
    assert TR.STUB_RESPONSE == JR.STUB_RESPONSE
    t, j = TR.StubRuntime(), JR.StubRuntime()
    a, b = t.generate("anything", model="m"), j.generate("anything", model="m")
    assert a.text == b.text and a.meta["provider"] == b.meta["provider"] == "stub"
    assert set(a.meta) == set(b.meta) and a.meta["model"] == b.meta["model"] == "m"
    assert list(t.generate_stream("x")) == list(j.generate_stream("x"))
    assert "".join(t.generate_stream("x")) == a.text
    assert TR.list_models(t) == JR.list_models(j) == ["stub"]
    assert [r.text for r in TR.generate_batch(t, ["a", "b"])] == [a.text] * 2
    assert TC.parse_judge_verdict(a.text) is None


def _pair(i, prompt, response, ts):
    kw = dict(trace_id=f"t{i}", ts=ts, app_id="a", prompt=prompt, response=response, tools=[], env={})
    return TracePayload(**kw), JTrace(**kw)


def _dumps(signals):
    out = []
    for s in signals:
        if s is None:
            out.append(None)
            continue
        d = s.model_dump(mode="json")
        d.pop("ts")
        out.append(d)
    return out


def test_tiered_classifier_llm_judge_matches_jax():
    """tests/test_pipeline.py's tiered test on both packages: the judge adds
    failures for unmarked fabrications and never overrides a rule verdict."""

    def yes_judge(Result):
        @dataclass
        class YesJudge:
            name: str = "fake"
            calls: list = field(default_factory=list)

            def generate(self, prompt, *, model=None, max_tokens=256):
                self.calls.append(prompt)
                return Result(text="YES.", meta={"provider": "fake"})

        return YesJudge()

    ts = time.time()
    citing = "Summarize this document and include citations even if not provided."
    pairs = [
        _pair(0, citing, "See references: [1] Smith 2020.", ts),
        _pair(1, citing, "As shown by Smith in his famous 2020 study, things happen.", ts),
        _pair(2, "What time is it?", "Noon.", ts),
    ]
    tj, jj = yes_judge(TR.GenerateResult), yes_judge(JR.GenerateResult)
    got = TC.TieredClassifier(runtime=tj).classify_batch([p[0] for p in pairs])
    want = JC.TieredClassifier(runtime=jj).classify_batch([p[1] for p in pairs])
    assert _dumps(got) == _dumps(want)
    assert got[0] is not None and "LLM-judged" not in got[0].root_cause
    assert got[1] is not None and "LLM-judged" in got[1].root_cause
    assert got[1].context_signature["judge"] == {"provider": "fake", "verdict": "YES"}
    assert got[2] is None
    assert tj.calls == jj.calls and len(tj.calls) == 1
    # The stub's canned reply parses to no verdict: rule-only.
    assert TC.TieredClassifier(runtime=TR.StubRuntime()).classify_batch([pairs[1][0]]) == [None]


def test_tiered_classifier_uses_batch_judging_like_jax():
    def batch_judge(Result):
        @dataclass
        class BatchJudge:
            name: str = "fake"
            batch_calls: list = field(default_factory=list)
            prefixes: list = field(default_factory=list)

            def generate(self, prompt, *, model=None, max_tokens=256):
                raise AssertionError("batch path should be used")

            def generate_batch(self, prompts, *, model=None, max_tokens=256):
                self.batch_calls.append((len(prompts), max_tokens))
                return [Result(text="YES", meta={"provider": "fake"}) for _ in prompts]

            def register_prefix(self, prefix):
                self.prefixes.append(prefix)
                raise RuntimeError("registration failures are swallowed")

        return BatchJudge()

    ts = time.time()
    pairs = [
        _pair(i, "Summarize and include citations even if not provided.", f"Unmarked fabricated study mention {i}.", ts)
        for i in range(5)
    ]
    tj, jj = batch_judge(TR.GenerateResult), batch_judge(JR.GenerateResult)
    tclf, jclf = TC.TieredClassifier(runtime=tj), JC.TieredClassifier(runtime=jj)
    for _ in range(2):
        got = tclf.classify_batch([p[0] for p in pairs])
        want = jclf.classify_batch([p[1] for p in pairs])
        assert _dumps(got) == _dumps(want) and all(s is not None for s in got)
    assert tj.batch_calls == jj.batch_calls == [(5, 4), (5, 4)]
    assert tj.prefixes == jj.prefixes == [JC._JUDGE_PROMPT.split("{prompt}")[0]]


def test_get_runtime_names_cache_and_device(monkeypatch):
    TR.clear_runtimes()
    try:
        monkeypatch.delenv("KAKVEDA_MODEL_RUNTIME", raising=False)
        stub = TR.get_runtime()
        assert isinstance(stub, TR.StubRuntime) and TR.get_runtime("stub") is stub
        monkeypatch.setenv("KAKVEDA_MODEL_RUNTIME", "ollama")
        oll = TR.get_runtime()
        assert isinstance(oll, TR.OllamaRuntime) and oll is TR.get_runtime("OLLAMA")
        with pytest.raises(ValueError, match="unknown model runtime"):
            TR.get_runtime("vllm")
        # torch (and tpu, the JAX package's value) build the in-tree Llama
        # on the named device, one per (name, device).
        tiny = TR.get_runtime("torch", device="cpu")
        assert isinstance(tiny, TG.LlamaRuntime) and tiny.device.type == "cpu"
        assert TR.get_runtime("tpu", device="cpu") is tiny
        assert tiny.cfg == TG.LlamaRuntime.from_env(device="cpu").cfg
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TR.get_runtime("torch")
        # KAKVEDA_HF_CKPTS builds the multi-checkpoint router, lazily: no
        # checkpoint is read until a model is asked for (as in the reference;
        # tests/test_torch_multimodel.py serves through it).
        monkeypatch.setenv("KAKVEDA_HF_CKPTS", "/nowhere/a:/nowhere/b")
        TR.clear_runtimes()  # one runtime per (name, device): forget the tiny one
        multi = TR.get_runtime("tpu", device="cpu")
        assert isinstance(multi, TR.MultiModelRuntime) and multi.list_models() == ["a", "b"]
        assert not multi._loaded and TR.get_runtime("torch", device="cpu") is multi
        with pytest.raises(TR.UnknownModelError, match="available"):
            multi.generate("x", model="c")
    finally:
        TR.clear_runtimes()


def test_card_runtime_refuses_an_unported_head_dim_at_construction(monkeypatch):
    """The card's attention kernel takes head_dim 32, 64, 96, 128 or 256 and
    bf16 models: a runtime on the card with head_dim 16, or with an f32
    model, raises when it is built, so KAKVEDA_CLASSIFIER=tiered fails at
    start-up, not at the first ambiguous trace of an ingest. Nothing reaches
    the card: the check comes first. (The tiny preset's head_dim 32 is
    served there; ``tests/test_torch_cuda.py`` builds it on the card.)"""
    TR.clear_runtimes()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("KAKVEDA_LLAMA_PRESET", raising=False)
    try:
        with pytest.raises(ValueError, match="head_dim 32, 64, 96, 128 or 256; head_dim=16"):
            TG.LlamaRuntime(cfg=TConfig(d_model=64, n_heads=4, n_kv_heads=2), device="cuda")
        with pytest.raises(ValueError, match="the card serves bf16 models"):
            TG.LlamaRuntime(cfg=TConfig(dtype=torch.float32), device="cuda")
        assert not TR._RUNTIMES
    finally:
        TR.clear_runtimes()


def test_ollama_runtime_falls_back_to_the_stub_like_jax():
    # Port 9 on localhost refuses at once: both runtimes answer with the stub.
    t = TR.OllamaRuntime(url="http://127.0.0.1:9", timeout=0.5)
    j = JR.OllamaRuntime(url="http://127.0.0.1:9", timeout=0.5)
    a, b = t.generate("p"), j.generate("p")
    assert a.text == b.text == JR.STUB_RESPONSE
    assert a.meta["error"].split(":")[0] == b.meta["error"].split(":")[0]
    assert t.list_models() == j.list_models() == ["llama3"]


# --- the in-tree Llama as the judge ------------------------------------------

JCFG = JConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=2048, dtype=jnp.float32,
)
TCFG = TConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=2048, dtype=torch.float32,
)


def yes_saying_weights():
    """Random tiny Llama weights (JAX init, seed 5) made to answer "YES."
    after any prompt that ends in '.': the residual stream is the last
    token's embedding (attention and MLP outputs scaled near zero), and the
    embeddings of '.', 'Y', 'E', 'S' are basis vectors that the LM head maps
    to 'Y', 'E', 'S', '.'. A judge that says YES exercises the judged
    branch through both packages' real decode paths."""
    p = jax.tree.map(np.array, jinit(jax.random.PRNGKey(5), JCFG))
    tok = lambda ch: ord(ch) + 3  # noqa: E731 — ByteTokenizer ids
    for i, (src, dst) in enumerate(zip(".YES", "YES.")):
        p["embed"][tok(src)] = 0.0
        p["embed"][tok(src), i] = 8.0
        p["lm_head"][:, tok(dst)] = 0.0
        p["lm_head"][i, tok(dst)] = 10.0
    for layer in p["layers"]:
        layer["wo"] *= 1e-3
        layer["w_down"] *= 1e-3
    return p


def _traces(Trace, seed=11, n=24):
    """One seeded batch: rule-positive, benign and ambiguous traces (a
    citation-asking prompt, a response without a marker), prompt + response
    over 40–390 bytes, so that judge prompts land in three buckets and
    three of the eight reuse the judge head at window 2048."""
    rng = np.random.default_rng(seed)
    ts = datetime(2026, 1, 2, 3, 4, 5, tzinfo=timezone.utc)
    asks = ["Summarize report {} and include citations.", "Explain paper {} with references.",
            "Write a brief on topic {} and cite sources."]
    out = []
    for i in range(n):
        kind = i % 3
        words = " ".join(f"w{int(x)}" for x in rng.integers(0, 1000, size=int(rng.integers(1, 70))))
        if kind == 0:
            prompt, response = asks[i % 3].format(i), "See [1] Smith 2020. " + words
        elif kind == 1:
            prompt, response = f"What time is it in city {i}?", words
        else:
            prompt, response = asks[(i // 3) % 3].format(i), "As Smith showed, " + words
        out.append(Trace(trace_id=f"t-{i:03d}", ts=ts, app_id=f"app-{i % 2}", agent_id="agent-1",
                         prompt=prompt, response=response, model="m", temperature=0.2,
                         tools=[], env={"os": "linux"}))
    return out


def _records(plat):
    out = []
    for f in plat.failures():
        d = f.model_dump(mode="json")
        for k in ("created_at", "updated_at"):
            d.pop(k)
        judge = d["context_signature"].get("judge")
        if judge is not None:
            # The runtime names itself: "tpu" in the JAX package, "torch" in
            # the port. The only field the two may differ in.
            assert judge["provider"] == ("tpu" if isinstance(plat, JaxPlatform) else "torch")
            judge["provider"] = "llama"
        out.append(d)
    return out


@pytest.mark.parametrize("window", ["512", "2048"])
def test_platform_with_llama_judge_matches_jax(tmp_path, monkeypatch, window):
    """The whole ingest with the in-tree Llama as judge: at window 512 every
    judge prompt takes the solo DecodeSession path, at 2048 the engine with
    the judge head registered as a prefix. Failures, patterns and health
    equal the JAX Platform's on the same traces and weights."""
    monkeypatch.setenv("KAKVEDA_SERVE_WINDOW", window)
    monkeypatch.setenv("KAKVEDA_PREFILL_CHUNK", "128")
    jp = yes_saying_weights()
    jrt = JG.LlamaRuntime(cfg=JCFG, params=jax.tree.map(jnp.asarray, jp))
    trt = TG.LlamaRuntime(cfg=TCFG, params=llama_params_from_jax(jp, TCFG, "cpu"), device="cpu")
    jplat = JaxPlatform(data_dir=tmp_path / "jax", mesh=create_mesh("data:1"), capacity=256, dim=1024,
                        classifier=JC.TieredClassifier(runtime=jrt))
    port = Platform(data_dir=tmp_path / "port", device="cpu", capacity=256, dim=1024,
                    classifier=TC.TieredClassifier(runtime=trt))
    try:
        jsig = asyncio.run(jplat.ingest_batch(_traces(JTrace)))
        tsig = asyncio.run(port.ingest_batch(_traces(TracePayload)))
        judged = [s for s in tsig if "LLM-judged" in (s.root_cause or "")]
        assert len(tsig) == len(jsig) == 16 and len(judged) == 8
        assert all(s.context_signature["judge"] == {"provider": "torch", "verdict": "YES"} for s in judged)
        assert _records(port) == _records(jplat)
        assert [p.model_dump(exclude={"created_at"}) for p in port.patterns_list()] == [
            p.model_dump(exclude={"created_at"}) for p in jplat.patterns_list()
        ]
        for app in ("app-0", "app-1"):
            jh, ph = jplat.health_history(app), port.health_history(app)
            assert len(jh) == len(ph) > 0
            for a, b in zip(jh, ph):
                for key in ("score", "failure_rate", "recurrent_penalty", "avg_recovery_time_sec"):
                    assert b[key] == pytest.approx(a[key], abs=1e-9)
        stats = trt._engine.cb.prefix_stats
        assert stats == jrt._engine.cb.prefix_stats
        if window == "512":
            # The judge head registers (one prefill) and is never used: no
            # judge prompt fits the engine, in the JAX package too.
            assert trt._engine.cb.forwards == 1
            assert stats == {"registered": 1, "hits": 0, "hit_tokens_saved": 0}
        else:
            # The batch's common head is the judge head (69 tokens with BOS),
            # so registered stays 1; a prompt of p tokens reuses it when
            # p - sw > 0, sw the power of two (floor 8) >= p - 69.
            judged_ids = {s.trace_id for s in judged}
            ps = [len(trt.tokenizer.encode(TC._JUDGE_PROMPT.format(prompt=t.prompt, response=t.response)))
                  for t in _traces(TracePayload) if t.trace_id in judged_ids]
            sws = [max(8, 1 << max(0, p - 70).bit_length()) for p in ps]
            hits = [(p, p - sw) for p, sw in zip(ps, sws) if p - sw > 0]
            assert len(hits) == 3
            assert stats == {"registered": 1, "hits": 3, "hit_tokens_saved": sum(h for _, h in hits)}
    finally:
        port.close()
        jplat.gfkb.close()
        trt.close()
        jrt.retire()


def test_platform_selects_the_tier_from_the_environment(tmp_path, monkeypatch):
    TR.clear_runtimes()
    try:
        monkeypatch.delenv("KAKVEDA_CLASSIFIER", raising=False)
        plat = Platform(data_dir=tmp_path / "a", device="cpu", capacity=16, dim=64)
        assert isinstance(plat.classifier, TC.RuleClassifier)
        plat.close()
        monkeypatch.setenv("KAKVEDA_CLASSIFIER", "tiered")
        monkeypatch.setenv("KAKVEDA_MODEL_RUNTIME", "torch")
        plat = Platform(data_dir=tmp_path / "b", device="cpu", capacity=16, dim=64)
        rt = plat.classifier.runtime
        assert isinstance(plat.classifier, TC.TieredClassifier) and isinstance(rt, TG.LlamaRuntime)
        assert rt.device == plat.device and rt is TR.get_runtime(device="cpu")
        plat.close()
    finally:
        TR.clear_runtimes()


def test_service_tiered_with_stub_equals_rule_only(tmp_path, monkeypatch):
    """KAKVEDA_CLASSIFIER=tiered over the stub runtime through make_app: the
    stub's reply carries no verdict, so the service records what the rule
    tier alone records."""
    from aiohttp.test_utils import TestClient, TestServer

    from kakveda_tpu_torch.service.app import make_app

    TR.clear_runtimes()
    monkeypatch.setenv("KAKVEDA_MODEL_RUNTIME", "stub")
    body = {"traces": [t.model_dump(mode="json") for t in _traces(TracePayload)]}

    async def run(app):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/ingest/batch", json=body)
            assert r.status == 200
            return await r.json(), (await (await client.get("/failures")).json())["failures"]
        finally:
            await client.close()

    states = []
    for tier in ("rule", "tiered"):
        monkeypatch.setenv("KAKVEDA_CLASSIFIER", tier)
        plat = Platform(data_dir=tmp_path / tier, device="cpu", capacity=256, dim=1024)
        want = TC.TieredClassifier if tier == "tiered" else TC.RuleClassifier
        assert isinstance(plat.classifier, want)
        ingest, failures = asyncio.run(run(make_app(plat)))
        states.append((ingest, [(f["failure_type"], f["signature_text"], f["occurrences"], f["root_cause"])
                                for f in failures]))
        plat.close()
    TR.clear_runtimes()
    assert states[0] == states[1] and states[0][0]["failures"] == 8 and len(states[0][1]) == 8
