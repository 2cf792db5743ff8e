"""Streaming, cancel and nucleus sampling in the port's serving path,
against the JAX package on the same weights.

Twins of the engine and runtime tests of ``tests/test_streaming.py``
(chunk callbacks, the loop-thread callback, cancel mid-decode and while
queued, a stream cancelled before its first token, the randomized
submit/cancel stress with ``spec_k`` 0, and ``generate_stream`` joined to
``generate`` on both paths), then the top-p kept set against the JAX
``_sample_top_p``'s. Greedy tokens are held to the JAX package's solo
``generate_tokens`` (a cancelled request's partial tokens to a prefix of
them), streams to the blocking text; outcomes, never timings: where the
reference sleeps to let a request queue up, these wait for the engine's
own state.
"""

import random
import threading
import time
from concurrent.futures import CancelledError

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kakveda_tpu.models import generate as JG
from kakveda_tpu.models.llama import LlamaConfig as JConfig, init_params as jinit
from kakveda_tpu.models.serving import ContinuousBatcher as JBatcher
from kakveda_tpu_torch.convert import llama_params_from_jax
from kakveda_tpu_torch.models import generate as TG
from kakveda_tpu_torch.models.llama import LlamaConfig as TConfig
from kakveda_tpu_torch.models.serving import ContinuousBatcher, ServingEngine

torch.set_num_threads(2)

JCFG = JConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=128, dtype=jnp.float32,
)
TCFG = TConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=128, dtype=torch.float32,
)


@pytest.fixture(scope="module")
def weights():
    jp = jinit(jax.random.PRNGKey(0), JCFG)
    return jp, llama_params_from_jax(jax.tree.map(np.asarray, jp), TCFG, "cpu")


def _solo(jp, prompt, n, max_len=64, eos_id=None):
    return JG.generate_tokens(jp, JCFG, prompt, max_new_tokens=n, max_len=max_len, eos_id=eos_id)


def _wait_for(cond, timeout=60.0):
    t = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > t:
            raise AssertionError("the engine never reached the awaited state")
        time.sleep(0.01)


def test_batcher_on_tokens_streams_exact_results(weights):
    """Chunk callbacks deliver exactly the result's tokens, in order, with
    done=True on the last chunk only; the streams equal the JAX batcher's."""
    jp, tp = weights
    prompts = [[5, 6, 7], [10, 11, 12, 13]]
    out = {}
    for name, mk, params, cfg in (("port", ContinuousBatcher, tp, TCFG), ("jax", JBatcher, jp, JCFG)):
        streamed, flags = {0: [], 1: []}, {0: [], 1: []}
        cb = mk(params, cfg, batch_slots=2, max_len=64, chunk_steps=4)
        rids = [
            cb.admit(
                p, max_new_tokens=10,
                on_tokens=(lambda i: lambda new, done: (streamed[i].extend(new), flags[i].append(done)))(i),
            )
            for i, p in enumerate(prompts)
        ]
        while cb.active:
            cb.step()
        for i, rid in enumerate(rids):
            assert streamed[i] == cb.results[rid]
            assert flags[i][-1] is True and all(f is False for f in flags[i][:-1])
        out[name] = streamed
    assert out["port"] == out["jax"]


def test_engine_stream_callback_runs_on_loop(weights):
    jp, tp = weights
    got, threads = [], set()
    eng = ServingEngine(tp, TCFG, batch_slots=2, max_len=64, chunk_steps=4)
    try:
        fut = eng.submit([5, 6, 7], 8, on_tokens=lambda new, done: (got.extend(new), threads.add(threading.get_ident())))
        result = fut.result(timeout=120)
        assert got == result == _solo(jp, [5, 6, 7], 8)
        assert threads == {eng._thread.ident}
    finally:
        eng.close()


def test_engine_cancel_frees_slot_midflight(weights):
    """cancel() on a request mid-decode resolves its Future to its partial
    tokens (a prefix of the solo tokens), counts one ``cancelled``, and the
    freed slot serves the next request with solo parity."""
    jp, tp = weights
    eng = ServingEngine(tp, TCFG, batch_slots=1, max_len=64, chunk_steps=2)
    try:
        first = threading.Event()
        release = threading.Event()

        def hold(new, done):  # holds the loop after the first chunk, so the cancel lands mid-decode
            if new and not first.is_set():
                first.set()
                release.wait(60)

        fut = eng.submit([5, 6, 7], 40, on_tokens=hold)
        assert first.wait(60)
        eng.cancel(fut)
        release.set()
        partial = fut.result(timeout=60)
        assert 0 < len(partial) < 40
        assert partial == _solo(jp, [5, 6, 7], 40)[: len(partial)]
        assert eng.generate_ids([9, 8, 7], 10) == _solo(jp, [9, 8, 7], 10)
        assert [e["kind"] for e in eng.recorder.dump()].count("cancel") == 1
        _wait_for(lambda: not eng.cb.slots and len(eng.cb.free) == 1)
    finally:
        eng.close()


def test_engine_cancel_queued_request(weights):
    """A request still waiting for a slot cancels outright and is never
    admitted; the running one completes with solo parity."""
    jp, tp = weights
    eng = ServingEngine(tp, TCFG, batch_slots=1, max_len=64, chunk_steps=2)
    try:
        release = threading.Event()
        first = eng.submit([5, 6, 7], 30, on_tokens=lambda new, done: release.wait(60))
        waiting = eng.submit([1, 2, 3], 30)
        eng.cancel(waiting)
        release.set()
        with pytest.raises(CancelledError):
            waiting.result(timeout=60)
        assert first.result(timeout=120) == _solo(jp, [5, 6, 7], 30)
        assert eng.stats()["completed"] == 1
    finally:
        eng.close()


def test_generate_stream_cancel_before_first_token(weights, monkeypatch):
    """A stream still waiting for a slot (the pool full, no delta yet)
    cancels when the consumer sets the cancel event, without waiting for a
    first token; the slot's owner is unaffected."""
    jp, tp = weights
    monkeypatch.setenv("KAKVEDA_SERVE_CONTINUOUS", "1")
    monkeypatch.setenv("KAKVEDA_SERVE_SLOTS", "1")
    rt = TG.LlamaRuntime(cfg=TCFG, params=tp, device="cpu")
    try:
        eng = rt.engine()
        release = threading.Event()
        blocker = eng.submit([5, 6, 7], 40, on_tokens=lambda new, done: release.wait(60))
        cancel_ev = threading.Event()
        got: list = []

        def consume():
            for d in rt.generate_stream("queued then abandoned", max_tokens=10, cancel=cancel_ev):
                got.append(d)

        t = threading.Thread(target=consume)
        t.start()
        _wait_for(lambda: eng.stats()["submitted"] == 2)  # queued behind the blocker
        cancel_ev.set()
        t.join(timeout=30)
        assert not t.is_alive(), "stream consumer still blocked after cancel"
        assert got == []
        release.set()
        assert blocker.result(timeout=120) == _solo(jp, [5, 6, 7], 40, max_len=128, eos_id=rt.tokenizer.EOS)
        assert eng.stats()["completed"] == 1
    finally:
        rt.retire()


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_randomized_submit_cancel_stress(weights, seed):
    """Random submits and cancels against the live engine: every Future
    resolves (a result or CancelledError), every result is a prefix of the
    JAX solo tokens (equal unless cancelled mid-decode), and the pool
    drains."""
    jp, tp = weights
    rng = random.Random(seed)
    eng = ServingEngine(tp, TCFG, batch_slots=2, max_len=64, chunk_steps=2)
    futs = []
    try:
        for _ in range(24):
            if rng.random() < 0.7 or not futs:
                prompt = [rng.randrange(5, 250) for _ in range(rng.randrange(1, 9))]
                n = rng.randrange(4, 24)
                futs.append((prompt, n, eng.submit(prompt, n)))
            else:
                eng.cancel(rng.choice(futs)[2])
            if rng.random() < 0.3:
                time.sleep(0.05)
        results = cancelled = 0
        for prompt, n, f in futs:
            try:
                toks = f.result(timeout=300)
            except CancelledError:
                cancelled += 1
                continue
            results += 1
            want = _solo(jp, prompt, n)
            assert toks == want[: len(toks)]
        assert results + cancelled == len(futs)
        _wait_for(lambda: len(eng.cb.free) == eng.cb.B and not eng.cb.slots)
    finally:
        eng.close()


@pytest.mark.parametrize("continuous", ["1", "0"])
def test_runtime_generate_stream_matches_generate(weights, monkeypatch, continuous):
    """Joined deltas equal the blocking text on both paths (the engine's
    stream and the solo chunked fallback), and the JAX runtime's text."""
    jp, tp = weights
    monkeypatch.setenv("KAKVEDA_SERVE_CONTINUOUS", continuous)
    rt = TG.LlamaRuntime(cfg=TCFG, params=tp, device="cpu")
    jrt = JG.LlamaRuntime(cfg=JCFG, params=jp)
    try:
        prompt = "stream parity check"
        r = rt.generate(prompt, max_tokens=12)
        blocking = r.text
        parts = list(rt.generate_stream(prompt, max_tokens=12))
        assert len(parts) >= 1
        assert "".join(parts) == blocking == jrt.generate(prompt, max_tokens=12).text
        if continuous == "1":
            assert r.meta["serve"]["tokens"] == r.meta["tokens_generated"]
            st = rt.serving_stats()["engine"]
            assert st["completed"] == 2 and st["slots"] == 8 and st["spec"] is None
        else:
            assert rt.serving_stats()["engine"] is None
    finally:
        rt.retire()
        jrt.retire()


def test_generate_stream_holds_back_a_partial_utf8_tail():
    """A delta never ends in half a multi-byte character: the held bytes
    come out with the delta that completes them."""
    rt = TG.LlamaRuntime(cfg=TCFG, device="cpu")
    tok = rt.tokenizer
    euro = tok.encode("€", bos=False)  # three bytes
    assert len(euro) == 3
    chunks = [[tok.encode("a", bos=False)[0], euro[0]], [euro[1]], [euro[2], tok.EOS]]

    class Eng:
        def fits(self, n, m):
            return True

        def submit(self, ids, n, on_tokens):
            from concurrent.futures import Future

            for i, c in enumerate(chunks):
                on_tokens([t for t in c if t != tok.EOS], i == len(chunks) - 1)
            fut = Future()
            fut.set_result([])
            return fut

    rt.engine = lambda: Eng()
    assert list(rt.generate_stream("x", max_tokens=8)) == ["a", "€"]


# ---------------------------------------------------------------------------
# top-p
# ---------------------------------------------------------------------------


def _jax_kept(logits: np.ndarray, temperature: float, top_p: float, monkeypatch) -> np.ndarray:
    """The JAX ``_sample_top_p``'s kept set, from its own code: its final
    categorical draw swapped for the identity returns the masked logits."""
    monkeypatch.setattr(jax.random, "categorical", lambda key, x, axis=-1: x)
    masked = JG._sample_top_p.__wrapped__(jax.random.PRNGKey(0), jnp.asarray(logits), temperature, top_p)
    return np.isfinite(np.asarray(masked))


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9, 1.0])
def test_top_p_kept_set_matches_jax(top_p, weights, monkeypatch):
    """The port's nucleus equals the JAX package's on the same logits (as
    sets, per row), and every draw falls inside it. At top_p = 1 neither
    package's ``generate_tokens`` calls its nucleus: both sample the whole
    vocabulary."""
    if top_p >= 1.0:
        jp, tp = weights

        def no_nucleus(*a, **kw):
            raise AssertionError("the nucleus was called at top_p = 1")

        monkeypatch.setattr(TG, "_sample_top_p", no_nucleus)
        monkeypatch.setattr(JG, "_sample_top_p", no_nucleus)
        got = TG.generate_tokens(tp, TCFG, [5, 6, 7], max_new_tokens=8, temperature=0.8, top_p=top_p,
                                 generator=torch.Generator().manual_seed(0), max_len=64)
        ref = JG.generate_tokens(jp, JCFG, [5, 6, 7], max_new_tokens=8, temperature=0.8, top_p=top_p,
                                 rng=jax.random.PRNGKey(3), max_len=64)
        assert len(got) == len(ref) == 8
        return
    rng = np.random.default_rng(7)
    logits = (3.0 * rng.standard_normal((6, 264))).astype(np.float32)
    for temperature in (0.7, 1.0):
        want = _jax_kept(logits, temperature, top_p, monkeypatch)
        got = TG.top_p_keep(torch.from_numpy(logits), temperature, top_p).numpy()
        assert (got == want).all()
        assert got.any(axis=-1).all()
        gen = torch.Generator().manual_seed(int(top_p * 1000))
        for _ in range(50):
            draw = TG._sample_top_p(torch.from_numpy(logits), temperature, top_p, gen).numpy()
            assert got[np.arange(len(draw)), draw].all()


def test_top_p_kept_set_at_llama3_vocabulary_differs_only_at_the_boundary(monkeypatch):
    """At Llama-3's 128,256 tokens the reference sums the sorted mass in
    f32 and the port in f64, so the two kept sets may part on the token at
    the boundary, and nowhere else: every token in one set and not the
    other has a mass before it within f32 rounding of top_p."""
    rng = np.random.default_rng(11)
    logits = (3.0 * rng.standard_normal((8, 128256))).astype(np.float32)
    for top_p in (0.5, 0.9, 0.95):
        want = _jax_kept(logits, 0.8, top_p, monkeypatch)
        got = TG.top_p_keep(torch.from_numpy(logits), 0.8, top_p).numpy()
        apart = got != want
        scaled = torch.from_numpy(logits).double() / 0.8
        srt, order = torch.sort(scaled, dim=-1, descending=True)
        p_sorted = torch.softmax(srt, dim=-1)
        mass_before = torch.empty_like(p_sorted).scatter_(-1, order, torch.cumsum(p_sorted, -1) - p_sorted).numpy()
        assert (np.abs(mass_before[apart] - top_p) < 1e-4).all(), f"top_p {top_p}: a token away from the boundary"
        assert got.sum() > 0 and want.sum() > 0


def test_tiny_top_p_is_greedy(weights):
    """At top_p = 1e-9 only the most likely token survives: sampled decode
    equals greedy, in the port and the JAX package alike."""
    jp, tp = weights
    logits = torch.from_numpy((3.0 * np.random.default_rng(1).standard_normal((4, 264))).astype(np.float32))
    keep = TG.top_p_keep(logits, 1.0, 1e-9)
    assert (keep.sum(-1) == 1).all() and (keep.float().argmax(-1) == logits.argmax(-1)).all()
    greedy = _solo(jp, [5, 6, 7], 12)
    got = TG.generate_tokens(tp, TCFG, [5, 6, 7], max_new_tokens=12, temperature=0.8, top_p=1e-9,
                             generator=torch.Generator().manual_seed(0), max_len=64)
    ref = JG.generate_tokens(jp, JCFG, [5, 6, 7], max_new_tokens=12, temperature=0.8, top_p=1e-9,
                             rng=jax.random.PRNGKey(3), max_len=64)
    assert got == ref == greedy
