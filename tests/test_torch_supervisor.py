"""The port's serving-engine supervisor, deadlines, admission sheds and
weighted-fair slot pick, against the JAX package.

Twins of ``tests/test_chaos.py``'s engine tests (a crash mid-decode
recovers with greedy parity, a registered prefix survives the rebuild, a
spent restart budget fails fast, a deadline retires cleanly) and of
``tests/test_tenants.py``'s fair-pick and tenant-plane tests (the deficit
pick, the starvation bound, FIFO for tenant-blind traffic, the bounded
served table, the micro-batcher's tenant-aware bound, and
``KAKVEDA_TENANT_FAIR=0``), each run through both packages on the same
inputs. Then what the port's pipelined loop adds: a chunk already enqueued
when its slot is cancelled and at once admitted again never reaches the
slot's next occupant.
"""

import asyncio
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kakveda_tpu.core import admission as jax_adm
from kakveda_tpu.core import faults as jax_faults
from kakveda_tpu.models import generate as JG
from kakveda_tpu.models.llama import LlamaConfig as JConfig, init_params as jinit
from kakveda_tpu.models.serving import ServingEngine as JEngine
from kakveda_tpu.service.batcher import MicroBatcher as JMicroBatcher
from kakveda_tpu_torch.convert import llama_params_from_jax
from kakveda_tpu_torch.core import admission as adm_mod
from kakveda_tpu_torch.core import faults
from kakveda_tpu_torch.core.admission import AdmissionController, OverloadError
from kakveda_tpu_torch.models.llama import LlamaConfig as TConfig
from kakveda_tpu_torch.models.serving import (
    ContinuousBatcher,
    DeadlineExceededError,
    EngineDeadError,
    EngineRetryableError,
    ServingEngine,
)
from kakveda_tpu_torch.service.batcher import MicroBatcher

pytestmark = pytest.mark.chaos

torch.set_num_threads(2)

JCFG = JConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=128, dtype=jnp.float32,
)
TCFG = TConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=128, dtype=torch.float32,
)


@pytest.fixture(autouse=True)
def _clean_globals():
    """Nothing armed and no global admission state, before and after."""
    faults.disarm()
    jax_faults.disarm()
    adm_mod.reset_for_tests()
    jax_adm.reset_for_tests()
    yield
    faults.disarm()
    jax_faults.disarm()
    adm_mod.reset_for_tests()
    jax_adm.reset_for_tests()


@pytest.fixture(scope="module")
def weights():
    out = {}
    for seed in (0, 1, 2):
        jp = jinit(jax.random.PRNGKey(seed), JCFG)
        out[seed] = (jp, llama_params_from_jax(jax.tree.map(np.asarray, jp), TCFG, "cpu"))
    return out


def _solo(jp, prompt, n, max_len=64):
    return JG.generate_tokens(jp, JCFG, prompt, max_new_tokens=n, max_len=max_len)


# ---------------------------------------------------------------------------
# the supervisor (twins of tests/test_chaos.py)
# ---------------------------------------------------------------------------


def test_engine_loop_crash_recovers_with_greedy_parity(weights, monkeypatch):
    """One injected dispatch crash mid-decode: the in-flight request fails
    with the retryable error, the queued one survives the restart and
    completes with the JAX solo tokens, and a resubmit matches too."""
    monkeypatch.setenv("KAKVEDA_SERVE_RESTARTS", "2")
    jp, tp = weights[0]
    prompts = [[5, 6, 7], [10, 11, 12, 13, 14]]
    solo = [_solo(jp, p, 10) for p in prompts]
    eng = ServingEngine(tp, TCFG, batch_slots=1, max_len=64, chunk_steps=4, name="sup-crash")
    try:
        faults.arm("engine.dispatch:1:1")
        f1 = eng.submit(prompts[0], max_new_tokens=10)
        f2 = eng.submit(prompts[1], max_new_tokens=10)  # waits for the slot
        with pytest.raises(EngineRetryableError):
            f1.result(timeout=120)
        assert f2.result(timeout=120) == solo[1]
        assert eng.submit(prompts[0], max_new_tokens=10).result(timeout=120) == solo[0]
        st = eng.stats()
        assert st["restarts"] == 1 and not st["dead"]
        assert faults.site("engine.dispatch").fired == 1
        kinds = [e["kind"] for e in eng.recorder.dump()]
        assert kinds.count("engine_error") == 1 and kinds.count("engine_restart") == 1
    finally:
        eng.close()


def test_engine_restart_rebuilds_prefix_slabs(weights, monkeypatch):
    """A registered prefix survives the rebuild: after a fetch crash the
    next admission still hits it, with the JAX solo tokens."""
    monkeypatch.setenv("KAKVEDA_SERVE_RESTARTS", "2")
    jp, tp = weights[1]
    head = list(range(60, 76))
    eng = ServingEngine(tp, TCFG, batch_slots=2, max_len=128, chunk_steps=4)
    try:
        assert eng.register_prefix(head)
        faults.arm("engine.fetch:1:1")
        with pytest.raises(EngineRetryableError):
            eng.submit(head + [5, 6, 7], max_new_tokens=8).result(timeout=120)
        solo = _solo(jp, head + [5, 6, 7], 8, max_len=128)
        assert eng.submit(head + [5, 6, 7], max_new_tokens=8).result(timeout=120) == solo
        with eng.cb.stats_lock:
            hits = eng.cb.prefix_stats["hits"]
        assert hits >= 1, "rebuilt batcher lost the registered prefix"
        assert eng.stats()["restarts"] == 1
    finally:
        eng.close()


def test_rebuild_drops_the_dead_cache(weights, monkeypatch):
    """The rebuild empties the dead batcher's cache and prefix slabs
    before it allocates the new ones (on the card, the new cache takes the
    old one's memory)."""
    monkeypatch.setenv("KAKVEDA_SERVE_RESTARTS", "1")
    _, tp = weights[0]
    eng = ServingEngine(tp, TCFG, batch_slots=2, max_len=64, chunk_steps=4)
    try:
        assert eng.register_prefix(list(range(20, 36)))
        dead = eng.cb
        faults.arm("engine.dispatch:1:1")
        with pytest.raises(EngineRetryableError):
            eng.submit([5, 6, 7], max_new_tokens=8).result(timeout=120)
        _wait(lambda: eng.cb is not dead)
        assert dead.cache["k"] == [] and dead.cache["v"] == [] and not dead._prefixes
        assert eng.cb.prefix_stats["registered"] == 1 and len(eng.cb.cache["k"]) == TCFG.n_layers
    finally:
        eng.close()


def test_engine_terminal_death_fails_fast(weights, monkeypatch):
    """A spent budget: EngineDeadError on the pending request and on every
    later submit and register_prefix; nothing hangs."""
    monkeypatch.setenv("KAKVEDA_SERVE_RESTARTS", "1")
    _, tp = weights[0]
    eng = ServingEngine(tp, TCFG, batch_slots=1, max_len=64, chunk_steps=4)
    try:
        faults.arm("engine.dispatch:1:-1")
        fut = eng.submit([5, 6, 7], max_new_tokens=8)
        with pytest.raises(EngineRetryableError):
            fut.result(timeout=120)
        fut2 = eng.submit([5, 6, 7], max_new_tokens=8)
        with pytest.raises(EngineDeadError):
            fut2.result(timeout=120)
        assert eng._dead.wait(timeout=60)
        t = time.perf_counter()
        with pytest.raises(EngineDeadError):
            eng.submit([5], max_new_tokens=2)
        with pytest.raises(EngineDeadError):
            eng.register_prefix(list(range(16)))
        assert time.perf_counter() - t < 1.0
        assert eng.stats()["dead"]
    finally:
        eng.close()


def test_admission_error_fails_its_future_and_engine_serves_on(weights):
    """An error inside ``cb.admit`` (on the card: an OOM or a CUDA error in
    the prefill) fails that request's future with the error, counted
    ``rejected``, where it would otherwise wait for ever; the slot goes back
    and the next request gets the JAX solo tokens, no restart spent."""
    jp, tp = weights[0]
    eng = ServingEngine(tp, TCFG, batch_slots=1, max_len=64, chunk_steps=4, name="sup-admit-err")
    try:
        cb = eng.cb
        real = cb._prefill_into
        calls = []

        def flaky(*a, **kw):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("prefill failed")
            return real(*a, **kw)

        cb._prefill_into = flaky
        with pytest.raises(RuntimeError, match="prefill failed"):
            eng.submit([5, 6, 7], max_new_tokens=6).result(timeout=120)
        assert cb.free == [0] and not cb.slots
        assert eng.submit([5, 6, 7], max_new_tokens=6).result(timeout=120) == _solo(jp, [5, 6, 7], 6)
        rejected = eng._m_requests.labels(engine="sup-admit-err", outcome="rejected").value
        assert rejected == 1
        assert eng.cb is cb and eng.stats()["restarts"] == 0 and not eng.stats()["dead"]
    finally:
        eng.close()


def test_deadline_expired_request_retires_cleanly(weights, monkeypatch):
    """A deadline the request cannot meet fails it with
    DeadlineExceededError, its partial tokens a prefix of the solo tokens;
    the slot frees and the engine goes on with parity, no restart spent.
    The loop is held after the first chunk until the deadline has passed,
    so it passes mid-decode whatever the machine's speed."""
    monkeypatch.setenv("KAKVEDA_SERVE_RESTARTS", "2")
    jp, tp = weights[2]
    eng = ServingEngine(tp, TCFG, batch_slots=2, max_len=128, chunk_steps=4)
    try:
        eng.submit([9, 8, 7], max_new_tokens=4).result(timeout=120)
        first = threading.Event()
        t_submit = time.perf_counter()

        def hold(new, done):
            if new and not first.is_set():
                first.set()
                time.sleep(max(0.0, t_submit + 1.05 - time.perf_counter()))

        fut = eng.submit([5, 6, 7], max_new_tokens=90, on_tokens=hold, deadline_s=1.0)
        with pytest.raises(DeadlineExceededError) as ei:
            fut.result(timeout=120)
        toks = ei.value.tokens
        assert 0 < len(toks) < 90 and toks == _solo(jp, [5, 6, 7], 90, max_len=128)[: len(toks)]
        assert eng.submit([9, 8, 7], max_new_tokens=8).result(timeout=120) == _solo(jp, [9, 8, 7], 8, max_len=128)
        st = eng.stats()
        assert st["restarts"] == 0 and not st["dead"]
        assert [e["where"] for e in eng.recorder.dump() if e["kind"] == "deadline"] == ["mid-decode"]
        _wait(lambda: not eng.cb.slots and len(eng.cb.free) == 2)
    finally:
        eng.close()


def test_queued_request_past_its_deadline_never_takes_a_slot(weights):
    """A request whose deadline passes while it waits for the one slot
    fails with no tokens; the slot's owner completes with parity."""
    jp, tp = weights[0]
    eng = ServingEngine(tp, TCFG, batch_slots=1, max_len=64, chunk_steps=2)
    try:
        late_in = threading.Event()

        def hold(new, done):  # the slot stays taken until the late request's deadline passed
            if late_in.wait(60):
                time.sleep(0.05)

        first = eng.submit([5, 6, 7], 12, on_tokens=hold)
        late = eng.submit([9, 8], 12, deadline_s=0.01)
        late_in.set()
        with pytest.raises(DeadlineExceededError) as ei:
            late.result(timeout=60)
        assert ei.value.tokens == []
        assert first.result(timeout=120) == _solo(jp, [5, 6, 7], 12)
        assert eng.stats()["completed"] == 1
        assert [e["where"] for e in eng.recorder.dump() if e["kind"] == "deadline"] in (
            ["while queued"], ["expired before admission"])
    finally:
        eng.close()


def test_submit_sheds_past_the_queue_bound_and_a_deadline_it_cannot_meet(weights, monkeypatch):
    """``KAKVEDA_ADMIT_QUEUE`` bounds the backlog (``queue_full``), and with
    a live backlog a deadline under the observed queue waits sheds
    (``deadline``), each an OverloadError (not a RuntimeError) and one
    ``shed`` outcome; both packages shed the same requests."""
    monkeypatch.setenv("KAKVEDA_ADMIT_QUEUE", "2")
    jp, tp = weights[0]
    out = {}
    for name, Eng, params, cfg, mod, Err in (
        ("port", ServingEngine, tp, TCFG, adm_mod, OverloadError),
        ("jax", JEngine, jp, JCFG, jax_adm, jax_adm.OverloadError),
    ):
        mod.get_admission().note_wait("interactive", 5.0)  # a wait history of 5 s
        eng = Eng(params, cfg, batch_slots=1, max_len=64, chunk_steps=2, name=f"shed-{name}")
        release = threading.Event()
        try:
            eng.submit([5, 6, 7], 8, on_tokens=lambda new, done: release.wait(60))
            _wait(lambda: eng.cb.active == 1)
            got = []
            for kw in ({}, {"deadline_s": 1.0}, {"deadline_s": 60.0}, {}, {}):
                try:
                    eng.submit([9, 8], 4, **kw)
                    got.append("ok")
                except Err as e:
                    assert not isinstance(e, RuntimeError)
                    got.append(e.reason)
            out[name] = got
        finally:
            release.set()
            eng.close()
    assert out["port"] == out["jax"] == ["ok", "deadline", "ok", "queue_full", "queue_full"]


# ---------------------------------------------------------------------------
# cancel under the pipelined loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_cancelled_slot_admitted_again_under_a_chunk_in_flight(weights, kv_quant):
    """The reference's done-flag-first answer to pipelining: a chunk is
    enqueued, one of its slots is cancelled and at once admitted again; the
    stale chunk's tokens for that slot are dropped, the new occupant and
    the other slot hold their solo tokens."""
    import dataclasses

    jp, tp = weights[0]
    jcfg, tcfg = dataclasses.replace(JCFG, kv_quant=kv_quant), dataclasses.replace(TCFG, kv_quant=kv_quant)
    keep, drop, new = [5, 6, 7], [50, 51, 52], [9, 8, 7, 6]
    want = {tuple(p): JG.generate_tokens(jp, jcfg, p, max_new_tokens=12, max_len=64) for p in (keep, new)}
    cb = ContinuousBatcher(tp, tcfg, batch_slots=2, max_len=64, chunk_steps=4)
    rk = cb.admit(keep, max_new_tokens=12)
    rd = cb.admit(drop, max_new_tokens=12)
    cb.step()
    handle = cb.step_async()
    freed = next(s for s, st in cb.slots.items() if st.req_id == rd)
    partial = cb.cancel_request(rd)
    assert partial is not None and len(partial) == 4
    streamed = []
    rn = cb.admit(new, max_new_tokens=12, on_tokens=lambda t, done: streamed.extend(t))
    assert next(s for s, st in cb.slots.items() if st.req_id == rn) == freed
    assert cb.process_chunk(handle) == []
    while cb.active:
        cb.step()
    assert cb.results[rk] == want[tuple(keep)]
    assert cb.results[rn] == streamed == want[tuple(new)]
    assert rd not in cb.results


# ---------------------------------------------------------------------------
# the weighted-fair slot pick (twins of tests/test_tenants.py)
# ---------------------------------------------------------------------------


def _fake_engine(promote=4, fair=True):
    return SimpleNamespace(
        _tenant_fair=fair, _promote_rounds=promote, _fair_served={},
        _fair_table_max=512, _fair_picks=0, _fair_promotions=0, _waiting=[],
    )


def _witem(tenant):
    return ("req", SimpleNamespace(tenant=tenant, fair_rounds=0))


def _both_engines(**kw):
    return [(Eng, _fake_engine(**kw)) for Eng in (ServingEngine, JEngine)]


def test_deficit_pick_prefers_least_served_tenant():
    for Eng, eng in _both_engines():
        eng._fair_served = {"f": 5}
        eng._waiting = [_witem("f"), _witem("f"), _witem("v")]
        assert Eng._pick_waiting_locked(eng)[-1].tenant == "v"
        assert all(it[-1].fair_rounds == 1 for it in eng._waiting)


def test_starvation_bound_promotes_within_k_rounds():
    """However skewed the deficits and however fast a flooder refills the
    queue, a waiting item is admitted within ``_promote_rounds`` picks;
    the pick sequences of both packages agree."""
    picks = {}
    promote = 3
    for (Eng, eng), mod in zip(_both_engines(promote=promote), (adm_mod, jax_adm)):
        eng._fair_served = {"v": 1000}
        eng._waiting = [_witem("f") for _ in range(3)] + [_witem("v")]
        seq = []
        for _ in range(promote + 1):
            seq.append(Eng._pick_waiting_locked(eng)[-1].tenant)
            eng._waiting.append(_witem("f"))
            if seq[-1] == "v":
                break
        assert seq[-1] == "v" and len(seq) <= promote + 1
        assert eng._fair_promotions == 1
        assert mod.tenant_promotions().get("serving") == 1
        picks[Eng] = seq
    assert picks[ServingEngine] == picks[JEngine]


def test_tenant_blind_and_fair_off_are_exact_fifo():
    for Eng in (ServingEngine, JEngine):
        eng = _fake_engine(fair=False)
        eng._waiting = [_witem("a"), _witem("b"), _witem("c")]
        assert Eng._pick_waiting_locked(eng)[-1].tenant == "a"
        eng2 = _fake_engine()
        eng2._fair_served = {"": 99}
        items = [_witem(""), _witem(""), _witem("")]
        eng2._waiting = list(items)
        assert Eng._pick_waiting_locked(eng2) is items[0]
        assert Eng._pick_waiting_locked(eng2) is items[1]


def test_fair_served_table_bounded():
    for Eng, eng in _both_engines():
        eng._fair_table_max = 2
        for i in range(10):
            eng._waiting = [_witem(f"t{i}")]
            Eng._pick_waiting_locked(eng)
        assert len(eng._fair_served) <= 2
    # Past the single-item shortcut, both tables evict the same keys.
    tables = []
    for Eng, eng in _both_engines():
        eng._fair_table_max = 3
        for i in range(12):
            eng._waiting = [_witem(f"t{i % 5}"), _witem(f"t{(i * 3) % 5}")]
            Eng._pick_waiting_locked(eng)
        tables.append(dict(eng._fair_served))
    assert tables[0] == tables[1] and len(tables[0]) <= 3


def test_engine_fair_pick_on_the_live_engine(weights, monkeypatch):
    """The live engine admits a light tenant ahead of a flooder's backlog:
    with one slot held, three flooder requests and then one victim wait.
    The first pick is a tie at zero (a lone waiter's pick is FIFO and not
    counted, as in the reference), so the flood's head goes; the victim
    goes second, ahead of the flood's tail, and every result holds
    parity."""
    jp, tp = weights[0]
    eng = ServingEngine(tp, TCFG, batch_slots=1, max_len=64, chunk_steps=4)
    order = []
    try:
        release = threading.Event()
        hold = eng.submit([5, 6, 7], 4, on_tokens=lambda new, done: release.wait(60), tenant="flood")
        _wait(lambda: eng.cb.active == 1)
        futs = [eng.submit([10 + i, 11, 12], 4, tenant="flood",
                           on_tokens=(lambda i: lambda n, d: d and order.append(f"f{i}"))(i)) for i in range(3)]
        futs.append(eng.submit([40, 41], 4, tenant="victim", on_tokens=lambda n, d: d and order.append("v")))
        _wait(lambda: eng.stats()["submitted"] == 5)
        release.set()
        assert hold.result(timeout=120) == _solo(jp, [5, 6, 7], 4)
        for f, p in zip(futs, [[10, 11, 12], [11, 11, 12], [12, 11, 12], [40, 41]]):
            assert f.result(timeout=120) == _solo(jp, p, 4)
        assert order == ["f0", "v", "f1", "f2"]
        assert eng.stats()["tenant_fair"]["served"] == {"flood": 2, "victim": 1}
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the tenant plane around it (twins of tests/test_tenants.py)
# ---------------------------------------------------------------------------


def test_fair_disabled_is_seed_fifo(monkeypatch):
    """``KAKVEDA_TENANT_FAIR=0``: pure class-bound admission. The port's
    controller (tenant-blind: no quotas) admits and sheds as the JAX
    controller does with tenants under the switch."""
    monkeypatch.setenv("KAKVEDA_TENANT_FAIR", "0")
    monkeypatch.setenv("KAKVEDA_ADMIT_WARN", "4")
    ref = jax_adm.AdmissionController(
        limits={"warn": 4, "ingest": 1, "interactive": 4, "background": 1}, enabled=True,
        brownout=jax_adm.BrownoutController(enabled=False),
    )
    port = AdmissionController()
    tenants = ["app-a", "app-a", "app-b", "app-a", "app-b"]
    outcomes = {"port": [], "jax": []}
    for t in tenants:
        for name, call in (("port", lambda: port.try_admit("warn")),
                           ("jax", lambda: ref.try_admit("warn", tenant=t))):
            try:
                call()
                outcomes[name].append("ok")
            except (OverloadError, jax_adm.OverloadError) as e:
                outcomes[name].append(e.reason)
    assert outcomes["port"] == outcomes["jax"] == ["ok"] * 4 + ["queue_full"]
    assert port.info()["sheds"] == ref.shed_counts() == {"warn/queue_full": 1}
    assert not ref.tenants_info()["fair"] and ref.tenants_info()["table_size"] == 0


def _mb(cls, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("tenant_key", lambda r: r.split("-")[0])
    return cls(lambda reqs: list(reqs), **kw)


@pytest.mark.parametrize("cls", [MicroBatcher, JMicroBatcher], ids=["port", "jax"])
def test_submit_bound_sheds_flooder_spares_victim(cls):
    """At the queue bound the shed lands on the tenant that owns the
    backlog; an under-share tenant rides the slack up to twice the bound."""
    mb = _mb(cls, max_queue=4)

    async def go():
        loop = asyncio.get_running_loop()
        for i in range(4):
            await mb._queue.put((f"f-{i}", loop.create_future(), time.monotonic(), "f"))
        mb._queued["f"] = 4
        with pytest.raises(Exception) as ei:
            await mb.submit("f-next")
        assert ei.value.reason == "tenant_quota" and ei.value.tenant == "f"
        task = asyncio.create_task(mb.submit("v-0"))
        await asyncio.sleep(0.01)
        assert not task.done() and mb._queue.qsize() == 5
        for i in range(3):
            await mb._queue.put((f"f-pad{i}", loop.create_future(), time.monotonic(), "f"))
        with pytest.raises(Exception) as ei2:
            await mb.submit("v-1")
        assert ei2.value.reason == "queue_full"
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task

    asyncio.run(go())


@pytest.mark.parametrize("cls", [MicroBatcher, JMicroBatcher], ids=["port", "jax"])
def test_batcher_fair_disabled_keeps_global_fifo(cls, monkeypatch):
    """``KAKVEDA_TENANT_FAIR=0`` with a tenant key is still FIFO with a
    global bound: the victim sheds too."""
    monkeypatch.setenv("KAKVEDA_TENANT_FAIR", "0")
    mb = _mb(cls, max_queue=4)
    assert not mb._fair

    async def go():
        loop = asyncio.get_running_loop()
        for i in range(4):
            await mb._queue.put((f"f-{i}", loop.create_future(), time.monotonic(), ""))
        with pytest.raises(Exception) as ei:
            await mb.submit("v-0")
        assert ei.value.reason == "queue_full" and ei.value.tenant == ""

    asyncio.run(go())


def _wait(cond, timeout=60.0):
    t = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > t:
            raise AssertionError("the engine never reached the awaited state")
        time.sleep(0.01)
