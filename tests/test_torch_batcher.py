"""The port's warn MicroBatcher against the JAX package's, on one schedule.

Each case submits the same requests, in the same order, to both batchers
before their drain loops start, so the drains see the same queue: the
batches each composes (FIFO, or deficit round-robin across tenants with
carry-over), the sheds at the submit-side bound (``queue_full``,
``tenant_quota``) and the decayed per-tenant counters must be equal.
Exact comparison: no arithmetic differs.
"""

import asyncio
import threading

import pytest

from kakveda_tpu.service import batcher as jax_batcher
from kakveda_tpu_torch.core.admission import AdmissionController
from kakveda_tpu_torch.service import batcher as port_batcher


async def _drive(mod, schedule, *, max_batch, fair=True, max_queue=0, admission=None):
    """Submit ``schedule`` ((tenant, n) requests) in order, then start the
    drain; returns (batches as request lists, per-request outcomes,
    the batcher)."""
    batches = []

    def run(reqs):
        batches.append(list(reqs))
        return [("done", r) for r in reqs]

    kw = dict(max_batch=max_batch, deadline_s=0.02, max_queue=max_queue,
              tenant_key=(lambda r: r[0]) if fair else None)
    if admission is not None:
        kw["admission"] = admission
    mb = mod.MicroBatcher(run, **kw)

    async def sub(req):
        try:
            return await mb.submit(req)
        except Exception as e:  # noqa: BLE001 — each package raises its own OverloadError
            return ("shed", getattr(e, "reason", type(e).__name__), getattr(e, "tenant", None))

    tasks = [asyncio.create_task(sub(r)) for r in schedule]
    await asyncio.sleep(0)  # every submit enqueues (or sheds) before the drain starts
    mb.start()
    try:
        outcomes = await asyncio.wait_for(asyncio.gather(*tasks), 30)
    finally:
        await mb.stop()
    return batches, outcomes, mb


def _both(schedule, **kw):
    port = asyncio.run(_drive(port_batcher, schedule, **kw))
    ref = asyncio.run(_drive(jax_batcher, schedule, **kw))
    return port, ref


SCHEDULES = {
    # One flooding tenant ahead of two light ones: the cap binds, the
    # flood's overflow carries over to later batches in arrival order.
    "flood_then_light": [("A", i) for i in range(12)] + [("B", i) for i in range(3)] + [("C", 0)],
    "interleaved": [(t, i) for i in range(6) for t in ("A", "B", "A", "C")],
    "one_tenant": [("A", i) for i in range(10)],
    "many_tenants": [(f"t{i % 7}", i) for i in range(41)],
}


@pytest.mark.parametrize("fair", [True, False])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_batch_composition_matches_jax(name, fair):
    (pb, po, _), (rb, ro, _) = _both(SCHEDULES[name], max_batch=4, fair=fair)
    assert pb == rb
    assert po == ro == [("done", r) for r in SCHEDULES[name]]
    if fair and name == "flood_then_light":
        # A batch pulls 2 x max_batch candidates: the first two see only A;
        # once B and C are among them, A's cap (half of 4) binds and its
        # overflow carries over, in arrival order.
        assert ["".join(r[0] for r in b) for b in pb] == ["AAAA", "AAAA", "ABCA", "BABA"]
    if not fair:
        assert [r for b in pb for r in b] == SCHEDULES[name]  # global FIFO


def test_tenant_fair_off_is_fifo(monkeypatch):
    monkeypatch.setenv("KAKVEDA_TENANT_FAIR", "0")
    sched = SCHEDULES["flood_then_light"]
    (pb, _, _), (rb, _, _) = _both(sched, max_batch=4, fair=True)
    assert pb == rb and [r for b in pb for r in b] == sched


@pytest.mark.parametrize("fair", [True, False])
def test_queue_bound_sheds_match_jax(fair):
    # max_queue 4: past it, a tenant at its share cap sheds tenant_quota,
    # others ride the slack to 2x, then everyone sheds queue_full.
    sched = [("A", i) for i in range(6)] + [("B", i) for i in range(3)] + [(f"t{i}", i) for i in range(6)]
    (pb, po, _), (rb, ro, _) = _both(sched, max_batch=4, fair=fair, max_queue=4)
    assert pb == rb and po == ro
    reasons = [o[1] for o in po if o[0] == "shed"]
    if fair:
        assert {"tenant_quota", "queue_full"} <= set(reasons)
        assert [o for o in po if o[0] == "shed" and o[1] == "tenant_quota"][0][2] == "A"
    else:
        assert reasons == ["queue_full"] * (len(sched) - 4)


def test_shed_goes_through_admission():
    adm = AdmissionController()
    sched = [("A", i) for i in range(8)]
    _, outcomes, _ = asyncio.run(_drive(port_batcher, sched, max_batch=4, max_queue=4, admission=adm))
    assert sum(o[0] == "shed" for o in outcomes) == 4
    assert adm.info()["sheds"] == {"warn/tenant_quota": 4}


def test_served_counters_decay_like_jax():
    # 300 single-request drains cross the decay period (256 drains).
    sched = [("A" if i % 3 else "B", i) for i in range(300)]
    (pb, _, pmb), (rb, _, rmb) = _both(sched, max_batch=1)
    assert pb == rb and len(pb) == 300
    assert pmb._served == rmb._served and pmb._drains == rmb._drains == 300
    assert pmb._queued == rmb._queued == {}


def _stop_mid_batch(mod):
    """Stop the batcher while its first batch runs: the carried items'
    waiters are cancelled. Returns (depth at stop, cancelled, pending)."""

    async def go():
        gate = threading.Event()
        mb = mod.MicroBatcher(lambda reqs: gate.wait(10) and list(reqs), max_batch=2,
                              deadline_s=0.01, tenant_key=lambda r: r[0])
        tasks = [asyncio.create_task(mb.submit(("A", i))) for i in range(5)]
        await asyncio.sleep(0)
        mb.start()
        for _ in range(100):  # until the first batch is in the executor
            await asyncio.sleep(0.01)
            if mb._carry:
                break
        depth = mb._depth()
        await mb.stop()
        await asyncio.sleep(0)
        cancelled = sum(t.cancelled() for t in tasks)
        pending = sum(not t.done() for t in tasks)
        gate.set()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        return depth, cancelled, pending

    return asyncio.run(go())


def test_stop_cancels_carried_waiters_like_jax():
    port = _stop_mid_batch(port_batcher)
    assert port == _stop_mid_batch(jax_batcher)
    depth, cancelled, pending = port
    assert depth == 3 and cancelled == 2 and pending == 3
