"""Micro-batching request queue for the pre-flight warn hot path.

Port of ``kakveda_tpu/service/batcher.py``. Concurrent warn requests
coalesce into one device call: requests enqueue, a drain loop collects up
to ``max_batch`` of them (waiting at most ``deadline_s`` for stragglers once
the first arrives), runs the batch through ``Platform.warn_batch`` — one
``fused_topk`` launch — in an executor thread, and resolves every waiter.
Under load the batch fills at once and a request costs batch_time/B; when
idle a lone request pays the deadline (default 2 ms) on top of its own
match.

The queue is BOUNDED. Past ``max_queue`` waiting requests ``submit`` sheds
at once with a typed ``OverloadError`` (HTTP tier: 429 + Retry-After)
instead of queueing into a timeout.

Per-tenant fairness: with a ``tenant_key`` extractor and
``KAKVEDA_TENANT_FAIR=1`` (default), batch COMPOSITION is deficit
round-robin over per-tenant subqueues instead of global FIFO — no tenant
takes more than ``KAKVEDA_TENANT_MAX_SHARE`` of a batch while others have
queued work (work-conserving: spare seats go to whoever has work), and
per-tenant order stays FIFO. The submit-side bound is tenant-aware the
same way: at ``max_queue`` depth a tenant whose own queued share is at cap
sheds with ``reason="tenant_quota"`` while an under-share tenant may ride
bounded slack up to 2x ``max_queue`` (the hard bound nobody crosses).
Items a composition pass defers carry over to the next batch ahead of new
queue pulls, so deferral never reorders a tenant against itself.
Per-tenant counters are bounded and decayed. ``KAKVEDA_TENANT_FAIR=0`` or
no ``tenant_key`` keeps global FIFO.

Each drain observes ``kakveda_microbatch_batch_size`` and sets
``kakveda_microbatch_queue_depth``, and feeds its oldest item's queue wait
to the admission controller (``note_wait``), whose pressure moves the
brownout ladder. A shed carries the tenant it was charged to.
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict, deque
from typing import (
    Callable, Generic, List, Optional, Sequence, Tuple, TypeVar,
)

from kakveda_tpu_torch.core import metrics as _metrics
from kakveda_tpu_torch.core.admission import (
    AdmissionController,
    _env_float,
    _env_int,
    tenant_fair_enabled,
)

TReq = TypeVar("TReq")
TRes = TypeVar("TRes")

# One queue entry: (request, waiter, enqueue time, tenant key).
_Item = Tuple[TReq, asyncio.Future, float, str]

# Decay cadence for the per-tenant served counters: every N drains the
# counts halve, so "fair share" means RECENT share — a tenant that was
# heavy an hour ago isn't deprioritized forever — and zeros drop, which
# (with the eviction in _bump_served) bounds the table under key churn.
_SERVED_DECAY_EVERY = 256

# The one batcher is the warn route's: its metric label and admission class.
_KLASS = "warn"


class MicroBatcher(Generic[TReq, TRes]):
    def __init__(
        self,
        run_batch: Callable[[Sequence[TReq]], List[TRes]],
        *,
        max_batch: int = 64,
        deadline_s: float = 0.002,
        max_queue: int = 0,
        admission: Optional[AdmissionController] = None,
        tenant_key: Optional[Callable[[TReq], str]] = None,
    ):
        self._run_batch = run_batch
        self.max_batch = max_batch
        self.deadline_s = deadline_s
        # 0 = unbounded (library users); the service app passes its
        # admission class bound so the queue can never outgrow what the
        # drain loop retires before callers give up.
        self.max_queue = max_queue
        self._admission = admission
        # Tenant plane — resolved at construction like every knob.
        self._tenant_key = tenant_key
        self._fair = tenant_key is not None and tenant_fair_enabled()
        self._tenant_share = min(1.0, max(
            0.01, _env_float("KAKVEDA_TENANT_MAX_SHARE", 0.5)))
        self._tenant_table_max = max(2, _env_int("KAKVEDA_TENANT_TABLE", 512))
        # Items deferred by a composition pass: drained BEFORE new queue
        # pulls so per-tenant FIFO survives deferral. Bounded ≤ max_batch
        # (a pass considers ≤ 2x max_batch candidates and runs max_batch).
        self._carry: List[_Item] = []
        # served: recent batch seats per tenant (deficit input, decayed).
        # queued: live per-tenant depth for the submit-side quota; keys
        # drop at zero, so it's bounded by the queue depth itself.
        self._served: dict = {}
        self._queued: dict = {}
        self._drains = 0
        self._queue: asyncio.Queue[_Item] = asyncio.Queue()
        self._task: asyncio.Task | None = None
        reg = _metrics.get_registry()
        self._m_depth = reg.gauge(
            "kakveda_microbatch_queue_depth",
            "Requests waiting in a micro-batcher queue", ("batcher",),
        ).labels(batcher=_KLASS)
        self._m_size = reg.histogram(
            "kakveda_microbatch_batch_size",
            "Coalesced batch size per micro-batcher drain", ("batcher",),
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0),
        ).labels(batcher=_KLASS)

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._drain())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # Carried items would otherwise dangle with no drain loop; queued
        # items keep seed behavior (they die with the queue on shutdown).
        for item in self._carry:
            if not item[1].done():
                item[1].cancel()
        self._carry.clear()

    def _depth(self) -> int:
        return self._queue.qsize() + len(self._carry)

    async def submit(self, req: TReq) -> TRes:
        tenant = self._tenant_key(req) if self._fair else ""
        depth = self._depth()
        if self.max_queue and depth >= self.max_queue:
            if not (self._fair and tenant):
                # Seed behavior: global bound, global shed.
                self._shed("queue_full",
                           f"micro-batcher backlog {depth} >= {self.max_queue}")
            cap = max(1, int(self.max_queue * self._tenant_share))
            held = self._queued.get(tenant, 0)
            if held >= cap:
                # The shed lands on whoever owns the backlog — under a
                # noisy-neighbor flood that is the flooder, not a victim
                # arriving into a queue someone else filled.
                self._shed(
                    "tenant_quota",
                    f"tenant {tenant!r} holds {held}/{cap} queued warn slots",
                    tenant=tenant,
                )
            if depth >= 2 * self.max_queue:
                # Hard bound nobody rides past — the slack exists so an
                # under-share tenant survives a full queue, not so total
                # depth grows without limit.
                self._shed(
                    "queue_full",
                    f"micro-batcher backlog {depth} >= {2 * self.max_queue}",
                    tenant=tenant,
                )
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        if self._fair and tenant:
            self._queued[tenant] = self._queued.get(tenant, 0) + 1
        await self._queue.put((req, fut, time.monotonic(), tenant))
        return await fut

    def _shed(self, reason: str, detail: str, tenant: str = "") -> None:
        # Shed while it's still cheap: the typed error carries the
        # drain-rate-derived retry hint when an admission controller
        # is attached (the service app's case).
        if self._admission is not None:
            self._admission.shed(_KLASS, reason, detail=detail,
                                 tenant=tenant)
        from kakveda_tpu_torch.core.admission import OverloadError

        raise OverloadError(
            f"micro-batcher shed ({reason}): {detail}",
            klass=_KLASS, reason=reason, tenant=tenant,
        )

    # -- batch collection -------------------------------------------------

    async def _collect(self) -> List[_Item]:
        if not self._fair:
            return await self._collect_fifo(self.max_batch)
        if self._carry:
            # Deferred items go first; top up with whatever is already
            # waiting (no deadline wait — the carry proves oversubscription
            # and the queue is being fed faster than it drains).
            cands = self._carry
            self._carry = []
            while len(cands) < 2 * self.max_batch:
                try:
                    cands.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
        else:
            # Pull up to 2x max_batch so composition sees the cross-tenant
            # mix the cap is supposed to act on; the overflow carries.
            cands = await self._collect_fifo(2 * self.max_batch)
        return self._compose(cands)

    async def _collect_fifo(self, limit: int) -> List[_Item]:
        first = await self._queue.get()
        batch = [first]
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.deadline_s
        while len(batch) < limit:
            timeout = deadline - loop.time()
            if timeout <= 0:
                break
            try:
                batch.append(await asyncio.wait_for(self._queue.get(), timeout))
            except asyncio.TimeoutError:
                break
        return batch

    def _compose(self, cands: List[_Item]) -> List[_Item]:
        """Deficit round-robin batch composition over per-tenant subqueues.
        Per-tenant FIFO is preserved (each subqueue is a deque in arrival
        order); the per-tenant cap binds only while other tenants have
        queued work; leftovers carry in original arrival order."""
        groups: "OrderedDict[str, deque]" = OrderedDict()
        for item in cands:
            groups.setdefault(item[3], deque()).append(item)
        if len(groups) <= 1:
            batch, leftover = cands[: self.max_batch], cands[self.max_batch:]
        else:
            cap = max(1, int(self.max_batch * self._tenant_share))
            taken = {t: 0 for t in groups}
            batch = []
            while len(batch) < self.max_batch:
                elig = [t for t in groups if groups[t] and taken[t] < cap]
                if not elig:
                    # Everyone with work is capped: relax the cap rather
                    # than run a short batch (work-conserving).
                    elig = [t for t in groups if groups[t]]
                    if not elig:
                        break
                t = min(elig, key=lambda x: (
                    self._served.get(x, 0) + taken[x], x))
                batch.append(groups[t].popleft())
                taken[t] += 1
            picked = set(map(id, batch))
            leftover = [it for it in cands if id(it) not in picked]
            for t, n in taken.items():
                if n:
                    self._bump_served(t, n)
        self._carry = leftover
        for item in batch:
            t = item[3]
            if t:
                left = self._queued.get(t, 0) - 1
                if left > 0:
                    self._queued[t] = left
                else:
                    self._queued.pop(t, None)
        self._drains += 1
        if self._drains % _SERVED_DECAY_EVERY == 0:
            self._served = {
                t: n // 2 for t, n in self._served.items() if n // 2 > 0
            }
        return batch

    def _bump_served(self, tenant: str, n: int) -> None:
        if tenant not in self._served and len(self._served) >= self._tenant_table_max:
            # Evict the heaviest-served key: it re-enters at zero (a brief
            # priority boost), which is the safe failure direction — a
            # bounded table must never deprioritize an unknown tenant.
            heaviest = max(self._served, key=self._served.get)
            del self._served[heaviest]
        self._served[tenant] = self._served.get(tenant, 0) + n

    async def _drain(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            batch = await self._collect()
            self._m_size.observe(len(batch))
            self._m_depth.set(self._depth())
            if self._admission is not None:
                # Oldest item's wait = the batch's worst queue delay; one
                # sample per drain keeps the wait history cheap and honest.
                self._admission.note_wait(
                    _KLASS, time.monotonic() - batch[0][2]
                )
            reqs = [b[0] for b in batch]
            try:
                # The device call is sync; run it off-loop so new requests
                # keep enqueueing while the match executes.
                results = await loop.run_in_executor(None, self._run_batch, reqs)
                for (_, fut, _, _), res in zip(batch, results):
                    if not fut.done():
                        fut.set_result(res)
            except Exception as e:  # noqa: BLE001 — propagate to all waiters
                for _, fut, _, _ in batch:
                    if not fut.done():
                        fut.set_exception(e)
