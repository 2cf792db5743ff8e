"""The fleet front router — one ingress port over N service replicas.

Port of ``kakveda_tpu/fleet/router.py``. ``python -m
kakveda_tpu_torch.cli up --replicas N`` mounts this app on the public
port; replicas listen on ``port_base + i``. Routing policy:

* **Warn traffic shards by app key** (``app_id``, falling back to
  ``signature_text``) over a deterministic consistent-hash ring
  (:mod:`kakveda_tpu_torch.fleet.hashring`) — affinity keeps each replica's
  match cache and incremental-mining reuse hot for its share of apps.
* **Health probes + ejection**: a background probe hits every replica's
  ``/readyz``; ``KAKVEDA_ROUTER_EJECT_FAILS`` consecutive transport
  failures eject a replica from selection (ring membership is untouched,
  so recovery restores its exact key range); a successful probe un-ejects.
* **Retry-on-next-replica** for idempotent reads (warn, match, GETs):
  a transport failure or 5xx walks the key's stable failover order —
  the kill-one-replica drill's zero-lost-warns contract. Ingest retries
  ONLY on connect errors (the request never left), and admin mutations
  are single-attempt.
* 429/503 from a replica are passed through untouched: those are
  admission/degraded verdicts, not router failures — shedding stays
  end-to-end typed (core/admission.py).
* Under sharded ownership (``KAKVEDA_FLEET_OWNERSHIP=1``) warn and match
  scatter to every live shard and merge (:func:`_merge_warn`,
  :func:`_merge_matches`), with the partial-result contract; the router
  is the ownership epoch's single writer (promotion pushes and
  ``POST /fleet/rebalance``).
* ``GET /metrics/fleet`` federates every replica's ``/metrics``;
  ``GET /trace/{id}`` assembles one trace from the router's ring and
  every replica's.

The router is deliberately stateless beyond health/breaker bookkeeping:
all durable state lives in the replicas, so a router restart only needs
the backend list to resume identical routing (hashring determinism).

Metrics: the ``kakveda_fleet_*`` family —
per-replica forwards/ejections/health, reroute counter, router overhead
histogram and a hot-key skew gauge (max single-key share of routed warn
traffic).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Dict, List, Mapping, Optional

from aiohttp import web

from kakveda_tpu_torch.core import faults as _faults
from kakveda_tpu_torch.core import metrics as _metrics
from kakveda_tpu_torch.core import trace as _trace
from kakveda_tpu_torch.core.runtime import ensure_request_id, get_runtime_config
from kakveda_tpu_torch.fleet import ownership as _own
from kakveda_tpu_torch.fleet.gossip import FleetView, sample_from_ready
from kakveda_tpu_torch.fleet.hashring import HashRing

log = logging.getLogger("kakveda.fleet")

# Chaos site: an armed router.forward fault fails a
# forward attempt exactly like a transport error — proving the
# retry-on-next-replica path without killing a process.
_FAULT_FORWARD = _faults.site("router.forward")
# Sharded-ownership chaos sites (resolved once):
# an armed gfkb.scatter_gather fault fails ONE shard sub-request of a
# scatter-gather warn exactly like a transport error — the merged verdict
# must degrade to partial=true with shard provenance, never hang, never
# silently shrink coverage. An armed fleet.promote fault fails the
# ownership-epoch push after an ejection — routing has already failed
# over (candidates skip the ejected owner); the push stays dirty and
# retries next probe tick.
_FAULT_SCATTER = _faults.site("gfkb.scatter_gather")
_FAULT_PROMOTE = _faults.site("fleet.promote")

ROUTER_KEY: web.AppKey["Router"] = web.AppKey("fleet_router", object)  # type: ignore[type-var]
_PROBE_TASK_KEY: web.AppKey[object] = web.AppKey("fleet_probe_task", object)
_SUPERVISE_TASK_KEY: web.AppKey[object] = web.AppKey("fleet_supervise_task", object)
AUTOSCALER_KEY: web.AppKey[object] = web.AppKey("fleet_autoscaler", object)
_AUTOSCALE_TASK_KEY: web.AppKey[object] = web.AppKey("fleet_autoscale_task", object)

# Bounded hot-key accounting: enough keys to see real skew, cheap enough
# to keep on the forward hot path.
_HOT_KEYS_MAX = 4096


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


class Router:
    """Routing + health state over a fixed backend map {replica_id: url}."""

    def __init__(
        self,
        backends: Dict[str, str],
        *,
        vnodes: Optional[int] = None,
        probe_interval_s: Optional[float] = None,
        eject_fails: Optional[int] = None,
        retries: Optional[int] = None,
        timeout_s: Optional[float] = None,
        ownership=None,
    ):
        if not backends:
            raise ValueError("router needs at least one backend replica")
        self.backends = dict(backends)
        # Sharded ownership (fleet/ownership.py OwnershipView, or None =
        # legacy full replication). The router is the epoch's single
        # writer: ejections and re-admissions mark the view dirty, the
        # probe loop bumps the epoch once per change batch and pushes the
        # view to every live replica (standby promotion is routing-side
        # instant via candidates(); the push is what fences stale views).
        self.ownership = ownership
        self._own_dirty = False
        self._verdict_seq = 0
        # Resolved once (hot forwards must not re-read config): the header
        # the service tier echoes/logs — propagated per hop so replica
        # logs join router logs by request id (and by trace id).
        self._rid_header = get_runtime_config(
            service_name="kakveda-router"
        ).request_id_header
        self.ring = HashRing(
            list(self.backends),
            vnodes=_env_int("KAKVEDA_FLEET_VNODES", 64) if vnodes is None else vnodes,
        )
        self.probe_interval_s = (
            _env_float("KAKVEDA_ROUTER_PROBE_S", 1.0)
            if probe_interval_s is None else probe_interval_s
        )
        self.eject_fails = (
            _env_int("KAKVEDA_ROUTER_EJECT_FAILS", 3)
            if eject_fails is None else eject_fails
        )
        # Extra attempts after the owner for idempotent reads.
        self.retries = (
            min(_env_int("KAKVEDA_ROUTER_RETRIES", 2), len(self.backends) - 1)
            if retries is None else retries
        )
        self.timeout_s = (
            _env_float("KAKVEDA_ROUTER_TIMEOUT_S", 15.0)
            if timeout_s is None else timeout_s
        )
        self._state = {
            rid: {"fails": 0, "ejected": False, "healthy": None, "ready": None}
            for rid in self.backends
        }
        # The router's own fold of the fleet's control vocabulary: one
        # gossip-shaped sample per successful probe (gossip.
        # sample_from_ready) under the SAME seq/TTL freshness discipline
        # the replicas use on the bus — the autoscaler's policy input.
        self.fleet_view = FleetView(
            ttl_s=_env_float("KAKVEDA_FLEET_GOSSIP_TTL_S", 5.0)
        )
        self._probe_fold_seq = 0
        # Mounted by make_router_app(autoscale=…); report() exposes it.
        self.autoscaler = None
        self._client = None  # aiohttp.ClientSession, bound at app startup
        self._hot_keys: Dict[str, int] = {}
        self._hot_total = 0
        reg = _metrics.get_registry()
        fwd = reg.counter(
            "kakveda_fleet_forwards_total",
            "Router forwards by replica and outcome (ok|error|passthrough)",
            ("replica", "outcome"),
        )
        self._m_fwd = {
            rid: {o: fwd.labels(replica=rid, outcome=o)
                  for o in ("ok", "error", "passthrough")}
            for rid in self.backends
        }
        self._m_reroutes = reg.counter(
            "kakveda_fleet_reroutes_total",
            "Requests retried on the next replica after a forward failure",
        )
        ej = reg.counter(
            "kakveda_fleet_ejections_total",
            "Replica ejections after consecutive forward/probe failures",
            ("replica",),
        )
        self._m_eject = {rid: ej.labels(replica=rid) for rid in self.backends}
        g_healthy = reg.gauge(
            "kakveda_fleet_replica_healthy",
            "1 while a replica answers probes and is not ejected", ("replica",),
        )
        self._m_healthy = {rid: g_healthy.labels(replica=rid) for rid in self.backends}
        load = reg.counter(
            "kakveda_fleet_shard_load_total",
            "Key-routed requests per replica (shard balance)", ("replica",),
        )
        self._m_load = {rid: load.labels(replica=rid) for rid in self.backends}
        self._m_overhead = reg.histogram(
            "kakveda_fleet_router_overhead_seconds",
            "Wall time the router spends forwarding one request (includes "
            "the replica's own service time)",
        )
        self._m_hot_share = reg.gauge(
            "kakveda_fleet_hot_key_share",
            "Share of routed keyed traffic going to the single hottest key "
            "(hot-key skew indicator)",
        )
        self._m_scatter = reg.counter(
            "kakveda_fleet_scatter_total",
            "Scatter-gather merges by outcome (ok|partial|shed|unreachable)",
            ("outcome",),
        )
        self._m_promote = reg.counter(
            "kakveda_fleet_promotions_total",
            "Ownership-epoch bumps pushed after ejection/re-admission/"
            "membership change",
        )
        self._m_epoch = reg.gauge(
            "kakveda_fleet_ownership_epoch",
            "The router's current ownership epoch (0 = ownership off)",
        )
        if self.ownership is not None:
            self._m_epoch.set(float(self.ownership.epoch))

    # -- selection -------------------------------------------------------

    def ejected(self) -> List[str]:
        return [rid for rid, st in self._state.items() if st["ejected"]]

    def liveness(self) -> Dict[str, bool]:
        """Per-replica routability (healthy AND not ejected) — the same
        verdict broadcast_verdicts gossips; the autoscaler's dead-replica
        detection input."""
        return {
            rid: bool(st["healthy"]) and not st["ejected"]
            for rid, st in self._state.items()
        }

    def candidates(self, key: str, attempts: int) -> List[str]:
        """The owner + failover order for ``key``, ejected replicas
        skipped — unless that empties the list (all ejected), in which
        case trying beats failing outright.

        Under sharded ownership a keyed request may ONLY land on the
        key's holders — any other replica simply does not store the
        range — so the walk is the holder list, not the full ring.
        Ejected-owner fallback within it IS standby promotion for the
        data plane (the standby holds the range by R-way replication)."""
        if self.ownership is not None and key:
            pref = self.ownership.holders(key)[: max(1, attempts)]
        else:
            pref = self.ring.preference(key, limit=attempts)
        ejected = set(self.ejected())
        live = [r for r in pref if r not in ejected]
        return live or pref

    def note_key(self, key: str) -> None:
        if len(self._hot_keys) >= _HOT_KEYS_MAX and key not in self._hot_keys:
            return  # bounded: skew among the first 4096 keys is plenty
        self._hot_keys[key] = self._hot_keys.get(key, 0) + 1
        self._hot_total += 1
        self._m_hot_share.set(max(self._hot_keys.values()) / self._hot_total)

    # -- failure accounting ---------------------------------------------

    def note_result(self, rid: str, ok: bool) -> None:
        st = self._state.get(rid)
        if st is None:
            return  # removed by a concurrent scale-down mid-flight
        if ok:
            st["fails"] = 0
            return
        st["fails"] += 1
        if st["fails"] >= self.eject_fails and not st["ejected"]:
            st["ejected"] = True
            self._m_eject[rid].inc()
            self._m_healthy[rid].set(0.0)
            log.warning(
                "replica %s ejected after %d consecutive failures", rid, st["fails"]
            )
            if self.ownership is not None:
                # Standby promotion: the data plane flipped the moment the
                # owner left candidates(); the epoch bump + view push (next
                # probe tick) is what fences stale ring views fleet-wide.
                self._own_dirty = True

    # -- forwarding ------------------------------------------------------

    def _hop_headers(
        self, body: Optional[bytes], incoming: Optional[Mapping[str, str]]
    ) -> Dict[str, str]:
        """Base outgoing headers for one forward/scatter: Content-Type
        for bodies plus the PROPAGATED incoming request id — without it,
        replica logs cannot be joined to router logs even by request id."""
        out: Dict[str, str] = {}
        if body:
            out["Content-Type"] = "application/json"
        if incoming:
            rid = incoming.get(self._rid_header)
            if rid:
                out[self._rid_header] = rid
        return out

    def _with_hop_context(
        self,
        base: Dict[str, str],
        hop,
        incoming: Optional[Mapping[str, str]],
    ) -> Optional[Dict[str, str]]:
        """Stamp one attempt's trace context: the hop span's traceparent
        (the replica's server span parents under THIS attempt), falling
        back to the raw incoming header when tracing is inert."""
        hdrs = dict(base)
        tp = hop.traceparent() or (
            incoming.get(_trace.TRACEPARENT_HEADER, "") if incoming else ""
        )
        if tp:
            hdrs[_trace.TRACEPARENT_HEADER] = tp
        return hdrs or None

    async def forward(
        self,
        method: str,
        path: str,
        body: Optional[bytes],
        key: str,
        *,
        idempotent: bool,
        retry_connect_only: bool = False,
        headers: Optional[Mapping[str, str]] = None,
    ) -> web.Response:
        """Forward one request along ``key``'s candidate list. Transport
        failures (and 5xx on idempotent routes) walk to the next replica;
        HTTP verdicts — including 429 shed and 503 degraded — pass through
        untouched. The forward client is aiohttp."""
        import aiohttp

        attempts = 1 + (self.retries if (idempotent or retry_connect_only) else 0)
        cands = self.candidates(key, attempts)
        base_headers = self._hop_headers(body, headers)
        t0 = time.perf_counter()
        last_err: Optional[str] = None
        for i, rid in enumerate(cands):
            if i > 0:
                self._m_reroutes.inc()
            base = self.backends.get(rid)
            if base is None:
                # Removed by a concurrent scale-down between candidate
                # selection and dispatch — walk on, don't 500.
                last_err = f"{rid} removed"
                continue
            url = base + path
            # Each attempt is its own child span (replica + outcome
            # provenance); the hop's traceparent rides the sub-request so
            # the replica's server span parents under THIS attempt, not
            # under a retry that never reached it.
            hop = _trace.get_tracer().start_span(
                "router.forward", replica=rid, attempt=i, path=path
            )
            hdrs = self._with_hop_context(base_headers, hop, headers)
            try:
                _FAULT_FORWARD.fire()
                async with self._client.request(
                    method, url, data=body, headers=hdrs,
                ) as r:
                    content = await r.read()
                    status = r.status
                    ctype = r.headers.get("Content-Type", "application/json")
                    retry_after = r.headers.get("Retry-After")
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    _faults.FaultInjected) as e:
                self.note_result(rid, False)
                self._m_fwd[rid]["error"].inc()
                last_err = f"{type(e).__name__}: {e}"
                hop.end("error", error=type(e).__name__)
                continue
            if status >= 500 and idempotent and i + 1 < len(cands):
                # A dying replica can serve 500s before its socket closes;
                # an idempotent read is safe to answer from the next one.
                self.note_result(rid, False)
                self._m_fwd[rid]["error"].inc()
                last_err = f"HTTP {status}"
                hop.end("error", status=status)
                continue
            hop.end(_hop_outcome(status), status=status)
            self.note_result(rid, status < 500)
            self._m_fwd[rid]["ok" if status < 500 else "passthrough"].inc()
            if key:
                self._m_load[rid].inc()
            self._m_overhead.observe(time.perf_counter() - t0)
            headers = {}
            if retry_after is not None:
                headers["Retry-After"] = retry_after
            return web.Response(
                body=content,
                status=status,
                content_type=ctype.split(";")[0],
                headers=headers,
            )
        self._m_overhead.observe(time.perf_counter() - t0)
        return web.json_response(
            {"ok": False, "error": f"no replica reachable ({last_err})"},
            status=502,
        )

    # -- scatter-gather (sharded ownership) ------------------------------

    async def scatter(
        self,
        path: str,
        body: Optional[bytes],
        merge,
        headers: Optional[Mapping[str, str]] = None,
    ) -> web.Response:
        """Fan one request out to every live shard and merge — the warn /
        match data plane under sharded ownership (each replica holds only
        its owned + standby ranges, so no single forward sees the corpus).

        Partial-result contract: a shard that is unreachable (or chaos:
        gfkb.scatter_gather) is recorded in ``shards`` provenance; the
        merged verdict carries ``partial=true`` IFF some ownership range
        has NO holder among the answering shards (exact arc accounting,
        fleet/ownership.py) — coverage is never silently dropped, and the
        gather is bounded by the per-request client timeout, never hangs.
        All-shed verdicts pass through typed as 429 + Retry-After."""
        import aiohttp

        view = self.ownership
        ejected = set(self.ejected())
        targets = [
            rid for rid in view.members
            if rid in self.backends and rid not in ejected
        ] or [rid for rid in view.members if rid in self.backends]
        base_headers = self._hop_headers(body, headers)
        t0 = time.perf_counter()

        async def one(rid: str):
            # One child span per shard sub-request — the assembled tree
            # shows every shard's replica + outcome, including the ones
            # the merge never used.
            hop = _trace.get_tracer().start_span(
                "router.scatter", replica=rid, path=path
            )
            hdrs = self._with_hop_context(base_headers, hop, headers)
            try:
                _FAULT_SCATTER.fire()
                async with self._client.request(
                    "POST", self.backends[rid] + path, data=body, headers=hdrs
                ) as r:
                    content = await r.read()
                    hop.end(_hop_outcome(r.status), status=r.status)
                    return rid, r.status, content, r.headers.get("Retry-After")
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    _faults.FaultInjected) as e:
                hop.end("error", error=type(e).__name__)
                return rid, None, None, None

        results = await asyncio.gather(*(one(rid) for rid in targets))
        answered: Dict[str, dict] = {}
        shards: Dict[str, str] = {}
        sheds: List[Optional[str]] = []
        for rid, status, content, retry_after in results:
            if status is None:
                self.note_result(rid, False)
                self._m_fwd[rid]["error"].inc()
                shards[rid] = "unreachable"
                continue
            self.note_result(rid, status < 500)
            if status == 200:
                try:
                    parsed = json.loads(content)
                except ValueError:
                    self._m_fwd[rid]["error"].inc()
                    shards[rid] = "bad_body"
                    continue
                self._m_fwd[rid]["ok"].inc()
                answered[rid] = parsed
                shards[rid] = "ok"
            elif status in (429, 503):
                self._m_fwd[rid]["passthrough"].inc()
                shards[rid] = "shed" if status == 429 else "degraded_unavailable"
                sheds.append(retry_after)
            else:
                self._m_fwd[rid]["error"].inc()
                shards[rid] = f"http_{status}"
        self._m_overhead.observe(time.perf_counter() - t0)
        if not answered:
            if sheds:
                # Uniform backpressure: keep the shed typed end-to-end.
                self._m_scatter.labels(outcome="shed").inc()
                ra = max((int(float(x)) for x in sheds if x), default=1)
                return web.json_response(
                    {"ok": False, "error": "all shards shed or unreachable",
                     "shards": shards, "retry_after": ra},
                    status=429, headers={"Retry-After": str(max(1, ra))},
                )
            self._m_scatter.labels(outcome="unreachable").inc()
            return web.json_response(
                {"ok": False, "error": "no shard reachable", "shards": shards},
                status=502,
            )
        holes = view.coverage_holes(answered.keys())
        merged = merge(answered)
        merged["shards"] = shards
        merged["partial"] = holes > 0
        if holes:
            merged["uncovered_ranges"] = holes
        self._m_scatter.labels(outcome="partial" if holes else "ok").inc()
        return web.json_response(merged)

    # -- ownership epoch (promotion / rebalance) -------------------------

    def set_ownership(self, view) -> None:
        """Swap in a new ownership view (rebalance flip) — one reference
        write; in-flight scatters finish on the view they captured."""
        self.ownership = view
        self._m_epoch.set(float(view.epoch))

    async def push_ownership(self, *, bump: bool = True) -> bool:
        """Bump the epoch (promotion: ejection / re-admission changed who
        serves which ranges) and push the view to every live member.
        Failure — including chaos fleet.promote — leaves the dirty flag
        set; the probe loop retries next tick. Routing never waits for
        this: candidates() already fails over, the push only fences."""
        import aiohttp

        if self.ownership is None:
            return True
        try:
            _FAULT_PROMOTE.fire()
        except _faults.FaultInjected as e:
            log.warning("ownership push deferred (chaos): %s", e)
            return False
        if bump:
            self.set_ownership(self.ownership.with_epoch(self.ownership.epoch + 1))
            self._m_promote.inc()
        body = json.dumps(self.ownership.to_dict()).encode("utf-8")
        ok = True
        for rid in list(self.ownership.members):
            st = self._state.get(rid)
            if st is None or st["ejected"]:
                continue  # re-admission push happens on probe recovery
            try:
                async with self._client.post(
                    self.backends[rid] + "/fleet/ownership", data=body,
                    headers={"Content-Type": "application/json"},
                ) as r:
                    if r.status >= 500:
                        ok = False
            except (aiohttp.ClientError, asyncio.TimeoutError):
                ok = False
        if ok:
            self._own_dirty = False
        return ok

    async def rebalance_to(self, members: Dict[str, str]) -> dict:
        """Drive the range-migration protocol to an explicit target
        membership — THE membership-change epoch write path. Both the
        POST /fleet/rebalance handler and the autoscaler go through here,
        so the router stays the single epoch writer (the autoscaler
        requests; run_rebalance's flip push commits, and any residual
        promotion retries ride the probe loop's dirty flag).
        Raises :class:`~kakveda_tpu_torch.fleet.ownership.MigrationError`
        with ``flipped`` provenance; flipped=False means the old view
        still rules everywhere and a full retry is safe."""
        if self.ownership is None:
            raise RuntimeError("ownership disabled")
        old = self.ownership
        new = old.with_members(dict(members))
        # Migration traces against the epochs that fence it: a failed
        # migration's span (error outcome, flipped provenance in the
        # raised MigrationError) correlates with every replicate_apply
        # span fenced at epoch_to.
        with _trace.get_tracer().start_span(
            "fleet.rebalance", epoch_from=old.epoch, epoch_to=new.epoch,
            members=len(new.members),
        ):
            summary = await asyncio.get_running_loop().run_in_executor(
                None, lambda: _own.run_rebalance(old, new)
            )
            for rid, url in new.members.items():
                self.add_backend(rid, url)
            for rid in [r for r in self.backends if r not in new.members]:
                self.remove_backend(rid)
            self.set_ownership(new)
            self._m_promote.inc()
            return summary

    async def resync_member(self, rid: str) -> dict:
        """Heal a replaced member's GFKB gap: snapshot-ship its held
        (owned + standby) arcs back from the surviving holders through
        the SAME migration protocol — ``run_rebalance`` from the view
        WITHOUT the member (same epoch, export basis only; never pushed)
        to the full view at epoch+1 ships exactly the arcs whose holder
        set regains the member, then drains the watermark delta.
        Row-idempotent by construction: deterministic ``mig-*`` event ids
        plus signature-keyed upserts mean re-shipped rows the member
        already holds update in place, never duplicate."""
        view = self.ownership
        if view is None or rid not in view.members:
            return {}
        donors = {r: u for r, u in view.members.items() if r != rid}
        if not donors:
            return {}
        old = view.with_members(donors, epoch=view.epoch)
        new = view.with_epoch(view.epoch + 1)
        with _trace.get_tracer().start_span(
            "fleet.resync", replica=rid,
            epoch_from=view.epoch, epoch_to=new.epoch,
        ):
            summary = await asyncio.get_running_loop().run_in_executor(
                None, lambda: _own.run_rebalance(old, new)
            )
            self.set_ownership(new)
            self._m_promote.inc()
            return summary

    def add_backend(self, rid: str, url: str) -> None:
        """Grow the routable fleet at runtime (scale-out): extend the
        backend map + ring and mint the per-replica metric children the
        constructor resolves once. The probe loop picks the newcomer up on
        its next pass (the due map self-heals)."""
        url = url.rstrip("/")
        if rid in self.backends:
            self.backends[rid] = url
            return
        self.backends[rid] = url
        self.ring = HashRing(list(self.backends), vnodes=self.ring.vnodes)
        self._state[rid] = {
            "fails": 0, "ejected": False, "healthy": None, "ready": None
        }
        reg = _metrics.get_registry()
        fwd = reg.counter(
            "kakveda_fleet_forwards_total",
            "Router forwards by replica and outcome (ok|error|passthrough)",
            ("replica", "outcome"),
        )
        self._m_fwd[rid] = {
            o: fwd.labels(replica=rid, outcome=o)
            for o in ("ok", "error", "passthrough")
        }
        ej = reg.counter(
            "kakveda_fleet_ejections_total",
            "Replica ejections after consecutive forward/probe failures",
            ("replica",),
        )
        self._m_eject[rid] = ej.labels(replica=rid)
        g_healthy = reg.gauge(
            "kakveda_fleet_replica_healthy",
            "1 while a replica answers probes and is not ejected", ("replica",),
        )
        self._m_healthy[rid] = g_healthy.labels(replica=rid)
        load = reg.counter(
            "kakveda_fleet_shard_load_total",
            "Key-routed requests per replica (shard balance)", ("replica",),
        )
        self._m_load[rid] = load.labels(replica=rid)

    def remove_backend(self, rid: str) -> None:
        """Shrink the routable fleet at runtime (lossless scale-down
        epilogue — the victim's arcs were already migrated away). A
        DELIBERATE membership change, unlike ejection, which never
        touches ring membership. Metric children stay minted (their
        counters keep their history); the probe loop prunes its due map."""
        if rid not in self.backends:
            return
        del self.backends[rid]
        self._state.pop(rid, None)
        self.ring = HashRing(list(self.backends), vnodes=self.ring.vnodes)
        m = self._m_healthy.get(rid)
        if m is not None:
            m.set(0.0)

    # -- probe-verdict broadcast (one liveness world-view) ---------------

    async def broadcast_verdicts(self) -> None:
        """Fold the router's probe/ejection liveness into every replica's
        FleetView as a synthetic gossip sample (sender ``__router__``).
        Ejection and the gossip pressure floor then share ONE liveness
        opinion: a peer the router marks dead stops pinning survivors'
        brownout ladders before its stale sample's TTL runs out.
        Best-effort — the TTL discipline covers missed broadcasts."""
        import aiohttp

        self._verdict_seq += 1
        sample = {
            "replica": "__router__",
            "seq": self._verdict_seq,
            "ts": time.time(),
            "occupancy": 0.0,
            "probe_verdicts": self.liveness(),
        }
        # The router's own view folds the verdicts too, so its
        # fleet_pressure() skips dead peers exactly like a replica's.
        self.fleet_view.fold(sample)
        body = json.dumps(sample).encode("utf-8")
        for rid, st in list(self._state.items()):
            if not st["healthy"]:
                continue
            try:
                async with self._client.post(
                    self.backends[rid] + "/fleet/gossip", data=body,
                    headers={"Content-Type": "application/json"},
                    timeout=aiohttp.ClientTimeout(total=min(2.0, self.timeout_s)),
                ) as r:
                    await r.read()
            except (aiohttp.ClientError, asyncio.TimeoutError):
                pass

    # -- probing ---------------------------------------------------------

    async def probe_replica(self, rid: str) -> None:
        import aiohttp

        url = self.backends[rid]
        st = self._state[rid]
        try:
            async with self._client.get(
                url + "/readyz",
                timeout=aiohttp.ClientTimeout(total=min(2.0, self.timeout_s)),
            ) as r:
                if r.status != 200:
                    raise ValueError(f"readyz HTTP {r.status}")
                st["ready"] = await r.json()
            self._probe_fold_seq += 1
            self.fleet_view.fold(
                sample_from_ready(rid, self._probe_fold_seq, st["ready"])
            )
            st["healthy"] = True
            st["fails"] = 0
            if st["ejected"]:
                st["ejected"] = False
                log.warning("replica %s re-admitted (probe ok)", rid)
                if self.ownership is not None:
                    self._own_dirty = True  # owner takes its ranges back
            self._m_healthy[rid].set(1.0)
        except (aiohttp.ClientError, asyncio.TimeoutError, ValueError) as e:
            st["healthy"] = False
            self._m_healthy[rid].set(0.0)
            self.note_result(rid, False)
            st["ready"] = None
            log.debug("probe %s failed: %s", rid, e)

    async def probe_once(self) -> None:
        """Probe every replica back-to-back — startup (the router must not
        route before it knows who is alive) and tests. The steady-state
        loop never does this: see probe_loop."""
        for rid in self.backends:
            await self.probe_replica(rid)

    def probe_phase(self, rid: str) -> float:
        """Deterministic per-replica probe phase in [0, interval): blake2b
        of the replica id, the hash ring's derivation discipline (never
        salted ``hash()``), so the stagger is stable across router
        restarts and identical on every router instance."""
        import hashlib

        h = int.from_bytes(
            hashlib.blake2b(rid.encode(), digest_size=4).digest(), "big"
        )
        return self.probe_interval_s * ((h % 9973) / 9973.0)

    async def probe_loop(self) -> None:
        """Phase-jittered health probing: every replica is still probed
        once per ``probe_interval_s``, but on its own deterministic phase
        offset instead of one synchronized tick. Back-to-back probing
        meant N /readyz bursts landing on the fleet simultaneously every
        interval — at small intervals the burst itself becomes load, and a
        transient stall (GC pause, snapshot fsync) hitting the shared tick
        could fail several replicas' probes at once and eject half the
        ring in one beat. Staggered, each replica's probe samples a
        different instant."""
        due = {
            rid: time.monotonic() + self.probe_phase(rid)
            for rid in self.backends
        }
        last_broadcast = 0.0
        while True:
            for rid in self.backends:  # add_backend: newcomers self-heal in
                due.setdefault(rid, time.monotonic() + self.probe_phase(rid))
            for rid in [r for r in due if r not in self.backends]:
                del due[rid]  # remove_backend (scale-down) prunes out
            rid = min(due, key=due.get)
            delay = due[rid] - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            try:
                await self.probe_replica(rid)
                now = time.monotonic()
                if now - last_broadcast >= self.probe_interval_s:
                    last_broadcast = now
                    await self.broadcast_verdicts()
                if self.ownership is not None and self._own_dirty:
                    await self.push_ownership()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — probe must never die
                log.warning("probe loop error: %s: %s", type(e).__name__, e)
            due[rid] = time.monotonic() + self.probe_interval_s

    # -- fleet report ----------------------------------------------------

    def report(self) -> dict:
        """Per-replica health + fleet admission mode — the router's
        /readyz body."""
        replicas = {}
        worst = {"state": "normal", "step": 0}
        degraded_any = False
        for rid, st in self._state.items():
            ready = st["ready"] or {}
            adm = ready.get("admission") or {}
            step = int(adm.get("brownout_step", 0) or 0)
            if st["healthy"] and step > worst["step"]:
                worst = {"state": adm.get("brownout", "?"), "step": step}
            dev = ready.get("device") or {}
            degraded_any = degraded_any or bool(dev.get("degraded"))
            replicas[rid] = {
                "url": self.backends[rid],
                "healthy": st["healthy"],
                "ejected": st["ejected"],
                "gfkb_count": ready.get("gfkb_count"),
                "brownout": adm.get("brownout"),
                "degraded": bool(dev.get("degraded")),
            }
        healthy = [r for r in replicas.values() if r["healthy"]]
        out = {
            "ok": bool(healthy),
            "replicas": replicas,
            "fleet": {
                "size": len(replicas),
                "healthy": len(healthy),
                "brownout": worst["state"],
                "degraded_any": degraded_any,
            },
        }
        if self.ownership is not None:
            view = self.ownership
            live = [
                rid for rid, st in self._state.items()
                if st["healthy"] and not st["ejected"]
            ]
            out["ownership"] = {
                "enabled": True,
                "epoch": view.epoch,
                "replication": view.replication,
                "members": list(view.members),
                "coverage_holes": view.coverage_holes(live),
            }
        if self.autoscaler is not None:
            out["autoscale"] = self.autoscaler.info()
        return out


def _merge_warn(answered: Dict[str, dict]) -> dict:
    """Top-k merge of per-shard /warn verdicts. Each shard answered from
    its owned+standby slice of the corpus; the global top-k is exactly the
    k best of the union of per-shard top-ks (scores are absolute cosine
    similarities — shard-independent), so the merge preserves single-node
    parity for every rank the shards cover. References gain ``shard``
    provenance; the winning verdict body comes from the shard holding the
    best merged reference (its policy decision saw that evidence)."""
    refs = []
    for rid, body in answered.items():
        for ref in body.get("references") or []:
            if isinstance(ref, dict):
                refs.append({**ref, "shard": rid})
    refs.sort(key=lambda r: -float(r.get("score", 0.0)))
    k = max((len(b.get("references") or []) for b in answered.values()), default=0)
    top = refs[: max(k, 1)] if refs else []
    if top:
        win = answered[top[0]["shard"]]
    else:  # no shard matched anything: keep the most confident verdict
        win = max(
            answered.values(),
            key=lambda b: float(b.get("confidence", 0.0) or 0.0),
        )
    out = dict(win)
    out["references"] = top
    out["degraded"] = any(bool(b.get("degraded")) for b in answered.values())
    return out


def _merge_matches(answered: Dict[str, dict]) -> dict:
    """Top-k merge of per-shard /failures/match candidate lists (same
    absolute-score argument as :func:`_merge_warn`)."""
    matches = []
    for rid, body in answered.items():
        for m in body.get("matches") or []:
            if isinstance(m, dict):
                matches.append({**m, "shard": rid})
    matches.sort(key=lambda m: -float(m.get("score", 0.0)))
    k = max((len(b.get("matches") or []) for b in answered.values()), default=0)
    out = dict(next(iter(answered.values())))
    out["matches"] = matches[: max(k, 1)] if matches else []
    return out


def _hop_outcome(status: Optional[int]) -> str:
    """Span outcome for one hop's HTTP verdict — mirrors the admission
    taxonomy: 429 is a shed, 503 a degraded verdict, other 5xx an error."""
    if status is None or status >= 500 and status != 503:
        return "error"
    if status == 429:
        return "shed"
    if status == 503:
        return "degraded"
    return "ok"


def _route_key(path: str, body: Optional[bytes]) -> str:
    """The shard key for a request: app_id when the body carries one,
    signature_text for raw match calls, first trace's app for batches.
    Unparseable bodies route by empty key (stable arbitrary owner)."""
    if not body:
        return ""
    try:
        obj = json.loads(body)
    except ValueError:
        return ""
    if not isinstance(obj, dict):
        return ""
    if isinstance(obj.get("app_id"), str):
        return obj["app_id"]
    tr = obj.get("trace")
    if isinstance(tr, dict) and isinstance(tr.get("app_id"), str):
        return tr["app_id"]
    trs = obj.get("traces")
    if isinstance(trs, list) and trs and isinstance(trs[0], dict):
        aid = trs[0].get("app_id")
        if isinstance(aid, str):
            return aid
    sig = obj.get("signature_text")
    if isinstance(sig, str):
        return sig
    return ""


def make_router_app(
    backends: Dict[str, str],
    *,
    supervisor=None,
    autoscale=None,
    **router_kw,
) -> web.Application:
    """Build the front-router app over ``{replica_id: base_url}``.

    ``supervisor`` (optional, a :class:`fleet.supervisor.FleetSupervisor`)
    enables the supervise loop: dead replica processes are restarted up to
    ``KAKVEDA_FLEET_RESTARTS`` times each (default 0 — route around only).

    ``autoscale=(min, max)`` (requires ``supervisor``) mounts the elastic
    :class:`fleet.autoscaler.Autoscaler` policy loop instead — replacement
    of dead replicas subsumes the supervise loop's restart duty, so the
    two are never mounted together (a double-start race on the same
    replica index otherwise).

    ``KAKVEDA_FLEET_OWNERSHIP=1`` (or an ``ownership=`` OwnershipView kw)
    turns on sharded ownership: warn/match become scatter-gather merges,
    ejection/re-admission drive epoch-bumped ownership pushes, and
    ``POST /fleet/rebalance`` runs the range-migration protocol."""
    if "ownership" not in router_kw and os.environ.get(
        "KAKVEDA_FLEET_OWNERSHIP", "0"
    ) == "1":
        router_kw["ownership"] = _own.OwnershipView(
            dict(backends),
            replication=_env_int("KAKVEDA_FLEET_REPLICATION", 2),
            vnodes=_env_int("KAKVEDA_FLEET_VNODES", 64),
        )
    router = Router(backends, **router_kw)

    @web.middleware
    async def _trace_mw(request: web.Request, handler):
        """Router-side trace root: extract the caller's W3C context or
        start a new trace folding the request id (same discipline as the
        service middleware, service/app.py) — hop spans under it carry
        per-replica, per-attempt outcome provenance."""
        rid = ensure_request_id(request.headers.get(router._rid_header))
        span = _trace.get_tracer().start_span(
            "router.request",
            traceparent=request.headers.get(_trace.TRACEPARENT_HEADER),
            trace_id=rid, path=request.path, method=request.method, rid=rid,
        )
        span.activate()
        try:
            response = await handler(request)
        except web.HTTPException as e:
            span.deactivate()
            span.end(_hop_outcome(e.status), status=e.status)
            e.headers.setdefault(router._rid_header, rid)
            raise
        except BaseException:
            span.deactivate()
            span.end("error")
            raise
        span.deactivate()
        span.end(_hop_outcome(response.status), status=response.status)
        response.headers.setdefault(router._rid_header, rid)
        return response

    app = web.Application(middlewares=[_trace_mw])
    app[ROUTER_KEY] = router

    async def _startup(app):
        import aiohttp

        router._client = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=router.timeout_s),
            connector=aiohttp.TCPConnector(limit=256),
        )
        await router.probe_once()
        app[_PROBE_TASK_KEY] = asyncio.get_running_loop().create_task(
            router.probe_loop()
        )
        if autoscale is not None and supervisor is not None:
            from kakveda_tpu_torch.fleet.autoscaler import Autoscaler

            mn, mx = autoscale
            scaler = Autoscaler(
                router, supervisor, min_replicas=int(mn), max_replicas=int(mx)
            )
            router.autoscaler = scaler
            app[AUTOSCALER_KEY] = scaler
            app[_AUTOSCALE_TASK_KEY] = asyncio.get_running_loop().create_task(
                scaler.run()
            )
        elif supervisor is not None:
            app[_SUPERVISE_TASK_KEY] = asyncio.get_running_loop().create_task(
                _supervise_loop(router, supervisor)
            )

    async def _cleanup(app):
        for key in (_PROBE_TASK_KEY, _SUPERVISE_TASK_KEY, _AUTOSCALE_TASK_KEY):
            t = app.get(key)
            if t is not None:
                t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass
        if router._client is not None:
            await router._client.close()

    app.on_startup.append(_startup)
    app.on_cleanup.append(_cleanup)

    def _keyed(idempotent: bool, retry_connect_only: bool = False):
        async def handler(request: web.Request):
            body = await request.read()
            key = _route_key(request.path, body)
            if key:
                router.note_key(key)
            return await router.forward(
                request.method, request.path, body or None, key,
                idempotent=idempotent, retry_connect_only=retry_connect_only,
                headers=request.headers,
            )

        return handler

    async def healthz(request):
        return web.json_response({"ok": True, "role": "router"})

    async def readyz(request):
        rep = router.report()
        return web.json_response(rep, status=200 if rep["ok"] else 503)

    async def metrics_ep(request):
        return web.Response(
            body=_metrics.get_registry().render().encode("utf-8"),
            headers={"Content-Type": _metrics.PROMETHEUS_CONTENT_TYPE},
        )

    async def metrics_fleet(request):
        """GET /metrics/fleet — ONE scrape for the whole fleet: every
        replica's exposition plus the router's own, counters/histograms
        summed, gauges tagged per replica (core/metrics.py
        federate_renders). A replica that cannot answer is skipped — a
        partial fleet scrape beats a failed one."""
        import aiohttp

        texts = {"__router__": _metrics.get_registry().render()}

        async def pull(rid: str, base: str):
            try:
                async with router._client.get(base + "/metrics") as r:
                    if r.status == 200:
                        texts[rid] = (await r.read()).decode("utf-8", "replace")
            except (aiohttp.ClientError, asyncio.TimeoutError):
                pass

        await asyncio.gather(
            *(pull(rid, base) for rid, base in list(router.backends.items()))
        )
        return web.Response(
            body=_metrics.federate_renders(texts).encode("utf-8"),
            headers={"Content-Type": _metrics.PROMETHEUS_CONTENT_TYPE},
        )

    async def trace_ring(request):
        tr = _trace.get_tracer()
        try:
            limit = int(request.query["n"]) if "n" in request.query else None
        except ValueError:
            limit = None
        return web.json_response(
            {"plane": tr.plane(), "spans": tr.dump(limit=limit)}
        )

    async def trace_collect(request):
        """GET /trace/{id} — the cross-process collector: the router's
        own ring plus every replica's ``/trace/{id}``, deduped by span id
        and scatter-assembled into one rendered tree. Per-source span
        counts ride along (-1 = replica unreachable) so a hole in the
        tree is attributable."""
        import aiohttp

        tid = request.match_info["trace_id"]
        spans = {s["span_id"]: s for s in _trace.get_tracer().dump(tid)}
        sources = {"__router__": len(spans)}

        async def pull(rid: str, base: str):
            try:
                async with router._client.get(base + "/trace/" + tid) as r:
                    if r.status != 200:
                        sources[rid] = -1
                        return
                    body = json.loads(await r.read())
            except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
                sources[rid] = -1
                return
            n = 0
            for s in body.get("spans") or []:
                sid = s.get("span_id")
                if sid and sid not in spans:
                    spans[sid] = s
                    n += 1
            sources[rid] = n

        await asyncio.gather(
            *(pull(rid, base) for rid, base in list(router.backends.items()))
        )
        ordered = sorted(
            spans.values(), key=lambda s: (s.get("ts") or 0.0, s.get("span_id"))
        )
        return web.json_response({
            "trace_id": tid,
            "spans": ordered,
            "sources": sources,
            "tree": _trace.render_trace(ordered) if ordered else "",
        })

    warm = _keyed(idempotent=True)
    ingest = _keyed(idempotent=False, retry_connect_only=True)
    admin = _keyed(idempotent=False)
    reads = _keyed(idempotent=True)

    def _scattered(merge):
        """Ownership on: warn/match must see every owned range, so they
        fan out and merge instead of forwarding to one replica (which
        only holds its own slice of the corpus)."""
        async def handler(request: web.Request):
            body = await request.read()
            key = _route_key(request.path, body)
            if key:
                router.note_key(key)
            return await router.scatter(
                request.path, body or None, merge, headers=request.headers
            )

        return handler

    if router.ownership is not None:
        warn_handler = _scattered(_merge_warn)
        match_handler = _scattered(_merge_matches)
    else:
        warn_handler = warm
        match_handler = warm

    async def rebalance(request: web.Request):
        """POST /fleet/rebalance — the range-migration protocol driver
        (fleet/ownership.py run_rebalance): snapshot-ship → flip → drain.
        Body: {"add": {"id": rid, "url": url}} to scale out by one, or
        {"members": {rid: url, ...}} for an explicit target membership
        (scale-in drops replicas). 409 with ``flipped`` provenance on a
        failed migration — flipped=false means the old view still rules
        everywhere and a retry is safe."""
        if router.ownership is None:
            return web.json_response(
                {"ok": False, "error": "ownership disabled"}, status=409
            )
        try:
            obj = json.loads(await request.read())
            if not isinstance(obj, dict):
                raise ValueError("body must be an object")
            members = dict(router.ownership.members)
            if isinstance(obj.get("members"), dict):
                members = {str(k): str(v) for k, v in obj["members"].items()}
            add = obj.get("add")
            if isinstance(add, dict):
                members[str(add["id"])] = str(add["url"])
            if not members:
                raise ValueError("empty membership")
        except (ValueError, KeyError, TypeError) as e:
            return web.json_response({"ok": False, "error": str(e)}, status=422)
        try:
            summary = await router.rebalance_to(members)
        except _own.MigrationError as e:
            return web.json_response(
                {"ok": False, "error": str(e), "flipped": e.flipped}, status=409
            )
        return web.json_response({"ok": True, **summary})

    app.add_routes(
        [
            web.get("/healthz", healthz),
            web.get("/readyz", readyz),
            web.get("/metrics", metrics_ep),
            web.get("/metrics/fleet", metrics_fleet),
            web.get("/trace", trace_ring),
            web.get("/trace/{trace_id}", trace_collect),
            web.post("/fleet/rebalance", rebalance),
            # Sharded, idempotent: retry-on-next-replica. Under ownership
            # these scatter-gather across owning shards instead.
            web.post("/warn", warn_handler),
            web.post("/failures/match", match_handler),
            # Sharded ingest: retried only when the connect itself failed.
            web.post("/ingest", ingest),
            web.post("/ingest/batch", ingest),
            # Reads: any healthy replica (replicated GFKB), retryable.
            web.get("/failures", reads),
            web.get("/patterns", reads),
            web.get("/topics", reads),
            web.get("/health/{app_id}", reads),
            # Admin mutations: single attempt, owner-routed.
            web.post("/failures/upsert", admin),
            web.post("/patterns/upsert", admin),
            web.post("/patterns/mine", admin),
            web.post("/snapshot", admin),
            web.post("/subscribe", admin),
            web.post("/unsubscribe", admin),
            web.post("/publish", admin),
        ]
    )
    return app


async def _supervise_loop(router: Router, supervisor) -> None:
    """Restart dead replica processes within the KAKVEDA_FLEET_RESTARTS
    budget (per replica). Routing already survives the gap (ejection +
    retry-on-next); this closes the loop for unattended fleets."""
    budget = _env_int("KAKVEDA_FLEET_RESTARTS", 0)
    restarts: Dict[int, int] = {}
    while True:
        await asyncio.sleep(max(0.5, router.probe_interval_s))
        try:
            for idx in supervisor.poll_dead():
                used = restarts.get(idx, 0)
                if used >= budget:
                    continue
                restarts[idx] = used + 1
                log.warning(
                    "replica %d died; restarting (%d/%d)", idx, used + 1, budget
                )
                await asyncio.get_running_loop().run_in_executor(
                    None, supervisor.start, idx
                )
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — supervision must never die
            log.warning("supervise loop error: %s: %s", type(e).__name__, e)
