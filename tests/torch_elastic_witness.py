"""Phase 19 c's elastic drill on the CPU, in either package (not collected
by pytest).

    python tests/torch_elastic_witness.py jax|port [SPAWN_DELAY_S]

``chip_smoke.py`` phase 19 c runs ``flash_crowd`` (seed 11, 4 + 18 + 12 s,
replica 1 SIGKILLed at surge end) over a 2-replica ownership fleet (R = 2)
under the autoscaler (2..3) with bench.py ``_bench_elastic``'s replica env
and drill knobs. Whether its scale-up finishes before the SIGKILL depends
on how long a new replica takes to be ready: when its range migration
meets the dead replica, the scale-up is ledgered ``error`` and the fleet
never grows. This script runs the same scenario, env and knobs through
either package's router and ``--device cpu`` / ``JAX_PLATFORMS=cpu``
replicas (capacity 1024, dim 512, the reference tests' sizes) and prints
one JSON line: the decisions, the scale log, the warn buckets, the SLO
report and the newcomer's spawn-to-ready seconds. ``SPAWN_DELAY_S`` (default
0) starts every replica that many seconds late (a shell wrapper that sleeps,
then runs the interpreter), so that a CPU replica is ready as late as a
card replica is on a slow host.
"""

import asyncio
import json
import os
import shlex
import sys
import tempfile
import time
import urllib.request
import uuid
from datetime import datetime, timezone
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# chip_smoke.py's ELASTIC_SCENARIO and ELASTIC_ENV (the knobs are read by the
# router when it mounts the autoscaler, the rest by the replicas).
SCENARIO = dict(seed=11, baseline_s=4.0, surge_s=18.0, decay_s=12.0, warn_rps=4.0, surge_x=3.0, bg_rps=12.0,
                apps=8, crash_replica=1, gossip_ttl_s=3.0, max_scale_flaps=1)
KNOBS = dict(KAKVEDA_SCALE_UP_OCC="0.6", KAKVEDA_SCALE_DOWN_OCC="0.2", KAKVEDA_SCALE_DWELL_S="2",
             KAKVEDA_SCALE_COOLDOWN_S="5", KAKVEDA_SCALE_REPLACE_S="3", KAKVEDA_SCALE_REPLACE_BACKOFF_S="3",
             KAKVEDA_SCALE_TICK_S="0.5")
REPLICA_ENV = dict(KAKVEDA_FLEET_OWNERSHIP="1", KAKVEDA_FLEET_REPLICATION="2", KAKVEDA_ADMIT_BACKGROUND="1",
                   KAKVEDA_ADMIT_WARN="64", KAKVEDA_DLQ_AUTO_S="2", KAKVEDA_INDEX_CAPACITY="1024",
                   KAKVEDA_FLEET_GOSSIP_S="0.5", KAKVEDA_GC_TUNE="0")
STUB = "Here is a summary with references.\n\nReferences:\n[1] Smith et al. (2020) A Study on Things.\n"


def main(pkg: str, spawn_delay_s: float = 0.0) -> int:
    os.environ.update(KNOBS)
    if pkg == "jax":
        from kakveda_tpu.fleet.ownership import OwnershipView
        from kakveda_tpu.fleet.router import ROUTER_KEY, make_router_app
        from kakveda_tpu.fleet.supervisor import FleetSupervisor, pick_port_base
        from kakveda_tpu.traffic import evaluate, make_scenario, run_scenario

        extra, kw = {"JAX_PLATFORMS": "cpu"}, {}
    else:
        from kakveda_tpu_torch.fleet.ownership import OwnershipView
        from kakveda_tpu_torch.fleet.router import ROUTER_KEY, make_router_app
        from kakveda_tpu_torch.fleet.supervisor import FleetSupervisor, pick_port_base
        from kakveda_tpu_torch.traffic import evaluate, make_scenario, run_scenario

        extra, kw = {}, {"device": "cpu"}
    from aiohttp.test_utils import TestClient, TestServer

    root = Path(tempfile.mkdtemp(prefix=f"kakveda-elastic-{pkg}-"))
    if spawn_delay_s > 0:  # both supervisors spawn ``sys.executable -m ...``
        slow = root / "python-late"
        slow.write_text(f"#!/bin/sh\nsleep {spawn_delay_s}\nexec {shlex.quote(sys.executable)} \"$@\"\n")
        slow.chmod(0o755)
        sys.executable = str(slow)
    cfg = root / "config.yaml"
    cfg.write_text("failure_matching:\n  similarity_threshold: 0.8\n  embedding_dim: 512\n  top_k: 5\n")
    sup = FleetSupervisor(root, port_base=pick_port_base(5), replicas=2,
                          env={"KAKVEDA_CONFIG_PATH": str(cfg), **REPLICA_ENV, **extra}, **kw)
    sup.autoscale = (2, 3)
    sc = make_scenario("flash_crowd", **SCENARIO)

    def trace(app_id, i):
        return {"trace_id": str(uuid.uuid4()), "ts": datetime.now(timezone.utc).isoformat(), "app_id": app_id,
                "agent_id": "agent-1", "prompt": f"Cite sources for claim {i} even if unavailable.",
                "response": STUB, "model": "stub", "tools": [], "env": {"os": "linux"}}

    async def go():
        app = make_router_app(sup.backend_map(), probe_interval_s=0.3, eject_fails=2, retries=1, timeout_s=15.0,
                              ownership=OwnershipView(sup.backend_map(), replication=2), supervisor=sup,
                              autoscale=(2, 3))
        rc = TestClient(TestServer(app))
        await rc.start_server()
        router = app[ROUTER_KEY]
        scaler = router.autoscaler
        try:
            for a in range(SCENARIO["apps"]):
                r = await rc.post("/ingest/batch", json={"traces": [trace(f"app-{a}", a * 6 + j) for j in range(6)]})
                assert r.status == 200, await r.text()

            async def post(path, body):
                resp = await rc.post(path, json=body)
                await resp.read()
                return resp.status

            spawned = {}

            async def watch():
                while True:
                    for i in range(2, 4):
                        if i not in spawned and sup.log_file(i).exists():
                            spawned[i] = time.monotonic()
                        if i in spawned and f"ready{i}" not in spawned:
                            try:
                                urllib.request.urlopen(sup.url(i) + "/readyz", timeout=0.5).read()
                                spawned[f"ready{i}"] = time.monotonic() - spawned[i]
                            except OSError:
                                pass
                    await asyncio.sleep(0.1)

            w = asyncio.create_task(watch())
            res = await run_scenario(sc, post=post, speed=1.0, supervisor=sup, autoscaler=scaler)
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                dc = scaler.decision_counts()
                if dc.get("replace:ok") and (dc.get("scale_down:ok") or dc.get("scale_up:error")):
                    break
                await asyncio.sleep(1.0)
            w.cancel()
            res.notes["scale_flaps"] = float(scaler.flap_count())
            return res, scaler.decision_counts(), spawned
        finally:
            await rc.close()

    try:
        sup.start_all()
        sup.wait_ready(timeout_s=300.0)
        res, counts, spawned = asyncio.run(go())
    finally:
        sup.stop_all()
    lines = [json.loads(x) for x in (root / "data" / "scale_log.jsonl").read_text().splitlines()]
    print(json.dumps({"package": pkg, "spawn_delay_s": spawn_delay_s, "decisions": counts, "scale_log": lines,
                      "warns": res.class_counts().get("warn", {}), "generated": res.generated("warn"),
                      "slo": evaluate(sc.slo, res).to_dict(),
                      "spawn_to_ready_s": {k: round(v, 2) for k, v in spawned.items() if str(k).startswith("ready")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], float(sys.argv[2]) if len(sys.argv) > 2 else 0.0))
