"""Phase 17 c's noisy-neighbour load against either package's app, on the CPU.

``chip_smoke.py`` phase 17 c drives the port's app on the card with two
client processes: app-victim keeps 4 /warn in flight alone for 1 s, then
app-noisy keeps 128 in flight beside it for 4 s, at ``KAKVEDA_ADMIT_WARN=32``.
This script runs the same clients (``chip_smoke.spawn_tenant_clients``)
against the JAX package's ``make_app`` or the port's, over a CPU Platform
of capacity 4096 and dim 1024, so the two can be set side by side::

    python tests/torch_noisy_neighbour_witness.py jax
    python tests/torch_noisy_neighbour_witness.py port

It prints one JSON line: the sheds, the victim's p95 alone and under the
flood and their ratio (the reference's noisy-neighbour gate wants it at
most 3), and the serving loop's lag over the flood (a 5 ms sleep's
overshoot: how long the loop's iterations run). Not a test: the numbers
move with the host, and nothing asserts on them.
"""

import asyncio
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BASE_S, FLOOD_S = 1.0, 4.0


def main(which: str) -> int:
    os.environ["KAKVEDA_ADMIT_WARN"] = "32"
    from aiohttp import web

    import chip_smoke as cs

    data = Path(tempfile.mkdtemp(prefix="kakveda-witness-"))
    if which == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from kakveda_tpu.parallel.mesh import create_mesh
        from kakveda_tpu.platform import Platform
        from kakveda_tpu.service.app import make_app

        plat = Platform(data_dir=data, mesh=create_mesh("data:1"), capacity=4096, dim=1024)
    else:
        from kakveda_tpu_torch.platform import Platform
        from kakveda_tpu_torch.service.app import make_app

        plat = Platform(data_dir=data, capacity=4096, dim=1024, device="cpu")

    async def go():
        procs = cs.spawn_tenant_clients([("app-victim", 4, 0.0, BASE_S + FLOOD_S),
                                         ("app-noisy", 128, BASE_S, FLOOD_S)])
        runner = web.AppRunner(make_app(plat))
        await runner.setup()
        port = cs._free_port()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        lags, on = [], [True]

        async def lag():
            while on[0]:
                t = time.perf_counter()
                await asyncio.sleep(0.005)
                lags.append((t, (time.perf_counter() - t - 0.005) * 1e3))

        task = asyncio.ensure_future(lag())
        try:
            rec, t_go = await cs.run_tenant_clients(procs, f"http://127.0.0.1:{port}")
        finally:
            on[0] = False
            await task
            await runner.cleanup()
        return rec, [x for t, x in lags if t_go + BASE_S <= t < t_go + BASE_S + FLOOD_S]

    rec, lags = asyncio.run(go())
    noisy, victim = rec["app-noisy"], rec["app-victim"]
    base = [x[2] for x in victim if x[0] < BASE_S and x[1] == 200]
    flood = [x[2] for x in victim if x[0] >= BASE_S and x[1] == 200]
    b95, v95 = cs._pct(base, 0.95), cs._pct(flood, 0.95)
    print(json.dumps(dict(
        package=which, noisy=len(noisy), noisy_shed=sum(x[1] == 429 for x in noisy),
        noisy_shed_reasons=sorted({x[3] for x in noisy if x[1] == 429}),
        victim=len(victim), victim_shed=sum(x[1] == 429 for x in victim),
        victim_p95_alone_ms=b95, victim_p95_flood_ms=v95, ratio=v95 / b95,
        loop_lag_flood_p50_ms=cs._pct(lags, 0.5), loop_lag_flood_p95_ms=cs._pct(lags, 0.95),
    )))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] not in (["jax"], ["port"]):
        sys.exit("usage: torch_noisy_neighbour_witness.py jax|port")
    sys.exit(main(sys.argv[1]))
