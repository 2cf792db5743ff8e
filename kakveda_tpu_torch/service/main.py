"""Server entry point: ``python -m kakveda_tpu_torch.service``.

Port of ``kakveda_tpu/service/main.py`` without the dashboard (ROADMAP
Queue 1 item 8), multi-host init or the compile ledger. It reads ``data_dir`` and ``index_capacity`` from the runtime
config (``KAKVEDA_DATA_DIR``, ``KAKVEDA_INDEX_CAPACITY``), loads the native
library, builds the ``Platform`` on the card (or on ``device``) and serves
the API until SIGINT or SIGTERM. On the way out it writes a GFKB snapshot
(best effort, as the reference does) and closes the GFKB so the buffered
log lines reach the disk: the next start restores the snapshot, replays
only the log tail, and serves its first mine incrementally. With
``KAKVEDA_PROFILE_DIR`` set it first captures a trace of one warm pre-flight
warn there (``core/profiling.profile``). What the reference starts with
the service starts here too: the fault plane's env arming
(``KAKVEDA_FAULTS``, ``KAKVEDA_FAULTS_CRASH`` and the timed
``KAKVEDA_FAULTS_TIMELINE``, read when ``core/faults`` is imported, so a
timeline's offsets count from the process's start), and, in ``make_app``,
the OTel middleware (``KAKVEDA_OTEL_ENABLED``), the token bucket
(``KAKVEDA_RATELIMIT_RPS``) and the loop-stall watchdog
(``KAKVEDA_SANITIZE``).
"""

from __future__ import annotations

import asyncio
import gc
import logging
import os
import signal

from aiohttp import web

from kakveda_tpu_torch import native
from kakveda_tpu_torch.core import profiling
from kakveda_tpu_torch.core.runtime import get_runtime_config, setup_logging
from kakveda_tpu_torch.core.schemas import WarningRequest
from kakveda_tpu_torch.platform import Platform
from kakveda_tpu_torch.service.app import make_app

log = logging.getLogger("kakveda.service")


async def _serve(plat: Platform, host: str, port: int) -> None:
    runner = web.AppRunner(make_app(plat))
    await runner.setup()
    try:
        await web.TCPSite(runner, host, port).start()
        restore = plat.gfkb.lifecycle_info()["restore"]
        log.info("platform API on http://%s:%d (gfkb entries: %d, restored from a snapshot: %d, device %s)",
                 host, port, plat.gfkb.count, restore["rows"] if restore else 0, plat.device)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
    finally:
        await runner.cleanup()


def run_server(
    host: str = "127.0.0.1",
    port: int = 8100,
    data_dir: str | None = None,
    device: str | None = None,
) -> int:
    """Serve until SIGINT/SIGTERM (from the main thread); returns 0."""
    setup_logging(service_name="kakveda-tpu-torch")
    cfg = get_runtime_config(service_name="kakveda-tpu-torch")
    # Build the library before listening: never inside a request.
    native.load()
    plat = Platform(data_dir=data_dir or cfg.data_dir, capacity=cfg.index_capacity, device=device)
    try:
        # Generational-GC tuning for the streaming path: ingest allocates
        # ~2k short-lived objects per 512-batch, which trips gen-2
        # collections every ~13 batches. Freezing the start-up heap takes it
        # out of every collection; raised thresholds amortize the rest.
        # KAKVEDA_GC_TUNE=0 keeps CPython's defaults.
        if os.environ.get("KAKVEDA_GC_TUNE", "1") != "0":
            gc.collect()
            gc.freeze()
            gc.set_threshold(50_000, 20, 20)
        # Zero-code operator profiling: KAKVEDA_PROFILE_DIR=/path captures a
        # trace of one warm pre-flight warn at startup.
        logdir = profiling.startup_profile_dir()
        if logdir:
            probe = WarningRequest(app_id="_profile", prompt="startup profile probe", tools=[], env={})
            plat.warn(probe)  # warm outside the trace
            with profiling.profile(logdir):
                plat.warn(probe)
        asyncio.run(_serve(plat, host, port))
    finally:
        # Graceful shutdown snapshot: the next start restores it instead of
        # re-embedding the whole GFKB and re-mining it.
        try:
            plat.gfkb.snapshot()
            log.info("gfkb snapshot written (%d entries)", plat.gfkb.count)
        except Exception as e:  # noqa: BLE001 — shutdown must not fail on this
            log.warning("shutdown snapshot failed: %s", e, exc_info=True)
        plat.close()
        log.info("gfkb closed (%d entries)", plat.gfkb.count)
    return 0
