"""Standalone agent-echo server: ``python -m kakveda_tpu_torch.service.agent_echo``.

The port's copy of ``kakveda_tpu/service/agent_echo.py``: it serves the
external-agent contract (``/health``, ``/capabilities``, ``/invoke``;
``service/app.make_agent_echo_app``) as its own process, so the
dashboard's agent registry and playground reach an agent over real HTTP.
It touches no device.
"""

from __future__ import annotations

import argparse
import asyncio

from aiohttp import web

from kakveda_tpu_torch.core.runtime import setup_logging
from kakveda_tpu_torch.service.app import make_agent_echo_app


async def _serve(host: str, port: int) -> None:
    runner = web.AppRunner(make_agent_echo_app())
    await runner.setup()
    await web.TCPSite(runner, host, port).start()
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        await runner.cleanup()


def main() -> int:
    ap = argparse.ArgumentParser(prog="kakveda_tpu_torch.service.agent_echo")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8120)
    args = ap.parse_args()
    setup_logging(service_name="agent-echo")
    try:
        asyncio.run(_serve(args.host, args.port))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
