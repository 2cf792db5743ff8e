"""The port's command line: ``up``, ``down`` and ``traffic``.

Port of the fleet's and the traffic harness's part of
``kakveda_tpu/cli/main.py``:

    python -m kakveda_tpu_torch.cli up [--dir D] [--port P] [--device cpu]
    python -m kakveda_tpu_torch.cli up --replicas N [--port-base B] ...
    python -m kakveda_tpu_torch.cli up --replicas N --autoscale MIN:MAX ...
    python -m kakveda_tpu_torch.cli up -d ...      (in the background)
    python -m kakveda_tpu_torch.cli down [--dir D]
    python -m kakveda_tpu_torch.cli traffic record --url U --out F
    python -m kakveda_tpu_torch.cli traffic replay --url U --log F | --scenario S
    python -m kakveda_tpu_torch.cli traffic storm [--device cpu]

``up`` serves the platform API on ``--port`` from ``D/data`` and writes
``D/server.pid``. ``--replicas N`` instead spawns N replica servers on
``B .. B+N-1`` (default ``B`` = ``P + 1``; ``replica-<i>.pid``,
``replica-<i>.log`` and ``data/replica-<i>/`` under ``D``, the manifest
``D/fleet.json``), waits for their readiness (``KAKVEDA_FLEET_READY_S``)
and serves the router (``fleet/router.py``) on ``--port``; the router
restarts a dead replica up to ``KAKVEDA_FLEET_RESTARTS`` times, and its
exit stops every replica. ``--autoscale MIN:MAX`` mounts the elastic
autoscaler (``fleet/autoscaler.py``, the ``KAKVEDA_SCALE_*`` knobs) in the
router instead: scale-up on sustained pressure, lossless drain on idle,
replacement of a dead replica (which subsumes the restart duty); the
manifest carries an ``autoscale`` block and the router's ``/readyz`` the
scaler's ``info()``. ``-d`` re-runs the same command in the
background with its output in ``D/server.log``. ``down`` sends SIGTERM to
the process in ``server.pid`` and then to every ``replica-*.pid`` left
behind, each with a bounded wait.

The index lives on the CUDA card unless ``--device`` names another torch
device; each replica gets the same ``--device``, and a process that asks
for the card and finds none exits non-zero. The dashboard is not ported,
so ``--dashboard-port`` must stay 0.

``traffic`` is the record-replay harness (``kakveda_tpu_torch/traffic/``):
``record`` pulls a live server's ``GET /flightrecorder`` and writes its
``traffic`` ring as a replayable log; ``replay`` drives a log or a named
scenario open-loop against a live server and exits 1 when an SLO gate
fails; ``storm`` runs the seeded storm drill in process against a private
Platform (on the card unless ``--device`` names another torch device; with
no card it exits non-zero), every gate evaluated.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from pathlib import Path


def _pid_path(root: Path) -> Path:
    return root / "server.pid"


def _log_path(root: Path) -> Path:
    return root / "server.log"


def _read_pid(root: Path) -> int | None:
    try:
        return int(_pid_path(root).read_text().strip())
    except (OSError, ValueError):
        return None


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def _cmd_up(args: argparse.Namespace) -> int:
    root = Path(args.dir)
    if args.dashboard_port:
        print("the dashboard is not ported: --dashboard-port must be 0", file=sys.stderr)
        return 2

    if args.replica_index is not None:
        # A fleet replica spawned by the supervisor: a plain server with
        # its own data dir and pid file; its identity arrived in the env.
        from kakveda_tpu_torch.service.main import run_server

        i = int(args.replica_index)
        pidp = root / f"replica-{i}.pid"
        root.mkdir(parents=True, exist_ok=True)
        pidp.write_text(str(os.getpid()))
        try:
            return run_server(
                host=args.host, port=args.port,
                data_dir=str(root / "data" / f"replica-{i}"), device=args.device,
            )
        finally:
            try:
                if int(pidp.read_text().strip()) == os.getpid():
                    pidp.unlink()
            except (OSError, ValueError):
                pass

    pid = _read_pid(root)
    # pid == os.getpid(): we ARE the detached child the parent recorded.
    if pid and pid != os.getpid() and _pid_alive(pid):
        print(f"server already running (pid {pid}); `down` first", file=sys.stderr)
        return 1

    if args.detach:
        import subprocess

        cmd = [
            sys.executable, "-m", "kakveda_tpu_torch.cli", "up",
            "--dir", str(root), "--host", args.host, "--port", str(args.port),
            "--dashboard-port", "0",
        ]
        if args.device:
            cmd += ["--device", args.device]
        if args.replicas:
            cmd += ["--replicas", str(args.replicas), "--port-base", str(args.port_base or 0)]
            if args.autoscale:
                cmd += ["--autoscale", args.autoscale]
        root.mkdir(parents=True, exist_ok=True)
        with open(_log_path(root), "ab") as logf:
            proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT, start_new_session=True)
        _pid_path(root).write_text(str(proc.pid))
        print(f"server starting (pid {proc.pid}); logs: {_log_path(root)}")
        return 0

    if args.replicas:
        return _run_fleet(args, root)

    from kakveda_tpu_torch.service.main import run_server

    root.mkdir(parents=True, exist_ok=True)
    _pid_path(root).write_text(str(os.getpid()))
    try:
        return run_server(host=args.host, port=args.port, data_dir=str(root / "data"), device=args.device)
    finally:
        try:
            if _read_pid(root) == os.getpid():
                _pid_path(root).unlink()
        except OSError:
            pass


def _parse_autoscale(spec: str | None) -> tuple | None:
    """``MIN:MAX`` → ``(min, max)`` with 1 <= min <= max; ValueError else."""
    if not spec:
        return None
    try:
        mn_s, mx_s = str(spec).split(":", 1)
        bounds = (int(mn_s), int(mx_s))
    except ValueError:
        raise ValueError(f"bad --autoscale {spec!r} (want MIN:MAX)") from None
    if not (1 <= bounds[0] <= bounds[1]):
        raise ValueError(f"bad --autoscale bounds {bounds} (want 1 <= min <= max)")
    return bounds


def _run_fleet(args: argparse.Namespace, root: Path) -> int:
    """``up --replicas N [--autoscale MIN:MAX]``: spawn the replicas, wait
    for their readiness, serve the router on ``--port`` until
    SIGINT/SIGTERM, stop them all. With ``--autoscale`` the router runs the
    elastic policy loop (``fleet/autoscaler.py``) instead of the restart
    loop."""
    from aiohttp import web

    from kakveda_tpu_torch.fleet.router import make_router_app
    from kakveda_tpu_torch.fleet.supervisor import FleetSupervisor

    try:
        autoscale = _parse_autoscale(args.autoscale)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    port_base = args.port_base or (args.port + 1)
    sup = FleetSupervisor(
        root, host=args.host, port_base=port_base, replicas=args.replicas,
        router_port=args.port, device=args.device or "cuda",
    )
    if autoscale is not None:
        sup.autoscale = autoscale  # the manifest's autoscale block
    root.mkdir(parents=True, exist_ok=True)
    _pid_path(root).write_text(str(os.getpid()))
    # SIGTERM (`down`) unwinds like SIGINT, so the finally below stops
    # every replica.
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    sup.start_all()
    print(
        f"fleet: {args.replicas} replicas starting on ports {port_base}..{port_base + args.replicas - 1} "
        f"(replica-<i>.pid / replica-<i>.log under {root})"
        + (f" autoscale={autoscale[0]}..{autoscale[1]}" if autoscale else ""),
        flush=True,
    )
    try:
        sup.wait_ready(timeout_s=float(os.environ.get("KAKVEDA_FLEET_READY_S", "240")))
        app = make_router_app(sup.backend_map(), supervisor=sup, autoscale=autoscale)
        print(f"fleet router on http://{args.host}:{args.port}", flush=True)
        web.run_app(app, host=args.host, port=args.port, print=None)
        return 0
    except KeyboardInterrupt:
        return 0
    finally:
        sup.stop_all()
        try:
            if _read_pid(root) == os.getpid():
                _pid_path(root).unlink()
        except OSError:
            pass


def _stop_pid(pid: int, timeout: float) -> bool:
    """SIGTERM and a bounded wait; True when the process is gone."""
    os.kill(pid, signal.SIGTERM)
    deadline = time.time() + timeout
    while _pid_alive(pid) and time.time() < deadline:
        time.sleep(0.2)
    return not _pid_alive(pid)


def _cmd_down(args: argparse.Namespace) -> int:
    """Stop the server in server.pid, then sweep ``replica-*.pid``: a
    fleet parent stops its replicas on exit, but a parent that crashed or
    was killed leaves them behind."""
    root = Path(args.dir)
    rc = 0
    pid = _read_pid(root)
    if pid is None:
        print("no server.pid — nothing to stop")
    elif not _pid_alive(pid):
        print(f"stale server.pid (pid {pid} not running); cleaning up")
        _pid_path(root).unlink(missing_ok=True)
    elif _stop_pid(pid, args.timeout):
        _pid_path(root).unlink(missing_ok=True)
        print(f"stopped (pid {pid})")
    else:
        print(f"pid {pid} did not exit within {args.timeout}s (still running)", file=sys.stderr)
        rc = 1
    for pidp in sorted(root.glob("replica-*.pid")):
        try:
            rpid = int(pidp.read_text().strip())
        except (OSError, ValueError):
            pidp.unlink(missing_ok=True)
            continue
        if _pid_alive(rpid):
            if not _stop_pid(rpid, args.timeout):
                print(f"replica pid {rpid} did not exit within {args.timeout}s", file=sys.stderr)
                rc = 1
                continue
            print(f"stopped replica (pid {rpid})")
        pidp.unlink(missing_ok=True)
    (root / "fleet.json").unlink(missing_ok=True)
    return rc


# The storm drill's admission and brownout settings (the reference CLI's):
# warn sized for DEGRADED throughput — during the device-loss window the
# queue must absorb the host tiers' drain rate without shedding (warn never
# sheds is a gate); background at 1 so the mine flood is the sheddable
# excess.
STORM_LIMITS = {"warn": 64, "ingest": 2, "interactive": 8, "background": 1}
STORM_BROWNOUT = dict(enter=0.85, exit=0.5, dwell_s=0.25)


def run_storm(
    *,
    seed: int = 0,
    duration_s: float = 12.0,
    speed: float = 1.0,
    max_concurrency: int | None = None,
    timeout_s: float = 15.0,
    gossip_ttl_s: float = 5.0,
    device: str | None = None,
    capacity: int = 1 << 10,
    dim: int = 256,
    data_dir: str | Path | None = None,
    seed_batches=(),
    on_response=None,
):
    """The ``traffic storm`` drill in process: a private Platform (on the
    card unless ``device`` names another torch device) behind ``make_app``
    with a private admission controller, the seeded ``storm`` scenario with
    its chaos timeline (a device-loss window, gossiped fleet pressure)
    replayed open-loop through the HTTP stack. Returns ``(scenario,
    result, report)``; the caller decides what a failed gate does.

    ``seed_batches`` (lists of trace dicts) are ingested through
    ``/ingest/batch`` before the scenario starts, so warns have rows to
    match (the CLI seeds none, as the reference's drill does), and one
    ``/patterns/mine`` then emits the seeded clusters, as a running
    service's earlier mines would have.
    ``on_response(path, status, body, t)`` sees every response the
    scenario's dispatches got, ``t`` the seconds from the scenario's start
    to the answer (the chaos timeline's offsets are ``t * speed``)."""
    import asyncio
    import tempfile

    import aiohttp
    from aiohttp.test_utils import TestClient, TestServer

    from kakveda_tpu_torch import traffic as T
    from kakveda_tpu_torch.core import admission as _adm
    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service.app import make_app

    sc = T.make_scenario("storm", seed=seed, duration_s=duration_s, gossip_ttl_s=gossip_ttl_s)
    brown = _adm.BrownoutController(enabled=True, **STORM_BROWNOUT)
    adm = _adm.AdmissionController(limits=dict(STORM_LIMITS), enabled=True, brownout=brown)
    root = Path(data_dir) if data_dir is not None else Path(tempfile.mkdtemp(prefix="kakveda-traffic-storm-"))

    async def _storm():
        plat = Platform(data_dir=root / "data", capacity=capacity, dim=dim, device=device)
        client = TestClient(TestServer(make_app(platform=plat, admission=adm)))
        await client.start_server()
        try:
            for batch in seed_batches:
                r = await client.post("/ingest/batch", json={"traces": list(batch)})
                if r.status != 200:
                    raise RuntimeError(f"storm seed ingest: {r.status} {await r.text()}")
            if seed_batches:
                r = await client.post("/patterns/mine", json={"mode": "auto"})
                if r.status != 200:
                    raise RuntimeError(f"storm seed mine: {r.status} {await r.text()}")
            loop = asyncio.get_running_loop()
            t0 = loop.time()

            async def post(path, body):
                resp = await client.post(path, json=body)
                if on_response is None:
                    await resp.read()
                else:
                    try:
                        payload = await resp.json()
                    except (ValueError, aiohttp.ContentTypeError):  # a non-JSON body
                        payload = None
                    on_response(path, resp.status, payload, loop.time() - t0)
                return resp.status

            return await T.run_scenario(
                sc, post=post, speed=speed, max_concurrency=max_concurrency,
                timeout_s=timeout_s, admission=adm)
        finally:
            await client.close()
            plat.close()

    res = asyncio.run(_storm())
    return sc, res, T.evaluate(sc.slo, res)


def _cmd_traffic(args: argparse.Namespace) -> int:
    """Record-replay traffic harness (``kakveda_tpu_torch/traffic/``):

    * ``record`` — pull GET /flightrecorder from a live server and convert
      its ``traffic`` ring into a replayable JSONL traffic log.
    * ``replay`` — drive a traffic log (or a named ``--scenario``)
      open-loop against a live server at ``--speed``; prints the replay
      accounting and the SLO report; rc 1 on SLO failure.
    * ``storm`` — the in-process storm drill (:func:`run_storm`), SLO-gated.

    Chaos ``faults`` actions arm ``core/faults.py`` IN THIS PROCESS — they
    reach a remote server only via its own ``KAKVEDA_FAULTS_TIMELINE``
    env; ``replay --url`` therefore replays traffic faithfully but leaves
    remote fault windows to the server's timeline.
    """
    import asyncio

    from kakveda_tpu_torch import traffic as T

    if args.action == "record":
        import urllib.request

        with urllib.request.urlopen(args.url.rstrip("/") + "/flightrecorder", timeout=args.timeout) as r:
            payload = json.loads(r.read().decode("utf-8"))
        events = T.from_flightrecorder(payload, seed=args.seed)
        n = T.write_log(args.out, events, meta={"source": args.url, "seed": args.seed})
        print(json.dumps({"out": str(args.out), "events": n}))
        return 0 if n else 1

    async def _replay_against_url(events, chaos=None, notes=None):
        import aiohttp

        base = args.url.rstrip("/")
        async with aiohttp.ClientSession() as sess:
            async def post(path, body):
                async with sess.post(base + path, json=body) as resp:
                    await resp.read()
                    return resp.status

            sc = T.Scenario(name="cli", seed=args.seed, duration_s=0.0, events=events,
                            chaos=chaos or [], notes=notes or {})
            return await T.run_scenario(sc, post=post, speed=args.speed,
                                        max_concurrency=args.max_concurrency, timeout_s=args.timeout)

    if args.action == "replay":
        if args.scenario:
            sc = T.make_scenario(args.scenario, seed=args.seed, duration_s=args.duration)
            events, chaos, notes, slo = sc.events, sc.chaos, sc.notes, sc.slo
        else:
            if not args.log:
                print("replay needs --log or --scenario", file=sys.stderr)
                return 2
            _meta, events = T.read_log(args.log)
            chaos, notes, slo = [], {}, T.SLO()
        res = asyncio.run(_replay_against_url(events, chaos, notes))
        import dataclasses

        rep = T.evaluate(dataclasses.replace(slo, recovery_s=None), res)
        print(json.dumps({"replay": res.to_dict(), "slo": rep.to_dict()}, indent=2))
        print(rep.summary(), file=sys.stderr)
        return 0 if rep.ok else 1

    # storm: the in-process drill, on the card unless --device says otherwise.
    import torch

    if args.device in (None, "cuda") and not torch.cuda.is_available():
        print("traffic storm wants the CUDA card and found none (--device cpu runs it on the CPU)",
              file=sys.stderr)
        return 2
    sc, res, rep = run_storm(
        seed=args.seed, duration_s=args.duration, speed=args.speed,
        max_concurrency=args.max_concurrency, timeout_s=args.timeout,
        gossip_ttl_s=args.gossip_ttl, device=args.device,
    )
    print(json.dumps({"replay": res.to_dict(), "slo": rep.to_dict()}, indent=2))
    print(rep.summary(), file=sys.stderr)
    return 0 if rep.ok else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kakveda_tpu_torch.cli", description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("up", help="start the platform server (or a fleet of them)")
    sp.add_argument("--dir", default=".")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8100)
    sp.add_argument("--dashboard-port", type=int, default=0, help="must be 0: the dashboard is not ported")
    sp.add_argument("-d", "--detach", action="store_true", help="run in the background (server.pid/server.log)")
    sp.add_argument("--replicas", type=int, default=0, help="spawn N service replicas behind a front router on --port")
    sp.add_argument("--port-base", type=int, default=0, help="first replica port (default --port + 1)")
    sp.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                    help="elastic fleet bounds: the router's autoscaler scales replicas between MIN and MAX "
                         "(--replicas is the starting count)")
    sp.add_argument("--device", default=None, help="torch device for the index (default: the CUDA card)")
    # Internal: set by the fleet supervisor on the children it spawns.
    sp.add_argument("--replica-index", type=int, default=None, help=argparse.SUPPRESS)
    sp.set_defaults(fn=_cmd_up)

    sp = sub.add_parser("down", help="stop the server recorded in server.pid (and any replicas)")
    sp.add_argument("--dir", default=".")
    sp.add_argument("--timeout", type=float, default=30.0)
    sp.set_defaults(fn=_cmd_down)

    sp = sub.add_parser("traffic", help="record / replay traffic logs, run SLO-gated storm drills")
    sp.add_argument("action", choices=("record", "replay", "storm"))
    sp.add_argument("--url", default="http://127.0.0.1:8000", help="server base URL (record/replay)")
    sp.add_argument("--out", default="traffic.jsonl", help="record: output traffic log path")
    sp.add_argument("--log", default=None, help="replay: traffic log to drive")
    sp.add_argument("--scenario", default=None,
                    help="replay: named scenario instead of a log (diurnal|hot_key|failure_storm|near_dup|mixed|"
                         "storm|aging)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--duration", type=float, default=12.0, help="scenario duration in seconds")
    sp.add_argument("--speed", type=float, default=1.0, help="replay speed factor (2 = twice real time)")
    sp.add_argument("--max-concurrency", type=int, default=None,
                    help="bounded client concurrency (default KAKVEDA_TRAFFIC_MAX_CONC)")
    sp.add_argument("--timeout", type=float, default=15.0, help="per-request timeout seconds (hung past this)")
    sp.add_argument("--gossip-ttl", type=float, default=5.0, help="storm: gossip TTL / ladder recovery bound")
    sp.add_argument("--device", default=None, help="storm: torch device of its Platform (default: the CUDA card)")
    sp.set_defaults(fn=_cmd_traffic)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
