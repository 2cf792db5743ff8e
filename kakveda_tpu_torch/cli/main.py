"""The port's command line: ``up`` and ``down``.

Port of the fleet's part of ``kakveda_tpu/cli/main.py``:

    python -m kakveda_tpu_torch.cli up [--dir D] [--port P] [--device cpu]
    python -m kakveda_tpu_torch.cli up --replicas N [--port-base B] ...
    python -m kakveda_tpu_torch.cli up -d ...      (in the background)
    python -m kakveda_tpu_torch.cli down [--dir D]

``up`` serves the platform API on ``--port`` from ``D/data`` and writes
``D/server.pid``. ``--replicas N`` instead spawns N replica servers on
``B .. B+N-1`` (default ``B`` = ``P + 1``; ``replica-<i>.pid``,
``replica-<i>.log`` and ``data/replica-<i>/`` under ``D``, the manifest
``D/fleet.json``), waits for their readiness (``KAKVEDA_FLEET_READY_S``)
and serves the router (``fleet/router.py``) on ``--port``; the router
restarts a dead replica up to ``KAKVEDA_FLEET_RESTARTS`` times, and its
exit stops every replica. ``-d`` re-runs the same command in the
background with its output in ``D/server.log``. ``down`` sends SIGTERM to
the process in ``server.pid`` and then to every ``replica-*.pid`` left
behind, each with a bounded wait.

The index lives on the CUDA card unless ``--device`` names another torch
device; each replica gets the same ``--device``, and a process that asks
for the card and finds none exits non-zero. The dashboard is not ported,
so ``--dashboard-port`` must stay 0, and ``--autoscale`` (the reference's
autoscaler) is refused until the autoscaler is ported; ``status``,
``doctor``, ``trace``, ``dlq`` and the set-up wizard are not ported yet.
"""

from __future__ import annotations

import argparse
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
    if args.autoscale:
        print("the fleet autoscaler is not ported yet: run a fixed --replicas N fleet", file=sys.stderr)
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


def _run_fleet(args: argparse.Namespace, root: Path) -> int:
    """``up --replicas N``: spawn the replicas, wait for their readiness,
    serve the router on ``--port`` until SIGINT/SIGTERM, stop them all."""
    from aiohttp import web

    from kakveda_tpu_torch.fleet.router import make_router_app
    from kakveda_tpu_torch.fleet.supervisor import FleetSupervisor

    port_base = args.port_base or (args.port + 1)
    sup = FleetSupervisor(
        root, host=args.host, port_base=port_base, replicas=args.replicas,
        router_port=args.port, device=args.device or "cuda",
    )
    root.mkdir(parents=True, exist_ok=True)
    _pid_path(root).write_text(str(os.getpid()))
    # SIGTERM (`down`) unwinds like SIGINT, so the finally below stops
    # every replica.
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    sup.start_all()
    print(
        f"fleet: {args.replicas} replicas starting on ports {port_base}..{port_base + args.replicas - 1} "
        f"(replica-<i>.pid / replica-<i>.log under {root})",
        flush=True,
    )
    try:
        sup.wait_ready(timeout_s=float(os.environ.get("KAKVEDA_FLEET_READY_S", "240")))
        app = make_router_app(sup.backend_map(), supervisor=sup)
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
    sp.add_argument("--autoscale", default=None, metavar="MIN:MAX", help="refused: the autoscaler is not ported")
    sp.add_argument("--device", default=None, help="torch device for the index (default: the CUDA card)")
    # Internal: set by the fleet supervisor on the children it spawns.
    sp.add_argument("--replica-index", type=int, default=None, help=argparse.SUPPRESS)
    sp.set_defaults(fn=_cmd_up)

    sp = sub.add_parser("down", help="stop the server recorded in server.pid (and any replicas)")
    sp.add_argument("--dir", default=".")
    sp.add_argument("--timeout", type=float, default=30.0)
    sp.set_defaults(fn=_cmd_down)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
