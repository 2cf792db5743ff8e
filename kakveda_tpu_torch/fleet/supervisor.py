"""Replica process lifecycle — spawn, watch, tear down.

Port of ``kakveda_tpu/fleet/supervisor.py``. ``python -m
kakveda_tpu_torch.cli up --replicas N --port-base P`` (and the drills)
drive fleets through this one class, so the file layout matches the
single-process server's:

    <root>/replica-<i>.pid     child pid (written by the child itself,
                               like server.pid)
    <root>/replica-<i>.log     child stdout/stderr
    <root>/data/replica-<i>/   the child's private data_dir (replicas
                               never share an append log)
    <root>/fleet.json          manifest {router_port, replicas:[{id,url,…}]}

Each child is a plain single-process server (``cli up --replica-index i
--device D``) with its fleet identity in env: ``KAKVEDA_REPLICA_ID``,
``KAKVEDA_FLEET_SELF``, ``KAKVEDA_FLEET_PEERS``, ``KAKVEDA_FLEET_MEMBERS``;
the service app wires gossip and replication from those. ``device`` is
passed to every child: the card unless the caller names another device
(the CPU tests pass ``cpu``), and a child that asked for the card and
finds none exits non-zero.

Teardown is SIGTERM and a bounded wait, then a bounded SIGKILL escalation
(``KAKVEDA_FLEET_STOP_KILL_S``) unless :meth:`FleetSupervisor.may_hold_device_lease`
says the child may hold a device lease. The reference assumes a TPU lease
by default (killing a lease holder wedges that device for hours); a CUDA
context is released by the driver when its process dies, so the port's
children hold no lease unless ``KAKVEDA_FLEET_TPU_LEASE=1`` forces the
marker on.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from kakveda_tpu_torch.core import httpjson

log = logging.getLogger("kakveda.fleet")


def pick_port_base(n: int, host: str = "127.0.0.1") -> int:
    """Find a base port with ``n`` consecutive free ports — drills and tests
    allocate fleets on ephemeral ranges without clashing."""
    for _ in range(64):
        with socket.socket() as s:
            s.bind((host, 0))
            base = s.getsockname()[1]
        if base + n >= 65535:
            continue
        ok = True
        for p in range(base, base + n):
            with socket.socket() as s:
                try:
                    s.bind((host, p))
                except OSError:
                    ok = False
                    break
        if ok:
            return base
    raise RuntimeError("could not find a free consecutive port range")


class FleetSupervisor:
    """Spawn/supervise/tear down N replica processes under one root."""

    def __init__(
        self,
        root: str | Path,
        *,
        host: str = "127.0.0.1",
        port_base: int,
        replicas: int,
        env: Optional[Dict[str, str]] = None,
        router_port: Optional[int] = None,
        device: str = "cuda",
    ):
        self.root = Path(root)
        self.host = host
        self.port_base = int(port_base)
        self.n = int(replicas)
        self.extra_env = dict(env or {})
        self.router_port = router_port
        self.device = str(device)
        self.procs: Dict[int, subprocess.Popen] = {}
        # Indices drained away by the autoscaler: excluded from the
        # active fleet (backend_map/poll/manifest) and recycled first by
        # add_replica so ports and ring positions stay bounded.
        self.retired: set = set()
        # (min, max) when the fleet runs under an autoscaler — stamped
        # into the manifest.
        self.autoscale: Optional[tuple] = None
        self.root.mkdir(parents=True, exist_ok=True)

    # -- identity --------------------------------------------------------

    def replica_id(self, i: int) -> str:
        return f"r{i}"

    def url(self, i: int) -> str:
        return f"http://{self.host}:{self.port_base + i}"

    def active_indices(self) -> List[int]:
        """Spawned-slot indices minus the retired ones — the fleet."""
        return [i for i in range(self.n) if i not in self.retired]

    def urls(self) -> List[str]:
        return [self.url(i) for i in self.active_indices()]

    def backend_map(self) -> Dict[str, str]:
        """{replica_id: url} — what make_router_app consumes."""
        return {self.replica_id(i): self.url(i) for i in self.active_indices()}

    def pid_file(self, i: int) -> Path:
        return self.root / f"replica-{i}.pid"

    def log_file(self, i: int) -> Path:
        return self.root / f"replica-{i}.log"

    def data_dir(self, i: int) -> Path:
        return self.root / "data" / f"replica-{i}"

    # -- spawn -----------------------------------------------------------

    def _child_env(self, i: int) -> Dict[str, str]:
        env = dict(os.environ)
        # Never override PYTHONPATH bare: add the repo root this package
        # was imported from, keep whatever else is there.
        repo = str(Path(__file__).resolve().parents[2])
        parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        if repo not in parts:
            parts.append(repo)
        env["PYTHONPATH"] = os.pathsep.join(parts)
        active = self.active_indices()
        peers = [self.url(j) for j in active if j != i]
        env.update(
            KAKVEDA_REPLICA_ID=self.replica_id(i),
            KAKVEDA_FLEET_SELF=self.url(i),
            KAKVEDA_FLEET_PEERS=",".join(peers),
            # Seed membership for sharded ownership (fleet/ownership.py);
            # inert unless the child also gets KAKVEDA_FLEET_OWNERSHIP=1
            # (usually via extra_env below). Children spawned later by
            # add_replica see the grown membership; earlier children learn
            # it from the epoch'd /fleet/ownership push instead.
            KAKVEDA_FLEET_MEMBERS=",".join(
                f"{self.replica_id(j)}={self.url(j)}" for j in active
            ),
        )
        env.update(self.extra_env)
        return env

    def start(self, i: int) -> subprocess.Popen:
        """Spawn replica ``i`` detached-ish (own session so a router
        SIGINT doesn't tear the fleet down un-supervised)."""
        cmd = [
            sys.executable, "-m", "kakveda_tpu_torch.cli", "up",
            "--dir", str(self.root),
            "--host", self.host,
            "--port", str(self.port_base + i),
            "--dashboard-port", "0",
            "--replica-index", str(i),
            "--device", self.device,
        ]
        self.data_dir(i).mkdir(parents=True, exist_ok=True)
        logf = open(self.log_file(i), "ab")
        proc = subprocess.Popen(
            cmd, stdout=logf, stderr=subprocess.STDOUT,
            env=self._child_env(i), start_new_session=True,
        )
        logf.close()
        self.procs[i] = proc
        return proc

    def start_all(self) -> None:
        for i in self.active_indices():
            self.start(i)
        self.write_manifest()

    def add_replica(self) -> int:
        """Scale out by one: recycle the lowest retired slot (its port
        and ring position come back) or spawn replica ``n`` on the next
        port, then refresh the manifest. The caller (the router's
        /fleet/rebalance, the autoscaler, a drill) still owns the range
        migration — this only creates the process. Returns the index."""
        if self.retired:
            i = min(self.retired)
            self.retired.discard(i)
        else:
            i = self.n
            self.n = i + 1
        self.start(i)
        self.write_manifest()
        return i

    def retire(self, i: int) -> None:
        """Drop a (stopped) replica from the active fleet — the
        autoscaler's scale-down epilogue. The slot recycles via
        add_replica; the data dir stays (its rows were migrated away,
        logs keep their forensic value)."""
        self.retired.add(i)
        self.procs.pop(i, None)
        self.pid_file(i).unlink(missing_ok=True)
        self.write_manifest()

    # -- watch -----------------------------------------------------------

    def alive(self, i: int) -> bool:
        p = self.procs.get(i)
        return p is not None and p.poll() is None

    def poll_dead(self) -> List[int]:
        return [
            i for i in self.active_indices()
            if i in self.procs and not self.alive(i)
        ]

    def wait_ready(self, timeout_s: float = 180.0,
                   only: Optional[Iterable[int]] = None) -> None:
        """Block until every replica's /readyz answers — replica start-up
        (torch import, CUDA context, the index's allocation) dominates
        fleet bring-up. ``only`` narrows the wait to those indices, so an
        unrelated peer dying mid-spawn cannot fail a scale-up."""
        deadline = time.monotonic() + timeout_s
        pending = set(self.active_indices() if only is None else only)
        while pending:
            for i in sorted(pending):
                if not self.alive(i):
                    tail = ""
                    try:
                        tail = self.log_file(i).read_text(errors="replace")[-2000:]
                    except OSError:
                        pass
                    raise RuntimeError(
                        f"replica {i} exited during startup; log tail:\n{tail}"
                    )
                try:
                    httpjson.request("GET", self.url(i) + "/readyz", timeout=2.0)
                    pending.discard(i)
                except OSError:
                    pass
            if pending:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"replicas {sorted(pending)} not ready within {timeout_s}s"
                    )
                time.sleep(0.25)

    # -- teardown --------------------------------------------------------

    def may_hold_device_lease(self, i: int) -> bool:
        """The device-lease marker for the SIGKILL escalation below.
        ``KAKVEDA_FLEET_TPU_LEASE=1`` forces it on. Otherwise False: the
        port's children hold CUDA contexts, which the driver releases when
        the process dies (the chip smoke's phase 18 b checks that the
        card's memory comes back after a SIGKILL)."""
        env = {**os.environ, **self.extra_env}
        return env.get("KAKVEDA_FLEET_TPU_LEASE") == "1"

    def stop(self, i: int, timeout_s: float = 20.0, sig: int = signal.SIGTERM) -> None:
        """Signal + bounded wait, then a bounded SIGKILL escalation so a
        wedged replica cannot hang `down`/scale-down forever — except on
        a replica that may hold the device lease, which is left alone
        (warned) by design."""
        p = self.procs.get(i)
        if p is None or p.poll() is not None:
            return
        try:
            p.send_signal(sig)
        except ProcessLookupError:
            return
        try:
            p.wait(timeout=timeout_s)
            return
        except subprocess.TimeoutExpired:
            pass
        if self.may_hold_device_lease(i):
            log.warning("replica %d did not exit within %.0fs; leaving it "
                        "(never SIGKILL a process that may hold a device "
                        "lease)", i, timeout_s)
            return
        grace = 5.0
        try:
            grace = float(os.environ.get("KAKVEDA_FLEET_STOP_KILL_S", "") or 5.0)
        except ValueError:
            pass
        log.warning("replica %d did not exit within %.0fs; escalating to "
                    "SIGKILL (no device-lease marker; reap grace %.0fs)",
                    i, timeout_s, grace)
        try:
            p.kill()
            p.wait(timeout=max(0.1, grace))
        except ProcessLookupError:
            return
        except subprocess.TimeoutExpired:
            log.warning("replica %d still not reaped %.0fs after SIGKILL",
                        i, grace)

    def stop_all(self, timeout_s: float = 20.0) -> None:
        for i in list(self.procs):
            self.stop(i, timeout_s=timeout_s)
        for i in list(self.procs):
            self.pid_file(i).unlink(missing_ok=True)
        (self.root / "fleet.json").unlink(missing_ok=True)

    # -- manifest --------------------------------------------------------

    def write_manifest(self) -> None:
        manifest = {
            "router_port": self.router_port,
            "host": self.host,
            "port_base": self.port_base,
            "ownership": {
                "enabled": self.extra_env.get("KAKVEDA_FLEET_OWNERSHIP")
                == "1"
                or os.environ.get("KAKVEDA_FLEET_OWNERSHIP") == "1",
                "replication": int(
                    self.extra_env.get("KAKVEDA_FLEET_REPLICATION")
                    or os.environ.get("KAKVEDA_FLEET_REPLICATION", "2")
                    or 2
                ),
            },
            "replicas": [
                {
                    "id": self.replica_id(i),
                    "url": self.url(i),
                    "pid_file": str(self.pid_file(i)),
                    "log_file": str(self.log_file(i)),
                    "data_dir": str(self.data_dir(i)),
                }
                for i in self.active_indices()
            ],
        }
        if self.autoscale is not None:
            manifest["autoscale"] = {
                "min": int(self.autoscale[0]),
                "max": int(self.autoscale[1]),
                "scale_log": str(self.root / "data" / "scale_log.jsonl"),
            }
        (self.root / "fleet.json").write_text(json.dumps(manifest, indent=2))


def read_manifest(root: str | Path) -> Optional[dict]:
    """The fleet manifest written at spawn, or None (single-process)."""
    p = Path(root) / "fleet.json"
    try:
        return json.loads(p.read_text())
    except (OSError, ValueError):
        return None
