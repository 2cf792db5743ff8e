"""The port's command line: init | up | down | status | reset | logs | dlq | traffic | trace | compact | doctor | version.

Port of ``kakveda_tpu/cli/main.py``, verb for verb:

    python -m kakveda_tpu_torch.cli init [--dir D] [--force] [--wizard | --yes]
    python -m kakveda_tpu_torch.cli up [--dir D] [--port P] [--dashboard-port Q] [--device cpu]
    python -m kakveda_tpu_torch.cli up --replicas N [--port-base B] ...
    python -m kakveda_tpu_torch.cli up --replicas N --autoscale MIN:MAX ...
    python -m kakveda_tpu_torch.cli up -d ...      (in the background)
    python -m kakveda_tpu_torch.cli down [--dir D]
    python -m kakveda_tpu_torch.cli status [--dir D] | reset [--dir D] --yes | logs [--dir D] [-f]
    python -m kakveda_tpu_torch.cli dlq [list | replay] [--dir D]
    python -m kakveda_tpu_torch.cli traffic record --url U --out F
    python -m kakveda_tpu_torch.cli traffic replay --url U --log F | --scenario S
    python -m kakveda_tpu_torch.cli traffic storm [--device cpu]
    python -m kakveda_tpu_torch.cli trace TRACE_ID --url U
    python -m kakveda_tpu_torch.cli compact [--dir D] [--device cpu] [--age-ttl S] [--collapse N]
    python -m kakveda_tpu_torch.cli doctor [--dir D] | version

``up`` serves the platform API on ``--port`` from ``D/data`` and writes
``D/server.pid``; the dashboard (``dashboard/``) listens on
``--dashboard-port`` (default 8110, 0 turns it off) in the same process,
over the same ``Platform``. ``--replicas N`` instead spawns N replica
servers on ``B .. B+N-1`` (default ``B`` = ``P + 1``; ``replica-<i>.pid``,
``replica-<i>.log`` and ``data/replica-<i>/`` under ``D``, the manifest
``D/fleet.json``; each replica with ``--dashboard-port 0``), waits for
their readiness (``KAKVEDA_FLEET_READY_S``) and serves the router
(``fleet/router.py``) on ``--port``; the router restarts a dead replica up
to ``KAKVEDA_FLEET_RESTARTS`` times, and its exit stops every replica.
``--autoscale MIN:MAX`` mounts the elastic autoscaler
(``fleet/autoscaler.py``, the ``KAKVEDA_SCALE_*`` knobs) in the router
instead: scale-up on sustained pressure, lossless drain on idle,
replacement of a dead replica (which subsumes the restart duty); the
manifest carries an ``autoscale`` block and the router's ``/readyz`` the
scaler's ``info()``. ``-d`` re-runs the same command in the background
with its output in ``D/server.log``. ``down`` sends SIGTERM to the process
in ``server.pid`` and then to every ``replica-*.pid`` left behind, each
with a bounded wait.

The index lives on the CUDA card unless ``--device`` names another torch
device; each replica gets the same ``--device``, and a process that asks
for the card and finds none exits non-zero. ``compact`` opens the GFKB on
the card too (``--device cpu`` for a host without one), where the
reference pins JAX to the CPU. ``doctor`` checks torch, the card, a
computation on it, the kernel build (``ops/_build``) and the native
library where the reference checks JAX; on a host without a card it notes
that the entry points want one, as the reference notes its fall back to
the CPU. ``init`` writes ``config/config.yaml`` and, with ``--wizard`` or
``--yes``, a ``.env`` that ``up``, ``doctor`` and ``status`` load (the
real environment wins). Live probes (``doctor``, ``status``) speak HTTP
through ``core/httpjson`` where the reference uses ``httpx``.

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
import shutil
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


def _get_json(url: str, timeout: float = 2.0):
    """``GET url`` → its parsed JSON, whatever its status (``httpx.get(...)
    .json()``); an ``OSError`` when no answer came, ``ValueError`` for a
    body that is not JSON."""
    from kakveda_tpu_torch.core import httpjson

    return json.loads(httpjson.answer("GET", url, timeout=timeout)[1])


def _cmd_version(args: argparse.Namespace) -> int:
    from kakveda_tpu_torch import __version__

    print(f"kakveda-tpu-torch {__version__}")
    return 0


def _cmd_init(args: argparse.Namespace) -> int:
    from kakveda_tpu_torch.core.config import write_default_config

    root = Path(args.dir)
    cfg = root / "config" / "config.yaml"
    if cfg.exists() and not args.force:
        print(f"config already exists at {cfg} (use --force to overwrite)")
    else:
        write_default_config(cfg)
        print(f"wrote {cfg}")
    (root / "data").mkdir(parents=True, exist_ok=True)
    print(f"data dir ready at {root / 'data'}")
    if args.wizard or args.yes:
        from kakveda_tpu_torch.cli.wizard import run_wizard

        run_wizard(root, assume_yes=args.yes)
    return 0


def _cmd_doctor(args: argparse.Namespace) -> int:
    checks = []

    def check(name, fn):
        try:
            detail = fn()
            checks.append((name, True, detail))
        except Exception as e:  # noqa: BLE001 — doctor reports, never crashes
            checks.append((name, False, f"{type(e).__name__}: {e}"))

    def _torch():
        import torch

        return f"{torch.__version__} cuda={torch.version.cuda}"

    def _cuda():
        import torch

        if not torch.cuda.is_available():
            return "no CUDA card visible here (the entry points want one; --device cpu runs them on the CPU)"
        major, minor = torch.cuda.get_device_capability(0)
        return f"{torch.cuda.get_device_name(0)} (sm_{major}{minor}) devices={torch.cuda.device_count()}"

    def _device_compute():
        import torch

        dev = "cuda" if torch.cuda.is_available() else "cpu"
        x = torch.ones((128, 128), dtype=torch.float32, device=dev)
        y = float((x @ x).sum())
        return f"matmul ok on {dev} (sum={y:.0f})" + ("" if dev == "cuda" else " (no card: on the CPU)")

    def _kernel_build():
        import torch

        from kakveda_tpu_torch.ops import _build

        names = _build.targets()
        if not torch.cuda.is_available():
            return f"{len(names)} sm_90a libraries, not built: no CUDA card here"
        t0 = time.perf_counter()
        _build.build(names)
        return f"{len(names)} sm_90a libraries ready under {_build.BUILD_DIR} ({time.perf_counter() - t0:.1f} s)"

    def _native():
        from kakveda_tpu_torch import native

        st = native.status()
        return (f"C++ host tier loaded ({st['lib']})" if st["available"]
                else f"pure-python fallback (KAKVEDA_NATIVE={st['mode']}; g++ builds it at first use)")

    def _config_parse():
        from kakveda_tpu_torch.core.config import ConfigStore

        cs = ConfigStore()
        return f"threshold={cs.similarity_threshold()} top_k={cs.match_top_k()}"

    def _jwt_secret():
        from kakveda_tpu_torch.core.runtime import get_runtime_config

        rc = get_runtime_config(service_name="doctor")
        if rc.env == "production" and rc.dashboard_jwt_secret == "dev-secret-change-me":
            raise RuntimeError("production with default JWT secret — set DASHBOARD_JWT_SECRET")
        return "set" if rc.dashboard_jwt_secret != "dev-secret-change-me" else "dev default (fine outside production)"

    def _serving_levers():
        """The env-tunable serving configuration in one line: what the
        engine will run with (``models/serving.py``'s knobs)."""
        e = os.environ.get
        parts = [
            f"continuous={'on' if e('KAKVEDA_SERVE_CONTINUOUS', '1') != '0' else 'OFF'}",
            f"slots={e('KAKVEDA_SERVE_SLOTS', '8')}",
            f"window={e('KAKVEDA_SERVE_WINDOW', 'auto')}",
            f"chunk={e('KAKVEDA_SERVE_CHUNK', '8')}",
            f"pipeline={'on' if e('KAKVEDA_SERVE_PIPELINE', '1') != '0' else 'OFF'}",
            f"prefix={'on' if e('KAKVEDA_SERVE_PREFIX', '1') != '0' else 'OFF'}",
            f"spec_k={e('KAKVEDA_SERVE_SPEC', '0')}",
            f"spec_gate=warmup{e('KAKVEDA_SERVE_SPEC_WARMUP', '8')}"
            f"/calib{e('KAKVEDA_SERVE_SPEC_CALIB', '2')}"
            f"/reprobe{e('KAKVEDA_SERVE_SPEC_REPROBE', '256')}",
            f"quant={e('KAKVEDA_QUANT', 'none')}",
            f"kv_quant={e('KAKVEDA_KV_QUANT', 'none')}",
        ]
        if e("KAKVEDA_HBM_BUDGET"):
            parts.append(f"hbm_budget={e('KAKVEDA_HBM_BUDGET')}")
        return " ".join(parts)

    def _redis():
        url = os.environ.get("KAKVEDA_REDIS_URL")
        if not url:
            return "not configured (in-memory revocation/rate-limit)"
        # Redact userinfo: the URL may carry a password, and doctor output
        # lands in terminals and CI logs.
        safe = url.split("@", 1)[-1] if "@" in url else url.split("//", 1)[-1]
        raise RuntimeError(f"KAKVEDA_REDIS_URL points at {safe}, but the port keeps revocations and rate "
                           "limits in memory only (no Redis tier)")

    def _fleet():
        """Per-replica health and the fleet's admission mode, from the
        manifest ``up --replicas`` writes (fleet.json): the router's
        /readyz report for operators without curl."""
        from kakveda_tpu_torch.fleet.supervisor import read_manifest

        manifest = read_manifest(args.dir)
        if not manifest:
            return "single-process (no fleet.json)"
        from kakveda_tpu_torch.core import httpjson

        parts = []
        worst = "normal"
        live_ids = []
        epochs = {}
        for rep in manifest.get("replicas", []):
            rid = rep.get("id", "?")
            pidp = Path(rep.get("pid_file", ""))
            alive = False
            try:
                alive = _pid_alive(int(pidp.read_text().strip()))
            except (OSError, ValueError):
                pass
            mode = "down"
            if alive:
                try:
                    body = json.loads(httpjson.request("GET", rep["url"] + "/readyz", timeout=2.0)[1])
                    adm = body.get("admission", {})
                    mode = adm.get("brownout", "?")
                    steps = ("normal", "no_spec", "clamped", "shed_background", "shed_interactive")
                    if mode in steps and steps.index(mode) > steps.index(worst):
                        worst = mode
                    live_ids.append(rid)
                    own = body.get("ownership") or {}
                    if own.get("enabled"):
                        epochs[rid] = int(own.get("epoch", 0))
                except (OSError, ValueError):
                    mode = "unreachable"
            parts.append(f"{rid}={'up' if alive else 'DOWN'}/{mode}")
        if any("DOWN" in p or "unreachable" in p for p in parts):
            raise RuntimeError(" ".join(parts))
        own_note = ""
        if epochs:
            # Sharded ownership: every reachable replica must agree on the
            # epoch, and every key range needs a live holder.
            if len(set(epochs.values())) > 1:
                raise RuntimeError(f"{' '.join(parts)} ownership epochs DISAGREE: {epochs}")
            from kakveda_tpu_torch.fleet.ownership import OwnershipView

            top = max(epochs, key=epochs.get)
            url = next(r["url"] for r in manifest["replicas"] if r.get("id") == top)
            try:
                view = OwnershipView.from_dict(_get_json(url + "/fleet/ownership"))
            except (OSError, ValueError, KeyError) as e:
                raise RuntimeError(f"ownership view unreadable: {e}") from e
            holes = view.coverage_holes(live_ids)
            if holes:
                raise RuntimeError(
                    f"{' '.join(parts)} COVERAGE HOLES: {holes} ranges have zero live holders (epoch {epochs[top]})"
                )
            own_note = f" ownership=epoch:{epochs[top]}/R:{view.replication}/holes:0"
        scale_note = ""
        auto = manifest.get("autoscale")
        if auto:
            # The elastic fleet: its bounds and the last ledgered decision.
            scale_note = f" autoscale={auto.get('min')}..{auto.get('max')}"
            last = None
            try:
                lines = Path(auto.get("scale_log", "")).read_text().splitlines()
                if lines:
                    last = json.loads(lines[-1])
            except (OSError, ValueError):
                pass
            if last:
                scale_note += f" last={last.get('action')}:{last.get('outcome')}→{last.get('target')}"
        return f"{' '.join(parts)} fleet_mode={worst}{own_note}{scale_note}"

    def _tenant_plane():
        """Tenant fairness posture from the live server's /readyz
        admission.tenants block. A tenant pinned at 100 % shed (many sheds,
        no admits) is an error; no live server is fine."""
        pid = _read_pid(Path(args.dir))
        if not (pid and _pid_alive(pid)):
            return "no live server (probes /readyz when one is up)"
        body = _get_json(args.url + "/readyz")
        tenants = (body.get("admission") or {}).get("tenants")
        if not tenants:
            return "admission reports no tenant block (older server?)"
        if not tenants.get("fair", False):
            return "KAKVEDA_TENANT_FAIR=0 — global FIFO, no isolation"
        pinned = [row for row in tenants.get("top_shed", []) if row.get("sheds", 0) >= 20 and row.get("admits", 0) == 0]
        note = (
            f"fair=on table={tenants.get('table_size')}/"
            f"{tenants.get('table_max')} share_cap={tenants.get('max_share')} "
            f"promotions={tenants.get('promotions') or {}}"
        )
        top = tenants.get("top_shed", [])
        if top:
            note += f" top_shed={top[0].get('tenant')}:{top[0].get('sheds')}"
        if pinned:
            raise RuntimeError(
                f"{note} — tenant(s) pinned at 100% shed: "
                + ", ".join(f"{r['tenant']} ({r['sheds']} sheds, 0 admits)" for r in pinned)
            )
        return note

    def _replay_budget():
        """Durability against the recovery-time budget:
        KAKVEDA_GFKB_REPLAY_BUDGET_S > 0 makes a replay estimate past it an
        error to fix with ``compact``."""
        data = Path(args.dir) / "data"
        if not data.exists():
            return "no data dir yet"
        post = _durability_posture(data)
        budget = float(os.environ.get("KAKVEDA_GFKB_REPLAY_BUDGET_S", "0"))
        est = post["replay_estimate_s"]
        note = (
            f"replay≈{est}s ({post['replayable_bytes']}B replayable, "
            f"generation {post['compact_generation']}, "
            f"{post['tombstoned_rows']} tombstoned)"
        )
        if budget > 0 and est > budget:
            raise RuntimeError(f"{note} exceeds KAKVEDA_GFKB_REPLAY_BUDGET_S={budget} — run `compact`")
        return note

    check("python", lambda: sys.version.split()[0])
    check("replay budget", _replay_budget)
    check("tenant plane", _tenant_plane)
    check("fleet", _fleet)
    check("torch", _torch)
    check("cuda", _cuda)
    check("device compute", _device_compute)
    check("kernel build", _kernel_build)
    check("native extension", _native)
    check("config", lambda: str(Path(os.environ.get("KAKVEDA_CONFIG_PATH", "config/config.yaml")).resolve()))
    check("serving levers", _serving_levers)
    check("config parse", _config_parse)
    check("jwt secret", _jwt_secret)
    check("redis", _redis)
    check("data dir writable", lambda: _writable(os.environ.get("KAKVEDA_DATA_DIR", "data")))

    ok = all(c[1] for c in checks)
    for name, good, detail in checks:
        print(f"[{'ok' if good else 'FAIL'}] {name}: {detail}")
    return 0 if ok else 1


def _writable(d: str) -> str:
    p = Path(d)
    p.mkdir(parents=True, exist_ok=True)
    probe = p / ".probe"
    probe.write_text("ok")
    probe.unlink()
    return str(p.resolve())


def _cmd_reset(args: argparse.Namespace) -> int:
    data = Path(args.dir) / "data"
    if not data.exists():
        print(f"nothing to reset at {data}")
        return 0
    if not args.yes:
        print(f"would delete {data} — re-run with --yes to confirm")
        return 1
    shutil.rmtree(data)
    print(f"deleted {data}")
    return 0


def _durability_posture(data: Path) -> dict:
    """Each store's durability posture from the files alone (no GFKB
    built, safe beside a live server). Replay time is replayable bytes over
    ``KAKVEDA_GFKB_REPLAY_RATE`` (bytes/s, default 4 MiB/s); the replayable
    bytes start at the snapshot manifest's ``log_offset``, so a compaction
    shrinks the estimate."""
    rate = float(os.environ.get("KAKVEDA_GFKB_REPLAY_RATE", str(4 << 20)))
    stores = {}
    replayable = 0
    for name in ("failures", "patterns", "applied_events", "tombstones"):
        try:
            size = (data / f"{name}.jsonl").stat().st_size
        except OSError:
            size = 0
        stores[name] = {"bytes": size}
        replayable += size
    manifest = {}
    try:
        manifest = json.loads((data / "snapshot" / "manifest.json").read_text())
    except (OSError, ValueError):
        pass
    offset = int(manifest.get("log_offset", 0) or 0)
    # The snapshot replaces the log's replay up to log_offset.
    stores["failures"]["replayable_bytes"] = max(0, stores["failures"]["bytes"] - offset)
    replayable -= min(offset, stores["failures"]["bytes"])
    tomb = 0
    f = data / "tombstones.jsonl"
    if f.exists():
        net = {}
        try:
            for ln in f.read_text().splitlines():
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    rec = json.loads(ln)
                except ValueError:
                    continue  # a torn tail: the store's replay handles it
                if rec.get("op") == "tomb":
                    net[rec.get("id")] = rec.get("reason")
                else:
                    net.pop(rec.get("id"), None)
            tomb = len(net)
        except OSError:
            pass
    compact = manifest.get("compact") or {}
    return {
        "stores": stores,
        "snapshot_rows": int(manifest.get("n", 0) or 0),
        "compact_generation": int(compact.get("generation", 0) or 0),
        "last_compact_ts": float(compact.get("ts", 0.0) or 0.0),
        "tombstoned_rows": tomb,
        "replayable_bytes": max(0, replayable),
        "replay_estimate_s": round(max(0, replayable) / rate, 3),
    }


def _cmd_status(args: argparse.Namespace) -> int:
    root = Path(args.dir)
    data = root / "data"
    status = {"data_dir": str(data), "exists": data.exists()}
    for name in ("failures", "patterns", "health"):
        f = data / f"{name}.jsonl"
        status[name] = sum(1 for ln in f.read_text().splitlines() if ln.strip()) if f.exists() else 0
    if data.exists():
        status["durability"] = _durability_posture(data)
    pid = _read_pid(root)
    status["server"] = {"pid": pid, "running": _pid_alive(pid)} if pid else {"pid": None, "running": False}
    if status["server"]["running"]:
        # The tenant plane from the live server's /readyz, best effort.
        try:
            tenants = (_get_json(args.url + "/readyz").get("admission") or {}).get("tenants")
            if tenants:
                status["tenants"] = tenants
        except Exception:  # noqa: BLE001 — status reports, never crashes
            pass
    replicas = {}
    for pidp in sorted(root.glob("replica-*.pid")):
        try:
            rpid = int(pidp.read_text().strip())
        except (OSError, ValueError):
            continue
        replicas[pidp.stem] = {"pid": rpid, "running": _pid_alive(rpid)}
    if replicas:
        status["replicas"] = replicas
        from kakveda_tpu_torch.fleet.supervisor import read_manifest

        manifest = read_manifest(root) or {}
        if (manifest.get("ownership") or {}).get("enabled"):
            # Sharded ownership: each replica's ranges, resident rows and
            # acknowledged epoch, from its /readyz.
            ownership = {}
            for rep in manifest.get("replicas", []):
                rid = rep.get("id", "?")
                try:
                    body = _get_json(rep["url"] + "/readyz")
                    own = body.get("ownership") or {}
                    ownership[rid] = {
                        "epoch": own.get("epoch"),
                        "owned_arcs": own.get("owned_arcs"),
                        "standby_arcs": own.get("standby_arcs"),
                        "rows": own.get("rows"),
                        "gfkb_count": body.get("gfkb_count"),
                    }
                except (OSError, ValueError):
                    ownership[rid] = {"unreachable": True}
            status["ownership"] = ownership
        auto = manifest.get("autoscale")
        if auto:
            # The elastic fleet: its bounds and the tail of the decision
            # ledger (data/scale_log.jsonl).
            block = {"min": auto.get("min"), "max": auto.get("max")}
            try:
                lines = Path(auto.get("scale_log", "")).read_text().splitlines()
                block["decisions"] = len(lines)
                block["last_decisions"] = [json.loads(ln) for ln in lines[-5:] if ln.strip()]
            except (OSError, ValueError):
                block["decisions"] = 0
            status["autoscale"] = block
    print(json.dumps(status, indent=2))
    return 0


def _cmd_compact(args: argparse.Namespace) -> int:
    """Offline failures-log compaction: open the GFKB on the data dir (on
    the card unless ``--device`` names another torch device), optionally
    age and collapse, checkpoint and rewrite, print the posture delta.
    Refuses while a recorded server owns the store: the GFKB is single
    writer, and a live process would keep appending into the old inode."""
    root = Path(args.dir)
    data = root / "data"
    pid = _read_pid(root)
    if pid and _pid_alive(pid) and not args.force:
        print(
            f"server pid {pid} is running against {data} — stop it first "
            f"(or --force if you know the pid file is stale)",
            file=sys.stderr,
        )
        return 1
    if not (data / "failures.jsonl").exists():
        print(f"nothing to compact: no failures log under {data}")
        return 0
    before = _durability_posture(data)
    from kakveda_tpu_torch.core.config import ConfigStore
    from kakveda_tpu_torch.index.gfkb import GFKB

    dim = args.dim or ConfigStore().embedding_dim()
    kb = GFKB(data_dir=data, capacity=args.capacity, dim=dim, device=args.device)
    try:
        if args.age_ttl > 0:
            aged = kb.age_rows(ttl_s=args.age_ttl)
            print(f"aged out {aged['tombstoned']} rows (ttl {args.age_ttl}s)")
        if args.collapse > 1:
            col = kb.collapse_duplicates(min_cluster=args.collapse)
            print(f"collapsed {col['collapsed']} rows across {col['clusters']} clusters")
        out = kb.compact()
    finally:
        kb.close()
    after = _durability_posture(data)
    print(
        json.dumps(
            {
                "compact": out,
                "replay_estimate_s": {"before": before["replay_estimate_s"], "after": after["replay_estimate_s"]},
                "durability": after,
            },
            indent=2,
        )
    )
    return 0


def _cmd_up(args: argparse.Namespace) -> int:
    root = Path(args.dir)
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
                dashboard_port=args.dashboard_port or None,
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
            "--dashboard-port", str(args.dashboard_port),
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
        return run_server(host=args.host, port=args.port, data_dir=str(root / "data"), device=args.device,
                          dashboard_port=args.dashboard_port or None)
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


def _cmd_dlq(args: argparse.Namespace) -> int:
    """Inspect or replay the event bus's dead-letter queue
    (``data/dlq.jsonl``: events whose URL delivery exhausted its retries or
    met an open breaker). ``list`` prints per-(topic, url) counts and the
    newest error, no event bodies; ``replay`` re-POSTs every event and
    rewrites the file with what still fails."""
    dlq = Path(args.dir) / "data" / "dlq.jsonl"
    if args.action == "replay":
        from kakveda_tpu_torch.events.bus import replay_dlq_file

        out = replay_dlq_file(dlq, timeout=args.timeout)
        print(json.dumps(out, indent=2))
        return 0 if out["failed"] == 0 else 1
    if not dlq.exists():
        print(json.dumps({"path": str(dlq), "events": 0, "entries": []}, indent=2))
        return 0
    groups: dict = {}
    total = 0
    for line in dlq.read_text(encoding="utf-8").splitlines():
        if not line.strip():
            continue
        total += 1
        try:
            rec = json.loads(line)
            g = groups.setdefault((rec.get("topic"), rec.get("url")), {"count": 0, "last_error": None, "last_ts": 0})
            g["count"] += 1
            if rec.get("ts", 0) >= g["last_ts"]:
                g["last_ts"] = rec.get("ts", 0)
                g["last_error"] = rec.get("error")
        except ValueError:
            groups.setdefault(("<malformed>", None), {"count": 0})["count"] += 1
    print(json.dumps({
        "path": str(dlq),
        "events": total,
        "entries": [{"topic": t, "url": u, **g} for (t, u), g in sorted(groups.items(), key=str)],
    }, indent=2))
    return 0


def _cmd_trace(args: argparse.Namespace) -> int:
    """Fetch one trace from a running server or router and render its tree
    (against a router the id is assembled across the fleet), with the
    per-source span counts when present."""
    import urllib.error
    import urllib.request

    url = args.url.rstrip("/") + "/trace/" + args.trace_id
    try:
        with urllib.request.urlopen(url, timeout=args.timeout) as r:
            body = json.loads(r.read().decode("utf-8"))
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"trace fetch failed: {url}: {e}", file=sys.stderr)
        return 1
    spans = body.get("spans") or []
    if not spans:
        print(f"no spans for trace {args.trace_id} at {args.url}")
        return 1
    tree = body.get("tree")
    if not tree:
        from kakveda_tpu_torch.core.trace import render_trace

        tree = render_trace(spans)
    print(tree)
    if body.get("sources"):
        print(json.dumps({"sources": body["sources"]}))
    return 0


def _cmd_logs(args: argparse.Namespace) -> int:
    """Tail server.log (written by ``up -d``), optionally following."""
    logp = _log_path(Path(args.dir))
    if not logp.exists():
        print(f"no log file at {logp} (start with `up --detach`)", file=sys.stderr)
        return 1
    lines = logp.read_text(encoding="utf-8", errors="replace").splitlines()
    for ln in lines[-args.tail:] if args.tail > 0 else []:
        print(ln)
    if not args.follow:
        return 0
    with logp.open("r", encoding="utf-8", errors="replace") as f:
        f.seek(0, os.SEEK_END)
        try:
            while True:
                ln = f.readline()
                if ln:
                    print(ln, end="")
                else:
                    time.sleep(0.5)
        except KeyboardInterrupt:
            pass
    return 0


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

    sp = sub.add_parser("init", help="write default config + create data dir")
    sp.add_argument("--dir", default=".", help="project root")
    sp.add_argument("--force", action="store_true")
    sp.add_argument("--wizard", action="store_true", help="interactive .env setup")
    sp.add_argument("--yes", action="store_true", help="write .env with all defaults, no questions")
    sp.set_defaults(fn=_cmd_init)

    sp = sub.add_parser("up", help="start the platform server and the dashboard (or a fleet of servers)")
    sp.add_argument("--dir", default=".")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8100)
    sp.add_argument("--dashboard-port", type=int, default=8110, help="0 disables the dashboard")
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

    sp = sub.add_parser("status", help="show data-store row counts")
    sp.add_argument("--dir", default=".")
    sp.add_argument("--url", default="http://127.0.0.1:8100", help="live server base URL for the tenant-plane probe")
    sp.set_defaults(fn=_cmd_status)

    sp = sub.add_parser("reset", help="delete local data stores")
    sp.add_argument("--dir", default=".")
    sp.add_argument("--yes", action="store_true")
    sp.set_defaults(fn=_cmd_reset)

    sp = sub.add_parser("logs", help="tail server.log")
    sp.add_argument("--dir", default=".")
    sp.add_argument("-n", "--tail", type=int, default=50)
    sp.add_argument("-f", "--follow", action="store_true")
    sp.set_defaults(fn=_cmd_logs)

    sp = sub.add_parser("dlq", help="inspect / replay the bus dead-letter queue")
    sp.add_argument("action", nargs="?", choices=("list", "replay"), default="list")
    sp.add_argument("--dir", default=".")
    sp.add_argument("--timeout", type=float, default=5.0, help="per-POST replay timeout")
    sp.set_defaults(fn=_cmd_dlq)

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

    sp = sub.add_parser("trace", help="fetch + render one causal trace (router assembles fleet-wide)")
    sp.add_argument("trace_id", help="32-hex trace id (x-request-id of the request)")
    sp.add_argument("--url", default="http://localhost:8000")
    sp.add_argument("--timeout", type=float, default=5.0)
    sp.set_defaults(fn=_cmd_trace)

    sp = sub.add_parser(
        "compact",
        help="offline GFKB lifecycle maintenance: optional aging/collapse, "
             "then checkpoint+delta log compaction (server must be down)",
    )
    sp.add_argument("--dir", default=".")
    sp.add_argument("--capacity", type=int, default=1 << 14, help="GFKB device capacity (match the server's)")
    sp.add_argument("--dim", type=int, default=0, help="embedding dim (0 = from config)")
    sp.add_argument("--age-ttl", type=float, default=0.0,
                    help="tombstone rows idle longer than this many seconds before compacting (0 = skip aging)")
    sp.add_argument("--collapse", type=int, default=0,
                    help="collapse mining clusters with ≥ N near-duplicate members to one exemplar (0 = skip)")
    sp.add_argument("--force", action="store_true", help="compact even though server.pid looks alive")
    sp.add_argument("--device", default=None, help="torch device of the GFKB (default: the CUDA card)")
    sp.set_defaults(fn=_cmd_compact)

    sp = sub.add_parser("doctor", help="check the runtime environment")
    sp.add_argument("--dir", default=".", help="project root (for .env)")
    sp.add_argument("--url", default="http://127.0.0.1:8100", help="live server base URL for the tenant-plane probe")
    sp.set_defaults(fn=_cmd_doctor)

    sp = sub.add_parser("version", help="print version")
    sp.set_defaults(fn=_cmd_version)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    # Apply the wizard-written .env (the real environment wins); ``init``
    # must not load it, since it may be about to (re)write the file.
    if args.cmd in ("up", "doctor", "status"):
        from kakveda_tpu_torch.cli.wizard import load_dotenv

        load_dotenv(Path(getattr(args, "dir", ".")) / ".env")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
