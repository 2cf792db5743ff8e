"""Crash-point recovery certification for the GFKB lifecycle.

Port of ``kakveda_tpu/index/crashsweep.py`` (the port keeps its own copy):
the same cycle, the same sites, the same certificates, run against the
port's GFKB on ``--device`` (``cpu`` in the tests, ``cuda`` on the card).

The sweep runs a fixed lifecycle cycle — row aging, an organic
resurrection, two fresh upserts, then a compaction — in a CHILD process
per kill point, with one crash point armed by
``KAKVEDA_FAULTS_CRASH=site:nth`` (``core/faults.py``): the n-th pass
through that site hard-kills the child with ``os._exit(137)`` (no
exception, no ``finally``, no buffered-write flush). A fresh VERIFY child
then opens the crashed store, and the parent certifies what it recovered:

* every pre-existing record survives, and every recovered record's
  ``(version, occurrences)`` equals its pre-cycle or post-cycle value —
  never a hybrid, never a parse error;
* the recovered tombstone set is a subset of the pre, mid (aging only)
  and post tombstones;
* top-1 warn parity on the held-out stable queries (rows the cycle never
  touches): the recovered store answers as the oracles do, and never with
  a tombstoned row.

A child that exits 0 never reached the armed site ``nth`` times: that site
is exhausted and the sweep moves on, so it finds every kill offset itself.

Entry points: :func:`run_sweep` and
``python -m kakveda_tpu_torch.index.crashsweep [--device cuda]`` (prints a
summary JSON; exit 1 on a corrupt recovery).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

__all__ = ["run_sweep", "DEFAULT_SITES", "CRASH_RC"]

CRASH_RC = 137

# Every durable write seam of the cycle, in the order it reaches them:
# gfkb.append is the shared JSONL append (failures and tombstone logs),
# gfkb.tombstone the per-transition tombstone write, gfkb.snapshot the
# checkpoint write, and the three compact_* sites bracket the fenced swap.
DEFAULT_SITES = (
    "gfkb.tombstone",
    "gfkb.append",
    "gfkb.snapshot",
    "gfkb.compact_delta",
    "gfkb.compact_fence",
    "gfkb.compact_swap",
)

_PKG_ROOT = Path(__file__).resolve().parents[2]


def _sig(i: int) -> str:
    return f"crashsweep failure signature {i} stack frame worker pool"


def _ftype(i: int) -> str:
    return "oom" if i % 2 else "timeout"


def _child_env(crash: str = "") -> Dict[str, str]:
    """The parent's environment without any KAKVEDA_* knob (the cycle must
    not inherit auto-compaction or ambient chaos arming), the package on
    the path, and exactly one crash spec."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("KAKVEDA_")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(_PKG_ROOT), env.get("PYTHONPATH", "")) if p)
    if crash:
        env["KAKVEDA_FAULTS_CRASH"] = crash
    env["KAKVEDA_CRASHSWEEP_CHILD"] = "1"
    return env


def _spawn(
    mode: str,
    data_dir: Path,
    *,
    capacity: int,
    dim: int,
    rows: int,
    aged: int,
    device: str,
    crash: str = "",
    extra: Sequence[str] = (),
    timeout: float = 300.0,
) -> subprocess.CompletedProcess:
    cmd = [
        sys.executable, "-m", "kakveda_tpu_torch.index.crashsweep",
        "--mode", mode, "--data-dir", str(data_dir), "--capacity", str(capacity),
        "--dim", str(dim), "--rows", str(rows), "--aged", str(aged), "--device", device,
        *extra,
    ]
    return subprocess.run(
        cmd, env=_child_env(crash), capture_output=True, text=True, timeout=timeout
    )


def _check(proc: subprocess.CompletedProcess, what: str) -> dict:
    if proc.returncode != 0:
        raise RuntimeError(
            f"crashsweep {what} child failed rc={proc.returncode}:\n{proc.stderr[-2000:]}"
        )
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ----------------------------------------------------------------------
# child modes (may be hard-killed)
# ----------------------------------------------------------------------


def _open_store(args):
    from kakveda_tpu_torch.index.gfkb import GFKB

    return GFKB(data_dir=Path(args.data_dir), capacity=args.capacity, dim=args.dim, device=args.device)


def _child_seed(args) -> None:
    """The pre-cycle store: two row cohorts with a real wall-clock gap
    between them, so the cycle's TTL boundary ages the old cohort and keeps
    the young one. Prints the cohort boundary timestamps."""
    kb = _open_store(args)
    for i in range(args.aged):
        kb.upsert_failure(
            failure_type=_ftype(i), signature_text=_sig(i), app_id=f"app-{i % 3}",
            impact_severity="high",
        )
    t_old = time.time()
    time.sleep(args.gap)
    t_new = time.time()
    for i in range(args.aged, args.rows):
        kb.upsert_failure(
            failure_type=_ftype(i), signature_text=_sig(i), app_id=f"app-{i % 3}",
            impact_severity="high",
        )
    kb.close()
    print(json.dumps({"t_old": t_old, "t_new": t_new}))


def _child_cycle(args) -> None:
    """One deterministic lifecycle cycle through the public calls; the
    armed crash point (if any) kills the process somewhere inside."""
    kb = _open_store(args)
    kb.age_rows(ttl_s=args.ttl, now=args.now)
    if args.phase == "aging":
        kb.close()
        print(json.dumps({"cycle": "aging"}))
        return
    # Organic resurrection of aged row 0.
    kb.upsert_failure(
        failure_type=_ftype(0), signature_text=_sig(0), app_id="app-res", impact_severity="high"
    )
    for i in (args.rows, args.rows + 1):
        kb.upsert_failure(
            failure_type=_ftype(i), signature_text=_sig(i), app_id=f"app-{i % 3}",
            impact_severity="high",
        )
    kb.compact()
    kb.close()
    print(json.dumps({"cycle": "complete"}))


def _child_verify(args) -> None:
    """Open the (possibly crash-recovered) store and print its canonical
    state: per-record (version, occurrences), net tombstones, top-1 warn
    answer per sweep signature, compaction generation."""
    kb = _open_store(args)
    with kb._lock:
        records = {str(r.failure_id): [r.version, r.occurrences] for r in kb._records}
        tombs = {str(kb._records[s].failure_id): reason for s, reason in kb._tombstoned.items()}
    queries = [_sig(i) for i in range(args.rows + 2)]
    top1: Dict[str, Optional[str]] = {}
    for q, matches in zip(queries, kb.match_batch(queries)):
        top1[q] = str(matches[0].failure_id) if matches else None
    out = {
        "records": records,
        "tombstones": tombs,
        "top1": top1,
        "generation": kb.lifecycle_info()["compact_generation"],
        "device": str(kb.device),
    }
    kb.close()
    print(json.dumps(out))


# ----------------------------------------------------------------------
# parent sweep
# ----------------------------------------------------------------------


def run_sweep(
    *,
    rows: int = 10,
    aged: int = 5,
    sites: Sequence[str] = DEFAULT_SITES,
    max_nth: int = 60,
    capacity: int = 64,
    dim: int = 256,
    gap: float = 1.2,
    device: str = "cuda",
    keep_dirs: bool = False,
) -> dict:
    """Sweep every kill offset of one lifecycle cycle; certify recovery.

    Returns ``{"kill_points": n, "corrupt_recoveries": n, "failures":
    [...], "sites": {site: points}, "stable_queries": n, "device": ...}``.
    A non-empty ``failures`` list means a crash offset from which the
    restart recovered a state that is neither pre-, mid- nor post-cycle."""
    root = Path(tempfile.mkdtemp(prefix="kakveda-crashsweep-"))
    common = dict(capacity=capacity, dim=dim, rows=rows, aged=aged, device=device)
    try:
        seed_dir = root / "seed"
        seed_dir.mkdir()
        seed = _check(_spawn("seed", seed_dir, **common, extra=["--gap", str(gap)]), "seed")
        # TTL boundary between the cohorts; the injected clock is the real one.
        now = time.time()
        ttl = now - (seed["t_old"] + seed["t_new"]) / 2.0
        cyc = ["--ttl", str(ttl), "--now", str(now)]

        pre = _check(_spawn("verify", seed_dir, **common), "verify-pre")

        # MID oracle: aging only. A crash between a row's aging and its
        # resurrection recovers to this clean prefix of the cycle.
        def oracle(name: str, phase: Sequence[str]) -> dict:
            work = root / name
            shutil.copytree(seed_dir, work)
            _check(_spawn("cycle", work, **common, extra=[*cyc, *phase]), f"cycle-{name}")
            return _check(_spawn("verify", work, **common), f"verify-{name}")

        def crash_cycle(site: str, nth: int) -> tuple:
            work = root / f"{site.replace('.', '_')}-{nth}"
            shutil.copytree(seed_dir, work)
            return work, _spawn("cycle", work, **common, extra=cyc, crash=f"{site}:{nth}")

        # Every child below works on its own copy of the seed (taken after
        # verify-pre opened it, as a serial sweep would), so the two
        # oracles, the sites, and each site's next kill offset beside the
        # recovery of the one before run side by side: only the wall
        # changes, the certificates do not (a recovery is certified once
        # both oracles are in).
        with ThreadPoolExecutor(max_workers=2 + 2 * len(sites)) as pool:
            oracles = [pool.submit(oracle, *a) for a in (("mid", ["--phase", "aging"]), ("post", []))]
            box: List[List[str]] = []
            lock = threading.Lock()

            def stable_queries() -> List[str]:
                """Queries the cycle never touches: stable top-1 across the oracles."""
                mid, post = (f.result() for f in oracles)
                with lock:
                    if not box:
                        box.append([
                            _sig(i)
                            for i in range(aged, rows)
                            if pre["top1"].get(_sig(i)) == mid["top1"].get(_sig(i)) == post["top1"].get(_sig(i))
                        ])
                return box[0]

            def certify(rec: dict) -> List[str]:
                mid, post = (f.result() for f in oracles)
                return _certify(rec, pre, mid, post, stable_queries())

            def sweep_site(site: str) -> tuple:
                """Every kill offset of one site: (points, failures)."""
                points, failures = 0, []
                nxt = pool.submit(crash_cycle, site, 1)
                for nth in range(1, max_nth + 1):
                    work, proc = nxt.result()
                    if proc.returncode == 0:
                        shutil.rmtree(work, ignore_errors=True)
                        return points, failures  # site exhausted: the cycle has < nth passes
                    if nth < max_nth:
                        nxt = pool.submit(crash_cycle, site, nth + 1)
                    if proc.returncode != CRASH_RC:
                        failures.append({
                            "site": site, "nth": nth, "kind": "bad_exit",
                            "rc": proc.returncode, "stderr": proc.stderr[-1000:],
                        })
                        shutil.rmtree(work, ignore_errors=True)
                        continue
                    points += 1
                    try:
                        rec = _check(_spawn("verify", work, **common), "verify")
                        errs = certify(rec)
                    except Exception as e:  # noqa: BLE001 — a recovery crash IS the finding
                        errs = [f"recovery raised: {type(e).__name__}: {e}"]
                    if errs:
                        failures.append({"site": site, "nth": nth, "errors": errs})
                    if not keep_dirs:
                        shutil.rmtree(work, ignore_errors=True)
                failures.append({"site": site, "kind": "not_exhausted", "max_nth": max_nth})
                return points, failures

            swept = [f.result() for f in [pool.submit(sweep_site, site) for site in sites]]
            stable, post = stable_queries(), oracles[1].result()

        results: Dict[str, int] = {site: points for site, (points, _) in zip(sites, swept)}
        failures: List[dict] = [f for _, fs in swept for f in fs]
        return {
            "kill_points": sum(results.values()),
            "corrupt_recoveries": len(failures),
            "failures": failures,
            "sites": results,
            "stable_queries": len(stable),
            "device": post["device"],
            "root": str(root) if keep_dirs else None,
        }
    finally:
        if not keep_dirs:
            shutil.rmtree(root, ignore_errors=True)


def _certify(rec: dict, pre: dict, mid: dict, post: dict, stable: Sequence[str]) -> List[str]:
    """The recovery contract, as checks over canonical verify output."""
    errs: List[str] = []
    for fid in pre["records"]:
        if fid not in rec["records"]:
            errs.append(f"committed record {fid} lost")
    for fid, vo in rec["records"].items():
        if vo != pre["records"].get(fid) and vo != post["records"].get(fid):
            errs.append(
                f"record {fid} hybrid state {vo} "
                f"(pre {pre['records'].get(fid)}, post {post['records'].get(fid)})"
            )
    allowed = set(pre["tombstones"]) | set(mid["tombstones"]) | set(post["tombstones"])
    for fid in rec["tombstones"]:
        if fid not in allowed:
            errs.append(f"unexpected tombstone {fid}")
    for q in stable:
        want = pre["top1"].get(q)
        got = rec["top1"].get(q)
        if got != want:
            errs.append(f"top-1 parity broke for {q!r}: {got} != {want}")
        if got is not None and got in rec["tombstones"]:
            errs.append(f"top-1 for {q!r} is tombstoned row {got}")
    return errs


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=("seed", "cycle", "verify", "sweep"), default="sweep")
    p.add_argument("--data-dir", default="")
    p.add_argument("--capacity", type=int, default=64)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--rows", type=int, default=10)
    p.add_argument("--aged", type=int, default=5)
    p.add_argument("--gap", type=float, default=1.2)
    p.add_argument("--ttl", type=float, default=0.0)
    p.add_argument("--now", type=float, default=0.0)
    p.add_argument("--phase", choices=("full", "aging"), default="full")
    p.add_argument("--max-nth", type=int, default=60)
    p.add_argument("--device", default="cuda", help="the children's device (cuda or cpu)")
    args = p.parse_args(argv)
    if args.mode == "sweep":
        out = run_sweep(
            rows=args.rows, aged=args.aged, capacity=args.capacity, dim=args.dim,
            max_nth=args.max_nth, device=args.device,
        )
        print(json.dumps(out, indent=2))
        return 1 if out["corrupt_recoveries"] else 0
    if not args.data_dir:
        p.error("--data-dir is required for child modes")
    {"seed": _child_seed, "cycle": _child_cycle, "verify": _child_verify}[args.mode](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
