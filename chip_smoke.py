"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout (it imports
``kakveda_tpu_torch`` from beside this file, and nothing of JAX or of the
JAX package). Phases, each of which raises on failure (exit code != 0):

1. the card: its name and power limit (``nvidia-smi``), TF32 off;
2. build every kernel from ``kakveda_tpu_torch/csrc`` (one ``nvcc`` each,
   in parallel);
3. each kernel against its plain PyTorch version at the main path's shape —
   ``fused_topk`` over a 1,048,576 × 2048 bf16 index (~90 % valid) for
   B ∈ {1, 64}, k ∈ {5, 8}: scores within 1e-4, ids equal wherever the plain
   scores of neighbouring ranks differ by more than 1e-4, exact
   lowest-index ties on duplicated rows; warm times from CUDA events beside
   the bound and one PyTorch yardstick call (never used by the port);
4. the main path, with launch counts zeroed just before and read just
   after: ``Platform(capacity=2^20, dim=2048)`` on the card runs the demo
   flow (warn → ingest for app-A/app-B, repeats that degrade app-A, a
   follow-up warn), then ``ingest_batch`` of 4096 traces in batches of 512
   and ``warn_batch`` of 64, whose matches are checked against the plain
   top-k of the same index.

Prints a ``{"kernels": [...]}`` line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import datetime, timezone
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
ROWS, DIM = 1 << 20, 2048
ATOL = 1e-4  # bf16 inputs, f32 sums taken in another order than the plain version
STUB_RESPONSE = (
    "Here is a summary with references.\n\n"
    "References:\n"
    "[1] Smith et al. (2020) A Study on Things.\n"
    "[2] Doe (2021) Another Paper.\n"
)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of per-launch CUDA-event times after a warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_topk(v, i, rv, ri, what: str) -> float:
    """Scores within ATOL; ids equal where neighbouring plain scores differ."""
    err = (v - rv).abs().max().item()
    if not torch.isfinite(v).all() or err > ATOL:
        raise AssertionError(f"{what}: max |score - plain| = {err} > {ATOL}")
    gap = rv[:, :-1] - rv[:, 1:]
    big = torch.ones_like(rv, dtype=torch.bool)
    big[:, :-1] &= gap > ATOL
    big[:, 1:] &= gap > ATOL
    bad = (i != ri) & big
    if bad.any():
        raise AssertionError(f"{what}: ids differ where scores are separated: {bad.nonzero()[:5].tolist()}")
    return err


def phase_kernels(fused_topk, fused_topk_reference) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    emb = torch.randn(ROWS, DIM, device="cuda", generator=gen)
    emb /= emb.norm(dim=1, keepdim=True)
    emb = emb.to(torch.bfloat16)
    valid = torch.rand(ROWS, device="cuda", generator=gen) < 0.9
    q = torch.randn(64, DIM, device="cuda", generator=gen)
    q /= q.norm(dim=1, keepdim=True)
    log(f"index {ROWS} x {DIM} bf16, {int(valid.sum())} valid rows")

    row = None
    max_err = 0.0
    for b in (1, 64):
        qb = q[:b].contiguous()
        for k in (5, 8):
            v, i = fused_topk(emb, valid, qb, k)
            torch.cuda.synchronize()
            rv, ri = fused_topk_reference(emb, valid, qb, k)
            err = check_topk(v, i, rv, ri, f"fused_topk B={b} k={k}")
            max_err = max(max_err, err)
            ms = cuda_ms(lambda: fused_topk(emb, valid, qb, k))
            plain_ms = cuda_ms(lambda: fused_topk_reference(emb, valid, qb, k), iters=3, warmup=1)
            lib_ms = cuda_ms(
                lambda: torch.topk(
                    torch.where(valid, qb.to(torch.bfloat16) @ emb.T, -2.0), k, dim=1
                )
            )
            nbytes = ROWS * DIM * 2 + ROWS + b * DIM * 4 + b * k * 8
            flops = 2 * b * ROWS * DIM
            bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3
            bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S else "operations"
            log(
                f"fused_topk B={b} k={k}: max_abs_err={err:.3g} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})"
            )
            if b == 64 and k == 5:  # the main path's warn_batch shape
                row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
    row["max_abs_err"] = max_err

    # Duplicated rows: exact ties across tiles resolve to the lowest row id.
    n_base = 4096
    emb.copy_(emb[:n_base].repeat(ROWS // n_base, 1))
    valid.fill_(True)
    qd = emb[:8].float()
    v, i = fused_topk(emb, valid, qd, 8)
    rv, ri = fused_topk_reference(emb, valid, qd, 8)
    want = torch.arange(8, device="cuda")[:, None] + n_base * torch.arange(8, device="cuda")[None, :]
    if not (torch.equal(i.long(), want) and torch.equal(ri.long(), want)):
        raise AssertionError(f"duplicate-row ties: kernel {i[0].tolist()} plain {ri[0].tolist()}")
    if not torch.equal(v, v[:, :1].expand_as(v)):
        raise AssertionError("duplicate rows must score exactly equal")
    log("fused_topk duplicate rows: lowest-index ties exact")
    return row


def _trace(TracePayload, i, app_id, prompt, response=STUB_RESPONSE):
    return TracePayload(
        trace_id=f"smoke-{i:06d}", ts=datetime.now(timezone.utc), app_id=app_id,
        agent_id="agent-1", prompt=prompt, response=response, model="stub",
        temperature=0.2, tools=[], env={"os": "linux"},
    )


def phase_platform(data_dir: Path, fused_topk, fused_topk_reference) -> dict:
    from kakveda_tpu_torch.core.fingerprint import signature_text
    from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
    from kakveda_tpu_torch.platform import Platform

    plat = Platform(data_dir=data_dir, capacity=ROWS, dim=DIM)
    if plat.device.type != "cuda" or plat.gfkb._emb.dtype != torch.bfloat16:
        raise AssertionError(f"Platform is on {plat.device} / {plat.gfkb._emb.dtype}")
    scenarios = [
        ("app-A", "Summarize this document and include citations even if not provided."),
        ("app-B", "Explain research paper and add references."),
    ]

    async def demo():
        n = 0
        for app_id, prompt in scenarios:
            w = plat.warn(WarningRequest(app_id=app_id, agent_id="agent-1", prompt=prompt,
                                         tools=[], env={"os": "linux"}))
            if w.action not in ("warn", "block", "silent"):
                raise AssertionError(f"warn action {w.action!r}")
            await plat.ingest(_trace(TracePayload, n, app_id, prompt))
            n += 1
        for j in range(8):
            prompt = "Summarize and add references" if j % 2 == 0 else "Short answer with citations"
            await plat.ingest(_trace(TracePayload, n, "app-A", prompt))
            n += 1

    asyncio.run(demo())
    failures = plat.failures()
    if not failures or {a for f in failures for a in f.affected_apps} != {"app-A", "app-B"}:
        raise AssertionError(f"demo failures wrong: {failures}")
    patterns = plat.patterns_list()
    if len(patterns) != 1 or patterns[0].pattern_id != "FP-0001" or patterns[0].affected_apps != ["app-A", "app-B"]:
        raise AssertionError(f"demo pattern wrong: {patterns}")
    pts = plat.health_points("app-A")
    if not (len(pts) >= 9 and pts[-1].score < pts[0].score and pts[-1].recurrent_penalty > 0):
        raise AssertionError("app-A health did not fall")
    follow = WarningRequest(app_id="app-C", prompt=scenarios[0][1], tools=[], env={"os": "linux"})
    w2 = plat.warn(follow)
    if not (w2.confidence > 0.9 and w2.pattern_id == "FP-0001" and w2.references):
        raise AssertionError(f"follow-up warn wrong: {w2}")
    log(f"demo flow: {len(failures)} failures, pattern FP-0001 over app-A/app-B, "
        f"app-A health {pts[0].score} -> {pts[-1].score}, follow-up confidence {w2.confidence:.4f}")

    traces = [
        _trace(TracePayload, 100 + i, f"app-{i % 8}", f"Summarize report {i} and include citations")
        for i in range(4096)
    ]
    t0 = time.perf_counter()
    for lo in range(0, len(traces), 512):
        sig = asyncio.run(plat.ingest_batch(traces[lo : lo + 512]))
        if len(sig) != 512:
            raise AssertionError("ingest_batch lost failures")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    if plat.gfkb.count != len(failures) + 4096:
        raise AssertionError(f"GFKB count {plat.gfkb.count}")

    reqs = [
        WarningRequest(app_id="z", prompt=f"Summarize report {i * 61} and include citations", tools=[], env={})
        for i in range(64)
    ]
    res = plat.warn_batch(reqs)
    if len(res) != 64 or not all(r.confidence > 0.5 and r.pattern_id == "FP-0001" for r in res):
        raise AssertionError("warn_batch verdicts wrong")
    # The batch's matches against the plain top-k of the same index.
    gfkb = plat.gfkb
    idx, val = gfkb.featurizer.encode_batch_sparse([signature_text(r.prompt, r.tools, r.env) for r in reqs])
    q = gfkb._knn.densify(torch.as_tensor(idx, device="cuda"), torch.as_tensor(val, device="cuda"))
    rv, ri = fused_topk_reference(gfkb._emb, gfkb._valid, q, gfkb.top_k)
    by_slot = plat.failures()
    for j, r in enumerate(res):
        if abs(r.confidence - min(1.0, rv[j, 0].item())) > ATOL:
            raise AssertionError(f"warn {j}: confidence {r.confidence} vs plain {rv[j, 0].item()}")
        separated = rv[j, 0].item() - rv[j, 1].item() > ATOL
        want = by_slot[int(ri[j, 0])].failure_id
        if separated and not (r.references and r.references[0].failure_id == want):
            raise AssertionError(f"warn {j}: top-1 differs from the plain top-k ({want})")

    one = [follow]
    warn1 = []
    for _ in range(50):
        t = time.perf_counter()
        plat.warn_batch(one)
        warn1.append((time.perf_counter() - t) * 1e3)
    warn64 = []
    for _ in range(20):
        t = time.perf_counter()
        plat.warn_batch(reqs)
        warn64.append((time.perf_counter() - t) * 1e3)
    plat.close()
    out = {
        "ingest_traces_per_s": 4096 / ingest_s,
        "warn_p50_ms": statistics.median(warn1),
        "warn_batch64_p50_ms": statistics.median(warn64),
        "records": plat.gfkb.count,
    }
    log("main path: " + json.dumps(out))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from kakveda_tpu_torch.ops import _build
    from kakveda_tpu_torch.ops.fused_topk import fused_topk, fused_topk_reference

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    t0 = time.perf_counter()
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    libs = _build.build(names)
    log(f"built {names} in {time.perf_counter() - t0:.2f} s")
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())

    row = phase_kernels(fused_topk, fused_topk_reference)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="kakveda-smoke-") as d:
        fused_topk.launches = 0
        main_path = phase_platform(Path(d) / "data", fused_topk, fused_topk_reference)
        launches = fused_topk.launches
    if launches <= 0:
        raise AssertionError("the main path never launched fused_topk")
    log(f"fused_topk launches on the main path: {launches}")

    kernels = [dict(
        name="fused_topk", route="cuda", source="kakveda_tpu_torch/csrc/fused_topk.cu",
        replaces="kakveda_tpu/ops/pallas_knn.py:128", launches=launches,
        max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
    )]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
