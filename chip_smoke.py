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
   B ∈ {1, 64}, k ∈ {5, 8}, against ``fused_topk_reference`` and the
   kernel's own schedule in plain PyTorch (``fused_topk_schedule_reference``
   over one block per SM): scores within 1e-4, ids equal wherever the plain
   scores of neighbouring ranks differ by more than 1e-4, exact
   lowest-index ties on duplicated rows; warm times from CUDA events beside
   the bound, its share of HBM, the plain version and one PyTorch yardstick
   call (never used by the port), eager and replayed from a CUDA graph; the kernel's registers, spills (ptxas),
   shared memory and ring depth per wgmma width;
4. the failure-memory main path, with launch counts zeroed just before and
   read just after: ``Platform(capacity=2^20, dim=2048)`` on the card runs
   the demo flow (warn → ingest for app-A/app-B, repeats that degrade
   app-A, a follow-up warn), then ``ingest_batch`` of 4096 traces in batches
   of 512 and ``warn_batch`` of 64, whose matches are checked against the
   plain top-k of the same index. Mining on that ingest path: the cluster
   state covers every row, never went stale, one delta top-k per 512-batch;
   ``mine()`` serves incrementally, ``mine(mode="full")`` sweeps and
   re-seeds (this stream is past the k-neighbour cap, where the streamed
   partition is not the sweep's, in the JAX package too); a warned
   signature's ingest attaches with no dispatch; the delta's device time
   beside its bound. Then two more Platforms ingest one stream whose
   clusters no neighbour list overflows: incremental patterns and
   partition equal the full sweep's. Then ingest traces/s on fresh
   Platforms with mining off, on, on, off;
5. ``flash_gqa_cache`` (bf16 cache and int8 cache) against its plain
   versions, the split schedule's (``flash_gqa_cache_split_reference`` with
   the kernel's ``n_split``) and the unsplit one, at the model plane's
   shapes (H = 32, KV = 8, D = 128): decode (B = 8, S = 1, L = 512,
   per-slot ``kv_valid``, one slot that sees nothing and must give exact
   zeros), decode under the engine's own mask (``_forward_wide`` at phase
   6's last step: rows [left pad, 95] of every slot, a left pad of 10-16,
   ``pos0`` = 512, with the engine's ``reach`` hint of 96 and, timed beside
   it, without), admission (B = 1, S = 64, L = 512, 13 left-pad slots) and
   a long cache (B = 8, S = 1, L = 8192); every bf16 output row within two
   bf16 steps of its largest plain value (2^-6 of it) and within 2e-2;
   each shape's ``n_split`` and live-tile fraction; device
   times from a CUDA graph of many calls replayed between CUDA events (so
   the wrappers' host time is not counted; one eager call's time is printed
   beside), cycling enough copies of the cache to defeat the 50 MB L2,
   beside the bound in two forms (every cache row, and only the rows some
   query sees) and one PyTorch yardstick call
   (``scaled_dot_product_attention``, never used by the port);
6. the model plane's main path: ``LlamaRuntime(LlamaConfig.llama3_8b())``
   (random bf16 weights from seed 0, 16.06 GB, 32 layers) serves
   ``generate_batch`` of 8 prompts × 32 tokens through the engine (8 slots,
   window 512, chunk 8), once with a bf16 cache and once with an int8
   cache, launch counts zeroed just before and read just after each run:
   the run's kernel launches 32 × (forward passes) times, the other kernel
   0. Each prompt's tokens equal a solo ``generate_tokens`` up to the first
   step whose solo top-2 logit margin is below 0.25 (bf16 noise between
   batch shapes can flip a nearer tie), and every engine token lies within
   0.25 of the solo argmax on the engine's own prefix (one teacher-forced
   pass, so all 32 steps are checked); the int8 cache's first-step logits
   keep a cosine ≥ 0.99 to the bf16 cache's. Admission ms, decode step p50
   ms (host clock) and the step's device time (graph replay, with the
   engine's ``reach`` hint) against the 4.8 ms weight-read bound, and
   tokens/s.

7. mining at the reference bench's size (``bench.py``'s corpus: 120
   templates, seed 0, ~1,080 distinct texts expanded on the card): the full
   sweep at 500,000 rows (projection tier) and 131,072 (exact tier), each
   split into its stages (CUDA events) beside each stage's bound, purity ≥
   0.99 against the templates; the first 20,000 rows streamed through the
   delta top-k into a ``ClusterState`` in batches of 512, whose labels must
   equal the full sweep's; the card's delta top-k of 64 rows against a
   float64 host computation on the same bf16 rows (scores within 1e-4, ids
   equal where the host's neighbouring scores differ by more, and on exact
   ties, lowest row first).

8. the service plane (``KAKVEDA_NATIVE=require`` holds for the whole run:
   the native host tier must build with ``g++`` and load, and phase 4
   already runs on it): ``make_app`` over a fresh
   ``Platform(capacity=2^20, dim=2048)`` on a ``TCPSite`` at 127.0.0.1,
   driven by an ``aiohttp.ClientSession`` in this process (aiohttp is
   required: without it the phase fails). a. ``/ingest/batch`` of 8 × 512
   traces, three in four failing: the summed failures equal the GFKB's
   growth; traces/s. b. 256 ``/warn`` at concurrency 1, half of ingested
   signatures: p50, p99. c. 64 clients × 16 ``/warn``: p50, p99, warns/s,
   ``fused_topk`` launches (under 1024 and at least 16), requests per
   launch, and the share of the arm's wall that each batch's device
   dispatch spans (CUDA events). d. ``/failures/match``, ``/patterns``,
   ``/health/app-A``, ``/readyz`` (native available, the card) agree with
   the platform, and every answer of b and c equals a direct
   ``warn_batch`` of the same requests (action, confidence within 1e-4,
   the top-1 id wherever the direct top-2 differ by more). e.
   ``/patterns/mine {"mode": "full"}`` equals ``plat.mine(mode="full")``;
   after one more ingest ``/patterns/mine {}`` is incremental. The
   ``fused_topk`` launches of the service's own requests (a–e, counter
   zeroed before a; the direct calls that check them are left out) are
   the kernel row's ``launches_service``. Then the
   warn path's stages at B = 1 and 64 (signature text, featurize native
   and Python, upload, densify and ``fused_topk`` with CUDA events, d2h,
   the rest) beside the unsynchronized ``warn_batch`` wall, and one
   512-trace ingest batch's (classify, featurize, insert, delta dispatch,
   log append). Last ``python3 -m kakveda_tpu_torch.service`` as a
   process on the card with a 2^20-row index: it answers ``/healthz``
   within 120 s, ingests 8 × 512 traces, warns an ingested signature back
   to itself, serves 64 clients × 16 warns from this process (so client
   and server no longer share one event loop), exits 0 on SIGINT, and a
   fresh ``Platform`` replays its data dir.

Prints a ``{"kernels": [...]}`` line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from datetime import datetime, timezone
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
ROWS, DIM = 1 << 20, 2048
ATOL = 1e-4  # bf16 inputs, f32 sums taken in another order than the plain version
# Flash: bf16 outputs from f32 sums taken in another order than the plain
# version's, so a probability's or an output's bf16 rounding may fall the
# other way. One bf16 step of x is at most 2^-7 |x|: each output row must lie
# within two steps of its largest plain value (FLASH_REL of it), and never
# past FLASH_ATOL (the largest outputs, |out| <~ 3, have steps of 1.6e-2).
FLASH_REL = 2.0**-6
FLASH_ATOL = 2e-2
H, KV, HD = 32, 8, 128  # Llama-3-8B attention heads, kv heads, head_dim
L2_BYTES = 50e6
MARGIN_TOL = 0.25  # solo top-2 logit margin below which a batched token may flip
INT8_COS_MIN = 0.99  # first-step logits, int8 cache vs bf16 cache
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


def graph_ms(fn, n: int = 20) -> float:
    """Device time per call: ``n`` calls captured in one CUDA graph and
    replayed between CUDA events, so the host's time between launches (the
    wrappers' Python) is not counted. Median of three replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up on a side stream before capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del g
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


def phase_kernels(fused_topk, fused_topk_reference, card: str) -> dict:
    from kakveda_tpu_torch.ops.fused_topk import fused_topk_schedule_reference, workspace_shape

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    emb = torch.randn(ROWS, DIM, device="cuda", generator=gen)
    emb /= emb.norm(dim=1, keepdim=True)
    emb = emb.to(torch.bfloat16)
    valid = torch.rand(ROWS, device="cuda", generator=gen) < 0.9
    q = torch.randn(64, DIM, device="cuda", generator=gen)
    q /= q.norm(dim=1, keepdim=True)
    log(f"index {ROWS} x {DIM} bf16, {int(valid.sum())} valid rows")

    rows = {}
    max_err = 0.0
    for b in (1, 64):
        qb = q[:b].contiguous()
        n_cta = workspace_shape(b, ROWS, sms)[1]
        for k in (5, 8):
            v, i = fused_topk(emb, valid, qb, k)
            torch.cuda.synchronize()
            rv, ri = fused_topk_reference(emb, valid, qb, k)
            err = check_topk(v, i, rv, ri, f"fused_topk B={b} k={k}")
            sv, si = fused_topk_schedule_reference(emb, valid, qb, k, n_cta)
            err = max(err, check_topk(v, i, sv, si, f"fused_topk B={b} k={k} (schedule, {n_cta} blocks)"))
            max_err = max(max_err, err)
            ms = cuda_ms(lambda: fused_topk(emb, valid, qb, k))
            plain_ms = cuda_ms(lambda: fused_topk_reference(emb, valid, qb, k), iters=3, warmup=1)
            def library():
                return torch.topk(torch.where(valid, qb.to(torch.bfloat16) @ emb.T, -2.0), k, dim=1)

            lib_ms = cuda_ms(library)
            # Device time alone: launches replayed from a CUDA graph (the
            # eager times above include the wrapper's host time).
            dev_ms = graph_ms(lambda: fused_topk(emb, valid, qb, k), n=10)
            lib_dev_ms = graph_ms(library, n=10)
            nbytes = ROWS * DIM * 2 + ROWS + b * DIM * 4 + b * k * 8
            flops = 2 * b * ROWS * DIM
            bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3
            bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S else "operations"
            log(
                f"fused_topk B={b} k={k} ({n_cta} blocks): max_abs_err={err:.3g} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
                f"share_of_bound={bound_ms / ms:.3f} kernel/library={ms / lib_ms:.3f}; graph replay: "
                f"kernel_ms={dev_ms:.4f} library_ms={lib_dev_ms:.4f} share_of_bound={bound_ms / dev_ms:.3f} [{card}]"
            )
            if k == 5:  # B = 1: the single warn, the main path's most frequent shape; 64: warn_batch
                rows[b] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                               bound_by=bound_by, graph_ms=dev_ms, library_graph_ms=lib_dev_ms)
    row = rows[1]
    row["max_abs_err"] = max_err
    row["b64"] = rows[64]

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


def phase_platform(data_dir: Path, fused_topk, fused_topk_reference, card: str) -> dict:
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

    mining = check_mining(plat, card)

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
    records = plat.gfkb.count
    plat.close()
    del plat, gfkb
    torch.cuda.empty_cache()
    mining["parity"] = check_mining_parity(data_dir.parent, card)
    torch.cuda.empty_cache()

    ingest_ab = ingest_mining_off_on(data_dir.parent, traces)
    out = {
        "ingest_traces_per_s": 4096 / ingest_s,
        "ingest_ab": ingest_ab,
        "warn_p50_ms": statistics.median(warn1),
        "warn_batch64_p50_ms": statistics.median(warn64),
        "records": records,
        "mining": mining,
    }
    log("ingest of 4096 traces on fresh Platforms, mining off / on / on / off: "
        + " / ".join(f"{r['traces_per_s']:.1f}" for r in ingest_ab) + " traces/s; host ms in the mining "
        "attach per 512-batch (on): " + " / ".join(f"{r['attach_host_ms_per_batch']:.2f}" for r in ingest_ab
                                                   if r["mining"]) + f" [{card}]")
    log("main path: " + json.dumps(out))
    return out


def ingest_mining_off_on(base: Path, traces) -> list:
    """``ingest_batch`` of the same traces (batches of 512, after one warm-up
    batch) on fresh Platforms with mining off, on, on, off
    (``KAKVEDA_MINE_INCREMENTAL``), the card synchronized at both ends; with
    mining on, the host wall spent in the attach (the delta's dispatch and
    the match-cache reuse), per batch."""
    from kakveda_tpu_torch.core.schemas import TracePayload
    from kakveda_tpu_torch.platform import Platform

    warm = [_trace(TracePayload, 90_000 + i, "app-w", f"Warm up batch {i} and include citations")
            for i in range(512)]
    out = []
    for j, mining in enumerate((False, True, True, False)):
        os.environ["KAKVEDA_MINE_INCREMENTAL"] = "1" if mining else "0"
        try:
            plat = Platform(data_dir=base / f"ingest-{j}", capacity=ROWS, dim=DIM)
        finally:
            del os.environ["KAKVEDA_MINE_INCREMENTAL"]
        gfkb = plat.gfkb
        attach = gfkb._mine_attach_new
        spent = [0.0]

        def timed(*a, attach=attach, spent=spent):
            t = time.perf_counter()
            try:
                return attach(*a)
            finally:
                spent[0] += time.perf_counter() - t

        gfkb._mine_attach_new = timed
        asyncio.run(plat.ingest_batch(warm))
        torch.cuda.synchronize()
        spent[0] = 0.0
        t0 = time.perf_counter()
        for lo in range(0, len(traces), 512):
            asyncio.run(plat.ingest_batch(traces[lo : lo + 512]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = gfkb.mine_state_info()
        if mining != st["enabled"] or (not mining and gfkb.mine_delta_dispatches):
            raise AssertionError(f"KAKVEDA_MINE_INCREMENTAL={int(mining)}: {st}")
        if mining and (st["stale"] or not st["covers_all_rows"]):
            raise AssertionError(f"mining state after ingest: {st}")
        out.append(dict(mining=mining, traces_per_s=len(traces) / wall,
                        attach_host_ms_per_batch=spent[0] * 1e3 / (len(traces) // 512)))
        plat.close()
        del plat, gfkb
        torch.cuda.empty_cache()
    return out


MINING_CALLS = {"delta": 0, "sweep": 0, "rescore": 0}


def count_mining_calls() -> None:
    """Count the calls of the mining device programs in ``MINING_CALLS``:
    ``_block_topk`` as the ingest delta (bound into ``ops.incremental``) and
    as the sweep (``ops.clustering``), and ``_rescore_pairs``."""
    from kakveda_tpu_torch.ops import clustering, incremental

    for mod, attr, name in ((incremental, "_block_topk", "delta"), (clustering, "_block_topk", "sweep"),
                            (clustering, "_rescore_pairs", "rescore")):
        def counted(*a, fn=getattr(mod, attr), name=name, **k):
            MINING_CALLS[name] += 1
            return fn(*a, **k)

        setattr(mod, attr, counted)


def _pattern_key(patterns):
    return {(p.name, tuple(p.failure_ids), tuple(sorted(p.affected_apps)), p.description) for p in patterns}


def check_mining(plat, card: str) -> dict:
    """Mining on the ingest path (phase 4, after the batch ingest): the
    streaming state covers every row and never went stale, one delta per
    512-batch; ``mine()`` serves incrementally, then a full sweep re-seeds
    it; a warned signature attaches with no dispatch; the delta's device
    time beside its bound."""
    import numpy as np

    from kakveda_tpu_torch.core.fingerprint import signature_text
    from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
    from kakveda_tpu_torch.ops.incremental import delta_topk_sparse

    gfkb = plat.gfkb
    st = gfkb.mine_state_info()
    if not (st.get("enabled") and not st["stale"] and st["covers_all_rows"] and st["delta_dispatches"] >= 8):
        raise AssertionError(f"mining state after ingest: {st}")
    t = time.perf_counter()
    inc, info = plat.mine()
    inc_ms = (time.perf_counter() - t) * 1e3
    if info["mode"] != "incremental" or not inc or info["stale"] or not info["covers_all_rows"]:
        raise AssertionError(f"incremental mine: {info}, {len(inc)} patterns")
    labels_inc = gfkb._mine.labels()
    t = time.perf_counter()
    full, finfo = plat.mine(mode="full")
    full_ms = (time.perf_counter() - t) * 1e3
    labels_full = gfkb._mine.labels()  # the sweep's, installed by the re-seed
    if finfo["mode"] != "full" or not full:
        raise AssertionError(f"full mine: {finfo}, {len(full)} patterns")
    # "Summarize report {i}" rows each have thousands of neighbours above the
    # threshold, so the k-neighbour cap binds (evictions) and the streamed
    # graph is not the sweep's: the JAX package's partitions differ the same
    # way on this stream (tests/test_torch_mining.py). Equality where no list
    # evicts is check_mining_parity's.
    same = bool(np.array_equal(labels_inc, labels_full))
    if info["evictions"] == 0 and not same:
        raise AssertionError("no list evicted, yet the incremental partition differs from the sweep's")
    # A warned signature's ingest reuses the warn's neighbours: no dispatch.
    prompt = "Summarize report 99999 and include citations"
    d0 = gfkb.mine_delta_dispatches
    plat.warn(WarningRequest(app_id="app-1", prompt=prompt, tools=[], env={"os": "linux"}))
    asyncio.run(plat.ingest_batch([_trace(TracePayload, 99_999, "app-1", prompt)]))
    if gfkb.mine_delta_dispatches != d0:
        raise AssertionError("a warned signature's ingest dispatched a delta")
    again, ainfo = plat.mine()
    if ainfo["mode"] != "incremental" or ainfo["stale"] or not ainfo["covers_all_rows"]:
        raise AssertionError(f"after the reused attach: {ainfo}")

    calls = dict(MINING_CALLS)  # the main path's, before the timing below
    # One 512-batch delta against the 2^20-row index, device time.
    texts = [signature_text(f"Delta batch row {i} and include citations", [], {"os": "linux"})
             for i in range(512)]
    idx, val = gfkb.featurizer.encode_batch_sparse(texts)
    k = gfkb._mine.k + 1
    delta_ms = cuda_ms(lambda: delta_topk_sparse(gfkb._emb, gfkb._valid, idx, val, k), iters=5, warmup=1)
    nbytes = ROWS * DIM * 2 + ROWS + 512 * DIM * 2 + 512 * 2 * k * 4
    flops = 2 * 512 * ROWS * DIM
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    out = dict(
        calls=calls, delta_dispatches=ainfo["delta_dispatches"], attached=ainfo["attached"],
        evictions=info["evictions"],
        clusters_incremental=int(len(np.unique(labels_inc))), clusters_full=int(len(np.unique(labels_full))),
        partitions_equal=same, patterns=len(inc), mine_incremental_ms=inc_ms, mine_full_ms=full_ms,
        mine_incremental_wall_ms=info["wall_ms"], mine_full_wall_ms=finfo["wall_ms"],
        delta_ms_per_512=delta_ms, delta_bound_ms=bound_ms,
        delta_bound_by="bytes" if t_bytes >= t_ops else "operations",
    )
    log(f"mining on the ingest path: {ainfo['delta_dispatches']} delta dispatches, {ainfo['attached']} rows "
        f"attached, never stale; incremental mine {inc_ms:.2f} ms ({len(inc)} patterns, "
        f"{out['clusters_incremental']} clusters, {info['evictions']} evictions), full sweep {full_ms:.2f} ms "
        f"({len(full)} patterns, {out['clusters_full']} clusters), partitions equal: {same}; warned signature "
        f"attached with 0 dispatches; delta top-k (k={k}) of 512 rows vs {ROWS} x {DIM} bf16: "
        f"{delta_ms:.4f} ms, bound {bound_ms:.4f} ms ({out['delta_bound_by']}); calls on the main path "
        f"{json.dumps(calls)} [{card}]")
    return out


def parity_corpus(n: int, seed: int = 1):
    """(app, prompt) pairs of citation failures in clusters of 1-10 members
    (thirteen random four-letter words, one of them changed per member):
    about 0.85 cosine inside a cluster, under 0.45 across, so no row has
    more than nine neighbours above 0.6 and no list ever evicts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    out, c = [], 0
    while len(out) < n:
        words = ["".join(rng.choice(letters, 4)) for _ in range(13)]
        for j in range(int(rng.integers(1, 11))):
            w = list(words)
            w[j] = "zz" + w[j][2:]
            out.append((f"app-{(c + j) % 8}", f"Sources: {' '.join(w)}"))
        c += 1
    return out[:n]


def check_mining_parity(data_dir: Path, card: str) -> dict:
    """Incremental mining equals the full sweep where the reference promises
    it (no neighbour list evicts): two Platforms at the GFKB's real size
    ingest one stream of 4096 traces in batches of 512; one mines
    incrementally, the other by a full sweep; the patterns (name, failure
    ids, apps, description) and the partitions must be equal."""
    import numpy as np

    from kakveda_tpu_torch.core.schemas import TracePayload
    from kakveda_tpu_torch.platform import Platform

    traces = [_trace(TracePayload, 200_000 + i, app, prompt) for i, (app, prompt) in enumerate(parity_corpus(4096))]
    plats = [Platform(data_dir=data_dir / name, capacity=ROWS, dim=DIM) for name in ("auto", "full")]
    for p in plats:
        for lo in range(0, len(traces), 512):
            asyncio.run(p.ingest_batch(traces[lo : lo + 512]))
    auto, full = plats
    t = time.perf_counter()
    inc, info = auto.mine()
    inc_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    swept, finfo = full.mine(mode="full")
    full_ms = (time.perf_counter() - t) * 1e3
    if info["mode"] != "incremental" or info["stale"] or info["evictions"] or finfo["mode"] != "full":
        raise AssertionError(f"parity stream: {info} / {finfo}")
    if not inc or _pattern_key(inc) != _pattern_key(swept):
        raise AssertionError(f"incremental patterns ({len(inc)}) differ from the full sweep's ({len(swept)})")
    labels = auto.gfkb._mine.labels()
    if not np.array_equal(labels, full.gfkb._mine.labels()):
        raise AssertionError("incremental partition differs from the full sweep's")
    for p in plats:
        p.close()
    out = dict(rows=len(labels), clusters=int(len(np.unique(labels))), patterns=len(inc),
               mine_incremental_ms=inc_ms, mine_full_ms=full_ms, delta_dispatches=info["delta_dispatches"])
    log(f"incremental == full where no list evicts: {len(labels)} rows, {out['clusters']} clusters, "
        f"{len(inc)} patterns equal; incremental mine {inc_ms:.2f} ms, full sweep {full_ms:.2f} ms "
        f"({info['delta_dispatches']} delta dispatches) [{card}]")
    return out


VERBS = ["Summarize", "Explain", "Describe", "Review", "Outline"]
OBJS = ["report", "paper", "contract", "dataset", "incident", "ticket"]
TAILS = [
    "and include citations even if not provided",
    "and add references for every claim",
    "listing all sources used",
    "with a short bibliography",
]
MINE_N, MINE_EXACT_N, MINE_INC_N, MINE_BATCH, MINE_TEMPLATES = 500_000, 1 << 17, 20_000, 512, 120
MINE_MIN_PURITY = 0.99


def mine_corpus(n: int, n_templates: int, dim: int):
    """``bench.py``'s mining corpus (seed 0): (template ids [n], bf16 rows
    [n, dim] on the card, text id [n]). The ~1,080 distinct texts are
    encoded once and expanded by index on the card."""
    import numpy as np

    from kakveda_tpu_torch.core.fingerprint import signature_text
    from kakveda_tpu_torch.ops.featurizer import HashedNGramFeaturizer
    from kakveda_tpu_torch.ops.knn import densify

    rng = np.random.default_rng(0)
    tmpl = rng.integers(0, n_templates, size=n)
    item = rng.integers(0, 9, size=n)  # the same stream as one draw per row
    combo = tmpl * 9 + item
    uniq, text_id = np.unique(combo, return_inverse=True)
    texts = [
        signature_text(f"{VERBS[t % len(VERBS)]} the {OBJS[(t // len(VERBS)) % len(OBJS)]} "
                       f"variant {t} {TAILS[t % len(TAILS)]} item {c % 9}", [], {"os": "linux"})
        for c in uniq.tolist() for t in [c // 9]
    ]
    idx, val = HashedNGramFeaturizer(dim=dim).encode_batch_sparse(texts)
    u = densify(torch.from_numpy(idx).cuda(), torch.from_numpy(val).cuda(), dim).to(torch.bfloat16)
    return tmpl, u[torch.from_numpy(text_id).cuda()], text_id


def purity(labels, truth) -> float:
    """Majority-template share per cluster label (``bench.py``'s measure)."""
    import numpy as np

    order = np.argsort(labels, kind="stable")
    sl, st = labels[order], truth[order]
    bounds = np.flatnonzero(np.r_[True, sl[1:] != sl[:-1], True])
    correct = sum(int(np.unique(st[a:b], return_counts=True)[1].max()) for a, b in zip(bounds[:-1], bounds[1:]))
    return correct / len(labels)


def sweep_bounds(n: int, tier: str, candidates: int) -> dict:
    """The least device time of the sweep's stages at ``n`` rows: the
    candidate sweep (every pair's product, bf16 on the tensor cores in the
    exact tier, f32 over the projected rows otherwise; the rows read once,
    the packed top-k written once) and, in the projection tier, the
    projection and the f32 re-score of the ``candidates`` pairs."""
    from kakveda_tpu_torch.ops import clustering

    kk = clustering._KNN_K + 1
    out = {}
    if tier == "exact":
        ops, nbytes = 2 * n * n * DIM / BF16_FLOP_PER_S, (n * DIM * 2 + n * kk * 8) / HBM_BYTES_PER_S
    else:
        m = clustering._MINE_DIM
        ops, nbytes = 2 * n * n * m / F32_FLOP_PER_S, (n * m * 4 + n * kk * 8) / HBM_BYTES_PER_S
        out["project_bound_ms"] = max(2 * n * DIM * m / F32_FLOP_PER_S, (n * DIM * 2 + n * m * 4) / HBM_BYTES_PER_S) * 1e3
        out["rescore_bound_ms"] = max(candidates * 2 * DIM / F32_FLOP_PER_S,
                                      (n * DIM * 2 + candidates * 20) / HBM_BYTES_PER_S) * 1e3
    out["sweep_bound_ms"] = max(ops, nbytes) * 1e3
    return out


def sweep_block_split(v, text_id, card: str) -> dict:
    """One block of the sweep at phase 7's shapes, its stages apart (CUDA
    events): ``_QBLOCK`` query rows against a column block as wide as
    ``_SCORE_BLOCK_BYTES`` of f32 scores allow; the product (bf16 on the
    tensor cores over the full dim, f32 over the projected rows) and the
    selection (``torch.topk`` alone, and the exact top-k with its tie
    resolution that ``_block_topk`` runs). The block's duplicated rows
    (``text_id``) must score bit-identically: the tie rule rests on it."""
    import numpy as np

    from kakveda_tpu_torch.ops import clustering

    qn = clustering._QBLOCK
    width = clustering._SCORE_BLOCK_BYTES // (4 * qn)
    k = clustering._KNN_K + 1
    proj = clustering._project(v[:width], clustering._MINE_DIM)
    _, first = np.unique(text_id[:width], return_index=True)
    first_of = torch.from_numpy(first[np.unique(text_id[:width], return_inverse=True)[1]]).cuda()
    out = {}
    for tier, rows in (("exact", v[:width]), ("projection", proj)):
        q = rows[:qn]
        product_ms = cuda_ms(lambda: clustering._scores(q, rows), iters=5, warmup=1)
        s = clustering._scores(q, rows)
        if not torch.equal(s, s[:, first_of]):
            raise AssertionError(f"{tier}: duplicated rows score differently in one product")
        topk_ms = cuda_ms(lambda: torch.topk(s, k, dim=1), iters=5, warmup=1)
        select_ms = cuda_ms(lambda: clustering._exact_topk(s, k), iters=5, warmup=1)
        out[tier] = dict(q=qn, width=width, dim=rows.shape[1], dtype=str(rows.dtype).replace("torch.", ""),
                         product_ms=product_ms, topk_ms=topk_ms, exact_topk_ms=select_ms)
        del s
    log("one sweep block [" + f"{qn} x {width}" + "]: " + "; ".join(
        f"{t} ({r['dtype']}, d={r['dim']}) product {r['product_ms']:.3f} ms, torch.topk {r['topk_ms']:.3f} ms, "
        f"exact top-k with ties {r['exact_topk_ms']:.3f} ms" for t, r in out.items())
        + f"; duplicated rows bit-identical in both products [{card}]")
    return out


def phase_mining(card: str) -> dict:
    """Mining at the reference bench's size: the full sweep (projection
    tier) at 500,000 rows and the exact tier at 131,072, each split into
    its stages; the incremental arm on the first 20,000 rows, whose labels
    must equal the full sweep's; and the card's delta top-k against a
    float64 host computation on the same bf16 rows."""
    import numpy as np

    from kakveda_tpu_torch.ops import clustering
    from kakveda_tpu_torch.ops.incremental import ClusterState, delta_topk_dense, unpack_topk

    t0 = time.perf_counter()
    tmpl, v, text_id = mine_corpus(MINE_N, MINE_TEMPLATES, DIM)
    torch.cuda.synchronize()
    log(f"mining corpus: {MINE_N} rows x {DIM} bf16 from {int(text_id.max()) + 1} distinct texts, "
        f"{MINE_TEMPLATES} templates, built in {time.perf_counter() - t0:.2f} s (untimed)")
    out = {}
    for name, n in (("full_500k", MINE_N), ("exact_131k", MINE_EXACT_N)):
        stats = {}
        t = time.perf_counter()
        labels = clustering.cluster_embeddings(v[:n], threshold=0.6, stats=stats)
        wall = (time.perf_counter() - t) * 1e3
        p = purity(labels, tmpl[:n])
        n_cl = int(len(np.unique(labels)))
        tier = "projection" if "rescore_ms" in stats else "exact"
        bounds = sweep_bounds(n, tier, stats["candidates"])
        out[name] = dict(n=n, tier=tier, wall_ms=wall, purity=p, clusters=n_cl, **stats, **bounds)
        log(f"full sweep at {n} rows ({tier} tier): wall {wall:.1f} ms = " + ", ".join(
            f"{key} {val:.1f}" for key, val in stats.items() if key.endswith("ms"))
            + f"; {stats['edges']} edges of {stats['candidates']} candidates, {n_cl} clusters, purity {p:.4f}; "
            + ", ".join(f"{key} {val:.2f}" for key, val in bounds.items()) + f" [{card}]")
        if p < MINE_MIN_PURITY:
            raise AssertionError(f"purity {p} below {MINE_MIN_PURITY} at {n} rows")
        if name == "full_500k" and tier != "projection":
            raise AssertionError("500,000 rows did not take the projection tier")

    out["block_split"] = sweep_block_split(v, text_id, card)

    # Incremental arm: the first 20,000 rows streamed in batches of 512.
    n, bs, k = MINE_INC_N, MINE_BATCH, clustering._KNN_K
    vv = v[:n]
    t = time.perf_counter()
    labels_sub = clustering.cluster_embeddings(vv, threshold=0.6)
    full_sub_ms = (time.perf_counter() - t) * 1e3
    state = ClusterState(threshold=0.6, k=k)
    unpack_topk(delta_topk_dense(vv[:bs], vv, bs, k + 1), bs)  # warm-up, off the clock
    t_stream = 0.0
    for s in range(0, n, bs):
        e = min(s + bs, n)
        t = time.perf_counter()
        sims, idx = unpack_topk(delta_topk_dense(vv[s:e], vv, e, k + 1), e - s)
        for r in range(e - s):
            state.add_row(s + r)
        for r in range(e - s):
            state.attach(s + r, idx[r], sims[r])
        t_stream += time.perf_counter() - t
    t = time.perf_counter()
    inc_labels = state.labels()
    refresh_ms = (time.perf_counter() - t) * 1e3
    parity = bool(np.array_equal(inc_labels, labels_sub))
    p_inc = purity(inc_labels, tmpl[:n])
    out["incremental_20k"] = dict(n=n, batch=bs, stream_wall_s=t_stream, ms_per_row=t_stream * 1e3 / n,
                                  refresh_ms=refresh_ms, full_sweep_ms=full_sub_ms, parity=parity,
                                  purity=p_inc, clusters=state.n_clusters, evictions=state.evictions)
    log(f"incremental arm: {n} rows in batches of {bs}, stream {t_stream:.3f} s "
        f"({t_stream * 1e3 / n:.4f} ms/row), refresh {refresh_ms:.2f} ms vs full sweep {full_sub_ms:.1f} ms, "
        f"parity {parity}, purity {p_inc:.4f}, {state.n_clusters} clusters, {state.evictions} evictions [{card}]")
    if not parity or p_inc < MINE_MIN_PURITY:
        raise AssertionError(f"incremental arm: parity {parity}, purity {p_inc}")

    # Card against host: 64 rows' delta top-k vs float64 on the same bf16
    # rows (computed per distinct text, so duplicated rows tie exactly).
    q0 = 5000
    sims, idx = unpack_topk(delta_topk_dense(vv[q0 : q0 + 64], vv, n, k + 1), 64)
    u64 = v[:n].double().cpu().numpy()
    first = np.unique(text_id[:n], return_index=True)[1]
    tid = np.searchsorted(np.unique(text_id[:n]), text_id[:n])
    host = (u64[first][tid[q0 : q0 + 64]] @ u64[first].T)[:, tid]  # [64, n]
    # One rank past k + 1, so a near-tie across the boundary is seen.
    order = np.lexsort((np.broadcast_to(np.arange(n), host.shape), -host), axis=1)[:, : k + 2]
    hv = np.take_along_axis(host, order, 1)
    err = float(np.abs(sims - hv[:, : k + 1]).max())
    gap = np.abs(np.diff(hv, axis=1))
    ok = (gap > ATOL) | (gap == 0)  # separated, or an exact tie (lowest row first)
    sep = np.ones_like(hv, dtype=bool)
    sep[:, :-1] &= ok
    sep[:, 1:] &= ok
    bad = (idx != order[:, : k + 1]) & sep[:, : k + 1]
    if err > ATOL or bad.any():
        raise AssertionError(f"delta top-k vs host: max |score| err {err}, {int(bad.sum())} ids differ")
    ties = int((gap == 0).sum())
    out["card_vs_host"] = dict(rows=64, k=k + 1, max_abs_err=err, exact_ties_checked=ties)
    log(f"delta top-k of 64 rows vs float64 host on the same bf16 rows: max |score err| {err:.3g}, "
        f"ids equal ({ties} exact ties, lowest row first) [{card}]")
    del v, vv
    torch.cuda.empty_cache()
    log("mining: " + json.dumps(out))
    return out


def flash_check(out, ref):
    """(max |out - ref|, its worst share of the tolerance): every row within
    FLASH_REL of its largest |ref| and within FLASH_ATOL; a share > 1 fails."""
    diff = (out.float() - ref.float()).abs()
    tol = (ref.float().abs().amax(dim=-1, keepdim=True) * FLASH_REL).clamp(max=FLASH_ATOL)
    return diff.max().item(), (diff / tol.clamp_min(1e-30)).max().item()


ENGINE_POS = 95  # phase 6's last decode row: prompts in the 64 bucket + 32 new tokens
FLASH_SHAPES = [
    # (name, B, S, L, pos0, kv_valid, reach hint)
    ("decode", 8, 1, 512, 512, "slots", None),
    ("decode_engine", 8, 1, 512, 512, "engine", ENGINE_POS + 1),
    ("admission", 1, 64, 512, 0, "leftpad", None),
    ("long_cache", 8, 1, 8192, 8192, None, None),
]


def flash_inputs(gen, b, s, l, kind, kv8, copies):
    """q, ``copies`` replicas of the cache (cycled so timed launches find it
    cold in L2, as the 32 layers of a real step do), scales, kv_valid."""
    from kakveda_tpu_torch.models.llama import _kv_quant_rows

    q = torch.randn(b, s, H, HD, device="cuda", generator=gen).to(torch.bfloat16)
    ks = vs = None
    k = torch.randn(copies, b, KV, l, HD, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(copies, b, KV, l, HD, device="cuda", generator=gen).to(torch.bfloat16)
    if kv8:
        k, ks = _kv_quant_rows(k)
        v, vs = _kv_quant_rows(v)
    ar = torch.arange(l, device="cuda")
    valid = None
    if kind == "slots":  # the serving decode regime: a band per slot
        lo = torch.randint(0, 64, (b, 1), device="cuda", generator=gen)
        hi = torch.randint(64, l + 1, (b, 1), device="cuda", generator=gen)
        valid = ((ar >= lo) & (ar < hi)).contiguous()
        valid[b - 1] = False  # a slot that sees nothing
    elif kind == "engine":  # _forward_wide's mask: rows [left pad, slot_pos], one slot_pos for all
        off = torch.randint(10, 17, (b, 1), device="cuda", generator=gen)  # 48-54-token prompts
        valid = ((ar >= off) & (ar <= ENGINE_POS)).contiguous()
    elif kind == "leftpad":  # admission: 13 left-pad rows, the prompt bucket of 64
        valid = ((ar >= 13) & (ar < s)).expand(b, l).contiguous()
    return q, k, v, ks, vs, valid


def flash_bound_ms(b, s, l, kv8, seen_rows=None):
    """Each input read once, the output written once, over 3.35 TB/s; the
    two products' flops over 989 TFLOP/s bf16. Returns (ms, bound_by).
    With ``seen_rows`` (cache rows, summed over the batch, that at least one
    query row can see) only those rows' K/V count, in bytes and flops: the
    least a kernel that skips what no query sees must still read."""
    r = H // KV
    rows = b * l if seen_rows is None else seen_rows
    kv_bytes = 2 * rows * (HD + 4) if kv8 else 2 * rows * HD * 2
    nbytes = KV * (b * 2 * s * r * HD * 2 + kv_bytes) + b * l
    flops = 4 * KV * s * r * rows * HD
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_schedule(b, s, l, pos0, valid, reach=None):
    """The kernel's schedule at this shape: (n_split, live-tile fraction
    over all its (b·kv, q block) tile visits, cache rows some query sees)."""
    from kakveda_tpu_torch.models.attention import flash_live_tiles, flash_split_count, kernel_q_rows

    r = H // KV
    sr = s * r
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hint = pos0 + s if reach is None else min(pos0 + s, reach)
    n_split = flash_split_count(b * KV, sr, l, sms, reach=hint)
    qb = kernel_q_rows(sr)
    live = [flash_live_tiles(l, pos0, r, r0, min(sr, r0 + qb), valid).expand(b, -1).float().mean().item()
            for r0 in range(0, sr, qb)]
    seen = torch.arange(l, device="cuda")[None, :] <= pos0 + s - 1
    if valid is not None:
        seen = seen & valid
    return n_split, statistics.mean(live), int(seen.expand(b, l).sum())


def phase_flash(card: str) -> dict:
    """Both flash bodies against the plain version at the main path's shapes."""
    import torch.nn.functional as F

    from kakveda_tpu_torch.models.attention import (
        flash_gqa_cache,
        flash_gqa_cache_reference,
        flash_gqa_cache_split_reference,
    )
    from kakveda_tpu_torch.models.llama import _kv_dequant

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for kv8 in (False, True):
        name = "flash_gqa_cache_kv8" if kv8 else "flash_gqa_cache"
        row = {"max_abs_err": 0.0}
        for shape, b, s, l, pos0, kind, reach in FLASH_SHAPES:
            kv_bytes = b * KV * l * (2 * (HD + 4) if kv8 else 4 * HD)
            copies = max(1, math.ceil(2.5 * L2_BYTES / kv_bytes))
            q, k, v, ks, vs, valid = flash_inputs(gen, b, s, l, kind, kv8, copies)
            n_split, live_frac, seen_rows = flash_schedule(b, s, l, pos0, valid, reach)
            # Without the hint, the split count pos0 alone gives (what the
            # engine's decode took before it passed one).
            n_split_bare = flash_schedule(b, s, l, pos0, valid)[0]

            def args(i):
                i %= copies
                return dict(q=q, k=k[i], v=v[i], pos0=pos0, kv_valid=valid,
                            k_scale=None if ks is None else ks[i], v_scale=None if vs is None else vs[i])

            a = args(0)
            kw = dict(k_scale=a["k_scale"], v_scale=a["v_scale"])
            err = use = 0.0
            for hint, ns in ((reach, n_split), (None, n_split_bare)):
                out = flash_gqa_cache(a["q"], a["k"], a["v"], pos0, valid, reach=hint, **kw)
                torch.cuda.synchronize()
                for ref in (flash_gqa_cache_split_reference(a["q"], a["k"], a["v"], pos0, valid, n_split=ns, **kw),
                            flash_gqa_cache_reference(a["q"], a["k"], a["v"], pos0, valid, **kw)):
                    e, u = flash_check(out, ref)
                    err, use = max(err, e), max(use, u)
                if not torch.isfinite(out).all() or use > 1.0:
                    raise AssertionError(f"{name} {shape} (reach {hint}): max |kernel - plain| = {err}, "
                                         f"{use:.3g} of the tolerance (FLASH_REL {FLASH_REL}, FLASH_ATOL {FLASH_ATOL})")
                if kind == "slots" and not torch.equal(out[b - 1], torch.zeros_like(out[b - 1])):
                    raise AssertionError(f"{name} {shape}: the slot that sees nothing is not zeros")
                if reach is None:
                    break
            row["max_abs_err"] = max(row["max_abs_err"], err)

            it = iter(range(1 << 30))

            def kern(hint=reach):
                a = args(next(it))
                flash_gqa_cache(a["q"], a["k"], a["v"], pos0, a["kv_valid"],
                                k_scale=a["k_scale"], v_scale=a["v_scale"], reach=hint)

            def plain():
                a = args(next(it))
                flash_gqa_cache_reference(a["q"], a["k"], a["v"], pos0, a["kv_valid"],
                                          k_scale=a["k_scale"], v_scale=a["v_scale"])

            # Yardstick: one library call on the same inputs (int8 dequantized
            # first), q heads-major, the same boolean mask.
            q_pos = pos0 + torch.arange(s, device="cuda")
            mask = (q_pos[:, None] >= torch.arange(l, device="cuda")[None, :])[None, None]
            if valid is not None:
                mask = mask & valid[:, None, None, :]
            qh = q.transpose(1, 2)

            def library():
                a = args(next(it))
                kk, vv = a["k"], a["v"]
                if kv8:
                    kk = _kv_dequant(kk, a["k_scale"], torch.bfloat16)
                    vv = _kv_dequant(vv, a["v_scale"], torch.bfloat16)
                F.scaled_dot_product_attention(qh, kk, vv, attn_mask=mask, enable_gqa=True)

            ms = graph_ms(kern, n=4 * copies)
            bare = ""
            if reach is not None:  # the same launches without the hint, in the same run
                bare = (f" without the reach hint: n_split={n_split_bare} "
                        f"kernel_ms={graph_ms(lambda: kern(None), n=4 * copies):.6f};")
            plain_ms = graph_ms(plain, n=2)
            lib_ms = graph_ms(library, n=4 * copies)
            call_ms = cuda_ms(kern, iters=50, warmup=5)  # one eager call, wrapper included
            bound_ms, bound_by = flash_bound_ms(b, s, l, kv8)
            seen_ms, _ = flash_bound_ms(b, s, l, kv8, seen_rows)
            log(f"{name} {shape} (B={b} S={s} L={l} reach={reach}): n_split={n_split} live_tiles={live_frac:.4f} "
                f"max_abs_err={err:.3g} ({use:.3f} of the tolerance) kernel_ms={ms:.6f};{bare} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.6f} "
                f"bound_ms={bound_ms:.6f} ({bound_by}) bound_seen_ms={seen_ms:.6f} "
                f"({seen_rows} of {b * l} rows seen) eager_call_ms={call_ms:.4f} [{card}]")
            if shape == "decode":  # the main path's most frequent shape
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                           bound_seen_ms=seen_ms)
            del q, k, v, ks, vs
        rows[name] = row
    torch.cuda.empty_cache()
    return rows


class RecordingTokenizer:
    """The byte tokenizer, remembering the ids each ``decode`` was given, so
    the tokens behind ``generate_batch``'s texts can be checked."""

    def __init__(self):
        from kakveda_tpu_torch.models.tokenizer import ByteTokenizer

        self._tok = ByteTokenizer()
        self.PAD, self.BOS, self.EOS = self._tok.PAD, self._tok.BOS, self._tok.EOS
        self.vocab_size = self._tok.vocab_size
        self.decoded = []

    def encode(self, text, **kw):
        return self._tok.encode(text, **kw)

    def decode(self, ids):
        self.decoded.append(list(ids))
        return self._tok.decode(ids)


PROMPTS = [  # 8 distinct prompts of 48-52 tokens: one admission bucket of 64
    f"Incident {i}: the {what} failed; summarize why."
    for i, what in enumerate(
        ["checkout API", "search index", "login flow", "payments batch",
         "image resizer", "mail relay", "audit export", "cache warmer"]
    )
]


def phase_model(card: str) -> dict:
    from kakveda_tpu_torch.models.attention import flash_gqa_cache
    from kakveda_tpu_torch.models.generate import LlamaRuntime, generate_tokens
    from kakveda_tpu_torch.models.llama import LlamaConfig, decode_step, init_cache, mask_pad_vocab
    from kakveda_tpu_torch.models.serving import ContinuousBatcher, _forward_wide

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    tok = RecordingTokenizer()
    rt = LlamaRuntime(cfg=cfg, seed=0, tokenizer=tok)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size()
                  for t in [rt.params["embed"], rt.params["lm_head"], rt.params["final_norm"]]
                  + [w for layer in rt.params["layers"] for w in layer.values()])
    log(f"Llama-3-8B width and depth: {cfg.n_layers} layers, {n_bytes / 1e9:.2f} GB of weights "
        f"on {rt.device}, drawn in {time.perf_counter() - t0:.1f} s")
    if rt.device.type != "cuda" or abs(n_bytes - 16.06e9) > 0.01e9:
        raise AssertionError(f"model on {rt.device} with {n_bytes} bytes")
    ids = [tok.encode(p) for p in PROMPTS]
    if len({tuple(i) for i in ids}) != 8 or not all(33 <= len(i) <= 64 for i in ids):
        raise AssertionError("prompts must be 8 distinct, of one admission bucket")

    out = {}
    first_logits = {}
    for kvq in ("", "int8"):
        tag = kvq or "bf16"
        rq = rt if not kvq else LlamaRuntime(cfg=dataclasses.replace(rt.cfg, kv_quant=kvq),
                                             params=rt.params, tokenizer=tok)
        eng = rq.engine()
        if (eng.cb.B, eng.cb.max_len, eng.cb.chunk_steps) != (8, 512, 8):
            raise AssertionError("engine is not 8 slots, window 512, chunk 8")
        rq.generate_batch(PROMPTS[:2], max_tokens=8)  # warm-up: cuBLAS heuristics, allocator
        tok.decoded.clear()
        flash_gqa_cache.launches = 0
        flash_gqa_cache.launches_kv8 = 0
        f0 = eng.cb.forwards
        t = time.perf_counter()
        res = rq.generate_batch(PROMPTS, max_tokens=32)
        wall = time.perf_counter() - t
        n_fwd = eng.cb.forwards - f0
        mine, other = flash_gqa_cache.launches, flash_gqa_cache.launches_kv8
        if kvq:
            mine, other = other, mine
        got = list(tok.decoded)
        rq.close()
        if mine != cfg.n_layers * n_fwd or other != 0:
            raise AssertionError(f"{tag}: {mine} launches for {n_fwd} forwards (want {cfg.n_layers} each), "
                                 f"{other} of the other kernel")
        if len(res) != 8 or not all(r.meta.get("continuous") for r in res) or len(got) != 8:
            raise AssertionError(f"{tag}: generate_batch did not run through the engine")
        n_tok = sum(len(g) for g in got)

        def forced(p_ids, toks):
            """Solo logits [len(toks) + 1, V] along prompt + toks, one pass."""
            seq = torch.tensor([p_ids + toks], device="cuda")
            cache = init_cache(rq.cfg, batch=1, max_len=seq.shape[1], device="cuda")
            logits, _ = decode_step(rq.params, rq.cfg, seq, cache)
            lg = mask_pad_vocab(logits[0, len(p_ids) - 1:], rq.cfg)
            if not torch.isfinite(lg[:, : tok.vocab_size]).all():
                raise AssertionError(f"{tag}: non-finite logits")
            return lg

        compared, deficit = [], 0.0
        for p_ids, eng_ids in zip(ids, got):
            # Equal to solo generate_tokens up to its first low-margin step.
            solo = generate_tokens(rq.params, rq.cfg, p_ids, max_new_tokens=32, eos_id=tok.EOS)
            lg = forced(p_ids, solo)
            first_logits.setdefault(tag, []).append(lg[0, : tok.vocab_size].double())
            top2 = lg.topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).tolist()
            n = min(len(solo), next((j for j, m in enumerate(margin) if m < MARGIN_TOL), len(solo)))
            if eng_ids[:n] != solo[:n]:
                raise AssertionError(f"{tag}: engine {eng_ids[:n]} != solo {solo[:n]} within {n} steps")
            compared.append(n)
            # Every engine token (and its EOS stop) within MARGIN_TOL of the
            # solo argmax on the engine's own prefix.
            picks = eng_ids + ([tok.EOS] if len(eng_ids) < 32 else [])
            lg = forced(p_ids, eng_ids)[: len(picks)]
            d = lg.max(dim=-1).values - lg[torch.arange(len(picks)), torch.tensor(picks)]
            deficit = max(deficit, d.max().item())
            if deficit > MARGIN_TOL:
                raise AssertionError(f"{tag}: an engine token is {deficit} below the solo argmax")
        log(f"{tag} cache: engine == solo generate_tokens on {sum(compared)} of {n_tok} tokens "
            f"(per prompt {compared}); every engine token within {deficit:.4f} of the solo argmax "
            f"on its own prefix; {n_fwd} forwards, {mine} launches")
        out[tag] = dict(launches=mine, forwards=n_fwd, tokens=n_tok, wall_s=wall,
                        tokens_per_s=n_tok / wall, compared=sum(compared), max_deficit=deficit)

    cos = [torch.nn.functional.cosine_similarity(a, b, dim=0).item()
           for a, b in zip(first_logits["bf16"], first_logits["int8"])]
    log(f"int8 cache vs bf16 cache, first-step logits cosine min {min(cos):.6f} (bound {INT8_COS_MIN})")
    if min(cos) < INT8_COS_MIN:
        raise AssertionError(f"int8-cache logits drift: cosine {min(cos)}")

    # Admission and decode-step times on a batcher of the engine's shape.
    for kvq in ("", "int8"):
        tag = kvq or "bf16"
        cb = ContinuousBatcher(rt.params, dataclasses.replace(rt.cfg, kv_quant=kvq),
                               batch_slots=8, max_len=512, chunk_steps=8, eos_id=None)
        adm = []
        for p_ids in ids:
            torch.cuda.synchronize()
            t = time.perf_counter()
            cb.admit(p_ids, max_new_tokens=400)
            torch.cuda.synchronize()
            adm.append((time.perf_counter() - t) * 1e3)
        cb.step()  # warm
        steps = []
        for _ in range(6):
            t = time.perf_counter()
            cb.step()  # ends in the tokens' device->host copy
            steps.append((time.perf_counter() - t) * 1e3 / cb.chunk_steps)
        if cb.active != 8:
            raise AssertionError("a slot retired early")
        # The same step's device time, its launches replayed from a graph.
        dev_args = (torch.zeros((8, 1), dtype=torch.long, device="cuda"),
                    torch.from_numpy(cb._pos_np.copy()).to("cuda"),
                    torch.from_numpy(cb._kv_np.copy()).to("cuda"),
                    torch.from_numpy(cb._off_np.copy()).to("cuda"))
        reach = int(cb._pos_np.max()) + 1  # the hint step_async passes
        step_dev = graph_ms(lambda: _forward_wide(cb.params, cb.cfg, cb.cache, *dev_args, reach=reach), n=4)
        del cb
        torch.cuda.empty_cache()
        weight_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        out[tag].update(admission_ms_p50=statistics.median(adm), decode_step_ms_p50=statistics.median(steps),
                        decode_step_device_ms=step_dev, weight_read_bound_ms=weight_ms)
        log(f"{tag} cache: admission p50 {statistics.median(adm):.2f} ms (B=1, S=64), decode step p50 "
            f"{statistics.median(steps):.2f} ms at 8 slots (device time {step_dev:.2f} ms) vs the "
            f"weight-read bound {weight_ms:.2f} ms, engine {out[tag]['tokens_per_s']:.1f} tokens/s [{card}]")
    log("model plane: " + json.dumps(out))
    return out


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _service_traces(TracePayload, lo: int, n: int):
    """Phase 4's trace generator, failing and passing mixed: three in four
    ask for citations and get a cited answer (a HALLUCINATION_CITATION each,
    every signature new); the fourth gets an answer with no markers."""
    return [
        _trace(TracePayload, 200_000 + i, f"app-{'ABCDEFG'[i % 7]}", f"Summarize report {i} and include citations",
               response=STUB_RESPONSE if i % 4 else "No sources were provided, so none are cited.")
        for i in range(lo, lo + n)
    ]


def _warn_body(app_id: str, prompt: str) -> dict:
    return {"app_id": app_id, "prompt": prompt, "tools": [], "env": {"os": "linux"}}


class _Tally:
    """``fused_topk`` launches of the service's own requests: the counter's
    growth summed over spans of HTTP calls, so the direct calls that check
    their answers stay out of the count."""

    def __init__(self, fused_topk):
        self.fn, self.n = fused_topk, 0

    @contextlib.contextmanager
    def span(self):
        mark = self.fn.launches
        try:
            yield
        finally:
            self.n += self.fn.launches - mark


class _DispatchSpans:
    """CUDA events around every ``topk_async_sparse`` call of ``knn`` (one
    warn batch's upload, densify, ``fused_topk`` and pack), from whichever
    thread makes it. A span also holds the host's enqueue gaps inside the
    call, so their sum bounds the card's busy time from above."""

    def __init__(self, knn):
        self.knn, self.pairs, self.lock = knn, [], threading.Lock()
        fn = knn.topk_async_sparse

        def timed(*a, **k):
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            try:
                return fn(*a, **k)
            finally:
                ev[1].record()
                with self.lock:
                    self.pairs.append(ev)

        knn.topk_async_sparse = timed

    def close(self) -> float:
        """Unwrap and return the spans' summed device ms."""
        del self.knn.topk_async_sparse  # the method again
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


class _Http:
    """Phase 8's client over real TCP to ``make_app`` on a ``TCPSite``."""

    def __init__(self, session, base: str):
        self.s, self.base = session, base

    async def _post(self, path, body):
        async with self.s.post(self.base + path, json=body) as r:
            out = await r.json()
            if r.status != 200:
                raise AssertionError(f"POST {path}: {r.status} {out}")
            return out

    async def get(self, path):
        async with self.s.get(self.base + path) as r:
            out = await r.json()
            if r.status != 200:
                raise AssertionError(f"GET {path}: {r.status} {out}")
            return out

    async def ingest_batch(self, traces):
        return await self._post("/ingest/batch", {"traces": traces})

    async def warn(self, body):
        return await self._post("/warn", body)

    async def mine(self, body):
        return await self._post("/patterns/mine", body)

    async def match(self, sig):
        return await self._post("/failures/match", {"signature_text": sig})


async def _service_arms(client, plat, fused_topk, card: str) -> dict:
    """Steps a-e of phase 8 through ``client``; ``launches_service`` counts
    the ``fused_topk`` launches of their HTTP requests alone."""
    from kakveda_tpu_torch.core.fingerprint import signature_text
    from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest

    out = {}
    # a. Ingest: 8 x 512 traces.
    traces = [t.model_dump(mode="json") for t in _service_traces(TracePayload, 0, 4096)]
    n0 = plat.gfkb.count
    fused_topk.launches = 0
    tally = _Tally(fused_topk)
    t0 = time.perf_counter()
    failures = 0
    with tally.span():
        for lo in range(0, 4096, 512):
            failures += (await client.ingest_batch(traces[lo : lo + 512]))["failures"]
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    if failures != plat.gfkb.count - n0 or failures != 3072:
        raise AssertionError(f"ingest: {failures} failures answered, GFKB grew {plat.gfkb.count - n0}")
    out["ingest_traces_per_s"] = 4096 / ingest_s
    log(f"phase 8 a: {failures} failures of 4096 traces in 8 batches of 512, "
        f"{out['ingest_traces_per_s']:.1f} traces/s end to end [{card}]")

    # b. One client: 256 warns, half of ingested signatures, half new.
    seen = [i for i in range(4096) if i % 4][:128]
    b_bodies = [_warn_body(f"app-{'ABCDEFGH'[j % 8]}", f"Summarize report {i} and include citations")
                for j, i in enumerate(seen)]
    b_bodies += [_warn_body(f"app-{'ABCDEFGH'[j % 8]}", f"Translate poem {j} into French verse")
                 for j in range(128)]
    order = [x for pair in zip(b_bodies[:128], b_bodies[128:]) for x in pair]
    lat_b, res_b = [], []
    with tally.span():
        await client.warn(order[0])  # warm the handler path
        for body in order:
            t = time.perf_counter()
            res_b.append(await client.warn(body))
            lat_b.append((time.perf_counter() - t) * 1e3)
    out["warn_c1_p50_ms"], out["warn_c1_p99_ms"] = _pct(lat_b, 0.5), _pct(lat_b, 0.99)
    log(f"phase 8 b: /warn at concurrency 1, 256 requests: p50 {out['warn_c1_p50_ms']:.3f} ms, "
        f"p99 {out['warn_c1_p99_ms']:.3f} ms [{card}]")

    # c. 64 clients x 16 warns; fused_topk is the card's only caller here.
    c_bodies = [[_warn_body(f"app-{'ABCDEFGH'[c % 8]}",
                            f"Summarize report {(c * 16 + j) * 3 + 1} and include citations" if j % 2 == 0
                            else f"Client {c} asks {j} about a new topic") for j in range(16)] for c in range(64)]
    lat_c = [[] for _ in range(64)]
    res_c = [[None] * 16 for _ in range(64)]

    async def one_client(c):
        for j, body in enumerate(c_bodies[c]):
            t = time.perf_counter()
            res_c[c][j] = await client.warn(body)
            lat_c[c].append((time.perf_counter() - t) * 1e3)

    spans = _DispatchSpans(plat.gfkb._knn)
    mark = fused_topk.launches
    try:
        with tally.span():
            t0 = time.perf_counter()
            await asyncio.gather(*[one_client(c) for c in range(64)])
            wall = time.perf_counter() - t0
    finally:
        span_ms = spans.close()
    launches = fused_topk.launches - mark
    flat = [x for xs in lat_c for x in xs]
    if not (1024 // 64 <= launches < 1024) or len(spans.pairs) != launches:
        raise AssertionError(f"1024 concurrent warns took {launches} fused_topk launches "
                             f"in {len(spans.pairs)} dispatches")
    out.update(warn_c64_p50_ms=_pct(flat, 0.5), warn_c64_p99_ms=_pct(flat, 0.99), warn_c64_per_s=1024 / wall,
               warn_c64_launches=launches, warn_c64_requests_per_launch=1024 / launches,
               warn_c64_dispatch_device_ms=span_ms, warn_c64_dispatch_span_share=span_ms / (wall * 1e3))
    log(f"phase 8 c: /warn at concurrency 64, 64 x 16 requests: p50 {out['warn_c64_p50_ms']:.3f} ms, "
        f"p99 {out['warn_c64_p99_ms']:.3f} ms, {out['warn_c64_per_s']:.1f} warns/s, {launches} fused_topk "
        f"launches, {out['warn_c64_requests_per_launch']:.2f} requests per launch; the batches' device "
        f"dispatches (upload, densify, fused_topk, pack; CUDA events) span {span_ms:.3f} ms of the arm's "
        f"{wall * 1e3:.3f} ms ({100 * out['warn_c64_dispatch_span_share']:.2f} %) [{card}]")

    # d. The read routes agree with the platform, then every answer equals
    # a direct warn_batch of the same requests.
    sig = signature_text(f"Summarize report {seen[0]} and include citations", [], {"os": "linux"})
    with tally.span():
        m = (await client.match(sig))["matches"]
        pats = (await client.get("/patterns"))["patterns"]
        pts = (await client.get("/health/app-A"))["points"]
        ready = await client.get("/readyz")
    want = plat.gfkb.match(sig)
    if [x["failure_id"] for x in m[:1]] != [want[0].failure_id] or abs(m[0]["score"] - want[0].score) > ATOL:
        raise AssertionError(f"/failures/match {m[:1]} vs {want[:1]}")
    if _pattern_key_json(pats) != _pattern_key(plat.patterns_list()):
        raise AssertionError("/patterns differs from the platform's")
    if len(pts) != len(plat.health_history("app-A")) or not pts:
        raise AssertionError("/health/app-A differs from the platform's")
    if not (ready["native"]["available"] and ready["device"]["name"] == torch.cuda.get_device_name(0)
            and ready["gfkb_count"] == plat.gfkb.count):
        raise AssertionError(f"/readyz: {ready}")
    bodies = order + [b for bs in c_bodies for b in bs]
    answers = res_b + [r for rs in res_c for r in rs]
    reqs = [WarningRequest.model_validate(b) for b in bodies]
    direct, tops = [], []
    for lo in range(0, len(reqs), 64):
        chunk = reqs[lo : lo + 64]
        direct += plat.warn_batch(chunk)
        tops += plat.gfkb.match_batch([signature_text(r.prompt, r.tools, r.env) for r in chunk])
    checked_ids = 0
    for j, (a, d, top) in enumerate(zip(answers, direct, tops)):
        if a["action"] != d.action or abs(a["confidence"] - d.confidence) > ATOL:
            raise AssertionError(f"answer {j}: {a['action']} {a['confidence']} vs direct {d.action} {d.confidence}")
        separated = len(top) < 2 or top[0].score - top[1].score > ATOL
        if d.references and separated:
            if not a["references"] or a["references"][0]["failure_id"] != d.references[0].failure_id:
                raise AssertionError(f"answer {j}: reference differs from the direct warn")
            checked_ids += 1
    out["answers_checked"] = len(answers)
    log(f"phase 8 d: /failures/match, /patterns, /health, /readyz agree with the platform; {len(answers)} "
        f"answers equal a direct warn_batch (action, confidence within {ATOL}, reference id on {checked_ids} "
        f"separated top-1s)")

    # e. Mining through the route.
    with tally.span():
        body = await client.mine({"mode": "full"})
    t = time.perf_counter()
    direct_full, dinfo = plat.mine(mode="full")
    direct_ms = (time.perf_counter() - t) * 1e3
    if body["mining"]["mode"] != "full" or _pattern_key_json(body["patterns"]) != _pattern_key(direct_full):
        raise AssertionError(f"/patterns/mine full differs from plat.mine(mode='full'): {body['mining']}")
    more = [t.model_dump(mode="json") for t in _service_traces(TracePayload, 4096, 512)]
    with tally.span():
        await client.ingest_batch(more)
        t = time.perf_counter()
        inc = await client.mine({})
        inc_ms = (time.perf_counter() - t) * 1e3
    if inc["mining"]["mode"] != "incremental":
        raise AssertionError(f"/patterns/mine after one more ingest: {inc['mining']}")
    out.update(mine_full_route_wall_ms=body["mining"]["wall_ms"], mine_full_direct_ms=direct_ms,
               mine_incremental_route_ms=inc_ms, patterns=len(direct_full))
    log(f"phase 8 e: /patterns/mine full == plat.mine(mode='full') ({len(direct_full)} patterns, route wall "
        f"{body['mining']['wall_ms']:.1f} ms, direct {direct_ms:.1f} ms); after 512 more traces /patterns/mine "
        f"{{}} is incremental ({inc_ms:.1f} ms, {inc['mining'].get('attached')} rows attached) [{card}]")
    out["launches_service"] = tally.n
    return out


def _pattern_key_json(patterns):
    return {(p["name"], tuple(p["failure_ids"]), tuple(sorted(p["affected_apps"])), p["description"])
            for p in patterns}


class _Stages:
    """Per-call stage times through wrappers on the real call path: a
    stage's host time is taken with the card synchronized at both of its
    boundaries (device stages also get CUDA events)."""

    def __init__(self):
        self.host, self.dev, self._undo = {}, {}, []

    def wrap(self, obj, attr, name, sync=True, events=False):
        fn = getattr(obj, attr)

        def timed(*a, **k):
            if sync:
                torch.cuda.synchronize()
            if events:
                ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                ev[0].record()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if events:
                    ev[1].record()
                if sync:
                    torch.cuda.synchronize()
                self.host[name] = self.host.get(name, 0.0) + (time.perf_counter() - t) * 1e3
                if events:
                    self.dev[name] = self.dev.get(name, 0.0) + ev[0].elapsed_time(ev[1])

        own = attr in vars(obj)
        setattr(obj, attr, timed)
        self._undo.append((obj, attr, fn if own else None))

    def take(self):
        out = dict(host=self.host, dev=self.dev)
        self.host, self.dev = {}, {}
        return out

    def restore(self):
        for obj, attr, fn in reversed(self._undo):
            if fn is None:
                delattr(obj, attr)  # a method again, not an instance attribute
            else:
                setattr(obj, attr, fn)
        self._undo.clear()


def host_split(plat, card: str) -> dict:
    """The warn path's stages for B = 1 and B = 64, and one 512-trace
    ingest batch's, at phase 8's index (medians over repeated calls)."""
    from kakveda_tpu_torch import native
    from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
    from kakveda_tpu_torch.ops import knn as knn_mod
    from kakveda_tpu_torch.ops.featurizer import dense_rows_to_sparse
    from kakveda_tpu_torch.pipeline import warning as warning_mod
    from kakveda_tpu_torch.core.fingerprint import signature_text

    gfkb, f, lib = plat.gfkb, plat.gfkb.featurizer, native.load()
    out = {}
    for b in (1, 64):
        reqs = [WarningRequest(app_id="app-s", prompt=f"Summarize report {i * 7 + 1} and include citations",
                               tools=[], env={"os": "linux"}) for i in range(b)]
        sigs = [signature_text(r.prompt, r.tools, r.env) for r in reqs]
        walls = []
        for _ in range(3):
            plat.warn_batch(reqs)
        for _ in range(30):
            t = time.perf_counter()
            plat.warn_batch(reqs)
            walls.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        py_ms, nat_ms = [], []
        for _ in range(30):
            t = time.perf_counter()
            dense_rows_to_sparse(f._encode_batch_py(sigs), f.dim)
            py_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            f._encode_sparse_native(lib, sigs)
            nat_ms.append((time.perf_counter() - t) * 1e3)
        st = _Stages()
        st.wrap(warning_mod, "signature_text", "signature_text", sync=False)
        st.wrap(f, "encode_batch_sparse", "featurize (native)", sync=False)
        st.wrap(knn_mod, "to_device", "upload (idx, val)")
        st.wrap(gfkb._knn, "densify", "densify", events=True)
        st.wrap(knn_mod, "fused_topk", "fused_topk", events=True)
        st.wrap(gfkb._knn, "topk_result", "d2h + unpack")
        st.wrap(plat.warning_policy, "warn_batch", "call")
        calls = []
        try:
            for _ in range(30):
                plat.warn_batch(reqs)
                calls.append(st.take())
        finally:
            st.restore()
        med = lambda key, kind="host": statistics.median(c[kind].get(key, 0.0) for c in calls)  # noqa: E731
        stages = {k: med(k) for k in ("signature_text", "featurize (native)", "upload (idx, val)", "densify",
                                      "fused_topk", "d2h + unpack")}
        # The rest: the bucket pad, the lock, the packed cat, the match
        # cache, FailureMatch and WarningResponse construction.
        stages["pad + matches + responses (rest)"] = med("call") - sum(stages.values())
        out[f"warn_b{b}"] = dict(
            stages_host_ms=stages, densify_dev_ms=med("densify", "dev"), fused_topk_dev_ms=med("fused_topk", "dev"),
            featurize_python_ms=statistics.median(py_ms), featurize_native_ms=statistics.median(nat_ms),
            synced_call_ms=med("call"), warn_batch_wall_ms=statistics.median(walls),
        )
        log(f"warn host split, B = {b}: " + json.dumps(out[f"warn_b{b}"]) + f" [{card}]")

    # One 512-trace ingest batch (after a warm-up batch).
    traces = _service_traces(TracePayload, 10_000, 1024)
    asyncio.run(plat.ingest_batch(traces[:512]))
    batch = traces[512:]
    texts = [signature_text(t.prompt, t.tools, t.env) for t in batch if t.response == STUB_RESPONSE]
    t = time.perf_counter()
    dense_rows_to_sparse(f._encode_batch_py(texts), f.dim)
    py_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    f._encode_sparse_native(lib, texts)
    nat_ms = (time.perf_counter() - t) * 1e3
    st = _Stages()
    st.wrap(plat.classifier, "classify_batch", "classify", sync=False)
    st.wrap(f, "encode_batch_sparse", "featurize (native)", sync=False)
    st.wrap(gfkb._knn, "insert_sparse", "insert")
    st.wrap(gfkb, "_mine_attach_new", "delta dispatch")
    st.wrap(gfkb, "_append_line", "log append", sync=False)
    st.wrap(gfkb, "_flush_logs", "log flush", sync=False)
    torch.cuda.synchronize()
    try:
        t = time.perf_counter()
        asyncio.run(plat.ingest_batch(batch))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        got = st.take()
    finally:
        st.restore()
    stages = dict(got["host"])
    stages["rest (records, health, patterns, event loop)"] = wall - sum(stages.values())
    out["ingest_512"] = dict(stages_host_ms=stages, featurize_python_ms=py_ms, featurize_native_ms=nat_ms,
                             failures=len(texts), wall_ms=wall)
    log("ingest host split, 512 traces: " + json.dumps(out["ingest_512"]) + f" [{card}]")
    return out


async def _warn_clients(post, clients: int, per_client: int) -> dict:
    """``clients`` concurrent clients, each sending ``per_client`` warns in
    turn (half of ingested signatures, half new): p50, p99, warns/s."""
    lat = []

    async def one(c):
        for j in range(per_client):
            prompt = (f"Summarize report {(c * per_client + j) * 3 + 1} and include citations" if j % 2 == 0
                      else f"Client {c} asks {j} about a new topic")
            t = time.perf_counter()
            body = await post("/warn", _warn_body(f"app-{'ABCDEFG'[c % 7]}", prompt))
            lat.append((time.perf_counter() - t) * 1e3)
            if body["action"] not in ("warn", "block", "silent"):
                raise AssertionError(f"warn answer {body}")

    t0 = time.perf_counter()
    await asyncio.gather(*[one(c) for c in range(clients)])
    wall = time.perf_counter() - t0
    return dict(p50_ms=_pct(lat, 0.5), p99_ms=_pct(lat, 0.99), warns_per_s=clients * per_client / wall)


def run_entry_point(base: Path, card: str) -> dict:
    """``python3 -m kakveda_tpu_torch.service`` as its own process on the
    card, its index at the GFKB's real size: it answers ``/healthz`` within
    120 s, ingests a warm-up batch and 8 timed batches of 512 traces, warns
    (one ingested signature must match itself; then 64 clients x 16 warns,
    the client in this process and the server in its own), exits 0 on
    SIGINT, and its data dir replays."""
    import signal

    import aiohttp

    from kakveda_tpu_torch.core.schemas import TracePayload
    from kakveda_tpu_torch.platform import Platform

    root = Path(__file__).resolve().parent
    data = base / "service-data"
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(root), KAKVEDA_LOG_FORMAT="text", KAKVEDA_INDEX_CAPACITY=str(ROWS))
    out_path = base / "service.log"
    base_url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    with open(out_path, "wb") as out_f:
        proc = subprocess.Popen([sys.executable, "-m", "kakveda_tpu_torch.service", "--port", str(port),
                                 "--data-dir", str(data)], cwd=root, env=env,
                                stdout=out_f, stderr=subprocess.STDOUT)

    async def drive():
        async with aiohttp.ClientSession(connector=aiohttp.TCPConnector(limit=128)) as s:
            async def post(path, body):
                async with s.post(base_url + path, json=body) as r:
                    out = await r.json()
                    if r.status != 200:
                        raise AssertionError(f"service POST {path}: {r.status} {out}")
                    return out

            while True:
                if proc.poll() is not None:
                    raise AssertionError("the service exited early:\n" + out_path.read_text()[-3000:])
                if time.perf_counter() - t0 > 120:
                    raise AssertionError("the service did not answer /healthz within 120 s")
                try:
                    async with s.get(base_url + "/healthz") as r:
                        if r.status == 200:
                            break
                except aiohttp.ClientConnectionError:
                    await asyncio.sleep(0.2)
            up_s = time.perf_counter() - t0
            # One warm-up batch first (the process's first device calls
            # initialize cuBLAS and the allocator), then 8 timed batches.
            warm = [t.model_dump(mode="json") for t in _service_traces(TracePayload, 100_000, 512)]
            await post("/ingest/batch", {"traces": warm})
            traces = [t.model_dump(mode="json") for t in _service_traces(TracePayload, 0, 4096)]
            t = time.perf_counter()
            failures = 0
            for lo in range(0, 4096, 512):
                failures += (await post("/ingest/batch", {"traces": traces[lo : lo + 512]}))["failures"]
            ingest_s = time.perf_counter() - t
            w = await post("/warn", _warn_body("app-z", "Summarize report 1 and include citations"))
            async with s.get(base_url + "/readyz") as r:
                ready = await r.json()
            if failures != 3072 or not w["references"] or w["confidence"] < 0.99:
                raise AssertionError(f"service answers: {failures} failures, {w}")
            if not (ready["native"]["available"] and ready["device"]["type"] == "cuda"
                    and ready["gfkb_count"] == 3072 + 384):
                raise AssertionError(f"service /readyz: {ready}")
            await post("/warn", _warn_body("app-z", "warm up"))
            c64 = await _warn_clients(post, 64, 16)
            return dict(start_s=up_s, ingest_traces_per_s=4096 / ingest_s, warn_c64=c64,
                        confidence=w["confidence"], failure_id=w["references"][0]["failure_id"])

    try:
        out = asyncio.run(drive())
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"service exit code {rc}:\n" + out_path.read_text()[-3000:])
    rows = (data / "failures.jsonl").read_text().splitlines()
    plat = Platform(data_dir=data, capacity=1 << 12, dim=DIM)
    if len(rows) != 3072 + 384 or plat.gfkb.count != 3072 + 384 or plat.device.type != "cuda":
        raise AssertionError(f"replay: {len(rows)} log rows, {plat.gfkb.count} records on {plat.device}")
    out["replayed"] = plat.gfkb.count
    plat.close()
    c64 = out["warn_c64"]
    log(f"python3 -m kakveda_tpu_torch.service ({ROWS} x {DIM} index): answered /healthz after "
        f"{out['start_s']:.1f} s; /ingest/batch 8 x 512 (after one warm-up batch) at "
        f"{out['ingest_traces_per_s']:.1f} traces/s; an ingested "
        f"signature warned at {out['confidence']:.6f} ({out['failure_id']}); /warn at concurrency 64 (64 x 16, "
        f"client in another process): p50 {c64['p50_ms']:.3f} ms, p99 {c64['p99_ms']:.3f} ms, "
        f"{c64['warns_per_s']:.1f} warns/s; exited 0 on SIGINT; a fresh Platform on the card replayed "
        f"{out['replayed']} records [{card}]")
    return out


def phase_service(base: Path, fused_topk, card: str) -> dict:
    """Phase 8: the service plane on the card at the GFKB's real size."""
    import aiohttp  # required: without it phase 8 fails
    from aiohttp import web

    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service.app import make_app

    log(f"aiohttp {aiohttp.__version__}")
    plat = Platform(data_dir=base / "service", capacity=ROWS, dim=DIM)
    if plat.device.type != "cuda":
        raise AssertionError(f"Platform on {plat.device}")

    async def go():
        runner = web.AppRunner(make_app(plat))
        await runner.setup()
        port = _free_port()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            async with aiohttp.ClientSession(connector=aiohttp.TCPConnector(limit=128)) as s:
                return await _service_arms(_Http(s, f"http://127.0.0.1:{port}"), plat, fused_topk, card)
        finally:
            await runner.cleanup()

    out = asyncio.run(go())
    out["host_split"] = host_split(plat, card)
    plat.close()
    del plat
    torch.cuda.empty_cache()
    out["entry_point"] = run_entry_point(base, card)
    log("phase 8: " + json.dumps({k: v for k, v in out.items() if k != "host_split"}))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    # The whole run on the native host tier: no silent Python fallback.
    os.environ["KAKVEDA_NATIVE"] = "require"
    from kakveda_tpu_torch import native
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
    g_plus = threading.Thread(target=native.load)  # g++ beside the nvcc builds
    g_plus.start()
    libs = _build.build(names)
    g_plus.join()
    log(f"built {names} in {time.perf_counter() - t0:.2f} s")
    if native.load() is None:
        raise AssertionError("KAKVEDA_NATIVE=require, yet the native library did not load")
    log("native host tier: " + json.dumps(native.status()) + " (featurizer and GFKB logs run on it)")
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
    topk_lib = _build.load("fused_topk")
    for width in (8, 16, 32, 64):
        log(f"  fused_topk at wgmma N={width}: {topk_lib.kkv_fused_topk_stages(width)} ring stages, "
            f"{topk_lib.kkv_fused_topk_smem_bytes(width)} bytes of dynamic shared memory")

    row = phase_kernels(fused_topk, fused_topk_reference, card)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="kakveda-smoke-") as d:
        count_mining_calls()
        fused_topk.launches = 0
        MINING_CALLS.update(dict.fromkeys(MINING_CALLS, 0))
        main_path = phase_platform(Path(d) / "data", fused_topk, fused_topk_reference, card)
        launches = fused_topk.launches
    if launches <= 0:
        raise AssertionError("the main path never launched fused_topk")
    log(f"fused_topk launches on the main path: {launches}")
    torch.cuda.empty_cache()  # the 2^20 x 2048 index is gone; the model needs the room

    phase_mining(card)

    with tempfile.TemporaryDirectory(prefix="kakveda-service-") as d:
        service = phase_service(Path(d), fused_topk, card)
    service_launches = service["launches_service"]
    if service_launches <= 0:
        raise AssertionError("the service path never launched fused_topk")
    log(f"fused_topk launches of the service's requests (phase 8 a-e): {service_launches}")
    torch.cuda.empty_cache()

    flash = phase_flash(card)
    model = phase_model(card)

    kernels = [dict(
        name="fused_topk", route="cuda", source="kakveda_tpu_torch/csrc/fused_topk.cu",
        replaces="kakveda_tpu/ops/pallas_knn.py:128", launches=launches,
        launches_service=service_launches, launches_service_c64=service["warn_c64_launches"],
        max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
        shape="B=1, k=5", b64=dict(shape="B=64, k=5", **row["b64"]),
    )]
    for kname, tag in (("flash_gqa_cache", "bf16"), ("flash_gqa_cache_kv8", "int8")):
        r = flash[kname]
        kernels.append(dict(
            name=kname, route="cuda", source="kakveda_tpu_torch/csrc/flash_gqa_cache.cu",
            replaces="kakveda_tpu/models/attention.py:284", launches=model[tag]["launches"],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            bound_seen_ms=r["bound_seen_ms"],
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
