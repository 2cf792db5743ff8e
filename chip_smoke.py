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
   it, without), admission (B = 1, S = 64, L = 512, 13 left-pad slots),
   a long cache (B = 8, S = 1, L = 8192), and phase 10's two shapes with
   S > 1 at pos0 > 0: a prefix-hit admission (B = 1, S = 512, L = 2048,
   pos0 = 512, rows [464, 1024) valid: a 560-token judge prompt reusing the
   69-token judge head) and chunked prefill (B = 64, S = 256, L = 1024,
   pos0 = 256 and 512, per-row left pads); then the shapes phase 10's own
   traffic gives, worked out from its judge prompts by the engine's and the
   solo path's arithmetic with the exact ``kv_valid`` of the run (arm A's
   heaviest whole admission, B = 1, S = 1024, pos0 = 0, L = 2048, and
   heaviest prefix hit; arm B's DecodeSession pieces, B = 64, S = 256,
   L = 2048, pos0 = 0, 256, 512, 768); every bf16 output row within two
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

9. Mixtral-8x7B width and depth with int8 weight-only weights (the
   published config.json's values in ``MIXTRAL_8X7B``; random weights from
   seed 0). a. One 4096 × 14336 f32 matrix quantized on the card and on the
   CPU: ``q`` and ``s`` bit-identical. b. Two layers of Mixtral's width in
   bf16 (5.8 GB) and their int8 quantization on the same prompts:
   first-step logits keep a cosine ≥ 0.99 (``hold_cosine``: a prompt whose
   expert choice flipped across a router near-tie is printed, not held).
   c. ``LlamaRuntime(quant="int8")`` draws each matrix in f32 and quantizes
   it before the next: 46,872,802,304 bytes (int8 projections and experts,
   a bf16 embedding, f32 scales, router and norms), the draw time and the
   peak allocated. d. Layer 0's ``moe_mlp`` at T = 8 and 64 against a
   per-token oracle (``moe_mlp_reference``): the same experts, each output
   row within 2^-6 of its largest oracle value. e. Phase 6's engine runs
   and checks, both caches (``KAKVEDA_KV_QUANT=int8``). f. Admission, decode
   step p50, the step's device time from a CUDA-graph replay of one
   ``_forward_wide`` (which a host sync in the MoE block would break) and
   its split into dequantize, GEMMs and ``bmm``s, ``flash_gqa_cache``, and
   router + dispatch + combine, beside the 14.0 ms weight-read bound.

10. the LLM judge on the ingest path (after phase 6 frees its model):
   ``KAKVEDA_CLASSIFIER=tiered KAKVEDA_MODEL_RUNTIME=torch`` puts
   Llama-3-8B (``get_runtime``, random bf16 weights from seed 0) beside a
   ``Platform(capacity=2^20, dim=2048)`` on the card. 4 × 512 traces from
   a seed, 1 in 8 ambiguous (citations asked for, no marker; prompt +
   response over 200-760 bytes), ingested rule-only on a fresh Platform
   and then with the judge. The submitted prompts must be ``judge_batches``'s,
   whose shapes phase 5 held. Arm A (``KAKVEDA_SERVE_WINDOW=2048``): every
   judge result through the engine, the prefix stats equal to the matching
   rules replayed over the submitted ids (``expected_prefix_stats``), flash
   launches 32 × forwards (prefix prefills and admissions counted), the
   signals the rule's plus ``parse_judge_verdict`` over the texts, the
   GFKB, cluster state, patterns and health consistent, then a
   ``warn_batch`` of 64 that launches ``fused_topk``. Arm B (window 512,
   ``KAKVEDA_PREFILL_CHUNK=256``): the same judge prompts, none fits the
   engine, one ``DecodeSession`` a batch, launches 32 × (pieces + steps),
   tokens equal arm A's or departing at a near-tie (``margin_rule``). One
   prefix-hit admission per cache type against the same prompt admitted
   whole (``KAKVEDA_SERVE_PREFIX=0``). Prints ingest traces/s with and
   without the judge, the judge's wall per batch, ``register_prefix`` ms,
   admission ms with and without the prefix (host, CUDA events, and the
   forward's graph replay), arm B's wall and prefill device time, and the
   peak allocated with both planes resident.

Prints a ``{"kernels": [...]}`` line (the flash rows with phase 9's and
phase 10's launches beside phase 6's, and the judge shapes' times), the
card line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
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
# Solo top-2 logit margin below which a batched token may flip. A router
# logit is a logit: a gap between an expert kept and one left out below it
# is a near-tie that noise may flip too (bf16 between batch shapes, int8
# weights, an int8 cache through 32 layers).
MARGIN_TOL = 0.25
# Mixtral-8x7B-v0.1's published config.json (mistralai/Mixtral-8x7B-v0.1 on
# the Hugging Face Hub) as LlamaConfig fields, written out: nothing is
# downloaded. vocab 32000 (a multiple of 8, so no pad columns), 32 layers of
# 32 heads over 8 KV heads, 8 experts of width 14336, top-2, rope theta 1e6.
MIXTRAL_8X7B = dict(
    vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336,
    max_seq_len=32768, rope_theta=1e6, norm_eps=1e-5, sliding_window=0,
    n_experts=8, n_experts_per_tok=2, router_aux_coef=0.02,
)
INT8_COS_MIN = 0.99  # first-step logits, int8 cache vs bf16 cache, int8 weights vs bf16
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
    # The LLM judge's shapes (phase 10): a 560-token judge prompt reusing the
    # 69-token judge head at window 2048 (bucket 1024, left pad 464, sw 512,
    # split 48), and DecodeSession's pieces for 64 judge prompts of <= 768
    # tokens at KAKVEDA_PREFILL_CHUNK=256.
    ("prefix_admission", 1, 512, 2048, 512, "prefix", None),
    ("chunk_prefill_256", 64, 256, 1024, 256, "chunkpad", None),
    ("chunk_prefill_512", 64, 256, 1024, 512, "chunkpad", None),
]
JUDGE_SHAPES = ("prefix_admission", "chunk_prefill_256", "chunk_prefill_512")


def judge_flash_shapes() -> list:
    """The flash shapes phase 10's own traffic gives, from the arithmetic
    the engine and the solo path apply to its judge prompts (so the checked
    shapes and the run's cannot drift apart; phase 10 asserts its prompts
    are these): arm A's heaviest whole admission (B = 1, S = its bucket,
    pos0 = 0, L = the 2048 window) and heaviest prefix hit (S = sw at pos0 =
    off + split), and each DecodeSession piece of arm B's widest batch (B =
    its prompts, S = 256, pos0 = k·256, L = its cache rows), with the exact
    ``kv_valid`` each runs with."""
    from kakveda_tpu_torch.models import generate as G
    from kakveda_tpu_torch.models.llama import LlamaConfig
    from kakveda_tpu_torch.models.serving import ContinuousBatcher
    from kakveda_tpu_torch.models.tokenizer import ByteTokenizer
    from kakveda_tpu_torch.pipeline.classifier import _JUDGE_PROMPT

    batches = judge_batches()
    head = ByteTokenizer().encode(_JUDGE_PROMPT.split("{prompt}")[0])
    admissions = []
    expected_prefix_stats(head, batches, JUDGE_WINDOW, JUDGE_PREFIX_MAX, admissions)
    ar = torch.arange(JUDGE_WINDOW)

    def admission(name, p, sw, split):
        bucket = ContinuousBatcher.bucket_for(p, JUDGE_WINDOW)
        off = bucket - p
        valid = ((ar >= off) & (ar < bucket))[None]
        return (name, 1, sw or bucket, JUDGE_WINDOW, off + split if sw else 0, valid, None)

    p = max(p for p, sw, _ in admissions if sw is None)
    out = [admission("judge_whole_admission", p, None, 0)]
    hit = max(((sw, p, split) for p, sw, split in admissions if sw is not None), default=None)
    if hit is not None:
        out.append(admission("judge_prefix_hit", hit[1], hit[0], hit[2]))
    widths = [G._prefill_width(max(map(len, ids)), JUDGE_CHUNK) for ids in batches]
    b = max(range(len(batches)), key=lambda i: (widths[i], i))
    ml = G._bucket_len(widths[b] + JUDGE_MAX_TOKENS + 1, LlamaConfig.llama3_8b().max_seq_len)
    valid = torch.from_numpy(G._pack_prompts(batches[b], ml, plen=widths[b])[1])
    out += [(f"judge_chunk_{pos0}", len(batches[b]), JUDGE_CHUNK, ml, pos0, valid, None)
            for pos0 in range(0, widths[b], JUDGE_CHUNK)]
    return out


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
    elif kind == "prefix":  # the slot's prompt rows [off, bucket) of a prefix-hit admission
        valid = ((ar >= 464) & (ar < 1024)).expand(b, l).contiguous()
    elif kind == "chunkpad":  # DecodeSession: rows from each prompt's left pad on
        off = torch.randint(0, 507, (b, 1), device="cuda", generator=gen)  # prompts of 262-768 tokens
        valid = (ar >= off).contiguous()
    elif torch.is_tensor(kind):  # the exact mask a run gives (judge_flash_shapes)
        valid = kind.to("cuda").expand(b, l).contiguous()
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
    judge_shapes = judge_flash_shapes()
    rows = {}
    for kv8 in (False, True):
        name = "flash_gqa_cache_kv8" if kv8 else "flash_gqa_cache"
        row = {"max_abs_err": 0.0}
        for shape, b, s, l, pos0, kind, reach in FLASH_SHAPES + judge_shapes:
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
            log(f"{name} {shape} (B={b} S={s} L={l} pos0={pos0} reach={reach}): n_split={n_split} live_tiles={live_frac:.4f} "
                f"max_abs_err={err:.3g} ({use:.3f} of the tolerance) kernel_ms={ms:.6f};{bare} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.6f} "
                f"bound_ms={bound_ms:.6f} ({bound_by}) bound_seen_ms={seen_ms:.6f} "
                f"({seen_rows} of {b * l} rows seen) eager_call_ms={call_ms:.4f} [{card}]")
            if shape == "decode":  # the main path's most frequent shape
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                           bound_seen_ms=seen_ms)
            if shape in JUDGE_SHAPES or shape.startswith("judge_"):
                row.setdefault("judge_shapes", {})[shape] = dict(
                    shape=f"B={b} S={s} L={l} pos0={pos0}", n_split=n_split, live_tiles=live_frac, ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                    bound_seen_ms=seen_ms, max_abs_err=err, tolerance_share=use)
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


class RouterTrace:
    """While on, records each ``moe.router_topk`` call of ``moe_mlp``: the
    experts chosen, copied to the host (a sync: used only around the passes
    that check, never on a timed path)."""

    def __init__(self):
        from kakveda_tpu_torch.models import moe

        self._moe = moe
        self.calls = []

    @contextlib.contextmanager
    def on(self):
        real = self._moe.router_topk
        self.calls = []

        def traced(logits, k):
            res = real(logits, k)
            self.calls.append(res[1].cpu())
            return res

        self._moe.router_topk = traced
        try:
            yield self.calls
        finally:
            self._moe.router_topk = real

    def table(self):
        """The last traced pass's choices: ``{token: {layer: experts}}``."""
        routes = {}
        for layer, idx in enumerate(self.calls):
            for n, experts in enumerate(idx.tolist()):
                routes.setdefault(n, {})[layer] = tuple(experts)
        return routes


def first_steps(params, cfg, ids, tok, pin=None):
    """Each prompt's first-step logits (the tokenizer's vocab, float64) from
    one solo pass over it, with its expert choices ``{token: {layer:
    experts}}``; or, given ``pin`` (another run's choices per prompt), each
    token's experts pinned to them and the choices where this pass's own
    top k differs (``pinned_forced``)."""
    from kakveda_tpu_torch.models.llama import decode_step, init_cache, mask_pad_vocab

    trace, out = RouterTrace(), []
    for i, p_ids in enumerate(ids):
        if pin is None:
            cache = init_cache(cfg, batch=1, max_len=len(p_ids), device="cuda")
            with trace.on():
                logits, _ = decode_step(params, cfg, torch.tensor([p_ids], device="cuda"), cache,
                                        last_only=True)
            lg, extra = logits[0, -1], trace.table()
        else:
            logits, extra = pinned_forced(params, cfg, p_ids, pin[i])
            lg = logits[-1]
        lg = mask_pad_vocab(lg, cfg)[: tok.vocab_size].double()
        if not torch.isfinite(lg).all():
            raise AssertionError("non-finite first-step logits")
        out.append((lg, extra))
    return out


def hold_cosine(ref, other, what: str) -> dict:
    """First-step logits of two runs of each prompt, the second's expert
    choices pinned to the first's (``first_steps``): cosine ≥ INT8_COS_MIN
    for every prompt, and every expert choice where the second run's own
    router differs from the pin lies across a gap under MARGIN_TOL. Pinned,
    because an expert choice on a router near-tie may flip under the
    perturbation and move the logits by design, and flips at other tokens
    and layers compound through the cache."""
    cos = [torch.nn.functional.cosine_similarity(la, lb, dim=0).item() for (la, _), (lb, _) in zip(ref, other)]
    flips = [f for _, fl in other for f in fl]
    worst = max((g for _, _, g in flips), default=0.0)
    n_choices = sum(len(t) * len(t[0]) for _, t in ref if t)
    log(f"{what}: first-step logits cosine min {min(cos):.6f} over {len(cos)} prompts (bound "
        f"{INT8_COS_MIN}); {len(flips)} of {n_choices} expert choices differ from the reference's, the "
        f"widest across a router gap of {worst:.4f} (bound {MARGIN_TOL})")
    if min(cos) < INT8_COS_MIN or worst >= MARGIN_TOL:
        raise AssertionError(f"{what}: cosine {cos}, expert flip across a router gap of {worst}")
    return dict(cos_min=min(cos), expert_flips=len(flips), expert_choices=n_choices, widest_flip_gap=worst)


def param_bytes(params) -> int:
    leaves = [params["embed"], params["final_norm"], params["lm_head"]]
    leaves += [w for layer in params["layers"] for w in layer.values()]
    flat = [t for w in leaves for t in (w.values() if isinstance(w, dict) else [w])]
    return sum(t.numel() * t.element_size() for t in flat)


def serve_engine(rt, tok, ids, what: str) -> dict:
    """The model plane's engine runs and checks (phases 6 and 9): ``rt``'s
    weights serve ``generate_batch`` of 8 prompts × 32 tokens through the
    engine (8 slots, window 512, chunk 8), once with a bf16 cache and once
    with ``KAKVEDA_KV_QUANT=int8``, launch counts zeroed just before and read
    just after each run: the run's kernel launches 32 × (forward passes)
    times, the other kernel 0. Then the tokens (``check_dense_tokens`` or,
    for a MoE model, ``check_moe_tokens``) and the two caches' first-step
    logits (``hold_cosine``)."""
    from kakveda_tpu_torch.models.attention import flash_gqa_cache
    from kakveda_tpu_torch.models.generate import LlamaRuntime

    cfg = rt.cfg
    out, first = {}, {}
    for kvq in ("", "int8"):
        tag = kvq or "bf16"
        rq = rt
        if kvq:
            os.environ["KAKVEDA_KV_QUANT"] = kvq
            try:
                rq = LlamaRuntime(cfg=cfg, params=rt.params, tokenizer=tok)
            finally:
                del os.environ["KAKVEDA_KV_QUANT"]
        if rq.cfg.kv_quant != kvq:
            raise AssertionError(f"KAKVEDA_KV_QUANT={kvq!r} gave a {rq.cfg.kv_quant!r} cache")
        eng = rq.engine()
        if (eng.cb.B, eng.cb.max_len, eng.cb.chunk_steps) != (8, 512, 8):
            raise AssertionError("engine is not 8 slots, window 512, chunk 8")
        rq.generate_batch(PROMPTS[:2], max_tokens=8)  # warm-up: cuBLAS heuristics, allocator
        tok.decoded.clear()
        routes = EngineRoutes(eng.cb)
        flash_gqa_cache.launches = 0
        flash_gqa_cache.launches_kv8 = 0
        f0 = eng.cb.forwards
        with routes.on() if cfg.n_experts else contextlib.nullcontext():
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
            raise AssertionError(f"{what} {tag}: {mine} launches for {n_fwd} forwards (want {cfg.n_layers} "
                                 f"each), {other} of the other kernel")
        if len(res) != 8 or not all(r.meta.get("continuous") for r in res) or len(got) != 8:
            raise AssertionError(f"{what} {tag}: generate_batch did not run through the engine")
        n_tok = sum(len(g) for g in got)
        out[tag] = dict(launches=mine, forwards=n_fwd, tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall)
        if cfg.n_experts:
            out[tag].update(check_moe_tokens(rq, tok, ids, got, routes, f"{what}, {tag} cache"))
        else:
            out[tag].update(check_dense_tokens(rq, tok, ids, got, f"{what}, {tag} cache"))
        pin = [t for _, t in first["bf16"]] if kvq else None
        first[tag] = first_steps(rq.params, rq.cfg, ids, tok, pin=pin)
        log(f"{what}, {tag} cache: {n_fwd} forwards, {mine} launches")
    out["kv_cache_cos"] = hold_cosine(first["bf16"], first["int8"], f"{what}, int8 cache vs bf16 cache")
    return out


def check_dense_tokens(rq, tok, ids, got, what: str) -> dict:
    """Each prompt's engine tokens equal a solo ``generate_tokens`` up to the
    first step whose solo top-2 logit margin is below MARGIN_TOL (bf16 noise
    between batch shapes can flip a nearer tie), and every engine token lies
    within MARGIN_TOL of the solo argmax on the engine's own prefix (one
    teacher-forced pass, so all 32 steps are checked)."""
    from kakveda_tpu_torch.models.generate import generate_tokens
    from kakveda_tpu_torch.models.llama import decode_step, init_cache, mask_pad_vocab

    def forced(p_ids, toks):
        """Solo logits [len(toks) + 1, V] along prompt + toks, one pass."""
        seq = torch.tensor([p_ids + toks], device="cuda")
        cache = init_cache(rq.cfg, batch=1, max_len=seq.shape[1], device="cuda")
        logits, _ = decode_step(rq.params, rq.cfg, seq, cache)
        lg = mask_pad_vocab(logits[0, len(p_ids) - 1:], rq.cfg)
        if not torch.isfinite(lg[:, : tok.vocab_size]).all():
            raise AssertionError(f"{what}: non-finite logits")
        return lg

    compared, deficit = [], 0.0
    for p_ids, eng_ids in zip(ids, got):
        solo = generate_tokens(rq.params, rq.cfg, p_ids, max_new_tokens=32, eos_id=tok.EOS)
        top2 = forced(p_ids, solo).topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).tolist()
        n = min(len(solo), next((j for j, m in enumerate(margin) if m < MARGIN_TOL), len(solo)))
        if eng_ids[:n] != solo[:n]:
            raise AssertionError(f"{what}: engine {eng_ids[:n]} != solo {solo[:n]} within {n} steps")
        compared.append(n)
        picks = eng_ids + ([tok.EOS] if len(eng_ids) < 32 else [])
        lg = forced(p_ids, eng_ids)[: len(picks)]
        d = lg.max(dim=-1).values - lg[torch.arange(len(picks)), torch.tensor(picks)]
        deficit = max(deficit, d.max().item())
        if deficit > MARGIN_TOL:
            raise AssertionError(f"{what}: an engine token is {deficit} below the solo argmax")
    log(f"{what}: engine == solo generate_tokens on {sum(compared)} of {sum(map(len, got))} tokens "
        f"(per prompt {compared}); every engine token within {deficit:.4f} of the solo argmax "
        f"on its own prefix")
    return dict(compared=sum(compared), max_deficit=deficit)


def check_moe_tokens(rq, tok, ids, got, routes, what: str) -> dict:
    """A MoE model's tokens. Its expert choices are discrete: bf16 noise
    between the engine's batch shapes and a solo pass's flips a choice that
    sits on a router near-tie, and the logits jump with it, so phase 6's
    token rules are held on the engine's own choices. One teacher-forced
    solo pass per prompt along the engine's tokens, each token's experts
    pinned to the ones the engine chose (``pinned_forced``): every expert
    choice of the engine that differs from the solo pass's own lies across
    a router gap under MARGIN_TOL; every engine token (and its EOS stop) lies
    within MARGIN_TOL of the solo argmax, and equals it wherever the solo
    top-2 margin is MARGIN_TOL or more."""
    from kakveda_tpu_torch.models.llama import mask_pad_vocab

    table = routes.table()
    rids = routes.admitted
    if len(rids) != len(ids):
        raise AssertionError(f"{what}: {len(rids)} admissions for {len(ids)} prompts")
    compared, deficit, flips = 0, 0.0, []
    for p_ids, eng_ids, rid in zip(ids, got, rids):
        logits, pflips = pinned_forced(rq.params, rq.cfg, p_ids + eng_ids, table[rid])
        flips += pflips
        picks = eng_ids + ([tok.EOS] if len(eng_ids) < 32 else [])
        lg = mask_pad_vocab(logits[len(p_ids) - 1:], rq.cfg)[: len(picks)]
        if not torch.isfinite(lg[:, : tok.vocab_size]).all():
            raise AssertionError(f"{what}: non-finite logits")
        top2 = lg.topk(2, dim=-1)
        sure = (top2.values[:, 0] - top2.values[:, 1] >= MARGIN_TOL).cpu()
        pick = torch.tensor(picks)
        if not torch.equal(top2.indices[:, 0].cpu()[sure], pick[sure]):
            raise AssertionError(f"{what}: an engine token differs from a clear solo argmax")
        compared += int(sure.sum())
        d = lg.max(dim=-1).values - lg[torch.arange(len(picks)), pick.to(lg.device)]
        deficit = max(deficit, d.max().item())
    worst = max((g for _, _, g in flips), default=0.0)
    n_choices = sum(len(p) + len(e) for p, e in zip(ids, got)) * rq.cfg.n_layers
    log(f"{what}: on the engine's expert choices, engine == solo argmax on {compared} of "
        f"{sum(map(len, got))} tokens (every solo margin >= {MARGIN_TOL}), every engine token within "
        f"{deficit:.4f} of the solo argmax; {len(flips)} of {n_choices} engine expert choices differ "
        f"from the solo pass's own, the widest across a router gap of {worst:.4f} (bound {MARGIN_TOL})")
    if deficit > MARGIN_TOL or worst >= MARGIN_TOL:
        raise AssertionError(f"{what}: deficit {deficit}, expert flip across a router gap of {worst}")
    return dict(compared=compared, max_deficit=deficit, expert_flips=len(flips), expert_choices=n_choices,
                widest_flip_gap=worst)


class EngineRoutes:
    """While on, records the experts the engine chose for every request's
    tokens, per layer (device copies, read after the run): ``admit`` and
    ``step_async`` are wrapped on the batcher to note which request and
    token each row of a forward holds. ``table()`` gives ``{request id:
    {token index: [experts per layer]}}`` and the admitted request ids."""

    def __init__(self, cb):
        from kakveda_tpu_torch.models import moe, serving

        self._moe, self._serving, self._cb = moe, serving, cb
        self.calls, self.admitted = [], []

    @contextlib.contextmanager
    def on(self):
        moe, serving, cb = self._moe, self._serving, self._cb
        real_topk, real_fw = moe.router_topk, serving._forward_wide
        real_admit, real_step = cb.admit, cb.step_async
        ctx = {"rows": None, "layer": 0}

        def topk(logits, k):
            res = real_topk(logits, k)
            if ctx["rows"] is not None:
                self.calls.append((ctx["rows"], ctx["layer"], res[1].clone()))
                ctx["layer"] += 1
            return res

        def admit(prompt_ids, max_new_tokens=64, temperature=0.0):
            p = len(prompt_ids)
            off = cb.bucket_for(p, cb.max_len) - p
            self.admitted.append(cb._next_id)
            ctx.update(rows=[None] * off + [(cb._next_id, n) for n in range(p)], layer=0)
            try:
                return real_admit(prompt_ids, max_new_tokens, temperature)
            finally:
                ctx["rows"] = None

        def step_async():
            live = {slot: st.req_id for slot, st in cb.slots.items() if not st.done}
            pos, off, step = cb._pos_np.copy(), cb._off_np.copy(), [0]

            def forward(*a, **k):  # step t writes row pos + t: token pos + t - off
                ctx.update(rows=[(live[b], int(pos[b] + step[0] - off[b])) if b in live else None
                                 for b in range(cb.B)], layer=0)
                step[0] += 1
                try:
                    return real_fw(*a, **k)
                finally:
                    ctx["rows"] = None

            serving._forward_wide = forward
            try:
                return real_step()
            finally:
                serving._forward_wide = real_fw

        moe.router_topk, cb.admit, cb.step_async = topk, admit, step_async
        try:
            yield self
        finally:
            moe.router_topk = real_topk
            del cb.admit, cb.step_async

    def table(self):
        routes = {}
        for rows, layer, idx in self.calls:
            for key, experts in zip(rows, idx.cpu().tolist()):
                if key is not None:
                    routes.setdefault(key[0], {}).setdefault(key[1], {})[layer] = tuple(experts)
        return routes


def pinned_forced(params, cfg, seq_ids, routes):
    """Solo logits [len(seq_ids), V] along ``seq_ids`` in one pass, each
    token's experts pinned to ``routes[n][layer]`` (the engine's), their
    weights from this pass's own router probabilities. Returns (logits,
    expert choices where this pass's own top k differs from the pin: a list
    of (token, layer, own router gap between its k-th and (k+1)-th
    logits))."""
    from kakveda_tpu_torch.models import moe
    from kakveda_tpu_torch.models.llama import decode_step, init_cache

    real, k, layer, flips = moe.router_topk, cfg.n_experts_per_tok, [0], []
    s = len(seq_ids)

    def pinned(logits, k_):
        li = layer[0]
        layer[0] += 1
        _, own, probs = real(logits, k_)
        pin = torch.tensor([routes[n][li] for n in range(s)], device=logits.device)
        top = logits.float().sort(dim=-1, descending=True).values
        gap = (top[:, k - 1] - top[:, k]).cpu()
        differ = (own.sort(dim=-1).values != pin.sort(dim=-1).values).any(dim=-1).cpu()
        flips.extend((n, li, gap[n].item()) for n in differ.nonzero()[:, 0].tolist())
        w = probs.gather(1, pin)
        return w / w.sum(dim=-1, keepdim=True).clamp_min(1e-20), pin, probs

    moe.router_topk = pinned
    try:
        cache = init_cache(cfg, batch=1, max_len=s, device="cuda")
        logits, _ = decode_step(params, cfg, torch.tensor([seq_ids], device="cuda"), cache)
    finally:
        moe.router_topk = real
    return logits[0], flips


def step_times(rt, ids, out: dict, n_bytes: int, what: str, card: str, split=None) -> None:
    """Admission and decode-step times on a batcher of the engine's shape,
    per cache type, into ``out``: admission p50 and decode step p50 on the
    host clock, the step's device time from a CUDA graph of ``_forward_wide``
    (with the engine's ``reach`` hint) beside the weight-read bound;
    ``split(cb, dev_args, reach, step_ms)`` breaks the bf16-cache step up."""
    from kakveda_tpu_torch.models.serving import ContinuousBatcher, _forward_wide

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
        step_dev = graph_ms(lambda: _forward_wide(cb.params, cb.cfg, cb.cache, *dev_args, reach=reach),
                            n=4 if split is None else 1)
        weight_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        out[tag].update(admission_ms_p50=statistics.median(adm), decode_step_ms_p50=statistics.median(steps),
                        decode_step_device_ms=step_dev, weight_read_bound_ms=weight_ms)
        log(f"{what}, {tag} cache: admission p50 {statistics.median(adm):.2f} ms (B=1, S=64), decode step p50 "
            f"{statistics.median(steps):.2f} ms at 8 slots (device time {step_dev:.2f} ms) vs the "
            f"weight-read bound {weight_ms:.2f} ms, engine {out[tag]['tokens_per_s']:.1f} tokens/s [{card}]")
        if split is not None and not kvq:
            out[tag]["step_split"] = split(cb, dev_args, reach, step_dev)
        del cb
        torch.cuda.empty_cache()


def phase_model(card: str) -> dict:
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    tok = RecordingTokenizer()
    rt = LlamaRuntime(cfg=cfg, seed=0, tokenizer=tok)
    torch.cuda.synchronize()
    n_bytes = param_bytes(rt.params)
    log(f"Llama-3-8B width and depth: {cfg.n_layers} layers, {n_bytes / 1e9:.2f} GB of weights "
        f"on {rt.device}, drawn in {time.perf_counter() - t0:.1f} s")
    if rt.device.type != "cuda" or abs(n_bytes - 16.06e9) > 0.01e9:
        raise AssertionError(f"model on {rt.device} with {n_bytes} bytes")
    ids = [tok.encode(p) for p in PROMPTS]
    if len({tuple(i) for i in ids}) != 8 or not all(33 <= len(i) <= 64 for i in ids):
        raise AssertionError("prompts must be 8 distinct, of one admission bucket")
    out = serve_engine(rt, tok, ids, "Llama-3-8B")
    step_times(rt, ids, out, n_bytes, "Llama-3-8B", card)
    log("model plane: " + json.dumps(out))
    return out


def moe_step_split(cb, dev_args, reach: int, step_ms: float, card: str) -> dict:
    """One MoE decode step (B = 8, the bf16 cache) split into its parts, each
    replayed from a CUDA graph between CUDA events at the step's shapes:
    dequantize (every ``wmat`` of a step), the GEMMs and ``bmm``s on
    dequantized weights (layer 0's, once per layer, and ``lm_head``; the
    SwiGLU's silu and product included), ``flash_gqa_cache`` (every layer's
    cache, the step's mask and ``reach``), and router + dispatch + combine
    (every layer's router at T = 8). The rest (embedding, norms, rope, cache
    writes, residual adds) is the step's device time less their sum. Bounds:
    the bytes each part must move at the HBM rate."""
    from kakveda_tpu_torch.models import moe
    from kakveda_tpu_torch.models.attention import gqa_cache_attention
    from kakveda_tpu_torch.models.llama import wmat

    params, cfg, cache = cb.params, cb.cfg, cb.cache
    b, d, dt, e, k = cb.B, cfg.d_model, cfg.dtype, cfg.n_experts, cfg.n_experts_per_tok
    names = ("wq", "wk", "wv", "wo", "we_gate", "we_up", "we_down")
    g = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, device="cuda", generator=g).to(dt)

    def dequant():
        for layer in params["layers"]:
            for n in names:
                wmat(layer[n], dt)
        wmat(params["lm_head"], dt)

    l0 = {n: wmat(params["layers"][0][n], dt) for n in names}
    head = wmat(params["lm_head"], dt)
    cap = moe.expert_capacity(b, cfg)
    x, attn, xe, ye = rnd(b, 1, d), rnd(b, 1, cfg.n_heads * cfg.head_dim), rnd(e, cap, d), rnd(e, cap, d)
    q = rnd(b, 1, cfg.n_heads, cfg.head_dim)

    def gemms():
        for _ in range(cfg.n_layers):
            x @ l0["wq"], x @ l0["wk"], x @ l0["wv"], attn @ l0["wo"]
            moe.expert_swiglu(xe, l0)
        x @ head

    _, pos, kv_valid, _ = dev_args
    col = torch.arange(cb.max_len, device="cuda")[None, :]
    mask = kv_valid & (col <= pos[:, None])

    def flash():
        for li in range(cfg.n_layers):
            gqa_cache_attention(q, cache["k"][li], cache["v"][li], cb.max_len, mask, reach=reach)

    xf = x.reshape(b, d)

    def route():
        for layer in params["layers"]:
            w, idx, _ = moe.router_topk(xf.float() @ layer["router"].float(), k)
            order, tok_sorted, slot, keep = moe.dispatch_slots(idx, cap, e)
            moe.dispatch(xf, tok_sorted, slot, e, cap)
            moe.combine(ye, w, order, slot, keep, b)

    q_bytes = sum(layer[n]["q"].numel() for layer in params["layers"] for n in names)
    q_bytes += params["lm_head"]["q"].numel()
    parts = {
        "dequantize": (graph_ms(dequant, n=1), 3 * q_bytes),  # read int8, write bf16
        "gemms_and_bmms": (graph_ms(gemms, n=1), 2 * q_bytes),  # read bf16
        "flash_gqa_cache": (graph_ms(flash, n=1), None),
        "router_dispatch_combine": (graph_ms(route, n=1), None),
    }
    split = {name: dict(ms=ms, bound_ms=None if nb is None else nb / HBM_BYTES_PER_S * 1e3)
             for name, (ms, nb) in parts.items()}
    split["rest"] = dict(ms=step_ms - sum(p["ms"] for p in split.values()), bound_ms=None)
    split["step"] = dict(ms=step_ms, bound_ms=param_bytes(params) / HBM_BYTES_PER_S * 1e3)
    del l0, head
    for name, p in split.items():
        bound = "" if p["bound_ms"] is None else f" (bound {p['bound_ms']:.2f} ms)"
        log(f"  MoE decode step split: {name} {p['ms']:.3f} ms{bound} [{card}]")
    return split


def phase_mixtral(card: str) -> dict:
    """Phase 9: Mixtral-8x7B width and depth, int8 weight-only, on the card."""
    from kakveda_tpu_torch.models import moe
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.llama import LlamaConfig
    from kakveda_tpu_torch.models.quant import quantize_tensor_int8

    held = torch.cuda.memory_allocated()
    if held > 1e9:  # from earlier phases: name the largest tensors still alive
        live = sorted(((o.numel() * o.element_size(), tuple(o.shape), str(o.dtype)) for o in gc.get_objects()
                       if isinstance(o, torch.Tensor) and o.is_cuda), reverse=True)[:8]
        log(f"phase 9: {held} bytes held from earlier phases; the largest live tensors: {live}")
    cfg = LlamaConfig(**MIXTRAL_8X7B)
    tok = RecordingTokenizer()
    ids = [tok.encode(p) for p in PROMPTS]
    out = {}

    # a. The card's quantizer against the CPU's on one f32 expert matrix.
    g = torch.Generator(device="cuda").manual_seed(9)
    w = torch.randn((cfg.d_model, cfg.d_ff), device="cuda", generator=g).div_(math.sqrt(cfg.d_model))
    on_card, on_host = quantize_tensor_int8(w), quantize_tensor_int8(w.cpu())
    same = (torch.equal(on_card["q"].cpu(), on_host["q"]), torch.equal(on_card["s"].cpu(), on_host["s"]))
    log(f"phase 9 a: int8 quantization of a {cfg.d_model} x {cfg.d_ff} f32 matrix, card == CPU: "
        f"q {same[0]}, s {same[1]}")
    if not all(same):
        raise AssertionError("the card's int8 quantization differs from the CPU's")
    del w, on_card

    # b. int8 weights against bf16 weights at Mixtral's width, 2 layers.
    bf = LlamaRuntime(cfg=dataclasses.replace(cfg, n_layers=2), seed=1, tokenizer=tok)
    i8 = LlamaRuntime(cfg=bf.cfg, params=bf.params, quant="int8", tokenizer=tok)
    log(f"phase 9 b: 2 layers of Mixtral's width, bf16 {param_bytes(bf.params) / 1e9:.2f} GB and its int8 "
        f"quantization {param_bytes(i8.params) / 1e9:.2f} GB")
    ref = first_steps(bf.params, bf.cfg, ids, tok)
    out["int8_vs_bf16"] = hold_cosine(ref, first_steps(i8.params, i8.cfg, ids, tok, pin=[t for _, t in ref]),
                                      "phase 9 b: int8 weights vs bf16 weights")
    del bf, i8
    gc.collect()
    torch.cuda.empty_cache()

    # c. The whole model, drawn on the card and quantized matrix by matrix.
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = LlamaRuntime(cfg=cfg, seed=0, quant="int8", tokenizer=tok)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_bytes = param_bytes(rt.params)
    peak = torch.cuda.max_memory_allocated() - base
    bad = [f"{li}.{n}" for li, layer in enumerate(rt.params["layers"]) for n, v in layer.items()
           if (n.startswith("w") and v["q"].dtype != torch.int8) or (n == "router" and v.dtype != torch.float32)]
    log(f"phase 9 c: Mixtral-8x7B width and depth: {cfg.n_layers} layers x {cfg.n_experts} experts, "
        f"{n_bytes} bytes ({n_bytes / 1e9:.2f} GB) of int8 weight-only weights on {rt.device}, drawn and "
        f"quantized in {draw_s:.1f} s, peak allocated by the draw {peak / 1e9:.2f} GB [{card}]")
    if rt.device.type != "cuda" or abs(n_bytes - 46_872_802_304) > 0.01e9 or bad:
        raise AssertionError(f"model on {rt.device} with {n_bytes} bytes; not int8 / f32: {bad}")
    out.update(weight_bytes=n_bytes, draw_s=draw_s, init_peak_bytes=peak)

    # d. Layer 0's moe_mlp against the per-token oracle at T = 8 and 64.
    layer0 = rt.params["layers"][0]
    trace = RouterTrace()
    out["moe_vs_oracle"] = {}
    for t in (8, 64):
        x = torch.randn((1, t, cfg.d_model), device="cuda", generator=g).to(cfg.dtype)
        with trace.on():
            got = moe.moe_mlp(x, layer0, cfg)
        want, experts = moe.moe_mlp_reference(x, layer0, cfg)
        chosen = trace.calls[0]
        diff = (got.float() - want.float()).abs()[0]
        scale = want.float()[0].abs().amax(dim=-1, keepdim=True)
        use = (diff / (FLASH_REL * scale)).max().item()
        log(f"phase 9 d: layer 0 moe_mlp at T={t} vs the per-token oracle: experts equal "
            f"{torch.equal(chosen, experts)}, max_abs_err {diff.max().item():.4g}, {use:.3f} of the "
            f"per-row tolerance (2^-6 of the row's largest oracle value)")
        if not torch.equal(chosen, experts) or use > 1.0 or not torch.isfinite(got).all():
            raise AssertionError(f"phase 9 d: moe_mlp at T={t} disagrees with the oracle")
        out["moe_vs_oracle"][t] = dict(max_abs_err=diff.max().item(), tolerance_used=use)

    # e. Through the engine, both caches; f. times and the step's split.
    out.update(serve_engine(rt, tok, ids, "phase 9 e: Mixtral-8x7B int8"))
    step_times(rt, ids, out, n_bytes, "phase 9 f: Mixtral-8x7B int8", card,
               split=lambda cb, a, r, ms: moe_step_split(cb, a, r, ms, card))
    rt.close()
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 9: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 10: the LLM judge on the ingest path
# ---------------------------------------------------------------------------

JUDGE_ASKS = [  # citation-asking prompts that start differently: the batch's common head is the judge head
    "Summarize incident {i} and include citations.",
    "Explain outage {i} with references to the sources.",
    "Write a brief on service {i} and cite your sources.",
    "List what caused failure {i}, with citations.",
]
FILLER = ("the system reported that latency rose after deploy while Smith noted a queue backlog and "
          "operators restarted workers but errors persisted across regions for hours").split()


def judge_traffic(TracePayload, n: int, seed: int = 10):
    """``n`` traces from a seed: 1 in 8 ambiguous (a citation-asking prompt, a
    response with no citation marker, prompt + response drawn over 200-760
    bytes), 4 in 8 rule-positive (a citation-asking prompt answered with the
    stub's citations), 3 in 8 benign. ASCII, so bytes are characters."""
    import random

    rng = random.Random(seed)
    out = []
    for i in range(n):
        kind, app = i % 8, f"app-{i % 5}"
        if kind == 7:
            prompt = JUDGE_ASKS[rng.randrange(len(JUDGE_ASKS))].format(i=i)
            total = rng.randint(200, 760)
            words = []
            while len(" ".join(words)) < total - len(prompt):
                words.append(rng.choice(FILLER))
            out.append(_trace(TracePayload, i, app, prompt, " ".join(words)[: total - len(prompt)]))
        elif kind < 4:
            out.append(_trace(TracePayload, i, app, f"Summarize report {i} and include citations"))
        else:
            out.append(_trace(TracePayload, i, app, f"What is the status of job {i}?", f"Job {i} is running."))
    return out


JUDGE_WINDOW = 2048  # arm A's KAKVEDA_SERVE_WINDOW
JUDGE_PREFIX_MAX = 4  # KAKVEDA_SERVE_PREFIX_MAX
JUDGE_CHUNK = 256  # arm B's KAKVEDA_PREFILL_CHUNK
JUDGE_MAX_TOKENS = 4  # TieredClassifier's max_tokens


def judge_batches() -> list:
    """The token ids ``TieredClassifier`` submits per ingest batch of phase
    10's traffic: the rule tier's ambiguous traces, each wrapped in the judge
    template and encoded as ``LlamaRuntime`` encodes for Llama-3-8B."""
    from kakveda_tpu_torch.core.schemas import TracePayload
    from kakveda_tpu_torch.models.llama import LlamaConfig
    from kakveda_tpu_torch.models.tokenizer import ByteTokenizer
    from kakveda_tpu_torch.pipeline.classifier import _JUDGE_PROMPT, RuleClassifier, TieredClassifier, _wants_citations

    tok, keep = ByteTokenizer(), LlamaConfig.llama3_8b().max_seq_len // 2
    cut = TieredClassifier.max_judge_chars
    traces, out = judge_traffic(TracePayload, 4 * 512), []
    for b in range(4):
        batch = traces[512 * b: 512 * (b + 1)]
        rule = RuleClassifier().classify_batch(batch)
        out.append([tok.encode(_JUDGE_PROMPT.format(prompt=t.prompt[:cut], response=t.response[:cut]))[-keep:]
                    for t, sig in zip(batch, rule) if sig is None and _wants_citations(t.prompt)])
    return out


def expected_prefix_stats(head, batches, max_len: int, maxp: int, admissions=None) -> dict:
    """``ContinuousBatcher``'s prefix rules replayed in plain Python over the
    token ids the judge submitted: the judge head registered first, then per
    ``generate_batch`` call its common head (two or more prompts, 16 or more
    tokens), then each admission in submission order. A prefix registers when
    8 <= len and len + 9 < the window; the longest registered prefix of a
    prompt matches and moves to the end of the LRU order (KAKVEDA_SERVE_PREFIX_
    MAX entries); the match reuses split = p - sw rows when positive, sw the
    power of two (floor 8) >= p - len(prefix). ``admissions``, when given,
    gets (p, sw, split) per admission, sw None for one admitted whole."""
    from collections import OrderedDict

    store, stats = OrderedDict(), dict(registered=0, hits=0, hit_tokens_saved=0)

    def register(ids):
        ids = tuple(ids)
        if len(ids) < 8 or len(ids) + 9 >= max_len or ids in store:
            return
        while len(store) >= max(1, maxp):
            store.popitem(last=False)
        store[ids] = True
        stats["registered"] += 1

    register(head)
    for ids_list in batches:
        if len(ids_list) >= 2:
            common = os.path.commonprefix(ids_list)
            if len(common) >= 16:
                register(common)
        for ids in ids_list:
            best = max((pe for pe in store if len(ids) >= len(pe) and tuple(ids[: len(pe)]) == pe),
                       key=len, default=None)
            sw = None
            if best is not None:
                store.move_to_end(best)
                sw = 8
                while sw < len(ids) - len(best):
                    sw <<= 1
                if len(ids) - sw > 0:
                    stats["hits"] += 1
                    stats["hit_tokens_saved"] += len(ids) - sw
                else:
                    sw = None
            if admissions is not None:
                admissions.append((len(ids), sw, len(ids) - sw if sw else 0))
    return stats


def margin_rule(params, cfg, tok, prompt_ids, ref, got, what: str):
    """Phase 6's token rule: ``got`` equals ``ref`` (each closed with EOS when
    it stopped early), or first departs from it at a step whose solo top-2
    margin along ``ref`` (one teacher-forced pass) is under MARGIN_TOL.
    Returns None when equal, else the margin at the departure."""
    from kakveda_tpu_torch.models.llama import decode_step, init_cache, mask_pad_vocab

    a = list(ref) + ([tok.EOS] if len(ref) < 4 else [])
    b = list(got) + ([tok.EOS] if len(got) < 4 else [])
    n = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if n is None:
        return None
    seq = torch.tensor([list(prompt_ids) + a[:n]], device="cuda")
    logits, _ = decode_step(params, cfg, seq, init_cache(cfg, 1, seq.shape[1], device="cuda"), last_only=True)
    top2 = mask_pad_vocab(logits[0, -1], cfg)[: tok.vocab_size].topk(2).values
    margin = (top2[0] - top2[1]).item()
    if margin >= MARGIN_TOL:
        raise AssertionError(f"{what}: tokens {b} depart from {a} at step {n}, where the solo margin is "
                             f"{margin:.4f} >= {MARGIN_TOL}")
    return margin


def ingest_timed(plat, traces, batch: int = 512):
    """``ingest_batch`` in batches of ``batch``, the card synchronized at both
    ends: (signals per batch, traces/s, wall per batch in s)."""
    sigs, walls = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, len(traces), batch):
        t = time.perf_counter()
        sigs.append(asyncio.run(plat.ingest_batch(traces[lo: lo + batch])))
        walls.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return sigs, len(traces) / (time.perf_counter() - t0), walls


def judge_admissions(rt, tok, head, card: str) -> dict:
    """One prefix-hit admission per cache type against the same prompt
    admitted whole (``KAKVEDA_SERVE_PREFIX=0``) on batchers of the engine's
    window (2048): a 560-token judge prompt (bucket 1024, left pad 464, sw
    512, split 48: phase 5's prefix_admission shape). Host ms (the card
    synchronized) and device ms (CUDA events) per admission, medians of 4;
    then 4 tokens each, held by ``margin_rule``."""
    from kakveda_tpu_torch.models.attention import flash_gqa_cache
    from kakveda_tpu_torch.models.serving import ContinuousBatcher
    from kakveda_tpu_torch.pipeline.classifier import _JUDGE_PROMPT

    prompt = "Summarize incident 7 and include citations."
    text = _JUDGE_PROMPT.format(prompt=prompt, response="x" * (298 - len(prompt)))
    ids = tok.encode(text)
    if len(ids) != 560:
        raise AssertionError(f"the admission prompt is {len(ids)} tokens, not 560")
    out, launches = {}, {}
    for kvq in ("", "int8"):
        tag = kvq or "bf16"
        toks, times = {}, {}
        for use in ("1", "0"):
            os.environ["KAKVEDA_SERVE_PREFIX"] = use
            try:
                counter = "launches_kv8" if kvq else "launches"
                flash_gqa_cache.launches = 0
                flash_gqa_cache.launches_kv8 = 0
                cb = ContinuousBatcher(rt.params, dataclasses.replace(rt.cfg, kv_quant=kvq), batch_slots=4,
                                       max_len=2048, chunk_steps=4, eos_id=None)
                cb.register_prefix(head)
                host, dev = [], []
                for _ in range(4):
                    torch.cuda.synchronize()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    t = time.perf_counter()
                    start.record()
                    cb.admit(ids, max_new_tokens=4)
                    end.record()
                    torch.cuda.synchronize()
                    host.append((time.perf_counter() - t) * 1e3)
                    dev.append(start.elapsed_time(end))
                want = (4, 4 * 48) if use == "1" else (0, 0)
                got = (cb.prefix_stats["hits"], cb.prefix_stats["hit_tokens_saved"])
                if got != want:
                    raise AssertionError(f"{tag} KAKVEDA_SERVE_PREFIX={use}: hits, saved {got} != {want}")
                while cb.active:
                    cb.step()
                launched = getattr(flash_gqa_cache, counter)
                both = flash_gqa_cache.launches + flash_gqa_cache.launches_kv8
                if launched != rt.cfg.n_layers * cb.forwards or both != launched:
                    raise AssertionError(f"{tag}: {launched} flash launches for {cb.forwards} forwards")
                launches[tag] = launches.get(tag, 0) + launched
                fwd_ms = admission_forward_ms(cb, ids, use == "1")
                rows = [cb.results[r] for r in sorted(cb.results)]
                if any(r != rows[0] for r in rows):
                    raise AssertionError(f"{tag}: four admissions of one prompt decoded differently: {rows}")
                toks[use] = rows[0]
                times[use] = (statistics.median(host), statistics.median(dev), fwd_ms)
                del cb
            finally:
                del os.environ["KAKVEDA_SERVE_PREFIX"]
        margin = margin_rule(rt.params, dataclasses.replace(rt.cfg, kv_quant=kvq), tok, ids, toks["0"], toks["1"],
                             f"phase 10 prefix-hit admission, {tag} cache")
        out[tag] = dict(hit_host_ms=times["1"][0], hit_events_ms=times["1"][1], hit_forward_graph_ms=times["1"][2],
                        whole_host_ms=times["0"][0], whole_events_ms=times["0"][1],
                        whole_forward_graph_ms=times["0"][2], tokens_equal=margin is None, departure_margin=margin)
        log(f"phase 10 admission of a 560-token judge prompt, {tag} cache: with the prefix (S=512 at "
            f"pos0=512) {times['1'][0]:.2f} ms host / {times['1'][1]:.2f} ms between CUDA events / "
            f"{times['1'][2]:.2f} ms device in its forward's graph replay; whole (S=1024 at pos0=0) "
            f"{times['0'][0]:.2f} / {times['0'][1]:.2f} / {times['0'][2]:.2f} ms (hit / whole: events "
            f"{times['1'][1] / times['0'][1]:.3f}, graph {times['1'][2] / times['0'][2]:.3f}); tokens "
            + ("equal" if margin is None else f"depart at a near-tie (margin {margin:.4f})") + f" [{card}]")
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def admission_forward_ms(cb, ids, use_prefix: bool) -> float:
    """Device time of one admission's forward alone, replayed from a CUDA
    graph (so the eager wrappers' host time is not counted): the prompt
    whole at its bucket from row 0, or with the matching prefix's slab in
    the scratch cache and only the suffix from row off + split."""
    from kakveda_tpu_torch.models.llama import decode_step, init_cache

    p = len(ids)
    bucket = cb.bucket_for(p, cb.max_len)
    off = bucket - p
    kv = torch.zeros((1, cb.max_len), dtype=torch.bool, device="cuda")
    kv[0, off:bucket] = True
    offs = torch.tensor([off], device="cuda")
    scratch = init_cache(cb.cfg, batch=1, max_len=cb.max_len, device="cuda")
    pos, toks = 0, [0] * off + list(ids)
    if use_prefix:
        pe, split, _ = cb._match_prefix(list(ids))
        for key, slabs in pe.kv.items():
            for sk, pk in zip(scratch[key], slabs):
                sk[:, :, off: off + len(pe.ids)] = pk
        pos, toks = off + split, list(ids[split:])
    tt = torch.tensor([toks], device="cuda")

    def fwd():
        scratch["pos"] = pos
        decode_step(cb.params, cb.cfg, tt, scratch, kv_valid=kv, pos_offset=offs, last_only=True)

    ms = graph_ms(fwd, n=2)
    del scratch
    return ms


def phase_judge(base: Path, fused_topk, card: str) -> dict:
    """Phase 10: the LLM judge on the ingest path, the Platform's 2^20 x 2048
    index and Llama-3-8B (random bf16 weights from seed 0) on one card."""
    from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
    from kakveda_tpu_torch.models import generate as G
    from kakveda_tpu_torch.models import runtime as R
    from kakveda_tpu_torch.models.attention import flash_gqa_cache
    from kakveda_tpu_torch.pipeline.classifier import (
        _JUDGE_PROMPT, RuleClassifier, TieredClassifier, _wants_citations, parse_judge_verdict)
    from kakveda_tpu_torch.platform import Platform

    out = {}
    traces = judge_traffic(TracePayload, 4 * 512)
    torch.cuda.reset_peak_memory_stats()

    # Rule-only, the same traces, on a fresh Platform: the comparison arm.
    plat = Platform(data_dir=base / "rule", capacity=ROWS, dim=DIM)
    if not isinstance(plat.classifier, RuleClassifier):
        raise AssertionError("without KAKVEDA_CLASSIFIER the Platform must classify by rule")
    rule_sigs, out["ingest_rule_only_traces_per_s"], _ = ingest_timed(plat, traces)
    plat.close()
    del plat
    gc.collect()
    torch.cuda.empty_cache()

    env = dict(KAKVEDA_CLASSIFIER="tiered", KAKVEDA_MODEL_RUNTIME="torch", KAKVEDA_LLAMA_PRESET="8b",
               KAKVEDA_SERVE_WINDOW=str(JUDGE_WINDOW), KAKVEDA_SERVE_PREFIX_MAX=str(JUDGE_PREFIX_MAX))
    saved = {k: os.environ.get(k) for k in (*env, "KAKVEDA_PREFILL_CHUNK")}
    os.environ.update(env)
    os.environ.pop("KAKVEDA_PREFILL_CHUNK", None)
    R.clear_runtimes()
    try:
        t0 = time.perf_counter()
        plat = Platform(data_dir=base / "judge", capacity=ROWS, dim=DIM)
        torch.cuda.synchronize()
        rt = plat.classifier.runtime
        if not (isinstance(plat.classifier, TieredClassifier) and isinstance(rt, G.LlamaRuntime)
                and rt.device == plat.device and rt.params["embed"].device.type == "cuda"
                and rt.cfg.n_layers == 32 and abs(param_bytes(rt.params) - 16.06e9) < 0.01e9):
            raise AssertionError("KAKVEDA_CLASSIFIER=tiered did not put Llama-3-8B beside the index")
        log(f"phase 10: Platform(2^20 x 2048) and Llama-3-8B ({param_bytes(rt.params) / 1e9:.2f} GB) on "
            f"{plat.device}, up in {time.perf_counter() - t0:.1f} s")
        tok = rt.tokenizer = RecordingTokenizer()
        head = tok.encode(_JUDGE_PROMPT.split("{prompt}")[0])
        if len(head) != 69:
            raise AssertionError(f"the judge head is {len(head)} tokens, not 69")
        eng = rt.engine()
        if (eng.cb.B, eng.cb.max_len) != (8, JUDGE_WINDOW):
            raise AssertionError(f"engine of {eng.cb.B} slots, window {eng.cb.max_len}")

        calls = []
        real_batch, real_reg = rt.generate_batch, rt.register_prefix

        def recorded_batch(prompts, **kw):
            tok.decoded.clear()
            t = time.perf_counter()
            res = real_batch(prompts, **kw)
            calls.append(dict(prompts=list(prompts), results=res, tokens=list(tok.decoded),
                              wall_s=time.perf_counter() - t))
            return res

        reg_ms = []

        def recorded_reg(prefix):
            t = time.perf_counter()
            ok = real_reg(prefix)
            torch.cuda.synchronize()
            reg_ms.append((time.perf_counter() - t) * 1e3)
            return ok

        rt.generate_batch, rt.register_prefix = recorded_batch, recorded_reg
        flash_gqa_cache.launches = 0
        flash_gqa_cache.launches_kv8 = 0
        f0 = eng.cb.forwards
        sigs, out["ingest_judge_traces_per_s"], walls = ingest_timed(plat, traces)
        n_fwd = eng.cb.forwards - f0
        launches, other = flash_gqa_cache.launches, flash_gqa_cache.launches_kv8
        if launches != 32 * n_fwd or other != 0 or n_fwd == 0:
            raise AssertionError(f"arm A: {launches} flash launches ({other} int8) for {n_fwd} forwards")
        if len(calls) != 4 or len(reg_ms) != 1:
            raise AssertionError(f"{len(calls)} judge calls, {len(reg_ms)} registrations")
        ids_per_call = [[rt._encode(p) for p in c["prompts"]] for c in calls]
        if ids_per_call != judge_batches():  # phase 5 held the kernel at the shapes these give
            raise AssertionError("the judge's prompts are not the ones phase 5 took its flash shapes from")
        stats = dict(eng.cb.prefix_stats)
        want = expected_prefix_stats(head, ids_per_call, JUDGE_WINDOW, JUDGE_PREFIX_MAX)
        if stats != want or stats["hits"] == 0 or stats["hits"] == sum(map(len, ids_per_call)):
            raise AssertionError(f"prefix stats {stats} != {want} worked out from the prompt lengths")
        if not all(r.meta.get("continuous") for c in calls for r in c["results"]):
            raise AssertionError("a judge result of arm A did not come through the engine")
        # The signals: the rule's verdicts plus parse_judge_verdict over the texts.
        n_yes = 0
        for b, (c, got) in enumerate(zip(calls, sigs)):
            batch = traces[512 * b: 512 * (b + 1)]
            rule = RuleClassifier().classify_batch(batch)
            amb = [i for i, (t, s) in enumerate(zip(batch, rule)) if s is None and _wants_citations(t.prompt)]
            if len(amb) != 64 or len(c["results"]) != 64 or len(c["tokens"]) != 64:
                raise AssertionError(f"batch {b}: {len(amb)} ambiguous traces, {len(c['results'])} verdicts")
            yes = {batch[i].trace_id for i, r in zip(amb, c["results"]) if parse_judge_verdict(r.text)}
            n_yes += len(yes)
            want_ids = {batch[i].trace_id for i, s in enumerate(rule) if s is not None} | yes
            if {s.trace_id for s in got} != want_ids:
                raise AssertionError(f"batch {b}: the judged signals are not the rule's plus the YES verdicts")
        # The stream's end state (the phase 4 checks): one record per failure,
        # the cluster state current, patterns and health for every app.
        n_fail = sum(map(len, sigs))
        st = plat.gfkb.mine_state_info()
        if plat.gfkb.count != n_fail or n_fail != sum(map(len, rule_sigs)) + n_yes:
            raise AssertionError(f"GFKB holds {plat.gfkb.count} records for {n_fail} failures")
        if not (st.get("enabled") and not st["stale"] and st["covers_all_rows"] and st["delta_dispatches"] >= 4):
            raise AssertionError(f"mining state after the judged stream: {st}")
        pats, info = plat.mine()
        if info["mode"] != "incremental" or not pats or not plat.patterns_list():
            raise AssertionError(f"mine after the judged stream: {info}")
        for app in sorted({t.app_id for t in traces}):
            pts = plat.health_points(app)
            if not pts or not all(0.0 <= p.score <= 100.0 for p in pts):
                raise AssertionError(f"{app}: health {pts[-1:] if pts else 'missing'}")
        # The warn that follows, on the same card.
        fused_topk.launches = 0
        reqs = [WarningRequest(app_id="z", prompt=f"Summarize report {i * 31} and include citations",
                               tools=[], env={"os": "linux"}) for i in range(64)]
        res = plat.warn_batch(reqs)
        if len(res) != 64 or fused_topk.launches < 1 or not all(r.confidence > 0.5 for r in res):
            raise AssertionError(f"warn_batch after the judged stream: {fused_topk.launches} launches")
        # register_prefix once more, warm (the first one paid the first
        # forward at S = 69): another head of the judge's length.
        other = _JUDGE_PROMPT.split("{prompt}")[0].replace("applications", "applicationz")
        t = time.perf_counter()
        if not real_reg(other) or len(tok.encode(other)) != 69:
            raise AssertionError("a second 69-token head did not register")
        torch.cuda.synchronize()
        reg_ms.append((time.perf_counter() - t) * 1e3)
        out.update(
            judge_launches=launches, judge_forwards=n_fwd, warn_fused_topk_launches=fused_topk.launches,
            prefix_stats=stats, register_prefix_ms=reg_ms[0], register_prefix_warm_ms=reg_ms[1], judge_wall_s=[c["wall_s"] for c in calls],
            ingest_batch_wall_s=walls, judged_yes=n_yes, failures=n_fail,
            prompt_tokens=[min(map(len, i)) for i in ids_per_call] + [max(map(len, i)) for i in ids_per_call],
        )
        log(f"phase 10 arm A (engine, window 2048): 4 x 512 traces, {sum(map(len, ids_per_call))} judged in "
            f"{len(calls)} generate_batch calls, every result through the engine; prefix stats {stats} == the "
            f"arithmetic's; {n_fwd} forwards, {launches} flash launches; register_prefix {reg_ms[0]:.2f} ms "
            f"(the first), {reg_ms[1]:.2f} ms (warm); "
            f"judge wall per batch " + " / ".join(f"{c['wall_s']:.3f}" for c in calls) + " s; ingest "
            f"{out['ingest_judge_traces_per_s']:.1f} traces/s with the judge, "
            f"{out['ingest_rule_only_traces_per_s']:.1f} rule-only; {n_yes} YES verdicts, {n_fail} failures; "
            f"warn_batch-64 after it: {fused_topk.launches} fused_topk launches [{card}]")

        # Arm B: the same judge prompts at the default window (512), prefill in
        # pieces of 256: none fits the engine, each batch one DecodeSession.
        del os.environ["KAKVEDA_SERVE_WINDOW"]
        os.environ["KAKVEDA_PREFILL_CHUNK"] = str(JUDGE_CHUNK)
        tok_b = RecordingTokenizer()
        rt_b = G.LlamaRuntime(cfg=rt.cfg, params=rt.params, tokenizer=tok_b)
        try:
            eng_b = rt_b.engine()
            if eng_b.cb.max_len != 512 or any(eng_b.fits(len(i), 4) for ids in ids_per_call for i in ids):
                raise AssertionError("arm B: a judge prompt fits the engine at window 512")
            walls_b, departures, pieces, launches_b, other = [], [], 0, 0, 0
            for c, ids in zip(calls, ids_per_call):
                tok_b.decoded.clear()
                flash_gqa_cache.launches = 0
                flash_gqa_cache.launches_kv8 = 0
                t = time.perf_counter()
                res = rt_b.generate_batch(c["prompts"], max_tokens=JUDGE_MAX_TOKENS)
                walls_b.append(time.perf_counter() - t)
                # Read here: margin_rule's teacher-forced passes below launch it too.
                launches_b += flash_gqa_cache.launches
                other += flash_gqa_cache.launches_kv8
                if any("continuous" in r.meta for r in res):
                    raise AssertionError("arm B: a judge result came through the engine")
                width = G._prefill_width(max(map(len, ids)), JUDGE_CHUNK)
                ml = G._bucket_len(width + JUDGE_MAX_TOKENS + 1, rt.cfg.max_seq_len)
                pieces += width // JUDGE_CHUNK + min(JUDGE_MAX_TOKENS, ml - 1 - width)
                for p_ids, a, b_ in zip(ids, c["tokens"], tok_b.decoded):
                    m = margin_rule(rt.params, rt.cfg, tok, p_ids, a, b_, "phase 10 arm B vs arm A")
                    if m is not None:
                        departures.append(m)
            if launches_b != 32 * pieces or other != 0 or eng_b.cb.forwards != 0:
                raise AssertionError(f"arm B: {launches_b} flash launches ({other} int8) for {pieces} forwards")
            # Its prefill alone, in device time: the last batch, pieces of 256.
            ids = ids_per_call[-1]
            width = G._prefill_width(max(map(len, ids)), JUDGE_CHUNK)
            ml = G._bucket_len(width + JUDGE_MAX_TOKENS + 1, rt.cfg.max_seq_len)
            toks, valid, offs, _ = G._pack_prompts(ids, ml, plen=width)
            cache = G.init_cache(rt.cfg, batch=len(ids), max_len=ml, device="cuda")
            args = [torch.from_numpy(a).cuda() for a in (toks, valid, offs)]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            G.prefill(rt.params, rt.cfg, args[0], cache, args[1], args[2], chunk=JUDGE_CHUNK)
            end.record()
            end.synchronize()
            prefill_ms = start.elapsed_time(end)
            del cache, args
        finally:
            rt_b.close()
        out.update(arm_b_wall_s=walls_b, arm_b_prefill_device_ms=prefill_ms, arm_b_prefill_width=width,
                   arm_b_cache_rows=ml, arm_b_forwards=pieces, arm_b_launches=launches_b,
                   arm_b_departures=len(departures),
                   arm_b_departure_margin_max=max(departures, default=None))
        log(f"phase 10 arm B (window 512, KAKVEDA_PREFILL_CHUNK=256): no judge prompt fits the engine; "
            f"{pieces} forwards, {launches_b} flash launches; wall per batch "
            + " / ".join(f"{w:.3f}" for w in walls_b) + f" s; the last batch's prefill ({len(ids)} prompts at "
            f"width {width}, cache {ml} rows) {prefill_ms:.2f} ms device; tokens == arm A's except "
            f"{len(departures)} prompts that depart at a near-tie (margins up to "
            f"{max(departures, default=0.0):.4f} < {MARGIN_TOL}) [{card}]")

        out["admission"] = judge_admissions(rt, tok, head, card)
        out["admission_launches"] = out["admission"].pop("launches")
        out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        log(f"phase 10: peak allocated with both planes resident {out['peak_allocated_bytes'] / 1e9:.2f} GB "
            f"[{card}]")
        plat.close()
    finally:
        R.clear_runtimes()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del plat, rt
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 10: " + json.dumps(out))
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


def log_held(after: str) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory still allocated after {after}: {torch.cuda.memory_allocated()} bytes")


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
    log_held("phase 4")  # the 2^20 x 2048 index should be gone; the models need the room

    phase_mining(card)
    log_held("phase 7")

    with tempfile.TemporaryDirectory(prefix="kakveda-service-") as d:
        service = phase_service(Path(d), fused_topk, card)
    service_launches = service["launches_service"]
    if service_launches <= 0:
        raise AssertionError("the service path never launched fused_topk")
    log(f"fused_topk launches of the service's requests (phase 8 a-e): {service_launches}")
    log_held("phase 8")

    flash = phase_flash(card)
    held = torch.cuda.memory_allocated()
    model = phase_model(card)
    log_held("phase 6")
    if torch.cuda.memory_allocated() > held + 0.5e9:  # phases 10 and 9 need phase 6's 16 GB back
        raise AssertionError(f"phase 6 left {torch.cuda.memory_allocated() - held} bytes allocated")
    with tempfile.TemporaryDirectory(prefix="kakveda-judge-") as d:
        judge = phase_judge(Path(d), fused_topk, card)
    log_held("phase 10")
    if torch.cuda.memory_allocated() > held + 0.5e9:  # phase 9 needs the card back
        raise AssertionError(f"phase 10 left {torch.cuda.memory_allocated() - held} bytes allocated")
    mixtral = phase_mixtral(card)

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
            launches_mixtral=mixtral[tag]["launches"],
            launches_judge=judge["judge_launches"] if tag == "bf16" else None,
            launches_judge_solo=judge["arm_b_launches"] if tag == "bf16" else None,
            launches_judge_admissions=judge["admission_launches"][tag],
            judge_shapes=r["judge_shapes"],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            bound_seen_ms=r["bound_seen_ms"],
        ))
    kernels[0]["launches_judge_warn"] = judge["warn_fused_topk_launches"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
