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
   plain top-k of the same index;
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

Prints a ``{"kernels": [...]}`` line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import math
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
            if "entry function" in line or "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
    topk_lib = _build.load("fused_topk")
    for width in (8, 16, 32, 64):
        log(f"  fused_topk at wgmma N={width}: {topk_lib.kkv_fused_topk_stages(width)} ring stages, "
            f"{topk_lib.kkv_fused_topk_smem_bytes(width)} bytes of dynamic shared memory")

    row = phase_kernels(fused_topk, fused_topk_reference, card)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="kakveda-smoke-") as d:
        fused_topk.launches = 0
        main_path = phase_platform(Path(d) / "data", fused_topk, fused_topk_reference)
        launches = fused_topk.launches
    if launches <= 0:
        raise AssertionError("the main path never launched fused_topk")
    log(f"fused_topk launches on the main path: {launches}")
    torch.cuda.empty_cache()  # the 2^20 x 2048 index is gone; the model needs the room

    flash = phase_flash(card)
    model = phase_model(card)

    kernels = [dict(
        name="fused_topk", route="cuda", source="kakveda_tpu_torch/csrc/fused_topk.cu",
        replaces="kakveda_tpu/ops/pallas_knn.py:128", launches=launches,
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
