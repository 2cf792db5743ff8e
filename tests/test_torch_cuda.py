"""The port's CUDA kernel and its card path, held to the plain versions.

Marked ``cuda``: these need an NVIDIA card and ``nvcc``, and skip with a
reason elsewhere. On the card (no JAX there, so without the repo's
conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: scores within 1e-4 of ``fused_topk_reference`` and of the
kernel's schedule in plain PyTorch, ``fused_topk_schedule_reference`` (bf16
inputs, f32 sums in another order); ids identical on these inputs, whose
separated scores and exact duplicate rows leave no near-ties. The flash kernel's bf16
output within 2e-2 of ``flash_gqa_cache_reference`` (|out| ≲ 3, where one
bf16 step is ≤ 1.6e-2, and f32 sums taken in another order may flip the
rounding of a probability or of the output), and exact zeros for a slot
that sees nothing. Against the split schedule (and the plain version
beside it) each output row within two bf16 steps of its largest plain
value, 2^-6 of it, and within 2e-2: at a long cache, where outputs are
~0.02, that is ~1e-3, tight enough to catch a wrong combine.
"""

import asyncio
from datetime import datetime, timezone

import pytest
import torch

from kakveda_tpu_torch.models.attention import flash_gqa_cache, flash_gqa_cache_reference
from kakveda_tpu_torch.models.llama import _kv_quant_rows
from kakveda_tpu_torch.ops.fused_topk import (
    fused_topk,
    fused_topk_reference,
    fused_topk_schedule_reference,
    workspace_shape,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _unit(x):
    return x / x.norm(dim=-1, keepdim=True)


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _check(emb, valid, q, k):
    v, i = fused_topk(emb, valid, q, k)
    torch.cuda.synchronize()
    n_cta = workspace_shape(q.shape[0], emb.shape[0], _sms())[1]
    for rv, ri in (fused_topk_reference(emb, valid, q, k),
                   fused_topk_schedule_reference(emb, valid, q, k, n_cta)):
        assert (v - rv).abs().max().item() < 1e-4
        assert torch.equal(i, ri), (i[0].tolist(), ri[0].tolist())
    return i


@pytest.mark.parametrize(
    "rows,dim,b,k,frac",
    [(3000, 128, 3, 5, 0.9), (100, 128, 2, 5, 0.02), (5, 64, 1, 8, 0.9),
     (1500, 256, 17, 5, 0.5), (70000, 512, 100, 7, 0.9), (1030, 192, 64, 3, 0.0),
     (129, 64, 16, 8, 1.0)]
    # every wgmma width (8, 16, 32, 64) and groups of 64, over more tiles
    # than SMs and a ragged last tile
    + [(200_077, 128, b, k, 0.9) for b in (1, 8, 9, 16, 32, 33, 64, 65, 128) for k in (5, 8)]
    # rows under one tile, one short of a tile, one past it, and the main
    # path's 2^20 (7-8 tiles a block), at every dim the layouts take
    + [(rows, dim, b, k, 0.9) for rows in (5, 1023, 1025, 1 << 20) for dim in (64, 128, 192, 2048)
       for b, k in ((1, 5), (33, 8))],
)
def test_kernel_matches_plain(gen, rows, dim, b, k, frac):
    emb = _unit(torch.randn(rows, dim, device="cuda", generator=gen)).to(torch.bfloat16)
    valid = torch.rand(rows, device="cuda", generator=gen) < frac
    q = _unit(torch.randn(b, dim, device="cuda", generator=gen))
    before = fused_topk.launches
    i = _check(emb, valid, q, k)
    assert fused_topk.launches == before + 1
    assert (i < rows).all()


def test_kernel_scores_below_sentinel(gen):
    # Every score below -2.0: the tile rule takes the max, then repeats it.
    q = _unit(torch.randn(2, 128, device="cuda", generator=gen))
    emb = (-q[:1].repeat(2048, 1)
           + 0.01 * torch.randn(2048, 128, device="cuda", generator=gen)).to(torch.bfloat16)
    valid = torch.ones(2048, dtype=torch.bool, device="cuda")
    _check(emb, valid, q[:1] * 5, 6)
    valid[::3] = False  # now -2.0 rows exist: they fill after the max
    _check(emb, valid, q[:1] * 5, 6)


@pytest.mark.parametrize("n_base,step,skip", [(64, 1, 0), (3000, 4, 7)])
def test_kernel_duplicate_rows_tie_to_lowest_id(gen, n_base, step, skip):
    """Exact ties resolve to the lowest row id; with 3000 × 100 rows (293
    tiles) also across the persistent grid's blocks, and where a row's first
    copy is invalid (it scores -2.0, so its second copy leads)."""
    base = _unit(torch.randn(n_base, 256, device="cuda", generator=gen))
    emb = base.repeat(100, 1).to(torch.bfloat16)
    valid = torch.ones(emb.shape[0], dtype=torch.bool, device="cuda")
    if skip:
        valid[:n_base:skip] = False
    rows = list(range(0, 4 * step, step))
    i = _check(emb, valid, emb[rows].float(), 8)
    ok = valid.cpu()
    want = [[r + n_base * c for c in range(100) if ok[r + n_base * c]][:8] for r in rows]
    assert i.tolist() == want


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    emb = torch.zeros(64, 128, dtype=torch.bfloat16, device="cuda")
    valid = torch.ones(64, dtype=torch.bool, device="cuda")
    q = torch.zeros(2, 128, device="cuda")
    with pytest.raises(ValueError):
        fused_topk(emb.float(), valid, q, 5)
    with pytest.raises(ValueError):
        fused_topk(emb, valid, q.cpu(), 5)
    with pytest.raises(ValueError):
        fused_topk(emb, valid, q, 9)
    with pytest.raises(ValueError):
        fused_topk(emb[:, :96].contiguous(), valid, q[:, :96], 5)


def test_platform_on_the_card(gen, tmp_path):
    from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
    from kakveda_tpu_torch.platform import Platform

    plat = Platform(data_dir=tmp_path, capacity=256, dim=1024)
    assert plat.device.type == "cuda" and plat.gfkb._emb.dtype == torch.bfloat16
    ts = datetime.now(timezone.utc)
    traces = [
        TracePayload(trace_id=f"t{i}", ts=ts, app_id=f"app-{i % 3}",
                     prompt=f"Summarize doc {i} and include citations",
                     response="See [1] and [2].")
        for i in range(300)
    ]
    before = fused_topk.launches
    assert len(asyncio.run(plat.ingest_batch(traces))) == 300
    assert plat.gfkb._knn.capacity == 512  # grew past 256
    res = plat.warn_batch([
        WarningRequest(app_id="z", prompt=f"Summarize doc {i} and include citations")
        for i in (0, 150, 299)
    ])
    assert fused_topk.launches == before + 1
    assert [r.references[0].failure_id for r in res] == ["F-0001", "F-0151", "F-0300"]
    assert all(r.pattern_id == "FP-0001" and r.confidence > 0.99 for r in res)
    plat.close()


def test_fused_topk_replays_from_a_cuda_graph(gen):
    """A captured launch replays equal to eager calls, follows in-place
    writes to the index it captured, and keeps doing so after a larger index
    is allocated (as the GFKB grows) and captured in a second graph: the
    tensor maps are encoded per call and held by value in each launch."""
    def case(rows):
        emb = _unit(torch.randn(rows, 256, device="cuda", generator=gen)).to(torch.bfloat16)
        return emb, torch.rand(rows, device="cuda", generator=gen) < 0.9
    q = _unit(torch.randn(9, 256, device="cuda", generator=gen))
    emb, valid = case(50_000)
    want = fused_topk(emb, valid, q, 5)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = fused_topk(emb, valid, q, 5)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    emb[77] = q[0].to(torch.bfloat16)  # an in-place insert: the captured launch sees it
    valid[77] = True
    g.replay()
    torch.cuda.synchronize()
    assert got[1][0, 0].item() == 77
    big, big_valid = case(130_000)  # a new, larger index tensor
    big[:50_000] = emb
    big_valid[:50_000] = valid
    g2 = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g2):
        got2 = fused_topk(big, big_valid, q, 5)
    for graph in (g2, g):
        graph.replay()
    torch.cuda.synchronize()
    for (v, i), (e, m) in ((got2, (big, big_valid)), (got, (emb, valid))):
        rv, ri = fused_topk_reference(e, m, q, 5)
        assert (v - rv).abs().max().item() < 1e-4 and torch.equal(i, ri)


def test_fused_topk_c_entry_refuses_a_wrong_layout(gen):
    """The C entry returns cudaErrorInvalidValue (1) for a query padding
    that is not the kernel's, a short candidate buffer, or dim % 64 != 0;
    the wrapper never calls it so (its own checks raise first)."""
    from kakveda_tpu_torch.ops.fused_topk import _lib

    fn = _lib()
    rows, dim, b = 5000, 128, 3
    emb = _unit(torch.randn(rows, dim, device="cuda", generator=gen)).to(torch.bfloat16)
    valid = torch.ones(rows, dtype=torch.bool, device="cuda")
    bpad, n_cta, lanes = workspace_shape(b, rows, _sms())
    qb = torch.zeros(64, dim, dtype=torch.bfloat16, device="cuda")
    cand_v = torch.empty(64 * n_cta * lanes, device="cuda")
    cand_i = torch.empty(64 * n_cta * lanes, dtype=torch.int32, device="cuda")
    out_v = torch.empty(b, 5, device="cuda")
    out_i = torch.empty(b, 5, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(pad, n_cand, d=dim):
        return fn(emb.data_ptr(), valid.data_ptr(), qb.data_ptr(), rows, d, pad, b, 5, _sms(),
                  cand_v.data_ptr(), cand_i.data_ptr(), n_cand, out_v.data_ptr(), out_i.data_ptr(), stream)

    need = bpad * n_cta * lanes
    assert call(16, 2 * need) == 1  # 3 queries run at width 8, not 16
    assert call(bpad, need - 1) == 1
    assert call(bpad, need, d=96) == 1
    assert call(bpad, need) == 0
    torch.cuda.synchronize()
    rv, ri = fused_topk_reference(emb, valid, torch.zeros(b, dim, device="cuda"), 5)
    assert torch.equal(out_i, ri)


FLASH_ATOL = 2e-2
# Split schedule: every output row within two bf16 steps of its largest
# plain value (one step of x is at most 2^-7 |x|) — f32 sums in another
# order may round an output or a probability the other way — and within
# FLASH_ATOL.
FLASH_REL = 2.0**-6


def _assert_flash_close(out, want):
    diff = (out.float() - want.float()).abs()
    tol = (want.float().abs().amax(dim=-1, keepdim=True) * FLASH_REL).clamp(max=FLASH_ATOL)
    assert (diff <= tol).all(), (diff.max().item(), (diff / tol.clamp_min(1e-30)).max().item())


def _flash_case(gen, b, s, h, kv, l, d, pos0, valid, kv8):
    q = torch.randn(b, s, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(b, kv, l, d, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(b, kv, l, d, device="cuda", generator=gen).to(torch.bfloat16)
    ks = vs = None
    if kv8:
        k, ks = _kv_quant_rows(k)
        v, vs = _kv_quant_rows(v)
    kv_valid = None
    ar = torch.arange(l, device="cuda")
    if valid == "slots":  # decode regime: a per-slot band, slot 0 sees nothing
        lo = torch.randint(0, l // 2, (b, 1), device="cuda", generator=gen)
        hi = torch.randint(l // 2, l + 1, (b, 1), device="cuda", generator=gen)
        kv_valid = (ar >= lo) & (ar < hi)
        kv_valid[0] = False
    elif valid == "leftpad":  # admission regime: left-pad rows invalid
        off = torch.randint(0, max(1, s // 2), (b, 1), device="cuda", generator=gen)
        kv_valid = ar >= off
    return q, k, v, pos0, kv_valid.contiguous() if kv_valid is not None else None, ks, vs


@pytest.mark.parametrize("kv8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize(
    "b,s,h,kv,l,d,pos0,valid,window",
    [
        (8, 1, 32, 8, 512, 128, 512, "slots", 0),  # serving decode
        (1, 64, 32, 8, 512, 128, 0, "leftpad", 0),  # admission
        (2, 3, 8, 8, 100, 64, 40, None, 0),  # R = 1, ragged L, D = 64
        (2, 5, 16, 2, 77, 64, 0, "leftpad", 0),  # R = 8, ragged L
        (2, 9, 32, 4, 300, 128, 0, None, 0),  # R = 8, S*R past one q block
        (3, 1, 32, 8, 2000, 128, 2000, "slots", 0),  # long ragged cache
        (2, 16, 8, 2, 96, 128, 30, None, 7),  # window, prefill at pos0 > 0
        (4, 1, 8, 2, 130, 64, 130, "slots", 16),  # window, decode regime
    ],
)
def test_flash_kernel_matches_plain(gen, b, s, h, kv, l, d, pos0, valid, window, kv8):
    q, k, v, pos0, kv_valid, ks, vs = _flash_case(gen, b, s, h, kv, l, d, pos0, valid, kv8)
    counter = "launches_kv8" if kv8 else "launches"
    before = getattr(flash_gqa_cache, counter)
    out = flash_gqa_cache(q, k, v, pos0, kv_valid, k_scale=ks, v_scale=vs, window=window)
    torch.cuda.synchronize()
    assert getattr(flash_gqa_cache, counter) == before + 1
    ref = flash_gqa_cache_reference(q, k, v, pos0, kv_valid, k_scale=ks, v_scale=vs, window=window)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= FLASH_ATOL, err
    if valid == "slots":
        assert torch.equal(out[0], torch.zeros_like(out[0]))  # the slot that sees nothing


def _split_count(b, s, h, kv, l, pos0, reach=None):
    from kakveda_tpu_torch.models.attention import flash_split_count

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hint = pos0 + s if reach is None else min(pos0 + s, reach)
    return flash_split_count(b * kv, s * (h // kv), l, sms, reach=hint)


@pytest.mark.parametrize("kv8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize(
    "b,s,h,kv,l,d,pos0,valid,window,reach,splits",
    [
        (8, 1, 32, 8, 512, 128, 512, "slots", 0, None, "many"),  # serving decode
        # the engine's decode mask (rows [left pad, 95] of every slot), without
        # and with the engine's reach hint
        (8, 1, 32, 8, 512, 128, 512, "engine", 0, None, "many"),
        (8, 1, 32, 8, 512, 128, 512, "engine", 0, 96, "one"),
        (8, 1, 32, 8, 512, 128, 512, "slots", 0, 300, "many"),  # a hint that still leaves splits
        (1, 64, 32, 8, 512, 128, 0, "leftpad", 0, None, "one"),  # admission: causal reach of one tile
        (2, 1, 8, 2, 40, 64, 40, "slots", 0, None, "one"),  # L < 64, D = 64
        (3, 2, 16, 4, 1000, 64, 1000, None, 0, None, "many"),  # ragged L, ragged last split
        (64, 1, 32, 8, 256, 128, 256, None, 0, None, "one"),  # 512 blocks fill the card alone
        (16, 1, 32, 8, 8192, 128, 8192, "slots", 0, None, "many"),  # long cache
        (4, 1, 8, 2, 700, 128, 700, "slots", 16, None, "many"),  # window, decode regime
        (2, 16, 8, 2, 300, 128, 250, "leftpad", 37, None, "many"),  # window, prefill at pos0 > 0
    ],
)
def test_flash_kernel_matches_split_reference(gen, b, s, h, kv, l, d, pos0, valid, window, reach, splits, kv8):
    from kakveda_tpu_torch.models.attention import flash_gqa_cache_split_reference

    n_split = _split_count(b, s, h, kv, l, pos0, reach)
    assert (n_split == 1) == (splits == "one"), n_split
    q, k, v, pos0, kv_valid, ks, vs = _flash_case(
        gen, b, s, h, kv, l, d, pos0, "slots" if valid == "engine" else valid, kv8
    )
    if valid == "engine":
        off = torch.randint(10, 17, (b, 1), device="cuda", generator=gen)
        ar = torch.arange(l, device="cuda")
        kv_valid = ((ar >= off) & (ar <= 95)).contiguous()
    elif reach is not None:  # the hint holds: nothing at or past it is valid
        kv_valid[:, reach:] = False
    counter = "launches_kv8" if kv8 else "launches"
    before = getattr(flash_gqa_cache, counter)
    out = flash_gqa_cache(q, k, v, pos0, kv_valid, k_scale=ks, v_scale=vs, window=window, reach=reach)
    torch.cuda.synchronize()
    assert getattr(flash_gqa_cache, counter) == before + 1
    kw = dict(k_scale=ks, v_scale=vs, window=window)
    split_ref = flash_gqa_cache_split_reference(q, k, v, pos0, kv_valid, n_split=n_split, **kw)
    ref = flash_gqa_cache_reference(q, k, v, pos0, kv_valid, **kw)
    assert torch.isfinite(out).all()
    for want in (split_ref, ref):
        _assert_flash_close(out, want)
    if valid == "slots":
        assert torch.equal(out[0], torch.zeros_like(out[0]))  # the slot that sees nothing


@pytest.mark.parametrize("kv8", [False, True], ids=["bf16", "int8"])
def test_flash_kernel_replays_from_a_cuda_graph(gen, kv8):
    """Several split launches captured in one graph replay equal to eager
    calls, twice in a row: the tickets are back at zero after every launch."""
    cases = [_flash_case(gen, 8, 1, 32, 8, l, 128, l, "slots", kv8) for l in (512, 1000, 512)]
    assert all(_split_count(8, 1, 32, 8, c[1].shape[2], c[3]) > 1 for c in cases)

    def run():
        return [flash_gqa_cache(q, k, v, p, m, k_scale=ks, v_scale=vs) for q, k, v, p, m, ks, vs in cases]

    eager = run()  # also grows the tickets before the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = run()
    for _ in range(2):
        for o in captured:
            o.fill_(float("nan"))
        g.replay()
        torch.cuda.synchronize()
        for o, want in zip(captured, eager):
            assert torch.equal(o, want)


@pytest.mark.parametrize("kv8", [False, True], ids=["bf16", "int8"])
def test_flash_graph_replays_after_the_tickets_grow(gen, kv8, monkeypatch):
    """A graph captured before a larger shape grows the split tickets still
    replays right: the buffer its launch holds is kept, never handed back
    to the allocator for another tensor to take."""
    from kakveda_tpu_torch.models import attention

    monkeypatch.setattr(attention, "_tickets", {})
    small = _flash_case(gen, 8, 1, 32, 8, 512, 128, 512, "slots", kv8)  # 64 tickets
    big = _flash_case(gen, 16, 1, 32, 8, 2048, 128, 2048, "slots", kv8)  # 128 tickets
    assert _split_count(8, 1, 32, 8, 512, 512) > 1 and _split_count(16, 1, 32, 8, 2048, 2048) > 1

    def run(case):
        q, k, v, p, m, ks, vs = case
        return flash_gqa_cache(q, k, v, p, m, k_scale=ks, v_scale=vs)

    want = run(small)  # also makes the tickets before the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = run(small)
    held = attention._tickets[0][-1]
    run(big)
    torch.cuda.synchronize()
    assert attention._tickets[0][-1].numel() > held.numel()
    junk = torch.full((held.numel(),), 7, dtype=torch.int32, device="cuda")  # may take a freed block
    for _ in range(2):
        captured.fill_(float("nan"))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, want)
    assert torch.equal(held, torch.zeros_like(held)) and torch.equal(junk, torch.full_like(junk, 7))


def test_flash_kernel_refuses_a_short_workspace(gen):
    """The C entry sizes the split partials itself and refuses (cudaErrorInvalidValue)
    a partials or ticket buffer shorter than the launch needs."""
    from kakveda_tpu_torch.models import attention

    lib = attention._lib()
    q, k, v, pos0, m, _, _ = _flash_case(gen, 8, 1, 32, 8, 512, 128, 512, "slots", False)
    qf = q.reshape(8, 1, 8, 4, 128).permute(0, 2, 1, 3, 4).reshape(64, 4, 128).contiguous()
    out = torch.empty_like(qf)
    need = lib.kkv_flash_gqa_cache_part_floats(64, 4, 128, 4)
    assert need == 64 * 4 * 16 * (128 + 2)
    part = torch.empty(need, device="cuda")
    tickets = torch.zeros(64, dtype=torch.int32, device="cuda")

    def call(n_part, n_tickets):
        return lib.kkv_flash_gqa_cache(
            qf.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, m.view(torch.uint8).data_ptr(),
            out.data_ptr(), part.data_ptr(), n_part, tickets.data_ptr(), n_tickets,
            64, 8, 4, 4, 512, 128, pos0, 0, 128**-0.5, 4, torch.cuda.current_stream().cuda_stream,
        )

    assert call(need - 1, 64) == 1 and call(need, 63) == 1
    assert call(need, 64) == 0
    torch.cuda.synchronize()
    want = flash_gqa_cache(q, k, v, pos0, m)
    assert torch.equal(out.reshape(8, 8, 1, 4, 128).permute(0, 2, 1, 3, 4).reshape(8, 1, 32, 128), want)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(gen):
    q = torch.zeros(1, 1, 8, 128, dtype=torch.bfloat16, device="cuda")
    k = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="bf16"):
        flash_gqa_cache(q.float(), k.float(), k.float(), 64, None)  # f32 model on the card
    with pytest.raises(ValueError):
        flash_gqa_cache(q[..., :96].contiguous(), k[..., :96].contiguous(), k[..., :96].contiguous(), 64, None)
    with pytest.raises(ValueError):
        flash_gqa_cache(q, k.to(torch.int8), k.to(torch.int8), 64, None)  # int8 without scales


def _small_bf16_model(gen, kv_quant=""):
    from kakveda_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig(vocab_size=264, d_model=512, n_layers=3, n_heads=8, n_kv_heads=2,
                      d_ff=1024, max_seq_len=256, effective_vocab=259, kv_quant=kv_quant)
    return cfg, init_params(gen, cfg)


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_batcher_on_the_card_runs_the_kernel(gen, kv_quant):
    """Continuous batching on the card: every forward launches the kernel
    once a layer, the other body never; every engine token is within one
    bf16 step of the solo argmax on its own prefix (teacher-forced)."""
    from kakveda_tpu_torch.models.llama import decode_step, init_cache, mask_pad_vocab
    from kakveda_tpu_torch.models.serving import ContinuousBatcher

    cfg, params = _small_bf16_model(gen, kv_quant)
    prompts = [[5, 6, 7], [10, 11, 12, 13, 14], [42], [9, 8], [100, 101, 102, 103, 104, 105]]
    mine = "launches_kv8" if kv_quant else "launches"
    other = "launches" if kv_quant else "launches_kv8"
    before = (getattr(flash_gqa_cache, mine), getattr(flash_gqa_cache, other))
    cb = ContinuousBatcher(params, cfg, batch_slots=2, max_len=128, chunk_steps=4)
    outs = cb.run_all(prompts, max_new_tokens=10)
    torch.cuda.synchronize()
    assert getattr(flash_gqa_cache, mine) - before[0] == cfg.n_layers * cb.forwards
    assert getattr(flash_gqa_cache, other) == before[1]
    for p, out in zip(prompts, outs):
        assert len(out) == 10
        seq = torch.tensor([p + out], device="cuda")
        logits, _ = decode_step(params, cfg, seq, init_cache(cfg, 1, seq.shape[1]))
        lg = mask_pad_vocab(logits[0, len(p) - 1 : -1], cfg)
        deficit = lg.max(dim=-1).values - lg[torch.arange(len(out)), torch.tensor(out)]
        assert deficit.max().item() <= 0.05, deficit


def test_runtime_on_the_card_serves_bf16_only(gen):
    from kakveda_tpu_torch.models.generate import LlamaRuntime

    cfg, params = _small_bf16_model(gen)
    rt = LlamaRuntime(cfg=cfg, params=params)
    try:
        res = rt.generate_batch(["hello", "world!"], max_tokens=6)
        assert all(r.meta["continuous"] and r.meta["tokens_generated"] <= 6 for r in res)
    finally:
        rt.close()
    import dataclasses

    with pytest.raises(ValueError, match="bf16"):
        LlamaRuntime(cfg=dataclasses.replace(cfg, dtype=torch.float32), params=params)


# ---------------------------------------------------------------------------
# mining on the card: the streaming top-k (torch.mm + exact ties), the delta
# dispatch, and the Platform's mine
# ---------------------------------------------------------------------------


def _host_topk(q, emb, valid, k):
    """The same top-k on the CPU in f32 over the bf16-rounded rows."""
    from kakveda_tpu_torch.ops.clustering import _block_topk

    out = _block_topk(q.to(emb.dtype).float().cpu(), emb.float().cpu(), valid.cpu(), k)
    kk = out.shape[1] // 2
    return out[:, :kk], out[:, kk:].long()


def _assert_mining_topk(got, want_v, want_i):
    """Scores within 1e-4 (bf16 products, f32 sums in another order); ids
    equal where the host's neighbouring scores differ by more than 1e-4, and
    on the host's exact ties (duplicated rows: lowest row first)."""
    kk = got.shape[1] // 2
    v, i = got[:, :kk].cpu(), got[:, kk:].long().cpu()
    fin = torch.isfinite(want_v)
    assert torch.equal(fin, torch.isfinite(v))
    assert (v[fin] - want_v[fin]).abs().max().item() <= 1e-4
    gap = (want_v[:, :-1] - want_v[:, 1:]).nan_to_num(0.0).abs()
    near = (gap > 0) & (gap <= 1e-4)
    loose = torch.zeros_like(fin)
    loose[:, :-1] |= near
    loose[:, 1:] |= near
    bad = (i != want_i) & ~loose
    assert not bad.any(), bad.nonzero()[:5].tolist()


@pytest.mark.parametrize("rows,dim,b,k,blocks", [
    (70_000, 2048, 64, 33, 1), (70_000, 256, 300, 33, 3), (5_003, 128, 7, 8, 4), (20, 64, 3, 33, 1)])
def test_block_topk_on_the_card_matches_host(gen, monkeypatch, rows, dim, b, k, blocks):
    """A bf16 index with every row duplicated four times across the index
    (and so across column blocks, whose widths differ by one where the
    index does not split evenly), 20 % invalid: the lowest valid copy
    first on every tie."""
    import kakveda_tpu_torch.ops.clustering as cl

    base = _unit(torch.randn(-(-rows // 4), dim, device="cuda", generator=gen))
    emb = base.repeat(4, 1)[:rows].to(torch.bfloat16)
    valid = torch.rand(rows, device="cuda", generator=gen) >= 0.2
    q = emb[torch.randint(0, rows, (b,), device="cuda", generator=gen)].float()
    monkeypatch.setattr(cl, "_SCORE_BLOCK_BYTES", 4 * b * -(-rows // blocks))
    got = cl._block_topk(q.to(torch.bfloat16), emb, valid, k)
    torch.cuda.synchronize()
    _assert_mining_topk(got, *_host_topk(q, emb, valid, k))
    # A query's copies all score exactly its self-score, lowest row first.
    kk = got.shape[1] // 2
    same = got[:, :kk] == got[:, :1]
    ids = got[:, kk:].long()
    for r in range(b):
        sel = ids[r][same[r]]
        assert torch.equal(sel, sel.sort().values)


def test_delta_topk_returns_before_its_host_copy(gen):
    """The ingest-side dispatch synchronizes nothing (sync debug mode
    raises on any synchronizing call) and returns while the card still
    works; ``unpack_topk`` then waits on the event and gives the rows."""
    import numpy as np

    from kakveda_tpu_torch.ops.featurizer import HashedNGramFeaturizer
    from kakveda_tpu_torch.ops.incremental import delta_topk_sparse, unpack_topk
    from kakveda_tpu_torch.ops.knn import densify

    rows, dim = 1 << 19, 2048
    feat = HashedNGramFeaturizer(dim=dim)
    idx, val = feat.encode_batch_sparse([f"timeout calling service {i} attempt {i % 3}" for i in range(300)])
    emb = _unit(torch.randn(rows, dim, device="cuda", generator=gen)).to(torch.bfloat16)
    dense = densify(torch.from_numpy(idx).cuda(), torch.from_numpy(val).cuda(), dim)
    emb[1000:1300] = dense.to(torch.bfloat16)
    valid = torch.ones(rows, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = delta_topk_sparse(emb, valid, idx, val, 33)
        running = not pending.event.query()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert running and pending.host.is_pinned()
    sims, ids = unpack_topk(pending, 300)
    assert sims.shape == (300, 33) and ids.dtype == np.int64
    assert (ids[:, 0] == 1000 + np.arange(300)).all()  # each query's own row leads
    want_v, want_i = _host_topk(dense, emb, valid, 33)
    packed = torch.cat([torch.from_numpy(sims), torch.from_numpy(ids).float()], 1)
    _assert_mining_topk(packed, want_v, want_i)


def test_platform_mines_on_the_card(gen, tmp_path):
    """Two batches, the second past the initial capacity (a growth rebuild),
    in clusters too small for any neighbour list to evict: one delta per
    batch, then an incremental mine whose partition is the sweep's on the
    card, and a full mine that re-seeds it."""
    import numpy as np

    from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
    from kakveda_tpu_torch.ops.clustering import cluster_embeddings
    from kakveda_tpu_torch.platform import Platform

    rng = np.random.default_rng(0)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    prompts = []
    while len(prompts) < 300:
        words = ["".join(rng.choice(letters, 4)) for _ in range(13)]
        prompts += [f"Sources: {' '.join(words[:j] + ['zz' + words[j][2:]] + words[j + 1:])}" for j in range(5)]
    plat = Platform(data_dir=tmp_path, capacity=256, dim=1024)
    ts = datetime.now(timezone.utc)
    traces = [TracePayload(trace_id=f"t{i}", ts=ts, app_id=f"app-{i % 3}", prompt=p, response="See [1].")
              for i, p in enumerate(prompts[:300])]
    plat.warn(WarningRequest(app_id="z", prompt="Sources: an unrelated question"))
    asyncio.run(plat.ingest_batch(traces[:100]))
    asyncio.run(plat.ingest_batch(traces[100:]))
    st = plat.gfkb.mine_state_info()
    assert plat.gfkb._knn.capacity == 512 and plat.gfkb.count == 300
    assert st["enabled"] and not st["stale"] and st["covers_all_rows"] and st["delta_dispatches"] == 2
    inc, info = plat.mine()
    assert info["mode"] == "incremental" and info["evictions"] == 0 and inc
    _, vecs = plat.gfkb.records_and_embeddings()
    assert vecs.is_cuda
    assert np.array_equal(plat.gfkb._mine.labels(), cluster_embeddings(vecs, threshold=0.6))
    full, info_full = plat.mine(mode="full")
    assert info_full["mode"] == "full" and full and plat.gfkb.mine_usable(0.6)
    plat.close()


def test_service_warn_burst_coalesces_on_the_card(gen, tmp_path):
    """``make_app`` on the card: a concurrent /warn burst goes through the
    micro-batcher in fewer ``fused_topk`` launches than requests, and each
    answer equals a direct ``warn_batch`` of the same requests (action and
    top-1 id; confidence within 1e-4, another batch shape sums in another
    order)."""
    pytest.importorskip("aiohttp", reason="the service plane needs aiohttp")
    from aiohttp.test_utils import TestClient, TestServer

    from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service.app import make_app

    plat = Platform(data_dir=tmp_path, capacity=4096, dim=1024)
    ts = datetime.now(timezone.utc)
    traces = [TracePayload(trace_id=f"t{i}", ts=ts, app_id=f"app-{i % 3}",
                           prompt=f"Summarize doc {i} and include citations", response="See [1] and [2].")
              for i in range(512)]
    asyncio.run(plat.ingest_batch(traces))
    bodies = [{"app_id": f"app-{i % 5}", "prompt": f"Summarize doc {i * 5} and include citations"}
              for i in range(96)]

    async def go():
        client = TestClient(TestServer(make_app(plat)))
        await client.start_server()
        try:
            before = fused_topk.launches
            rs = await asyncio.gather(*[client.post("/warn", json=b) for b in bodies])
            out = [await r.json() for r in rs]
            assert all(r.status == 200 for r in rs)
            return out, fused_topk.launches - before
        finally:
            await client.close()

    answers, launches = asyncio.run(go())
    assert 1 <= launches < len(bodies)
    direct = plat.warn_batch([WarningRequest(**b) for b in bodies])
    for a, d in zip(answers, direct):
        assert a["action"] == d.action and abs(a["confidence"] - d.confidence) <= 1e-4
        assert a["references"][0]["failure_id"] == d.references[0].failure_id
    plat.close()


# ---------------------------------------------------------------------------
# the sparse-MoE MLP and int8 weight-only weights on the card
# ---------------------------------------------------------------------------


def _small_moe_model(gen, quant=None, d=512, n_layers=2):
    from kakveda_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig(vocab_size=264, d_model=d, n_layers=n_layers, n_heads=d // 128, n_kv_heads=2,
                      d_ff=int(3.5 * d), max_seq_len=256, effective_vocab=259, n_experts=8,
                      n_experts_per_tok=2)
    return cfg, init_params(gen, cfg, quant=quant)


@pytest.mark.parametrize("shape", [(4096, 14336), (8, 1024, 3584)], ids=["dense", "stacked"])
def test_int8_quantization_on_the_card_equals_the_cpu(gen, shape):
    """The card's quantizer gives the CPU's q and s bit for bit (IEEE
    division, round half to even on both), on a draw with an all-zero
    column and exact .5 ties."""
    from kakveda_tpu_torch.models.quant import quantize_tensor_int8

    w = torch.randn(shape, device="cuda", generator=gen) / 64
    w[..., 3] = 0.0
    w[..., :4, 5] = torch.tensor([127.0, 2.5, -0.5, 3.5], device="cuda")
    w[..., 4:, 5] = 0.25  # column 5: scale exactly 1.0, so the values above are .5 ties
    host = quantize_tensor_int8(w.cpu())
    for consume in (False, True):
        card = quantize_tensor_int8(w.clone(), consume=consume)
        assert card["q"].device.type == "cuda" and card["q"].dtype == torch.int8
        assert torch.equal(card["q"].cpu(), host["q"]) and torch.equal(card["s"].cpu(), host["s"])
    assert host["q"][..., :4, 5].reshape(-1, 4)[0].tolist() == [127, 2, 0, 4]


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("t", [1, 8, 64])
def test_moe_mlp_on_the_card_matches_the_per_token_oracle(gen, t, quant):
    """moe_mlp (sort, dispatch, bmm, combine) against a per-token dense
    SwiGLU on the same (dequantized) bf16 weights accumulated in f32: the
    same experts, each output row within two bf16 steps of its largest
    oracle value (2^-6 of it)."""
    from kakveda_tpu_torch.models import moe

    cfg, params = _small_moe_model(gen, quant, d=1024)
    layer = params["layers"][0]
    x = torch.randn((1, t, cfg.d_model), device="cuda", generator=gen).to(torch.bfloat16)
    got = moe.moe_mlp(x, layer, cfg)
    want, experts = moe.moe_mlp_reference(x, layer, cfg)
    _, idx, _ = moe.router_topk(x.reshape(t, -1).float() @ layer["router"], 2)
    assert torch.equal(idx.cpu(), experts)
    diff = (got.float() - want.float()).abs()[0]
    bound = 2.0**-6 * want.float()[0].abs().amax(dim=-1, keepdim=True)
    assert (diff <= bound).all(), (diff / bound).max().item()


@pytest.mark.parametrize("quant", [None, "int8"])
def test_moe_forward_wide_replays_from_a_cuda_graph(gen, quant):
    """A MoE decode step captures whole (no host sync in routing, dispatch
    or combine), and a replay after an in-place write of new tokens equals
    an eager step on those tokens."""
    from kakveda_tpu_torch.models.serving import ContinuousBatcher, _forward_wide

    cfg, params = _small_moe_model(gen, quant)
    cb = ContinuousBatcher(params, cfg, batch_slots=4, max_len=128, chunk_steps=4)
    for p in ([5, 6, 7], [10, 11, 12, 13, 14], [42], [9, 8, 7, 6]):
        cb.admit(p, max_new_tokens=40)
    cb.step()
    cb._grow_valid(1)  # the rows the next step writes, as step_async does
    tokens = torch.tensor([[11], [12], [13], [14]], device="cuda")
    args = (torch.from_numpy(cb._pos_np.copy()).cuda(), torch.from_numpy(cb._kv_np.copy()).cuda(),
            torch.from_numpy(cb._off_np.copy()).cuda())
    reach = int(cb._pos_np.max()) + 1

    def step():
        return _forward_wide(cb.params, cb.cfg, cb.cache, tokens, *args, reach=reach)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = step()
    g.replay()
    first = out.clone()
    tokens.copy_(torch.tensor([[50], [60], [70], [80]], device="cuda"))
    g.replay()
    eager = step()
    torch.cuda.synchronize()
    assert torch.isfinite(out[..., :259]).all() and not torch.equal(out, first)
    torch.testing.assert_close(out, eager, atol=2e-2, rtol=0)
    assert torch.equal(out.argmax(-1), eager.argmax(-1))


def test_int8_runtime_never_holds_a_bf16_expert_stack(gen):
    """quant="int8" at Mixtral's width (4 layers): each expert stack is drawn
    in f32 and quantized before the next, so the peak during init stays
    under the int8 model's bytes + 2 GB (one f32 stack is 1.88 GB; one bf16
    copy of the three stacks of a layer would be 2.8 GB more)."""
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.llama import LlamaConfig

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig(vocab_size=32000, d_model=4096, n_layers=4, n_heads=32, n_kv_heads=8, d_ff=14336,
                      max_seq_len=4096, rope_theta=1e6, n_experts=8, n_experts_per_tok=2)
    rt = LlamaRuntime(cfg=cfg, seed=0, quant="int8")
    try:
        peak = torch.cuda.max_memory_allocated() - base
        leaves = [rt.params["embed"], rt.params["final_norm"], *rt.params["lm_head"].values()]
        for layer in rt.params["layers"]:
            for name, w in layer.items():
                if name.startswith("we_") or name.startswith("w"):
                    assert w["q"].dtype == torch.int8 and w["s"].dtype == torch.float32, name
                    leaves += [w["q"], w["s"]]
                else:
                    assert w.dtype == torch.float32, name
                    leaves.append(w)
        n_bytes = sum(t.numel() * t.element_size() for t in leaves)
        assert n_bytes < 6.3e9 and peak < n_bytes + 2e9, (n_bytes, peak)
    finally:
        rt.close()
        del rt
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the LLM judge's shapes: a prefix-hit admission and chunked prefill, where
# the flash kernel runs S > 1 from pos0 > 0
# ---------------------------------------------------------------------------

# Solo top-2 logit margin below which bf16 noise between two computations of
# the same function (a slab's rows vs a full admission's, one prefill piece
# vs several) may flip a greedy token.
MARGIN_TOL = 0.25


@pytest.mark.parametrize("kv8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize(
    "b,s,l,pos0,valid",
    [
        # A 560-token judge prompt at window 2048 hitting the 69-token judge
        # head: bucket 1024, left pad 464, sw 512, split 48.
        (1, 512, 2048, 512, (464, 1024)),
        # DecodeSession's pieces of 64 judge prompts of <= 768 tokens at
        # KAKVEDA_PREFILL_CHUNK=256, per-row left pads.
        (64, 256, 1024, 256, "leftpad"),
        (64, 256, 1024, 512, "leftpad"),
    ],
    ids=["prefix_admission", "chunk_1", "chunk_2"],
)
def test_flash_kernel_at_the_judge_shapes(gen, b, s, l, pos0, valid, kv8):
    from kakveda_tpu_torch.models.attention import flash_gqa_cache_split_reference

    q, k, v, _, _, ks, vs = _flash_case(gen, b, s, 32, 8, l, 128, pos0, None, kv8)
    ar = torch.arange(l, device="cuda")
    if valid == "leftpad":
        off = torch.randint(0, 512, (b, 1), device="cuda", generator=gen)
        off[0] = 0
        off[1] = 511  # the first piece is all left pad for this row
        kv_valid = (ar >= off).contiguous()
    else:
        kv_valid = ((ar >= valid[0]) & (ar < valid[1])).expand(b, l).contiguous()
    n_split = _split_count(b, s, 32, 8, l, pos0)
    counter = "launches_kv8" if kv8 else "launches"
    before = getattr(flash_gqa_cache, counter)
    out = flash_gqa_cache(q, k, v, pos0, kv_valid, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert getattr(flash_gqa_cache, counter) == before + 1
    kw = dict(k_scale=ks, v_scale=vs)
    assert torch.isfinite(out).all()
    for want in (flash_gqa_cache_split_reference(q, k, v, pos0, kv_valid, n_split=n_split, **kw),
                 flash_gqa_cache_reference(q, k, v, pos0, kv_valid, **kw)):
        _assert_flash_close(out, want)


def _agree_under_margin(params, cfg, prompt, ref, got):
    """``got`` equals ``ref``, or first departs from it at a step where the
    solo top-2 margin along ``ref`` is under MARGIN_TOL."""
    from kakveda_tpu_torch.models.llama import decode_step, init_cache, mask_pad_vocab

    n = next((j for j, (x, y) in enumerate(zip(ref, got)) if x != y), None)
    if n is None:
        return len(ref) == len(got)
    seq = torch.tensor([prompt + ref[:n]], device="cuda")
    logits, _ = decode_step(params, cfg, seq, init_cache(cfg, 1, seq.shape[1]), last_only=True)
    top2 = mask_pad_vocab(logits[0, -1], cfg).topk(2).values
    return (top2[0] - top2[1]).item() < MARGIN_TOL


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_prefix_hit_admission_on_the_card(gen, kv_quant, monkeypatch):
    """A prompt that reuses a registered prefix (split > 0, the suffix at
    pos0 = off + split) decodes the tokens of the same prompt admitted whole
    (KAKVEDA_SERVE_PREFIX=0), up to a near-tie; every forward (the prefix
    prefill included) launches the kernel once a layer."""
    from kakveda_tpu_torch.models.serving import ContinuousBatcher

    cfg, params = _small_bf16_model(gen, kv_quant)
    rng = torch.Generator().manual_seed(1)
    head = torch.randint(3, 259, (40,), generator=rng).tolist()
    prompts = [head + torch.randint(3, 259, (n,), generator=rng).tolist() for n in (60, 25, 7)]
    mine = "launches_kv8" if kv_quant else "launches"
    outs = {}
    for use in ("1", "0"):
        monkeypatch.setenv("KAKVEDA_SERVE_PREFIX", use)
        cb = ContinuousBatcher(params, cfg, batch_slots=2, max_len=256, chunk_steps=4)
        before = getattr(flash_gqa_cache, mine)
        assert cb.register_prefix(head)
        outs[use] = cb.run_all(prompts, max_new_tokens=12)
        torch.cuda.synchronize()
        assert getattr(flash_gqa_cache, mine) - before == cfg.n_layers * cb.forwards
        # 100 tokens: sw 64, split 36; 65: sw 32, split 33; 47: sw 8, split 39.
        want = {"registered": 1, "hits": 3, "hit_tokens_saved": 36 + 33 + 39} if use == "1" else \
            {"registered": 1, "hits": 0, "hit_tokens_saved": 0}
        assert cb.prefix_stats == want
    for p, a, b in zip(prompts, outs["0"], outs["1"]):
        assert len(a) == len(b) == 12 and _agree_under_margin(params, cfg, p, a, b), (a, b)


def _session_logits(sess, cfg):
    return sess._last[:, : cfg.effective_vocab].float()


def test_decode_session_chunked_prefill_on_the_card(gen):
    """Chunked prefill (pieces of 32 from pos0 = 0, 32, 64, 96) against the
    one-piece prefill of the same batch: last logits within MARGIN_TOL, and
    each row's greedy tokens equal up to a near-tie."""
    from kakveda_tpu_torch.models.generate import DecodeSession

    cfg, params = _small_bf16_model(gen)
    rng = torch.Generator().manual_seed(2)
    prompts = [torch.randint(3, 259, (n,), generator=rng).tolist() for n in (100, 37, 64, 90)]
    before = flash_gqa_cache.launches
    one = DecodeSession(params, cfg, prompts, chunk_steps=8, max_len=256)
    assert flash_gqa_cache.launches - before == cfg.n_layers
    before = flash_gqa_cache.launches
    many = DecodeSession(params, cfg, prompts, chunk_steps=8, max_len=256, prefill_chunk=32)
    assert flash_gqa_cache.launches - before == 4 * cfg.n_layers and many._pos == 128
    diff = (_session_logits(one, cfg) - _session_logits(many, cfg)).abs().max().item()
    assert diff < MARGIN_TOL, diff
    a, b = one.step_chunk().tolist(), many.step_chunk().tolist()
    for p, ra, rb in zip(prompts, a, b):
        assert _agree_under_margin(params, cfg, p, ra, rb), (ra, rb)


def test_get_runtime_puts_the_judge_on_the_platforms_card(gen, tmp_path, monkeypatch):
    """KAKVEDA_CLASSIFIER=tiered with KAKVEDA_MODEL_RUNTIME=torch: the
    Platform's judge is the in-tree Llama on the index's card, and an
    ambiguous trace's ingest runs it there. The 8B preset (random weights):
    the tiny preset's head_dim of 32 is not one the flash kernel takes."""
    from kakveda_tpu_torch.core.schemas import TracePayload
    from kakveda_tpu_torch.models import runtime as TR
    from kakveda_tpu_torch.pipeline.classifier import TieredClassifier
    from kakveda_tpu_torch.platform import Platform

    TR.clear_runtimes()
    monkeypatch.setenv("KAKVEDA_CLASSIFIER", "tiered")
    monkeypatch.setenv("KAKVEDA_MODEL_RUNTIME", "torch")
    monkeypatch.setenv("KAKVEDA_SERVE_WINDOW", "2048")
    monkeypatch.setenv("KAKVEDA_LLAMA_PRESET", "8b")
    plat = Platform(data_dir=tmp_path, capacity=1024, dim=256)
    try:
        rt = plat.classifier.runtime
        assert isinstance(plat.classifier, TieredClassifier) and rt is TR.get_runtime(device="cuda")
        assert plat.device.type == rt.device.type == rt.params["embed"].device.type == "cuda"
        before = flash_gqa_cache.launches
        trace = TracePayload(trace_id="t", ts=datetime.now(timezone.utc), app_id="a",
                             prompt="Summarize the report and include citations.",
                             response="As Smith showed in 2020, it works.", tools=[], env={})
        asyncio.run(plat.ingest_batch([trace]))
        torch.cuda.synchronize()
        eng = rt.engine()
        assert eng.cb.prefix_stats["registered"] == 1  # the judge head
        assert flash_gqa_cache.launches - before == rt.cfg.n_layers * eng.cb.forwards > 0
    finally:
        plat.close()
        TR.clear_runtimes()


def test_sticky_cuda_error_is_served_degraded(gen, tmp_path):
    """A real sticky CUDA error, in a child process (it poisons the
    child's context for good): ``chip_smoke.py --sticky-child`` builds a
    12,288-row store with the hot cap at 4,096 (mining on, so the overflow
    attaches from the tiers), records warns, trips a device-side assert,
    and must then answer every warn degraded and equal to the recorded one
    (action and top-1, confidence within 1e-2: bf16 rows against f32; a
    top-1 may differ only between rows tied within 1e-2, or an action on
    the threshold's edge; the 48 stored signatures exactly), with
    the error classified and latched, the probe failing and generation
    refused in under a second."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    p = subprocess.run(
        [sys.executable, str(root / "chip_smoke.py"), "--sticky-child", str(tmp_path / "d"), "12288", "4096"],
        capture_output=True, text=True, timeout=600,
    )
    line = next((ln for ln in p.stdout.splitlines() if ln.startswith("STICKY ")), None)
    assert line, p.stdout[-3000:] + p.stderr[-3000:]
    res = json.loads(line[len("STICKY "):])
    assert p.returncode == 0 and res["ok"], res
    agree = res["agreement"]
    assert res["all_degraded"] and res["still_degraded"] and res["stored_equal"] == 48
    assert agree["equal"] + agree["tie"] + agree["threshold"] == res["queries"], agree
    assert res["before_tiers"] == ["tiered"] and set(res["after_tiers"]) <= {"warm", "warm_routed"}
    assert "at gfkb.match" in res["reason"] and res["generate"] == "DeviceUnavailableError"
    assert res["mining"]["tier_attaches"] == 12288 - 4096 and not res["mining"]["stale"]
