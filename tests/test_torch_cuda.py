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


# Softcap cases scale q by this: scaled scores ~N(0, 20^2), past a cap of 50.
SOFTCAP_Q_SCALE = 20.0


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

    lib = attention._lib(128)
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
            64, 8, 4, 4, 512, 128, pos0, None, 0, 128**-0.5, 0.0, 4, torch.cuda.current_stream().cuda_stream,
        )

    assert call(need - 1, 64) == 1 and call(need, 63) == 1
    assert call(need, 64) == 0
    torch.cuda.synchronize()
    want = flash_gqa_cache(q, k, v, pos0, m)
    assert torch.equal(out.reshape(8, 8, 1, 4, 128).permute(0, 2, 1, 3, 4).reshape(8, 1, 32, 128), want)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(gen):
    q = torch.zeros(1, 1, 8, 128, dtype=torch.bfloat16, device="cuda")
    k = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="bf16 or f32"):
        flash_gqa_cache(q.half(), k.half(), k.half(), 64, None)  # no body takes f16 (gqa_grouped does)
    with pytest.raises(ValueError):  # the f32 body takes D 64 and 128
        flash_gqa_cache(q[..., :96].float(), k[..., :96].float(), k[..., :96].float(), 64, None)
    with pytest.raises(ValueError, match="int8"):  # an f32 model over an int8 cache takes gqa_grouped
        flash_gqa_cache(q.float(), k.to(torch.int8), k.to(torch.int8), 64, None,
                        k_scale=k[..., 0].float(), v_scale=k[..., 0].float())
    with pytest.raises(ValueError):  # a head_dim the kernel does not take (it takes 32, 64, 96, 128, 256)
        flash_gqa_cache(q[..., :80].contiguous(), k[..., :80].contiguous(), k[..., :80].contiguous(), 64, None)
    with pytest.raises(ValueError):
        flash_gqa_cache(q, k.to(torch.int8), k.to(torch.int8), 64, None)  # int8 without scales
    with pytest.raises(ValueError):
        flash_gqa_cache(q, k, k, 64, None, softcap=-1.0)
    with pytest.raises(ValueError, match="per-row pos0"):  # per-row positions are int32 [B]
        flash_gqa_cache(q, k, k, torch.zeros(1, dtype=torch.int64, device="cuda"), None)
    with pytest.raises(ValueError, match="per-row pos0"):
        flash_gqa_cache(q, k, k, torch.zeros(2, dtype=torch.int32, device="cuda"), None)


@pytest.mark.parametrize("kv8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("softcap", [0.0, 50.0], ids=["nocap", "softcap"])
@pytest.mark.parametrize(
    "b,s,h,kv,l,d,pos0,valid,window,splits",
    [
        (8, 1, 16, 8, 8192, 256, 8192, "slots", 4096, "many"),  # Gemma-2-9B decode, its window
        (1, 64, 16, 8, 512, 256, 0, "leftpad", 0, "one"),  # Gemma-2-9B admission
        (2, 16, 16, 8, 5120, 256, 4608, "leftpad", 4096, "many"),  # a prefill piece past the window
        (2, 1, 32, 32, 2048, 96, 2048, "slots", 0, "many"),  # Phi-3-mini decode
        (1, 40, 32, 32, 300, 96, 100, None, 0, "one"),  # Phi-3-mini prefill piece
    ],
)
def test_flash_kernel_new_head_dims_replay_from_a_cuda_graph(gen, b, s, h, kv, l, d, pos0, valid, window, splits,
                                                            softcap, kv8):
    """D = 96 and 256, with and without Gemma-2's softcap, both bodies, split
    and unsplit: the kernel against the plain version of its split schedule
    and the unsplit one (the softcap in both), then the same launch captured
    in a CUDA graph replays equal to the eager call, twice. With the softcap
    q is scaled so that the scores reach past the cap (|s| up to ~80 at cap
    50; randn inputs give |s| < 5, where the cap moves a score by < 0.012),
    and the plain version without the cap must fall outside the tolerance:
    a kernel that skipped the cap would fail."""
    from kakveda_tpu_torch.models.attention import (
        flash_gqa_cache_split_reference,
        flash_split_count,
        kernel_blocks_per_sm,
    )

    sr = s * (h // kv)
    n_split = flash_split_count(b * kv, sr, l, _sms(), reach=pos0 + s, blocks_per_sm=kernel_blocks_per_sm(d, kv8, sr))
    assert (n_split == 1) == (splits == "one"), n_split
    q, k, v, pos0, kv_valid, ks, vs = _flash_case(gen, b, s, h, kv, l, d, pos0, valid, kv8)
    if softcap:
        q = (q.float() * SOFTCAP_Q_SCALE).to(torch.bfloat16)
    kw = dict(k_scale=ks, v_scale=vs, window=window, softcap=softcap)
    counter = "launches_kv8" if kv8 else "launches"
    before = getattr(flash_gqa_cache, counter)
    eager = flash_gqa_cache(q, k, v, pos0, kv_valid, **kw)
    torch.cuda.synchronize()
    assert getattr(flash_gqa_cache, counter) == before + 1
    assert torch.isfinite(eager).all()
    for want in (flash_gqa_cache_split_reference(q, k, v, pos0, kv_valid, n_split=n_split, **kw),
                 flash_gqa_cache_reference(q, k, v, pos0, kv_valid, **kw)):
        _assert_flash_close(eager, want)
    if softcap:  # the control: the cap bends these scores past the tolerance
        with pytest.raises(AssertionError):
            _assert_flash_close(eager, flash_gqa_cache_reference(q, k, v, pos0, kv_valid, **dict(kw, softcap=0.0)))
    if valid == "slots":
        assert torch.equal(eager[0], torch.zeros_like(eager[0]))  # the slot that sees nothing
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = flash_gqa_cache(q, k, v, pos0, kv_valid, **kw)
    for _ in range(2):
        captured.fill_(float("nan"))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


def test_flash_blocks_per_sm_the_split_count_plans_are_resident():
    """At every head_dim and both bodies the blocks per SM the split count
    plans for (the library's launch bound: two, one for D = 256's bf16
    ring) are what the card's occupancy calculator grants at least."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from kakveda_tpu_torch.models.attention import KERNEL_HEAD_DIMS, _lib, kernel_blocks_per_sm

    for d in KERNEL_HEAD_DIMS:
        lib = _lib(d)
        for kv8 in (0, 1):
            for sr in (4, 64):
                planned = kernel_blocks_per_sm(d, kv8, sr)
                assert planned == (1 if d == 256 else 2), (d, kv8, sr, planned)
                assert lib.kkv_flash_gqa_cache_blocks_per_sm(d, kv8, sr, 0) >= planned, (d, kv8, sr)
        # each library takes its own head_dim only
        assert all(lib.kkv_flash_gqa_cache_blocks_per_sm(e, 0, 4, 1) == -1 for e in KERNEL_HEAD_DIMS if e != d)


FAMILY_FLAGS = {
    # Gemma-2: GeGLU, the embedding scale, head_dim 256, the softcaps, the
    # window on even layers, a query scale off the default, sandwich norms.
    "gemma2": dict(d_model=512, n_layers=4, n_heads=4, n_kv_heads=2, head_dim_opt=256, d_ff=1024,
                   act_fn="gelu_tanh", scale_embed=True, sliding_window=32, alt_window=True, attn_softcap=50.0,
                   final_softcap=30.0, query_scale=144**-0.5, post_norms=True, norm_eps=1e-6),
    # Phi-3: head_dim 96, longrope past 64 tokens.
    "phi3": dict(d_model=384, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=1024, rope_original_max_len=64,
                 rope_dim_factors=tuple(1.0 + 0.01 * i for i in range(48)),
                 rope_dim_factors_long=tuple(2.0 + 0.08 * i for i in range(48)), rope_attn_scaling=1.1),
    # Qwen2 biases and Qwen3 q/k norms at head_dim 128.
    "qwen": dict(d_model=512, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=1024, attn_bias=True, qk_norm=True),
}


@pytest.mark.parametrize("kv_quant", ["", "int8"])
@pytest.mark.parametrize("family", list(FAMILY_FLAGS))
def test_family_batcher_on_the_card_runs_the_kernel(gen, family, kv_quant):
    """Continuous batching of each family's flags on the card: every forward
    launches the kernel once a layer (the softcap and D = 96 / 256 too, no
    fallback), and every engine token lies within 0.05 of the solo argmax
    on its own prefix (teacher-forced: one pass, or under longrope, whose
    regime follows the running length as decode does, the prompt and then
    one step per token)."""
    from kakveda_tpu_torch.models.llama import LlamaConfig, decode_step, init_cache, init_params, mask_pad_vocab
    from kakveda_tpu_torch.models.serving import ContinuousBatcher

    cfg = LlamaConfig(vocab_size=264, max_seq_len=256, effective_vocab=259, kv_quant=kv_quant, **FAMILY_FLAGS[family])
    params = init_params(gen, cfg)
    prompts = [list(range(5, 60)), [10, 11, 12, 13, 14], [42] * 40, [9, 8], list(range(100, 150))]
    mine = "launches_kv8" if kv_quant else "launches"
    before = getattr(flash_gqa_cache, mine)
    cb = ContinuousBatcher(params, cfg, batch_slots=2, max_len=128, chunk_steps=4)
    outs = cb.run_all(prompts, max_new_tokens=24)
    torch.cuda.synchronize()
    assert getattr(flash_gqa_cache, mine) - before == cfg.n_layers * cb.forwards
    for p, out in zip(prompts, outs):
        cache = init_cache(cfg, 1, len(p) + len(out))
        if cfg.rope_dim_factors_long:
            first, _ = decode_step(params, cfg, torch.tensor([p], device="cuda"), cache, last_only=True)
            steps = [decode_step(params, cfg, torch.tensor([[t]], device="cuda"), cache)[0] for t in out[:-1]]
            logits = torch.cat([first] + steps, dim=1)
        else:
            logits, _ = decode_step(params, cfg, torch.tensor([p + out], device="cuda"), cache)
            logits = logits[:, len(p) - 1 : -1]
        lg = mask_pad_vocab(logits[0], cfg)
        deficit = lg.max(dim=-1).values - lg[torch.arange(len(out)), torch.tensor(out)]
        assert deficit.max().item() <= 0.05, deficit


@pytest.mark.parametrize("family", ["gemma2", "phi3"])
def test_family_forward_wide_replays_from_a_cuda_graph(gen, family):
    """A decode step of a family model captures whole: the embedding scale
    and the query-scale fold are host floats and longrope's divisors are
    made once per device, so nothing copies from the host under capture.
    A replay after an in-place write of new tokens equals an eager step."""
    from kakveda_tpu_torch.models.llama import LlamaConfig, init_params
    from kakveda_tpu_torch.models.serving import ContinuousBatcher, _forward_wide

    cfg = LlamaConfig(vocab_size=264, max_seq_len=256, effective_vocab=259, **FAMILY_FLAGS[family])
    params = init_params(gen, cfg)
    cb = ContinuousBatcher(params, cfg, batch_slots=4, max_len=128, chunk_steps=4)
    for p in (list(range(5, 60)), [10, 11, 12, 13, 14], [42] * 40, [9, 8, 7, 6]):
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
    """The bf16 runtime serves through the engine; an f32 model of the same
    shapes is no longer refused on the card (the f32 body serves it)."""
    from kakveda_tpu_torch.models.generate import LlamaRuntime

    cfg, params = _small_bf16_model(gen)
    rt = LlamaRuntime(cfg=cfg, params=params)
    try:
        res = rt.generate_batch(["hello", "world!"], max_tokens=6)
        assert all(r.meta["continuous"] and r.meta["tokens_generated"] <= 6 for r in res)
    finally:
        rt.close()
    import dataclasses

    f32 = {k: v.float() if torch.is_tensor(v) and v.is_floating_point() else v for k, v in params.items()
           if k != "layers"}
    f32["layers"] = [{k: v.float() for k, v in layer.items()} for layer in params["layers"]]
    before = flash_gqa_cache.launches_f32
    rt = LlamaRuntime(cfg=dataclasses.replace(cfg, dtype=torch.float32), params=f32)
    try:
        res = rt.generate_batch(["hello", "world!"], max_tokens=6)
        assert all(r.meta["continuous"] and r.meta["tokens_generated"] <= 6 for r in res)
    finally:
        rt.close()
    assert flash_gqa_cache.launches_f32 > before


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


# ---------------------------------------------------------------------------
# the engine's request lifecycle on the card: cancel under the pipelined
# loop, the supervisor's rebuild, nucleus sampling
# ---------------------------------------------------------------------------


def _deficit(params, cfg, prompt, out):
    """Teacher-forced: how far each token's logit lies below the argmax on
    its own prefix (0 where the token is the argmax)."""
    from kakveda_tpu_torch.models.llama import decode_step, init_cache, mask_pad_vocab

    seq = torch.tensor([prompt + out], device="cuda")
    logits, _ = decode_step(params, cfg, seq, init_cache(cfg, 1, seq.shape[1]))
    lg = mask_pad_vocab(logits[0, len(prompt) - 1 : -1], cfg)
    return (lg.max(dim=-1).values - lg[torch.arange(len(out)), torch.tensor(out)]).max().item()


def test_cancelled_stream_frees_its_slot_for_the_next_occupant(gen, monkeypatch):
    """One slot: a stream closed after its first delta cancels its request
    under the pipelined loop (a chunk is in flight when the slot frees);
    the next request takes the same slot at once and its tokens are its
    own, each the argmax of its prefix within one bf16 step."""
    from kakveda_tpu_torch.models.generate import LlamaRuntime

    monkeypatch.setenv("KAKVEDA_SERVE_SLOTS", "1")
    cfg, params = _small_bf16_model(gen)
    rt = LlamaRuntime(cfg=cfg, params=params)
    try:
        eng = rt.engine()
        stream = rt.generate_stream("a stream nobody finishes reading", max_tokens=100)
        assert next(stream)
        stream.close()
        fut = eng.submit([5, 6, 7], 24)
        out = fut.result(timeout=120)
        torch.cuda.synchronize()
        assert len(out) == 24 and _deficit(params, cfg, [5, 6, 7], out) <= 0.05
        st = eng.stats()
        assert st["completed"] == 1 and eng.cb.active == 0
        assert [e["kind"] for e in eng.recorder.dump()].count("cancel") == 1
    finally:
        rt.close()


def test_supervisor_rebuild_frees_the_old_cache(gen, monkeypatch):
    """After an injected dispatch crash the rebuilt batcher's cache takes
    the dead one's memory: allocated memory comes back within half a cache
    of what it was, and the engine serves again."""
    from kakveda_tpu_torch.core import faults
    from kakveda_tpu_torch.models.serving import EngineRetryableError, ServingEngine

    monkeypatch.setenv("KAKVEDA_SERVE_RESTARTS", "1")
    cfg, params = _small_bf16_model(gen, "int8")
    eng = ServingEngine(params, cfg, batch_slots=8, max_len=256, chunk_steps=8)
    try:
        eng.submit([5, 6, 7], 8).result(timeout=120)
        torch.cuda.synchronize()
        cache_bytes = sum(t.numel() * t.element_size() for v in eng.cb.cache.values()
                          if isinstance(v, list) for t in v)
        before = torch.cuda.memory_allocated()
        dead = eng.cb
        faults.arm("engine.dispatch:1:1")
        with pytest.raises(EngineRetryableError):
            eng.submit([5, 6, 7], 8).result(timeout=120)
        for _ in range(600):
            if eng.cb is not dead:
                break
            import time

            time.sleep(0.05)
        del dead
        out = eng.submit([9, 8, 7], 8).result(timeout=120)
        torch.cuda.synchronize()
        assert len(out) == 8 and eng.stats()["restarts"] == 1
        assert abs(torch.cuda.memory_allocated() - before) < cache_bytes / 2
    finally:
        faults.disarm()
        eng.close()


def test_top_p_kept_set_on_the_card_equals_the_cpu(gen):
    """``_sample_top_p`` at Llama-3's vocabulary (128,256) and B = 8: the
    card's kept set equals the plain CPU computation's as a set (a sort on
    the card may order equal values otherwise), 1,000 draws fall inside
    it, and at top_p = 1e-9 the draw is the argmax."""
    from kakveda_tpu_torch.models.generate import _sample_top_p, top_p_keep

    logits = 3.0 * torch.randn((8, 128256), generator=gen, device="cuda")
    for top_p in (0.5, 0.9, 0.95):
        keep = top_p_keep(logits, 0.8, top_p)
        assert torch.equal(keep.cpu(), top_p_keep(logits.cpu(), 0.8, top_p))
        g = torch.Generator(device="cuda").manual_seed(1)
        draws = torch.stack([_sample_top_p(logits, 0.8, top_p, g) for _ in range(125)])  # 1,000 draws
        assert keep.gather(1, draws.T).all()
    assert torch.equal(_sample_top_p(logits, 0.8, 1e-9, torch.Generator(device="cuda")), logits.argmax(-1))


# ---------------------------------------------------------------------------
# speculative decoding on the card: the kernel at per-slot positions and at
# head_dim 32, the verify chunk, the default preset
# ---------------------------------------------------------------------------


def _verify_case(gen, b, s, h, kv, l, d, kv8):
    """A verify chunk's inputs: slot i's S queries from its own position
    pos[i], its rows [left pad, pos[i] + S) valid (the engine's grown
    kv_valid), slot 0 seeing nothing."""
    q, k, v, _, _, ks, vs = _flash_case(gen, b, s, h, kv, l, d, 0, None, kv8)
    pos, valid = _verify_positions(gen, b, s, l)
    return q, k, v, ks, vs, pos, valid


def _verify_positions(gen, b, s, l):
    ar = torch.arange(l, device="cuda")
    off = torch.randint(0, max(1, l // 8), (b,), device="cuda", generator=gen)
    pos = torch.randint(l // 8, l - s + 1, (b,), device="cuda", generator=gen)
    valid = (ar[None] >= off[:, None]) & (ar[None] < (pos + s)[:, None])
    valid[0] = False
    return pos.to(torch.int32), valid.contiguous()


@pytest.mark.parametrize("kv8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize(
    "b,s,h,kv,l,d,window,softcap",
    [
        (8, 5, 8, 4, 512, 32, 0, 0.0),  # the default preset's heads (D 32)
        (4, 5, 8, 2, 2048, 64, 0, 0.0),
        (4, 5, 32, 32, 2048, 96, 0, 0.0),  # Phi-3-mini's heads
        (8, 5, 32, 8, 2048, 128, 0, 0.0),  # Llama-3-8B's heads, S*R = 20: the wide block
        (4, 5, 16, 8, 8192, 256, 4096, 50.0),  # Gemma-2-9B's heads, its window and softcap
        (8, 2, 32, 8, 700, 128, 16, 0.0),  # a window narrower than the positions' spread
    ],
)
def test_flash_kernel_per_slot_positions_match_plain(gen, b, s, h, kv, l, d, window, softcap, kv8):
    """``pos0`` as an int32 [B] tensor on the card (the verify chunk's
    per-slot positions) in both bodies at every head_dim: the kernel against
    the plain version of its split schedule and the unsplit one, with the
    host's reach hint and without; then captured in a CUDA graph and
    replayed after the positions and the mask changed on the card, against
    the plain version at the new positions (the hint stays stale: exact)."""
    from kakveda_tpu_torch.models.attention import (
        flash_gqa_cache_split_reference,
        flash_split_count,
        kernel_blocks_per_sm,
    )

    q, k, v, ks, vs, pos, valid = _verify_case(gen, b, s, h, kv, l, d, kv8)
    if softcap:
        q = (q.float() * SOFTCAP_Q_SCALE).to(torch.bfloat16)
    kw = dict(k_scale=ks, v_scale=vs, window=window, softcap=softcap)
    sr = s * (h // kv)
    reach = int(pos.max()) + s
    counter = "launches_kv8" if kv8 else "launches"
    for hint in (reach, None):
        n_split = flash_split_count(b * kv, sr, l, _sms(), reach=hint, blocks_per_sm=kernel_blocks_per_sm(d, kv8, sr))
        before = getattr(flash_gqa_cache, counter)
        out = flash_gqa_cache(q, k, v, pos, valid, reach=hint, **kw)
        torch.cuda.synchronize()
        assert getattr(flash_gqa_cache, counter) == before + 1
        assert torch.isfinite(out).all()
        for want in (flash_gqa_cache_split_reference(q, k, v, pos, valid, n_split=n_split, **kw),
                     flash_gqa_cache_reference(q, k, v, pos, valid, **kw)):
            _assert_flash_close(out, want)
        assert torch.equal(out[0], torch.zeros_like(out[0]))  # the slot that sees nothing
    # One row of the batch against a scalar pos0 launch: the same function.
    one = flash_gqa_cache(q[1:2], k[1:2], v[1:2], int(pos[1]), valid[1:2].contiguous(),
                          **dict(kw, k_scale=None if ks is None else ks[1:2], v_scale=None if vs is None else vs[1:2]))
    _assert_flash_close(out[1:2], one)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = flash_gqa_cache(q, k, v, pos, valid, reach=reach, **kw)
    for _ in range(2):
        new_pos, new_valid = _verify_positions(gen, b, s, l)
        pos.copy_(new_pos)
        valid.copy_(new_valid)
        captured.fill_(float("nan"))
        g.replay()
        torch.cuda.synchronize()
        _assert_flash_close(captured, flash_gqa_cache_reference(q, k, v, new_pos, new_valid, **kw))


@pytest.mark.parametrize("kv8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize(
    "h,kv,l,d,window,softcap",
    [
        (8, 4, 512, 32, 0, 0.0),  # the default preset's heads
        (32, 8, 2048, 128, 0, 0.0),  # Llama-3-8B's
        (16, 8, 8192, 256, 4096, 50.0),  # Gemma-2-9B's, its window and softcap
    ],
)
def test_flash_decode_per_row_positions_equal_the_mask_form(gen, h, kv, l, d, window, softcap, kv8):
    """The engine's decode step (S = 1) passes the slots' positions as the
    per-row ``pos0`` with the raw validity and the window; the same
    attention as a ``[B, L]`` mask (validity, causal and band folded in)
    under a scalar ``pos0`` past every row, the form the decode step took
    before, launches the same schedule and gives the same bits."""
    q, k, v, ks, vs, pos, valid = _verify_case(gen, 8, 1, h, kv, l, d, kv8)
    if softcap:
        q = (q.float() * SOFTCAP_Q_SCALE).to(torch.bfloat16)
    col = torch.arange(l, device="cuda")
    mask = valid & (col[None] <= pos[:, None])
    if window:
        mask &= col[None] > pos[:, None] - window
    reach = int(pos.max()) + 1
    kw = dict(k_scale=ks, v_scale=vs, softcap=softcap, reach=reach)
    per_row = flash_gqa_cache(q, k, v, pos, valid, window=window, **kw)
    masked = flash_gqa_cache(q, k, v, l, mask.contiguous(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(per_row, masked)


@pytest.mark.parametrize("kv8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize(
    "b,s,l,pos0,valid,splits",
    [
        (8, 1, 512, 512, "slots", "many"),  # decode under the engine's mask regime
        (8, 1, 4096, 4096, "slots", "many"),
        (1, 512, 1024, 0, "leftpad", "many"),  # a 512-row prefill piece: 16 q blocks, split 4 ways
        (2, 64, 1000, 300, "leftpad", "many"),  # a piece at pos0 > 0, ragged L
    ],
)
def test_flash_kernel_head_dim_32(gen, b, s, l, pos0, valid, splits, kv8):
    """D = 32 at the default preset's heads (H 8, KV 4): decode and
    prefill, both bodies, against both plain versions."""
    from kakveda_tpu_torch.models.attention import flash_gqa_cache_split_reference

    n_split = _split_count(b, s, 8, 4, l, pos0)
    assert (n_split == 1) == (splits == "one"), n_split
    q, k, v, pos0, kv_valid, ks, vs = _flash_case(gen, b, s, 8, 4, l, 32, pos0, valid, kv8)
    out = flash_gqa_cache(q, k, v, pos0, kv_valid, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    for want in (flash_gqa_cache_split_reference(q, k, v, pos0, kv_valid, k_scale=ks, v_scale=vs, n_split=n_split),
                 flash_gqa_cache_reference(q, k, v, pos0, kv_valid, k_scale=ks, v_scale=vs)):
        _assert_flash_close(out, want)
    if valid == "slots":
        assert torch.equal(out[0], torch.zeros_like(out[0]))


def _margin_departure(params, cfg, prompt, ref, got):
    """None when ``got`` equals ``ref``, else the solo top-2 logit margin
    along ``ref`` (teacher-forced) at the first step where they part."""
    from kakveda_tpu_torch.models.llama import decode_step, init_cache, mask_pad_vocab

    n = next((j for j, (x, y) in enumerate(zip(ref, got)) if x != y), None)
    if n is None:
        assert len(ref) == len(got)
        return None
    seq = torch.tensor([prompt + ref[:n]], device="cuda")
    logits, _ = decode_step(params, cfg, seq, init_cache(cfg, 1, seq.shape[1]), last_only=True)
    top2 = mask_pad_vocab(logits[0, -1], cfg).topk(2).values
    return (top2[0] - top2[1]).item()


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_batcher_spec_on_the_card_gives_the_plain_tokens(gen, kv_quant, monkeypatch):
    """The default preset (head_dim 32) in bf16 on the card: a speculating
    pool (gate held open) runs verify chunks through the kernel, one launch
    a layer per forward, and its tokens equal the plain pool's, or part
    from them only where the solo top-2 margin is under 0.25 (a k+1-wide
    GEMM rounds bf16 otherwise than a 1-wide one)."""
    from kakveda_tpu_torch.models.llama import LlamaConfig, init_params
    from kakveda_tpu_torch.models.serving import ContinuousBatcher

    monkeypatch.setenv("KAKVEDA_SERVE_SPEC_CALIB", "0")
    monkeypatch.setenv("KAKVEDA_SERVE_SPEC_BREAKEVEN", "0")
    cfg = LlamaConfig(effective_vocab=259, kv_quant=kv_quant)
    assert cfg.head_dim == 32
    params = init_params(gen, cfg)
    prompts = [[7, 8, 9] * 3, [5, 6, 7], [10, 11, 12, 13, 14] * 2, [42]]
    plain = ContinuousBatcher(params, cfg, batch_slots=4, max_len=256, chunk_steps=4).run_all(prompts, 32)
    mine = "launches_kv8" if kv_quant else "launches"
    before = getattr(flash_gqa_cache, mine)
    cb = ContinuousBatcher(params, cfg, batch_slots=4, max_len=256, chunk_steps=4, spec_k=4)
    spec = cb.run_all(prompts, 32)
    torch.cuda.synchronize()
    assert cb.spec_stats["chunks"] > 0
    assert getattr(flash_gqa_cache, mine) - before == cfg.n_layers * cb.forwards
    for p, a, b in zip(prompts, plain, spec):
        margin = _margin_departure(params, cfg, p, a, b)
        assert margin is None or margin < 0.25, (p, a, b, margin)


def test_default_preset_runtime_serves_on_the_card_with_spec(monkeypatch):
    """``LlamaRuntime()`` and ``get_runtime("torch")`` build the default
    preset (head_dim 32, seed 0) on the card, and its engine serves with
    and without ``KAKVEDA_SERVE_SPEC``: the same texts, or a departure at a
    near-tie (the margin rule above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from kakveda_tpu_torch.models import runtime as TR
    from kakveda_tpu_torch.models.generate import LlamaRuntime

    monkeypatch.delenv("KAKVEDA_LLAMA_PRESET", raising=False)
    monkeypatch.setenv("KAKVEDA_SERVE_SPEC_CALIB", "0")
    monkeypatch.setenv("KAKVEDA_SERVE_SPEC_BREAKEVEN", "0")
    TR.clear_runtimes()
    try:
        rt = TR.get_runtime("torch")
        assert rt.device.type == "cuda" and rt.cfg.head_dim == 32
    finally:
        TR.clear_runtimes()
    ids = [[7, 8, 9] * 4, [104, 101, 108, 108, 111]]
    outs = []
    for spec in ("0", "4"):
        monkeypatch.setenv("KAKVEDA_SERVE_SPEC", spec)
        rt = LlamaRuntime()
        try:
            eng = rt.engine()
            outs.append([eng.submit(p, 24).result(timeout=300) for p in ids])
            assert (eng.stats()["spec"]["chunks"] > 0) == (spec == "4")
        finally:
            rt.close()
    for p, a, b in zip(ids, *outs):
        margin = _margin_departure(rt.params, rt.cfg, p, a, b)
        assert margin is None or margin < 0.25, (p, a, b, margin)


# ---------------------------------------------------------------------------
# the f32 body, and the card's dispatch: gqa_grouped where no body takes the
# dtype, the head_dim or the mask
# ---------------------------------------------------------------------------

# The f32 body against its plain version: f32 sums in another order, so
# within 1e-4 absolute (rtol 0). Its q is scaled so that the scores are
# ~N(0, 16): sharp rows, where inputs rounded to a 10-bit mantissa (TF32) or
# to bf16 move the plain version past the same tolerance (the control).
F32_ATOL = 1e-4
F32_Q_SCALE = 4.0


def test_ladder_step_one_vetoes_verify_chunks_on_the_card(gen, monkeypatch):
    """The brownout ladder held at its first step (no_spec): a speculating
    pool on the card (gate held open) dispatches no verify chunk, and its
    tokens are the plain pool's, bit for bit (the same 1-wide chunks)."""
    from kakveda_tpu_torch.core import admission
    from kakveda_tpu_torch.models.serving import ContinuousBatcher

    monkeypatch.setenv("KAKVEDA_SERVE_SPEC_CALIB", "0")
    monkeypatch.setenv("KAKVEDA_SERVE_SPEC_BREAKEVEN", "0")
    monkeypatch.setenv("KAKVEDA_BROWNOUT_EXIT", "-1")
    admission.reset_for_tests()
    try:
        cfg, params = _small_bf16_model(gen)
        prompts = [[7, 8, 9] * 3, [5, 6, 7], [10, 11, 12, 13, 14] * 2, [42]]
        plain = ContinuousBatcher(params, cfg, batch_slots=4, max_len=256, chunk_steps=4).run_all(prompts, 32)
        ladder = admission.get_admission().brownout
        ladder.note_pressure(1.0)
        assert ladder.step == 1 and not ladder.spec_allowed()
        cb = ContinuousBatcher(params, cfg, batch_slots=4, max_len=256, chunk_steps=4, spec_k=4)
        before = flash_gqa_cache.launches
        out = cb.run_all(prompts, 32)
        torch.cuda.synchronize()
        assert cb.spec_stats["chunks"] == 0 and cb.spec_stats["drafted"] == 0
        assert flash_gqa_cache.launches - before == cfg.n_layers * cb.forwards
        assert out == plain
    finally:
        admission.reset_for_tests()


def _round_mantissa(x, bits):
    """``x`` rounded to ``bits`` explicit mantissa bits: 10 is TF32, 7 bf16."""
    i = x.contiguous().view(torch.int32)
    drop = 23 - bits
    return ((i + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)


def _f32_case(gen, b, s, h, kv, l, d, pos0, valid):
    """f32 q (scaled), k, v drawn as f32, and the mask of ``_flash_case``;
    a ``pos0`` of "verify" gives per-slot positions (``_verify_positions``)."""
    if pos0 == "verify":
        pos0, kv_valid = _verify_positions(gen, b, s, l)
    else:
        kv_valid = _flash_case(gen, b, s, h, kv, l, 64, pos0, valid, False)[4]
    q = torch.randn(b, s, h, d, device="cuda", generator=gen) * F32_Q_SCALE
    k = torch.randn(b, kv, l, d, device="cuda", generator=gen)
    v = torch.randn(b, kv, l, d, device="cuda", generator=gen)
    return q, k, v, pos0, kv_valid


F32_CASES = [
    # (b, s, h, kv, l, d, pos0, valid, window, softcap)
    (8, 1, 32, 8, 2048, 128, 2048, "slots", 0, 0.0),  # decode at Llama-3-8B's heads, split
    (8, 1, 32, 8, 2048, 64, 2048, "slots", 0, 0.0),
    (8, 5, 32, 8, 2048, 128, "verify", None, 0, 0.0),  # the verify chunk: S*R = 20, the wide block
    (8, 5, 8, 2, 1024, 64, "verify", None, 0, 0.0),
    (1, 512, 32, 8, 1024, 128, 512, "leftpad", 0, 0.0),  # a 512-row prefill piece
    (1, 512, 8, 2, 1024, 64, 512, "leftpad", 0, 0.0),
    (2, 3, 8, 8, 100, 64, 40, None, 0, 0.0),  # R = 1, ragged L
    (2, 9, 32, 4, 300, 128, 0, None, 0, 0.0),  # S*R past one q block
    (4, 1, 8, 2, 700, 128, 700, "slots", 16, 0.0),  # window, decode regime
    (2, 16, 8, 2, 300, 128, 250, "leftpad", 37, 0.0),  # window, prefill at pos0 > 0
    (4, 5, 16, 8, 1024, 128, "verify", None, 256, 2.0),  # softcap and window at per-slot positions
    (4, 1, 8, 4, 512, 64, 512, "slots", 0, 2.0),  # softcap at decode
]


@pytest.mark.parametrize("b,s,h,kv,l,d,pos0,valid,window,softcap", F32_CASES)
def test_flash_f32_body_matches_plain(gen, b, s, h, kv, l, d, pos0, valid, window, softcap):
    """The f32 body against the plain version of its split schedule and the
    unsplit one, within F32_ATOL: split and unsplit, decode, the verify
    chunk's per-slot positions, prefill, windows and the softcap (a cap of
    2 bends scores ~N(0, 16), so the uncapped plain version falls outside);
    a slot that sees nothing gives zeros; only the f32 counter moves."""
    from kakveda_tpu_torch.models.attention import (
        flash_gqa_cache_split_reference,
        flash_split_count,
        kernel_blocks_per_sm,
    )

    q, k, v, pos0, kv_valid = _f32_case(gen, b, s, h, kv, l, d, pos0, valid)
    vec = torch.is_tensor(pos0)
    reach = int(pos0.max()) + s if vec else None
    kw = dict(window=window, softcap=softcap)
    sr = s * (h // kv)
    hint = reach if vec else pos0 + s
    n_split = flash_split_count(b * kv, sr, l, _sms(), reach=hint, blocks_per_sm=kernel_blocks_per_sm(d, False, sr, True))
    before = (flash_gqa_cache.launches_f32, flash_gqa_cache.launches, flash_gqa_cache.launches_kv8)
    out = flash_gqa_cache(q, k, v, pos0, kv_valid, reach=reach, **kw)
    torch.cuda.synchronize()
    assert (flash_gqa_cache.launches_f32, flash_gqa_cache.launches, flash_gqa_cache.launches_kv8) == (
        before[0] + 1, before[1], before[2])
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    ref = flash_gqa_cache_reference(q, k, v, pos0, kv_valid, **kw)
    for want in (flash_gqa_cache_split_reference(q, k, v, pos0, kv_valid, n_split=n_split, **kw), ref):
        assert (out - want).abs().max().item() <= F32_ATOL
    if valid == "slots" or vec:
        assert torch.equal(out[0], torch.zeros_like(out[0]))  # the slot that sees nothing
    if softcap:
        uncapped = flash_gqa_cache_reference(q, k, v, pos0, kv_valid, window=window)
        assert (out - uncapped).abs().max().item() > F32_ATOL


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape", ["decode", "verify", "prefill"])
def test_flash_f32_tolerance_tells_f32_from_tf32_and_bf16(gen, d, shape):
    """The control at phase 5's f32 shapes: the kernel within F32_ATOL of
    the plain version, and the plain version over inputs rounded to TF32 or
    to bf16 outside it."""
    b, s, h, kv, l, pos0, valid = {
        "decode": (8, 1, 32, 8, 2048, 2048, "slots"),
        "verify": (8, 5, 32, 8, 2048, "verify", None),
        "prefill": (1, 512, 32, 8, 1024, 512, "leftpad"),
    }[shape]
    q, k, v, pos0, kv_valid = _f32_case(gen, b, s, h, kv, l, d, pos0, valid)
    reach = int(pos0.max()) + s if torch.is_tensor(pos0) else None
    ref = flash_gqa_cache_reference(q, k, v, pos0, kv_valid)
    out = flash_gqa_cache(q, k, v, pos0, kv_valid, reach=reach)
    assert (out - ref).abs().max().item() <= F32_ATOL
    for bits in (10, 7):
        r = [_round_mantissa(x, bits) for x in (q, k, v)]
        assert (flash_gqa_cache_reference(*r, pos0, kv_valid) - ref).abs().max().item() > F32_ATOL, bits


def test_flash_f32_replays_from_a_cuda_graph(gen):
    """Split f32 launches and a per-slot one captured in one graph replay
    equal to eager calls, twice; after the positions and the mask change on
    the card the per-slot launch equals the plain version at the new ones."""
    cases = [_f32_case(gen, 8, 1, 32, 8, l, d, l, "slots") for l, d in ((512, 128), (1000, 64))]
    vq, vk, vv, vpos, vvalid = _f32_case(gen, 8, 5, 32, 8, 1024, 128, "verify", None)
    reach = 1024

    def run():
        outs = [flash_gqa_cache(q, k, v, p, m) for q, k, v, p, m in cases]
        return outs + [flash_gqa_cache(vq, vk, vv, vpos, vvalid, reach=reach)]

    eager = run()
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
    new_pos, new_valid = _verify_positions(gen, 8, 5, 1024)
    vpos.copy_(new_pos)
    vvalid.copy_(new_valid)
    g.replay()
    torch.cuda.synchronize()
    assert (captured[-1] - flash_gqa_cache_reference(vq, vk, vv, new_pos, new_valid)).abs().max().item() <= F32_ATOL


@pytest.mark.parametrize(
    "dtype,d,full_mask,kv8,path",
    [
        (torch.bfloat16, 128, False, False, "launches"),
        (torch.bfloat16, 128, False, True, "launches_kv8"),
        (torch.float32, 64, False, False, "launches_f32"),
        (torch.float32, 128, False, False, "launches_f32"),
        (torch.float32, 80, False, False, "grouped"),  # no body at D = 80
        (torch.bfloat16, 80, False, False, "grouped"),
        (torch.float16, 64, False, False, "grouped"),  # no f16 body
        (torch.float32, 128, False, True, "grouped"),  # an f32 model over an int8 cache
        (torch.bfloat16, 128, True, False, "grouped"),  # a full_mask
        (torch.float32, 64, True, False, "grouped"),
    ],
)
def test_card_dispatch_counts_and_matches_the_cpu(gen, dtype, d, full_mask, kv8, path):
    """``gqa_cache_attention`` on the card goes where ``card_path`` says, and
    only that counter moves; its output equals the CPU port's (the plain
    versions) within 1e-4 in f32, 2e-2 in bf16 / f16 (one step of |out| <~ 3)."""
    from kakveda_tpu_torch.models.attention import card_path, gqa_cache_attention, gqa_grouped

    assert (card_path(dtype, d, full_mask, kv8) == "grouped") == (path == "grouped")
    b, s, h, kv, l = 4, 5, 8, 2, 256
    q = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, kv, l, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, kv, l, d, device="cuda", generator=gen).to(dtype)
    ks = vs = None
    if kv8:
        k, ks = _kv_quant_rows(k)
        v, vs = _kv_quant_rows(v)
    pos = torch.randint(40, l - s, (b,), device="cuda", generator=gen).to(torch.int32)
    ar = torch.arange(l, device="cuda")
    valid = ((ar[None] >= 8) & (ar[None] < (pos + s)[:, None].long())).contiguous()  # every row sees a slot
    mask = None
    if full_mask:
        mask = valid[:, None, :] & (ar[None, None, :] <= (pos[:, None] + torch.arange(s, device="cuda")).long()[..., None])
    counters = ("launches", "launches_kv8", "launches_f32")
    before = [getattr(flash_gqa_cache, c) for c in counters] + [gqa_grouped.launches]
    out = gqa_cache_attention(q, k, v, pos, valid, k_scale=ks, v_scale=vs, full_mask=mask, reach=int(pos.max()) + s)
    torch.cuda.synchronize()
    after = [getattr(flash_gqa_cache, c) for c in counters] + [gqa_grouped.launches]
    moved = [n for n, x, y in zip(counters + ("grouped",), before, after) if x != y]
    assert moved == [path] and after[(counters + ("grouped",)).index(path)] == before[(counters + ("grouped",)).index(path)] + 1
    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
    want = gqa_cache_attention(*(cpu(t) for t in (q, k, v, pos, valid)), k_scale=cpu(ks), v_scale=cpu(vs),
                               full_mask=cpu(mask))
    assert out.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (out.float().cpu() - want.float()).abs().max().item() <= tol


def _to_dtype(params, dtype):
    """A parameter tree with every floating leaf in ``dtype``."""
    conv = lambda v: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v  # noqa: E731
    out = {k: conv(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: conv(v) for k, v in layer.items()} for layer in params["layers"]]
    return out


@pytest.mark.parametrize(
    "dtype,head_dim,path",
    [(torch.float32, 64, "launches_f32"), (torch.float32, 80, "grouped"), (torch.float16, 64, "grouped"),
     (torch.bfloat16, 80, "grouped")],
)
def test_runtime_of_another_dtype_or_head_dim_on_the_card_gives_the_cpu_tokens(gen, dtype, head_dim, path):
    """``LlamaRuntime`` serves an f32 model, an f16 one and head_dim 80 on
    the card (the engine, then the solo path): every forward goes through
    ``card_path``'s choice, one launch a layer, and the tokens equal the CPU
    port's on the same weights, or part at a solo top-2 margin under 0.05
    (f32) / 0.25 (half precisions)."""
    import dataclasses

    from kakveda_tpu_torch.models.attention import gqa_grouped
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig(vocab_size=264, d_model=head_dim * 4, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
                      max_seq_len=256, effective_vocab=259, dtype=torch.float32)
    params = init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    cfg = dataclasses.replace(cfg, dtype=dtype)
    cpu = LlamaRuntime(cfg=cfg, params=_to_dtype(params, dtype), device="cpu")
    card_params = _to_dtype(params, dtype)
    card_params = {k: (v.cuda() if torch.is_tensor(v) else v) for k, v in card_params.items() if k != "layers"}
    card_params["layers"] = [{k: v.cuda() for k, v in layer.items()} for layer in _to_dtype(params, dtype)["layers"]]
    rt = LlamaRuntime(cfg=cfg, params=card_params)
    ids = [rt.tokenizer.encode(p) for p in ("hello there", "the quick brown fox", "a")]
    count = (lambda: gqa_grouped.launches) if path == "grouped" else (lambda: getattr(flash_gqa_cache, path))
    try:
        before = count()
        got = [rt.engine().submit(i, 12).result(timeout=300) for i in ids]
        got.append(rt._generate_ids_chunked(ids[:1], 12)[0])  # the solo DecodeSession path
        assert count() > before
    finally:
        rt.close()
    try:
        want = [cpu.engine().submit(i, 12).result(timeout=300) for i in ids]
    finally:
        cpu.close()
    tol = 0.05 if dtype == torch.float32 else 0.25
    for p, a, b in zip(ids + ids[:1], want + want[:1], got):
        margin = _margin_departure(card_params, cfg, p, a, b)
        assert margin is None or margin < tol, (p, a, b, margin)


def test_two_replicas_on_the_card_behind_the_router_answer_as_one_platform(gen, tmp_path):
    """Two port replicas on the card (``cli up --replica-index i --device
    cuda``) behind the router, ingest through the router (replicated to the
    peer) and warns: every replica holds every row, no warn is degraded and
    the replicas' ``fused_topk`` launches (``/readyz``) rose, and each
    warn's references equal one Platform's on the card that ingested the
    same traces, signature for signature, scores within 1e-4."""
    import json
    import urllib.request

    from aiohttp import ClientSession
    from aiohttp.test_utils import TestServer

    from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
    from kakveda_tpu_torch.fleet.router import make_router_app
    from kakveda_tpu_torch.fleet.supervisor import FleetSupervisor, pick_port_base
    from kakveda_tpu_torch.platform import Platform

    stub = "Here is a summary with references.\n\nReferences:\n[1] Smith et al. (2020) A Study on Things.\n"
    traces = [
        {"trace_id": f"t-{i}", "ts": datetime.now(timezone.utc).isoformat(), "app_id": f"app-{i % 5}",
         "agent_id": "a", "prompt": f"Summarize report {i} and cite sources even if none are given.",
         "response": stub, "model": "stub", "tools": [], "env": {"os": "linux"}}
        for i in range(40)
    ]
    warns = [{"app_id": f"app-{i % 5}", "prompt": f"Summarize report {i} and cite sources.", "tools": [],
              "env": {"os": "linux"}} for i in range(0, 40, 3)]
    oracle = Platform(data_dir=tmp_path / "oracle", capacity=4096, device="cuda")
    asyncio.run(oracle.ingest_batch([TracePayload.model_validate(t) for t in traces]))
    want = oracle.warn_batch([WarningRequest.model_validate(w) for w in warns])  # builds the kernel first
    n_rows = oracle.gfkb.count
    oracle.close()

    sup = FleetSupervisor(tmp_path / "fleet", port_base=pick_port_base(2), replicas=2, device="cuda",
                          env={"KAKVEDA_INDEX_CAPACITY": "4096", "KAKVEDA_FLEET_GOSSIP_S": "0.5"})

    async def go():
        server = TestServer(make_router_app(sup.backend_map(), probe_interval_s=1.0, retries=1))
        await server.start_server()
        try:
            async with ClientSession() as s:
                async with s.post(server.make_url("/ingest/batch"), json={"traces": traces}) as r:
                    assert r.status == 200
                got = []
                for w in warns:
                    async with s.post(server.make_url("/warn"), json=w) as r:
                        assert r.status == 200
                        got.append(await r.json())
                return got
        finally:
            await server.close()

    try:
        sup.start_all()
        sup.wait_ready(timeout_s=300.0)
        got = asyncio.run(go())
        ready = [json.loads(urllib.request.urlopen(u + "/readyz", timeout=10).read()) for u in sup.urls()]
    finally:
        sup.stop_all()
    assert [r["gfkb_count"] for r in ready] == [n_rows] * 2
    assert not any(r["device"]["degraded"] for r in ready) and not any(b["degraded"] for b in got)
    assert sum(r["device"]["launches"]["fused_topk"] for r in ready) > 0
    # Each replica mints its own ids, so the check is on what minting
    # leaves alone: the action, the types and the scores, rank by rank.
    for body, ref in zip(got, want):
        assert body["action"] == ref.action
        assert [x["failure_type"] for x in body["references"]] == [x.failure_type for x in ref.references]
        assert [x["score"] for x in body["references"]] == pytest.approx(
            [x.score for x in ref.references], abs=1e-4)
        assert body["confidence"] == pytest.approx(ref.confidence, abs=1e-4)
