"""The port's CUDA kernel and its card path, held to the plain versions.

Marked ``cuda``: these need an NVIDIA card and ``nvcc``, and skip with a
reason elsewhere. On the card (no JAX there, so without the repo's
conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: scores within 1e-4 of ``fused_topk_reference`` (bf16 inputs,
f32 sums in another order); ids identical on these inputs, whose separated
scores and exact duplicate rows leave no near-ties.
"""

import asyncio
from datetime import datetime, timezone

import pytest
import torch

from kakveda_tpu_torch.ops.fused_topk import fused_topk, fused_topk_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _unit(x):
    return x / x.norm(dim=-1, keepdim=True)


def _check(emb, valid, q, k):
    v, i = fused_topk(emb, valid, q, k)
    torch.cuda.synchronize()
    rv, ri = fused_topk_reference(emb, valid, q, k)
    assert (v - rv).abs().max().item() < 1e-4
    assert torch.equal(i, ri), (i[0].tolist(), ri[0].tolist())
    return i


@pytest.mark.parametrize(
    "rows,dim,b,k,frac",
    [(3000, 128, 3, 5, 0.9), (100, 128, 2, 5, 0.02), (5, 64, 1, 8, 0.9),
     (1500, 256, 17, 5, 0.5), (70000, 512, 100, 7, 0.9), (1030, 192, 64, 3, 0.0),
     (129, 64, 16, 8, 1.0)],
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


def test_kernel_duplicate_rows_tie_to_lowest_id(gen):
    base = _unit(torch.randn(64, 256, device="cuda", generator=gen))
    emb = base.repeat(100, 1).to(torch.bfloat16)
    valid = torch.ones(emb.shape[0], dtype=torch.bool, device="cuda")
    i = _check(emb, valid, emb[:4].float(), 8)
    want = torch.arange(4, device="cuda")[:, None] + 64 * torch.arange(8, device="cuda")[None, :]
    assert torch.equal(i.long(), want)


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
