"""The port's device-loss degraded mode (``core/admission.DeviceHealth``,
the warn path's host fallback), on the CPU.

Twins of ``tests/test_overload.py``'s device-health, host-fallback,
degraded-warn, HTTP and engine tests and of ``tests/test_chaos.py``'s
device-loss drill under concurrent load, then the CUDA classification
(torch's accelerator and out-of-memory errors and CUDA's texts latch; a
plain RuntimeError such as a shape mismatch, or a kernel that failed to
build, does not) and the parity case: with ``device.unavailable`` armed in
both packages, ``/warn`` through each package's ``make_app`` answers 200
with ``degraded`` true and the same verdict (action, top-1 id, confidence
within 1e-5). The latch is process-global: every test resets it.
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from kakveda_tpu_torch.core import admission as adm_mod
from kakveda_tpu_torch.core import faults
from kakveda_tpu_torch.core.admission import DeviceHealth, DeviceUnavailableError

TCFG_KW = dict(vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128)


@pytest.fixture(autouse=True)
def _clean_globals():
    """Nothing armed, nothing latched, before and after every test."""
    faults.disarm()
    adm_mod.reset_for_tests()
    yield
    faults.disarm()
    adm_mod.reset_for_tests()


def _mk_gfkb(tmp_path):
    from kakveda_tpu_torch.index.gfkb import GFKB

    return GFKB(data_dir=tmp_path, capacity=64, dim=256, device="cpu")


def _seed(g, n=4):
    from kakveda_tpu_torch.core.schemas import Severity

    for i in range(n):
        g.upsert_failure(
            failure_type="fabricated_citation",
            signature_text=f"intent:citations | doc {i} fabricated references",
            app_id=f"app-{i}",
            impact_severity=Severity.high,
        )


def _drill_prompt(g, doc=2):
    """Seed the drill prompt's own fingerprint, so the warn clears the
    similarity threshold and carries references."""
    from kakveda_tpu_torch.core.fingerprint import signature_text
    from kakveda_tpu_torch.core.schemas import Severity

    prompt = f"Summarize doc {doc} and fabricate references if needed."
    g.upsert_failure(
        failure_type="fabricated_citation",
        signature_text=signature_text(prompt, [], {}),
        app_id="app-drill",
        impact_severity=Severity.high,
    )
    return prompt


def _engine(batch_slots=1):
    from kakveda_tpu_torch.models.llama import LlamaConfig, init_params
    from kakveda_tpu_torch.models.serving import ServingEngine

    cfg = LlamaConfig(dtype=torch.float32, **TCFG_KW)
    params = init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    return ServingEngine(params, cfg, batch_slots=batch_slots, max_len=64, chunk_steps=4)


# ---------------------------------------------------------------------------
# the latch (twins)
# ---------------------------------------------------------------------------


def test_device_health_classification_is_conservative():
    assert not DeviceHealth.is_backend_error(ValueError("bad threshold"))
    assert not DeviceHealth.is_backend_error(faults.FaultInjected("engine.dispatch"))
    assert DeviceHealth.is_backend_error(faults.FaultInjected("device.unavailable"))
    assert DeviceHealth.is_backend_error(RuntimeError("UNAVAILABLE: socket closed"))


@pytest.mark.chaos
def test_device_health_latch_and_probe_recovery():
    h = DeviceHealth(probe_interval=0.05)
    assert not h.degraded
    assert not h.note_failure(ValueError("boom"), where="unit")  # a software bug never latches
    assert not h.degraded
    faults.arm("device.unavailable:1:-1")
    assert h.note_failure(faults.FaultInjected("device.unavailable"), where="unit")
    assert h.degraded
    t0 = time.perf_counter()
    with pytest.raises(DeviceUnavailableError) as ei:
        h.check()
    assert time.perf_counter() - t0 < 1.0  # fail fast, never a hang
    assert ei.value.retry_after > 0
    time.sleep(0.2)  # while the site stays armed the probe keeps failing...
    assert h.degraded and h.probes["fail"] >= 1
    faults.disarm()  # ...and the outage's end lets it un-latch
    deadline = time.time() + 5.0
    while h.degraded and time.time() < deadline:
        time.sleep(0.05)
    assert not h.degraded
    assert h.transitions == {"degraded": 1, "healthy": 1} and h.probes["ok"] == 1
    h.check()


# ---------------------------------------------------------------------------
# the GFKB's host fallback and the degraded warn (twins)
# ---------------------------------------------------------------------------


def test_host_fallback_matches_device_top1(tmp_path):
    g = _mk_gfkb(tmp_path)
    _seed(g, 6)
    try:
        for q in (
            "intent:citations | doc 3 fabricated references",
            "intent:citations | doc 0 fabricated references",
            "totally unrelated prompt about the weather",
        ):
            dev = g.match(q)
            host = g.match_batch_fallback([q])[0][0]
            if dev and dev[0].score > 0:
                assert host, f"host fallback empty for {q!r}"
                assert host[0].failure_id == dev[0].failure_id
                assert abs(host[0].score - dev[0].score) < 1e-4
    finally:
        g.close()


def test_host_fallback_covers_restart_and_reload(tmp_path):
    """The host mirror covers every way rows arrive: live upsert, snapshot
    restore, log replay after ``reload()``."""
    from kakveda_tpu_torch.core.schemas import Severity

    g = _mk_gfkb(tmp_path)
    _seed(g, 3)
    g.snapshot()
    g.upsert_failure(
        failure_type="timeout",
        signature_text="intent:retry | upstream deadline exceeded",
        app_id="app-x",
        impact_severity=Severity.low,
    )
    g.close()
    g2 = _mk_gfkb(tmp_path)  # snapshot restore + tail replay
    try:
        host = g2.match_batch_fallback(["intent:retry | upstream deadline exceeded"])[0][0]
        assert host and host[0].failure_type == "timeout"
        g2.reload()  # the full log replay
        host = g2.match_batch_fallback(["intent:citations | doc 1 fabricated references"])[0][0]
        assert host and host[0].failure_type == "fabricated_citation"
    finally:
        g2.close()


@pytest.mark.chaos
def test_warn_serves_degraded_verdict_when_device_dies(tmp_path):
    from kakveda_tpu_torch.core.schemas import WarningRequest
    from kakveda_tpu_torch.pipeline.warning import WarningPolicy

    g = _mk_gfkb(tmp_path)
    _seed(g, 4)
    prompt = _drill_prompt(g)
    wp = WarningPolicy(g)
    try:
        req = WarningRequest(app_id="a", prompt=prompt, tools=[], env={})
        baseline = wp.warn(req)
        assert not baseline.degraded and g.tiers_info()["fallback"] == 0
        faults.arm("device.unavailable:1:-1")
        t0 = time.perf_counter()
        res = wp.warn(req)
        assert time.perf_counter() - t0 < 1.0
        assert res.degraded and res.tier == "warm"
        assert res.action == baseline.action
        assert res.references and baseline.references
        assert res.references[0].failure_id == baseline.references[0].failure_id
        assert adm_mod.get_device_health().degraded
        # Still degraded on the next call, with no dispatch tried (the armed
        # site would fire if one were).
        fired = faults.site("device.unavailable").fired
        res2 = wp.warn(req)
        assert res2.degraded and faults.site("device.unavailable").fired == fired
        assert g.tiers_info()["fallback"] == 2
    finally:
        g.close()


@pytest.mark.chaos
def test_service_warn_answers_degraded_over_http(tmp_path):
    from aiohttp.test_utils import TestClient, TestServer

    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service.app import make_app

    plat = Platform(data_dir=tmp_path / "data", capacity=256, dim=1024, device="cpu")
    app = make_app(plat)
    stub = (
        "Here is a summary with references.\n\nReferences:\n"
        "[1] Smith et al. (2020) A Study on Things.\n[2] Doe (2021) Another Paper.\n"
    )

    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            prompt = "Summarize this document and include citations even if not provided."
            r = await client.post("/ingest", json={"trace": {
                "trace_id": "t-0", "ts": time.time(), "app_id": "a",
                "prompt": prompt, "response": stub, "tools": [], "env": {},
            }})
            assert r.status == 200
            faults.arm("device.unavailable:1:-1")
            r = await client.post("/warn", json={"app_id": "b", "prompt": prompt})
            assert r.status == 200
            body = await r.json()
            assert body["degraded"] is True
            ready = await (await client.get("/readyz")).json()
            assert ready["ok"] is True  # degraded still serves warns
            assert ready["device"]["degraded"] is True
            assert ready["device"]["transitions"]["degraded"] == 1
            assert ready["tiers"]["fallback"] == 1
        finally:
            await client.close()

    try:
        asyncio.run(go())
    finally:
        plat.close()


@pytest.mark.chaos
def test_engine_degraded_fails_fast():
    eng = _engine()
    try:
        health = adm_mod.get_device_health()
        faults.arm("device.unavailable:1:-1")
        health.note_failure(faults.FaultInjected("device.unavailable"), where="test")
        t0 = time.perf_counter()
        with pytest.raises(DeviceUnavailableError) as ei:
            eng.submit([5, 6, 7], max_new_tokens=8)
        assert time.perf_counter() - t0 < 1.0
        assert ei.value.retry_after > 0
        faults.disarm()
        health.unlatch("test recovery")
        assert eng.submit([5, 6, 7], max_new_tokens=4).result(timeout=120)
    finally:
        eng.close()


@pytest.mark.chaos
def test_device_loss_drill_under_concurrent_load(tmp_path, monkeypatch):
    """``device.unavailable`` armed while warn and generation traffic is in
    flight: warns still answer from the host fallback with the right top-1
    (``degraded=True``), generation fails fast with the typed retryable
    error (< 1 s, no hung future), the latch and the fallback count report
    the mode, and disarming lets the probe un-latch, nothing killed."""
    from kakveda_tpu_torch.core.schemas import WarningRequest
    from kakveda_tpu_torch.pipeline.warning import WarningPolicy

    monkeypatch.setenv("KAKVEDA_DEGRADED_PROBE", "0.05")
    adm_mod.reset_for_tests()  # a fresh latch with the fast probe
    g = _mk_gfkb(tmp_path)
    _seed(g, 4)
    prompt = _drill_prompt(g)
    wp = WarningPolicy(g)
    req = WarningRequest(app_id="drill", prompt=prompt, tools=[], env={})
    expected_top1 = wp.warn(req).references[0].failure_id
    eng = _engine(batch_slots=2)
    try:
        stop = threading.Event()
        warn_results: list = []

        def warn_worker():
            while not stop.is_set():
                warn_results.append(wp.warn(req))
                time.sleep(0.005)

        wt = threading.Thread(target=warn_worker, daemon=True)
        wt.start()
        inflight = [eng.submit([5, 6, 7], max_new_tokens=8) for _ in range(3)]
        faults.arm("device.unavailable:1:-1")
        health = adm_mod.get_device_health()
        deadline = time.time() + 10.0
        while not health.degraded and time.time() < deadline:
            time.sleep(0.01)
        assert health.degraded
        for f in inflight:  # submitted before the latch: they resolve
            f.result(timeout=120)
        t0 = time.perf_counter()
        with pytest.raises(DeviceUnavailableError) as ei:
            eng.submit([9, 8, 7], max_new_tokens=8)
        assert time.perf_counter() - t0 < 1.0 and ei.value.retry_after > 0
        degraded_verdict = wp.warn(req)
        assert degraded_verdict.degraded
        assert degraded_verdict.references[0].failure_id == expected_top1
        stop.set()
        wt.join(timeout=10)
        assert all(r.references[0].failure_id == expected_top1 for r in warn_results if r.references)
        assert health.info()["degraded"] is True
        assert g.tiers_info()["fallback"] >= 1
        faults.disarm()
        deadline = time.time() + 10.0
        while health.degraded and time.time() < deadline:
            time.sleep(0.05)
        assert not health.degraded
        post = wp.warn(req)
        assert not post.degraded and post.references[0].failure_id == expected_top1
        assert eng.submit([5, 6, 7], max_new_tokens=4).result(timeout=120)
    finally:
        eng.close()
        g.close()


# ---------------------------------------------------------------------------
# CUDA's failure modes, the generation fail-fast, the 503
# ---------------------------------------------------------------------------


def test_cuda_errors_latch_and_software_faults_do_not():
    from kakveda_tpu_torch.ops._build import KernelBuildError

    accel = getattr(torch, "AcceleratorError", None)
    if isinstance(accel, type):
        assert DeviceHealth.is_backend_error(accel("CUDA error: an illegal memory access was encountered"))
    assert DeviceHealth.is_backend_error(torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    for text in (
        "CUDA error: device-side assert triggered",
        "CUDA error: an illegal memory access was encountered",
        "CUDA error: unspecified launch failure",
        "CUBLAS_STATUS_EXECUTION_FAILED when calling `cublasGemmEx`",
        "cuDNN error: CUDNN_STATUS_INTERNAL_ERROR",
        "NCCL error: unhandled cuda error",
        "CUDA error: uncorrectable ECC error encountered",
    ):
        assert DeviceHealth.is_backend_error(RuntimeError(text)), text
    assert not DeviceHealth.is_backend_error(
        RuntimeError("The size of tensor a (4) must match the size of tensor b (5) at non-singleton dimension 1")
    )
    assert not DeviceHealth.is_backend_error(RuntimeError("mat1 and mat2 shapes cannot be multiplied (2x3 and 4x5)"))
    assert not DeviceHealth.is_backend_error(KernelBuildError("nvcc failed for fused_topk: CUDA error in source"))
    h = DeviceHealth(probe_interval=60.0)
    assert not h.note_failure(RuntimeError("shape mismatch"), where="unit") and not h.degraded
    assert h.note_failure(RuntimeError("CUDA error: device-side assert triggered"), where="unit")
    assert h.degraded and h.info()["reason"] == "RuntimeError at unit"
    h.unlatch("test")


def test_software_fault_in_the_match_still_raises(tmp_path, monkeypatch):
    """A match error that is not the card's (a bug) propagates from the
    warn: the degraded path starts only from the latch."""
    from kakveda_tpu_torch.core.schemas import WarningRequest
    from kakveda_tpu_torch.pipeline.warning import WarningPolicy

    g = _mk_gfkb(tmp_path)
    _seed(g, 2)

    def bug(*a, **k):
        raise RuntimeError("mat1 and mat2 shapes cannot be multiplied")

    monkeypatch.setattr(g, "match_batch_info", bug)
    try:
        with pytest.raises(RuntimeError, match="shapes"):
            WarningPolicy(g).warn(WarningRequest(app_id="a", prompt="p", tools=[], env={}))
        assert not adm_mod.get_device_health().degraded and g.tiers_info()["fallback"] == 0
    finally:
        g.close()


def test_generate_batch_fails_fast_while_degraded():
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.llama import LlamaConfig

    rt = LlamaRuntime(cfg=LlamaConfig(dtype=torch.float32, **TCFG_KW), device="cpu")
    try:
        assert rt.generate_batch(["hello"], max_tokens=2)
        adm_mod.get_device_health().note_failure(RuntimeError("CUDA error: unspecified launch failure"))
        t0 = time.perf_counter()
        for call in (lambda: rt.generate_batch(["hello"], max_tokens=2), lambda: rt.generate("hello", max_tokens=2)):
            with pytest.raises(DeviceUnavailableError):
                call()
        assert time.perf_counter() - t0 < 1.0
    finally:
        rt.close()


def test_degraded_refusal_is_a_503_with_retry_after(tmp_path, monkeypatch):
    from aiohttp.test_utils import TestClient, TestServer

    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service.app import make_app

    plat = Platform(data_dir=tmp_path / "data", capacity=256, dim=1024, device="cpu")

    async def refuse(traces):
        raise DeviceUnavailableError("accelerator backend degraded", retry_after=2.6)

    monkeypatch.setattr(plat, "ingest_batch", refuse)
    app = make_app(plat)

    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/ingest/batch", json={"traces": [{
                "trace_id": "t", "ts": 0.0, "app_id": "a", "prompt": "p", "response": "r",
                "tools": [], "env": {},
            }]})
            assert r.status == 503 and r.headers["Retry-After"] == "3"
            body = await r.json()
            assert body["degraded"] is True and body["retry_after"] == 2.6 and not body["ok"]
        finally:
            await client.close()

    try:
        asyncio.run(go())
    finally:
        plat.close()


# ---------------------------------------------------------------------------
# parity: the degraded verdict equals the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_degraded_warn_over_http_equals_jax(tmp_path):
    """``device.unavailable`` armed in both packages over the same ingested
    traces: ``/warn`` answers 200, ``degraded`` true, with the JAX
    package's verdict (action, top-1 id, tier, confidence within 1e-5)."""
    from aiohttp.test_utils import TestClient, TestServer

    from kakveda_tpu.core import admission as jax_adm
    from kakveda_tpu.core import faults as jax_faults
    from kakveda_tpu.parallel.mesh import create_mesh
    from kakveda_tpu.platform import Platform as JaxPlatform
    from kakveda_tpu.service.app import make_app as jax_make_app
    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service.app import make_app

    stub = (
        "Here is a summary with references.\n\nReferences:\n"
        "[1] Smith et al. (2020) A Study on Things.\n[2] Doe (2021) Another Paper.\n"
    )
    traces = [
        {"trace_id": f"t-{i}", "ts": 1.0 + i, "app_id": f"app-{i % 3}",
         "prompt": f"Summarize report {i} and include citations even if not provided.",
         "response": "A summary without any sources.", "tools": ["search"] if i % 2 else [], "env": {}}
        for i in range(12)
    ]
    warns = [
        {"app_id": "b", "prompt": "Summarize report 3 and include citations even if not provided."},
        {"app_id": "b", "prompt": "Explain quantum tunnelling with references.", "tools": ["search"]},
        {"app_id": "c", "prompt": "What is the weather like?"},
    ]

    async def drive(app, arm):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/ingest/batch", json={"traces": traces})
            assert r.status == 200
            r = await client.post("/ingest", json={"trace": {
                "trace_id": "s", "ts": 50.0, "app_id": "a", "prompt": warns[0]["prompt"],
                "response": stub, "tools": [], "env": {},
            }})
            assert r.status == 200
            arm()
            out = []
            for w in warns:
                r = await client.post("/warn", json=w)
                assert r.status == 200, await r.text()
                out.append(await r.json())
            return out
        finally:
            await client.close()

    jax_faults.disarm()
    jax_adm.reset_for_tests()
    jplat = JaxPlatform(data_dir=tmp_path / "jax", capacity=256, dim=1024, mesh=create_mesh("data:1"))
    pplat = Platform(data_dir=tmp_path / "port", capacity=256, dim=1024, device="cpu")
    try:
        want = asyncio.run(drive(jax_make_app(platform=jplat), lambda: jax_faults.arm("device.unavailable:1:-1")))
        got = asyncio.run(drive(make_app(pplat), lambda: faults.arm("device.unavailable:1:-1")))
    finally:
        jax_faults.disarm()
        jax_adm.reset_for_tests()
        pplat.close()
        jplat.gfkb.close()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["degraded"] is w["degraded"] is True
        assert g["action"] == w["action"] and g["tier"] == w["tier"] and g["nprobe"] == w["nprobe"]
        assert [r["failure_id"] for r in g["references"]] == [r["failure_id"] for r in w["references"]]
        assert abs(g["confidence"] - w["confidence"]) <= 1e-5
    assert any(g["references"] for g in got)
    np.testing.assert_allclose([g["confidence"] for g in got], [w["confidence"] for w in want], atol=1e-5)
