"""The port's device profiler (``kakveda_tpu_torch/core/profiling.py``)
against the JAX package's ``core/profiling.py``: ``annotate`` re-raises the
enclosed work's exception unchanged and observes
``kakveda_device_block_seconds{name}`` as the reference does (the same
family, HELP, type and label names on ``/metrics``); ``profile(logdir)``
writes a Chrome trace whose events carry the reference's annotation names
around the GFKB's match and the runtime's generate; ``KAKVEDA_PROFILE_DIR``
makes the service write one at startup."""

import asyncio
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from kakveda_tpu.core import metrics as jm
from kakveda_tpu.core import profiling as jprof
from kakveda_tpu_torch.core import metrics as m
from kakveda_tpu_torch.core import profiling

REPO = Path(__file__).resolve().parent.parent
FABRICATED = "Here is a summary.\n\nReferences:\n[1] Smith et al. (2020) A Study on Things."


def _seed(plat, n=2):
    """``n`` traces the rule classifier records as failures (citations the
    prompt gave no sources for), so that a warn dispatches a match."""
    from datetime import datetime, timezone

    from kakveda_tpu_torch.core.schemas import TracePayload

    traces = [TracePayload(trace_id=f"t-{i}", ts=datetime.now(timezone.utc), app_id="app-A",
                           prompt=f"Summarize article {i} with citations", response=FABRICATED)
              for i in range(n)]
    asyncio.run(plat.ingest_batch(traces))
    assert plat.gfkb.count == n


class Boom(Exception):
    pass


@pytest.mark.parametrize("mod", [profiling, jprof], ids=["port", "jax"])
def test_annotate_reraises_the_enclosed_exception_unchanged(mod):
    err = Boom("from the enclosed work")
    with pytest.raises(Boom) as got:
        with mod.annotate("unit.raise"):
            raise err
    assert got.value is err


def test_annotate_is_transparent():
    with profiling.annotate("unit.test"):
        x = torch.arange(4).sum().item()
    assert x == 6


def _family(reg, name):
    fam = reg._families[name]
    return fam.kind, fam.labelnames, fam.help


def _series(text, name):
    """The ``name{...}`` sample lines of a render, values masked."""
    return sorted(re.sub(r" \S+$", "", ln) for ln in text.splitlines()
                  if ln.startswith(name) and 'name="unit.metrics"' in ln)


def test_device_block_lands_on_metrics_as_in_the_jax_package():
    for mod in (profiling, jprof):
        with mod.annotate("unit.metrics"):
            pass
    assert _family(m.get_registry(), "kakveda_device_block_seconds") == _family(
        jm.get_registry(), "kakveda_device_block_seconds")
    port, ref = m.get_registry().render(), jm.get_registry().render()
    assert _series(port, "kakveda_device_block_seconds") == _series(ref, "kakveda_device_block_seconds")
    assert 'kakveda_device_block_seconds_count{name="unit.metrics"}' in port


def test_warn_through_the_service_reports_its_match_block(tmp_path):
    """A warn through the port's ``make_app`` runs the annotated GFKB match:
    ``GET /metrics`` carries its ``gfkb.match.dispatch`` and
    ``gfkb.match.fetch`` blocks, and an ingest its ``gfkb.insert``."""
    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service.app import make_app

    plat = Platform(data_dir=tmp_path / "data", capacity=256, dim=1024, device="cpu")
    trace = {"trace_id": "t-1", "ts": "2026-01-01T00:00:00+00:00", "app_id": "app-A",
             "prompt": "Summarize the article with citations", "response": FABRICATED}
    warn = {"app_id": "app-A", "prompt": "Summarize the article with citations", "tools": [], "env": {}}

    async def go():
        client = TestClient(TestServer(make_app(plat)))
        await client.start_server()
        try:
            assert (await client.post("/ingest", json={"trace": trace})).status == 200
            assert (await client.post("/warn", json=warn)).status == 200
            return await (await client.get("/metrics")).text()
        finally:
            await client.close()

    try:
        text = asyncio.run(go())
    finally:
        plat.close()
    for name in ("gfkb.match.dispatch", "gfkb.match.fetch", "gfkb.insert"):
        assert f'kakveda_device_block_seconds_count{{name="{name}"}}' in text, name


def _trace_names(logdir):
    files = list(Path(logdir).glob("*.json"))
    assert len(files) == 1, files
    events = json.loads(files[0].read_text())["traceEvents"]
    return {e.get("name") for e in events}


@pytest.mark.parametrize("continuous", ["1", "0"])
def test_profile_writes_a_trace_with_the_annotation_names(tmp_path, monkeypatch, continuous):
    """``profile`` around a warn batch and a ``generate_batch`` on the CPU:
    the Chrome trace holds the GFKB's and the runtime's ranges, the engine's
    wait (``llama.generate_batch_online``) or the solo path's
    (``llama.generate_batch``)."""
    from kakveda_tpu_torch.core.schemas import WarningRequest
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.llama import LlamaConfig
    from kakveda_tpu_torch.platform import Platform

    monkeypatch.setenv("KAKVEDA_SERVE_CONTINUOUS", continuous)
    plat = Platform(data_dir=tmp_path / "data", capacity=256, dim=1024, device="cpu")
    rt = LlamaRuntime(cfg=LlamaConfig(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, dtype=torch.float32),
                      device="cpu")
    req = WarningRequest(app_id="app-A", prompt="Summarize article 1 with citations", tools=[], env={})
    try:
        _seed(plat)
        plat.warn(req)
        with profiling.profile(tmp_path / "trace"):
            plat.warn_batch([req] * 4)
            rt.generate_batch(["hello", "world"], max_tokens=4)
    finally:
        rt.close()
        plat.close()
    names = _trace_names(tmp_path / "trace")
    gen = "llama.generate_batch_online" if continuous == "1" else "llama.generate_batch"
    for name in ("gfkb.match.dispatch", "gfkb.match.fetch", gen):
        assert name in names, name


def test_profile_survives_a_bad_logdir():
    with profiling.profile("/proc/definitely/not/writable"):
        pass  # must not raise


def test_startup_profile_dir_reads_the_env(monkeypatch):
    monkeypatch.delenv("KAKVEDA_PROFILE_DIR", raising=False)
    assert profiling.startup_profile_dir() is None
    monkeypatch.setenv("KAKVEDA_PROFILE_DIR", "/tmp/x")
    assert profiling.startup_profile_dir() == "/tmp/x"


def test_service_writes_a_trace_at_startup(tmp_path):
    """``KAKVEDA_PROFILE_DIR`` makes ``python -m kakveda_tpu_torch.service``
    trace one warm warn before it listens: the trace holds the match's
    ranges, and the service then serves and exits 0 on SIGINT."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logdir = tmp_path / "profile"
    from kakveda_tpu_torch.platform import Platform

    plat = Platform(data_dir=tmp_path / "data", capacity=1024, dim=2048, device="cpu")
    try:
        _seed(plat)
    finally:
        plat.close()
    env = dict(os.environ, KAKVEDA_PROFILE_DIR=str(logdir), KAKVEDA_INDEX_CAPACITY="1024",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "kakveda_tpu_torch.service", "--device", "cpu", "--port", str(port),
         "--data-dir", str(tmp_path / "data")],
        cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.time() + 120
        up = False
        while time.time() < deadline and proc.poll() is None:
            try:
                with socket.create_connection(("127.0.0.1", port), timeout=1):
                    up = True
                    break
            except OSError:
                time.sleep(0.2)
        assert up, "the service did not listen"
        names = _trace_names(logdir)  # written before the listener opened
        assert "gfkb.match.dispatch" in names and "gfkb.match.fetch" in names
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    assert rc == 0
