"""The port's metrics plane (``kakveda_tpu_torch/core/metrics.py``) against
the JAX package's.

Twins of ``tests/test_metrics.py`` (exposition format and escaping,
histogram buckets, get-or-create and shape conflicts, updates while
scraping, the flight recorder's ring and its capacity-0 switch, the
serving engine's lifecycle families and recorder, ``GET /metrics`` and
``GET /flightrecorder`` through the port's ``make_app``): the same
operations through both registries render the same text, byte for byte.
Then the serving families: the pre-registered catalog's names, types,
labels and HELP equal the reference's, and after the same traffic through
both engines their exposition is byte-equal once the values that timing
moves (histogram buckets and sums of walls) are masked.
"""

import asyncio
import json
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from kakveda_tpu.core import metrics as jm
from kakveda_tpu.models.llama import LlamaConfig as JConfig, init_params as jinit
from kakveda_tpu.models.serving import ServingEngine as JEngine
from kakveda_tpu_torch.convert import llama_params_from_jax
from kakveda_tpu_torch.core import metrics as m
from kakveda_tpu_torch.models.llama import LlamaConfig as TConfig
from kakveda_tpu_torch.models.serving import ServingEngine

torch.set_num_threads(2)

JCFG = JConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=128, dtype=jnp.float32,
)
TCFG = TConfig(
    vocab_size=264, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq_len=128, dtype=torch.float32,
)
SERVING = re.compile(r"kakveda_serving_\w+")


@pytest.fixture(scope="module")
def weights():
    jp = jinit(jax.random.PRNGKey(0), JCFG)
    return jp, llama_params_from_jax(jax.tree.map(np.asarray, jp), TCFG, "cpu")


def _both(fn):
    """``fn(module)`` on a private registry of each package; the renders."""
    out = []
    for mod in (m, jm):
        reg = mod.MetricsRegistry(preregister=False)
        fn(mod, reg)
        out.append(reg.render())
    return out


# ---------------------------------------------------------------------------
# exposition format
# ---------------------------------------------------------------------------


def test_counter_gauge_exposition_help_type_and_escaping():
    def ops(mod, reg):
        reg.counter("demo_total", "a counter", ("who",)).labels(who='he said "hi"\\here\nline').inc(3)
        reg.gauge("depth", "a gauge").set(2.5)

    text, ref = _both(ops)
    assert text == ref
    lines = text.splitlines()
    assert "# HELP demo_total a counter" in lines and "# TYPE demo_total counter" in lines
    assert "# TYPE depth gauge" in lines and "depth 2.5" in lines
    assert 'demo_total{who="he said \\"hi\\"\\\\here\\nline"} 3' in lines
    hi, ti = lines.index("# HELP demo_total a counter"), lines.index("# TYPE demo_total counter")
    si = next(i for i, ln in enumerate(lines) if ln.startswith("demo_total{"))
    assert hi < ti < si


def test_histogram_buckets_monotone_inf_and_sum():
    def ops(mod, reg):
        h = reg.histogram("lat_seconds", "latency", (), buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 5.0, 0.05):
            h.observe(v)

    text, ref = _both(ops)
    assert text == ref
    lines = text.splitlines()
    buckets = [ln for ln in lines if ln.startswith("lat_seconds_bucket")]
    assert [ln.split("le=")[1].split("}")[0] for ln in buckets] == ['"0.01"', '"0.1"', '"1"', '"+Inf"']
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in buckets]
    assert counts == sorted(counts) and counts[-1] == 5
    assert "lat_seconds_count 5" in lines
    sum_line = next(ln for ln in lines if ln.startswith("lat_seconds_sum"))
    assert abs(float(sum_line.split(" ")[1]) - 5.605) < 1e-9


def test_registry_get_or_create_and_shape_conflicts():
    for mod in (m, jm):
        reg = mod.MetricsRegistry(preregister=False)
        a = reg.counter("x_total", "x", ("l",))
        assert reg.counter("x_total", "ignored", ("l",)) is a
        with pytest.raises(ValueError):
            reg.gauge("x_total", "x", ("l",))
        with pytest.raises(ValueError):
            reg.counter("x_total", "x", ("other",))
        with pytest.raises(ValueError):
            a.labels(wrong="v")


def test_concurrent_updates_while_scraping():
    """Renders interleaved with updates never raise and never lose counts."""
    reg = m.MetricsRegistry(preregister=False)
    c = reg.counter("hits_total", "h", ("t",))
    h = reg.histogram("obs_seconds", "o", (), buckets=(0.5,))
    n, t = 2000, 4
    children = [c.labels(t=str(i)) for i in range(t)]

    def work(i):
        for _ in range(n):
            children[i].inc()
            h.observe(0.1)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(t)]
    for th in threads:
        th.start()
    for _ in range(50):
        assert "hits_total" in reg.render()
    for th in threads:
        th.join()
    final = reg.render().splitlines()
    assert sum(int(ln.rsplit(" ", 1)[1]) for ln in final if ln.startswith("hits_total{")) == n * t
    assert f"obs_seconds_count {n * t}" in final


def _families(reg, pattern):
    return {
        name: (fam.kind, fam.labelnames, fam.help, getattr(fam, "buckets", None))
        for name, fam in reg._families.items() if pattern.fullmatch(name)
    }


def test_preregistered_catalog_matches_the_reference():
    """A bare scrape names the serving families, and every family the port
    pre-registers has the reference's type, label names, HELP and buckets."""
    text = m.get_registry().render()
    for fam in ("kakveda_serving_ttft_seconds", "kakveda_serving_tokens_per_second",
                "kakveda_serving_spec_gate_state", "kakveda_serving_queue_wait_seconds"):
        assert f"# TYPE {fam} " in text, fam
    port = _families(m.MetricsRegistry(), re.compile(r".*"))
    ref = _families(jm.MetricsRegistry(), re.compile(r".*"))
    assert set(port) <= set(ref)
    assert {k: ref[k] for k in port} == port
    assert _families(m.MetricsRegistry(), SERVING) == _families(jm.MetricsRegistry(), SERVING)
    assert len(_families(m.MetricsRegistry(), SERVING)) == 18


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def _untimed(events):
    return [{k: v for k, v in e.items() if k != "t"} for e in events]


def test_flight_recorder_ring_bound_and_json_roundtrip():
    dumps = []
    for mod in (m, jm):
        fr = mod.FlightRecorder("test/ring", capacity=4)
        for i in range(9):
            fr.record("request", request_id=i, wall_ms=1.5 * i)
        events = fr.dump()
        assert [e["request_id"] for e in events] == [5, 6, 7, 8]
        assert json.loads(json.dumps(events)) == events
        assert json.loads(fr.dump_json())["name"] == "test/ring"
        assert "test/ring" in [r["name"] for r in mod.dump_recorders()]
        dumps.append(_untimed(events))
    assert dumps[0] == dumps[1]


def test_flight_recorder_capacity_zero_disables():
    for mod in (m, jm):
        fr = mod.FlightRecorder("test/off", capacity=0)
        fr.record("request", request_id=1)
        assert fr.dump() == []


# ---------------------------------------------------------------------------
# the serving engine's lifecycle families
# ---------------------------------------------------------------------------

# Histograms whose buckets and sums are walls: only their counts are
# deterministic. The chunk histogram's count is the number of chunks read,
# which the pipelined loop's timing moves too.
TIMED = ("queue_wait_seconds", "prefill_seconds", "ttft_seconds", "request_seconds", "tokens_per_second")


def _masked_serving(text: str, engine: str) -> list:
    out = []
    for ln in text.splitlines():
        name = ln.split(" ")[2] if ln.startswith("#") else re.split(r"[{ ]", ln, 1)[0]
        if not SERVING.fullmatch(re.sub(r"_(bucket|sum|count)$", "", name)):
            continue
        if not ln.startswith("#"):
            if f'engine="{engine}"' not in ln:
                continue
            if "chunk_seconds" in name or (name.endswith(("_bucket", "_sum")) and any(t in name for t in TIMED)):
                ln = ln.rsplit(" ", 1)[0] + " <timed>"
        out.append(ln.replace(f'engine="{engine}"', 'engine="E"'))
    return out


def test_serving_engine_lifecycle_metrics_and_recorder(weights):
    """The same three requests through both engines: the same outputs, the
    same serving exposition once timing is masked (counts of requests,
    tokens, prefix misses, the gate and slot gauges), and one timeline per
    request in the recorder and on the Future."""
    jp, tp = weights
    prompts = [[5, 6, 7], [9, 8], [41, 42, 43]]
    texts, outs, timelines = [], [], []
    for name, Eng, params, cfg, mod in (
        ("port", ServingEngine, tp, TCFG, m), ("jax", JEngine, jp, JCFG, jm),
    ):
        eng = Eng(params, cfg, batch_slots=2, max_len=64, chunk_steps=4, name="metrics-parity")
        try:
            futs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            outs.append([f.result(timeout=120) for f in futs])
            s = eng.stats()
            assert s["completed"] == 3
            s["prefix"]["hits"] = 999
            assert eng.cb.prefix_stats["hits"] == 0  # stats() is a copy
            reqs = [e for e in eng.recorder.dump() if e["kind"] == "request"]
            assert len(reqs) == 3 and eng.recorder.name == "serving/metrics-parity"
            for e in reqs:
                for key in ("request_id", "queue_wait_ms", "ttft_ms", "wall_ms", "tokens", "tokens_per_s"):
                    assert key in e, key
                assert e["tokens"] > 0
            assert futs[0].timeline["tokens"] == len(outs[-1][0])
            timelines.append(sorted(e["tokens"] for e in reqs))
            text = mod.get_registry().render()
            assert 'kakveda_serving_ttft_seconds_count{engine="metrics-parity"} 3' in text
            assert 'kakveda_serving_requests_total{engine="metrics-parity",outcome="completed"} 3' in text
            assert 'kakveda_serving_spec_gate_state{engine="metrics-parity",state="disabled"} 1' in text
            texts.append(_masked_serving(text, "metrics-parity"))
        finally:
            eng.close()
    assert outs[0] == outs[1]
    assert timelines[0] == timelines[1]
    assert len(texts[0]) > 150 and texts[0] == texts[1]


# ---------------------------------------------------------------------------
# HTTP endpoints
# ---------------------------------------------------------------------------


def test_service_metrics_and_flightrecorder_endpoints(tmp_path):
    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service.app import make_app

    plat = Platform(data_dir=tmp_path / "data", capacity=256, dim=1024, device="cpu")
    fr = m.FlightRecorder("serving/endpoint-test")
    fr.record("engine_error", error="RuntimeError: x")

    async def go():
        client = TestClient(TestServer(make_app(plat)))
        await client.start_server()
        try:
            r = await client.get("/metrics")
            f = await client.get("/flightrecorder")
            return r.status, r.headers["Content-Type"], await r.text(), f.status, await f.json()
        finally:
            await client.close()

    try:
        status, ctype, text, fstatus, payload = asyncio.run(go())
    finally:
        plat.close()
    assert status == 200 and ctype == m.PROMETHEUS_CONTENT_TYPE
    for fam, kind in (("kakveda_serving_ttft_seconds", "histogram"),
                      ("kakveda_serving_tokens_per_second", "histogram"),
                      ("kakveda_serving_spec_gate_state", "gauge"),
                      ("kakveda_serving_requests_total", "counter")):
        assert f"# TYPE {fam} {kind}" in text
    assert fstatus == 200 and isinstance(payload["recorders"], list)
    rec = next(r for r in payload["recorders"] if r["name"] == "serving/endpoint-test")
    assert [e["kind"] for e in rec["events"]] == ["engine_error"]


# ---------------------------------------------------------------------------
# fleet federation
# ---------------------------------------------------------------------------


def _replica_renders(mod):
    """Two replicas' expositions: a labelled counter, a gauge, a histogram
    with an exemplar, an unlabelled counter only one of them has."""
    texts = {}
    for rid, k in (("r0", 1), ("r1", 2)):
        reg = mod.MetricsRegistry(preregister=False)
        reg.counter("kakveda_x_total", "x \\ help", ("a",)).labels(a='q"1').inc(k)
        reg.gauge("kakveda_g", "g").set(k / 4)
        reg.histogram("kakveda_h_seconds", "h").observe(0.003 * k, exemplar="ab" * 16)
        if k == 2:
            reg.counter("kakveda_only_r1_total", "only").inc(5)
        texts[rid] = reg.render()
    return texts


def test_parse_prometheus_text_equals_jax():
    for rid, text in _replica_renders(m).items():
        noisy = text + "# a comment\nnot a sample line\nkakveda_bad 1e\n\n"
        assert m.parse_prometheus_text(noisy) == jm.parse_prometheus_text(noisy), rid
    fams = m.parse_prometheus_text(_replica_renders(m)["r1"])
    assert fams["kakveda_h_seconds"]["type"] == "histogram"
    assert {s[0] for s in fams["kakveda_h_seconds"]["samples"]} == {
        "kakveda_h_seconds_bucket", "kakveda_h_seconds_sum", "kakveda_h_seconds_count"}


def test_federate_renders_equals_jax():
    """The same renders federate to the same text in both packages:
    counters and histogram series summed, gauges tagged per replica."""
    port, ref = m.federate_renders(_replica_renders(m)), jm.federate_renders(_replica_renders(jm))
    assert port == ref
    assert 'kakveda_x_total{a="q\\"1"} 3' in port
    assert 'kakveda_g{replica="r0"} 0.25' in port and 'kakveda_g{replica="r1"} 0.5' in port
    assert "kakveda_h_seconds_count 2" in port and "kakveda_only_r1_total 5" in port
