"""The port's causal tracer (``kakveda_tpu_torch/core/trace.py``) against the
JAX package's, on the CPU.

Same inputs to both: a fixed list of ``traceparent`` headers, 10,000 trace
ids drawn from a seeded numpy generator, one script of spans. Span ids,
start times and durations are random or wall-clock in both packages, so
the trees are compared with those masked: names, parent links (by name),
outcomes and attributes. The armed ``trace.record`` case runs one /warn
through each package's app.
"""

import asyncio
import re

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from kakveda_tpu.core import admission as jax_admission
from kakveda_tpu.core import faults as jax_faults
from kakveda_tpu.core import trace as jax_trace
from kakveda_tpu.parallel.mesh import create_mesh
from kakveda_tpu.platform import Platform as JaxPlatform
from kakveda_tpu.service.app import make_app as jax_make_app
from kakveda_tpu_torch.core import admission as port_admission
from kakveda_tpu_torch.core import faults as port_faults
from kakveda_tpu_torch.core import trace as port_trace
from kakveda_tpu_torch.platform import Platform
from kakveda_tpu_torch.service.app import make_app

PACKAGES = {"jax": jax_trace, "port": port_trace}

HEADERS = [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-00",
    "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-01",  # upper case
    " 00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01 ",
    "01-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-03-extra",  # future version
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",  # forbidden version
    "00-" + "0" * 32 + "-b7ad6b7169203331-01",  # all-zero trace id
    "00-0af7651916cd43dd8448eb211c80319c-" + "0" * 16 + "-01",  # all-zero span id
    "00-0af7651916cd43dd8448eb211c80319-b7ad6b7169203331-01",  # 31-hex trace id
    "00-0af7651916cd43dd8448eb211c80319cc-b7ad6b7169203331-01",  # 33-hex trace id
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b716920333-01",  # 15-hex span id
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-zz",  # bad flags
    "0-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",  # short version
    "00-0gf7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",  # non-hex
    "00-0af7651916cd43dd8448eb211c80319c",
    "",
    "garbage",
    None,
    17,
]


@pytest.fixture(autouse=True)
def _clean():
    for m in PACKAGES.values():
        m.get_tracer().reset()
    yield
    for m in PACKAGES.values():
        m.get_tracer().reset()
    jax_faults.disarm()
    port_faults.disarm()
    jax_admission.reset_for_tests()
    port_admission.reset_for_tests()


@pytest.mark.parametrize("header", HEADERS, ids=[repr(h)[:40] for h in HEADERS])
def test_traceparent_parse_and_format_match_jax(header):
    port, ref = port_trace.parse_traceparent(header), jax_trace.parse_traceparent(header)
    assert port == ref
    if ref is not None:
        assert port_trace.format_traceparent(*port) == jax_trace.format_traceparent(*ref)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_sample_decision_matches_jax_over_seeded_ids(rate):
    rng = np.random.default_rng(5)
    ids = ["".join(f"{b:02x}" for b in rng.integers(0, 256, 16)) for _ in range(10_000)]
    port = port_trace.Tracer(capacity=0, sample=rate)
    ref = jax_trace.Tracer(capacity=0, sample=rate)
    got = [port.sample_decision(t) for t in ids]
    assert got == [ref.sample_decision(t) for t in ids]
    assert abs(sum(got) / len(got) - rate) < 0.02


def _span_script(m):
    """One script of spans: nested roots, a sampled-out trace whose error
    still records, a record_completed child under a wire parent, a span
    never ended (an orphan), and enough spans to wrap a ring of 8."""
    tr = m.Tracer(capacity=8, sample=0.5)
    kept = "0" * 7 + "1" + "a" * 24  # sampled at 0.5 (first 8 hex small)
    dropped = "f" * 32  # sampled out at 0.5
    with tr.start_span("root", trace_id=kept, app="a") as root:
        with tr.start_span("mid", n=2):
            tr.start_span("leaf").end("ok", k=1)
        tr.record_completed("serving.request", traceparent=root.traceparent(),
                            dur_ms=12.5, tokens=4, engine="e0")
    with tr.start_span("quiet", trace_id=dropped):
        tr.start_span("inner").end("ok")
    tr.start_span("bad", trace_id=dropped).end("error", why="x")
    tr.start_span("never-ended", trace_id=kept)
    for i in range(6):
        tr.start_span(f"fill{i}", trace_id=kept).end("shed" if i % 2 else "ok")
    spans = tr.dump()
    names = {s["span_id"]: s["name"] for s in spans}
    masked = [
        (s["name"], names.get(s["parent_id"]), s["trace_id"], s["outcome"], s["attrs"],
         s["dur_ms"] if s["name"] == "serving.request" else None)
        for s in spans
    ]
    return masked, tr.plane(), spans, kept


def test_ring_bound_and_orphan_counts_match_jax():
    port, port_plane, _, _ = _span_script(port_trace)
    ref, ref_plane, _, _ = _span_script(jax_trace)
    assert port == ref
    assert port_plane == ref_plane
    assert port_plane["orphaned"] == 1 and port_plane["ring"] == 8 and port_plane["dropped"] > 0


def _mask_render(text):
    text = re.sub(r"\d+\.\d+ms", "Tms", text)
    return text


def test_assemble_tree_and_render_match_jax():
    """The same span dicts through both packages' ``assemble_tree`` and
    ``render_trace`` give the same trees and text; then each package's own
    script gives the same text once ids and durations are masked."""
    _, _, spans, kept = _span_script(jax_trace)
    one = [s for s in spans if s["trace_id"] == kept]
    assert port_trace.assemble_tree(one + one) == jax_trace.assemble_tree(one + one)
    assert port_trace.render_trace(one) == jax_trace.render_trace(one)
    assert port_trace.render_trace([]) == jax_trace.render_trace([]) == "(no spans)"

    def ordered(m):
        tr = m.Tracer(capacity=16, sample=1.0)
        with tr.start_span("root", trace_id=kept, app="a") as root:
            root.ts = 1.0
            with tr.start_span("mid", n=2) as mid:
                mid.ts = 2.0
                leaf = tr.start_span("leaf")
                leaf.ts = 3.0
                leaf.end("ok")
        return _mask_render(m.render_trace(tr.dump(kept)))

    assert ordered(port_trace) == ordered(jax_trace)


def _jax_platform(path):
    return JaxPlatform(data_dir=path, mesh=create_mesh("data:1"), capacity=256, dim=1024)


def _port_platform(path):
    return Platform(data_dir=path, capacity=256, dim=1024, device="cpu")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_armed_trace_record_fails_no_warn(tmp_path, pkg):
    faults = {"port": port_faults, "jax": jax_faults}[pkg]
    tracer = PACKAGES[pkg].get_tracer()
    plat = (_port_platform if pkg == "port" else _jax_platform)(tmp_path / pkg)
    app = (make_app if pkg == "port" else jax_make_app)(plat)

    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            faults.arm("trace.record:1.0:-1")
            statuses = []
            for i in range(4):
                r = await client.post("/warn", json={"app_id": f"app-{i}", "prompt": "hello world"})
                statuses.append((r.status, "action" in await r.json()))
            return statuses
        finally:
            faults.disarm()
            await client.close()

    assert asyncio.run(go()) == [(200, True)] * 4
    plane = tracer.plane()
    assert plane["dropped"] >= 8 and plane["orphaned"] == 0 and plane["ring"] == 0
    getattr(plat, "close", lambda: None)()
