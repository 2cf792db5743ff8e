"""The port's Platform against the JAX Platform on the same trace stream.

Both run on the CPU (the JAX one on a one-device mesh, so its tie order is
the single-device port's), fed identical traces; model responses are the
JAX ``StubRuntime``'s text, passed to both as strings. Failures, patterns
and warn verdicts must be equal; health scores within 1e-9 (the same float
math in the same order) and warn confidences within 1e-5 (f32 top-k scores).
"""

import asyncio
from datetime import datetime, timezone

import pytest

from kakveda_tpu.core.schemas import TracePayload as JaxTrace
from kakveda_tpu.core.schemas import WarningRequest as JaxRequest
from kakveda_tpu.models.runtime import StubRuntime
from kakveda_tpu.parallel.mesh import create_mesh
from kakveda_tpu.platform import Platform as JaxPlatform
from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
from kakveda_tpu_torch.ops.fused_topk import fused_topk
from kakveda_tpu_torch.platform import Platform

RESPONSE = StubRuntime().generate("x").text
TS = datetime(2026, 1, 2, 3, 4, 5, tzinfo=timezone.utc)
SCENARIOS = [
    ("app-A", "Summarize this document and include citations even if not provided."),
    ("app-B", "Explain research paper and add references."),
]


def _trace_fields(i, app_id, prompt, response=RESPONSE):
    return dict(
        trace_id=f"t-{i:05d}", ts=TS, app_id=app_id, agent_id="agent-1", prompt=prompt,
        response=response, model="stub", temperature=0.2, tools=[], env={"os": "linux"},
    )


def _req_fields(app_id, prompt, env=None):
    return dict(app_id=app_id, prompt=prompt, tools=[], env={"os": "linux"} if env is None else env)


@pytest.fixture
def pair(tmp_path):
    jax_p = JaxPlatform(data_dir=tmp_path / "jax", mesh=create_mesh("data:1"), capacity=256, dim=1024)
    port = Platform(data_dir=tmp_path / "port", device="cpu", capacity=256, dim=1024)
    yield jax_p, port
    port.close()
    jax_p.gfkb.close()


def _assert_same_state(jax_p, port, apps=("app-A", "app-B")):
    jf, pf = jax_p.failures(), port.failures()
    assert [(f.failure_id, f.failure_type, f.affected_apps, f.occurrences, f.version, f.signature_text)
            for f in pf] == [
        (f.failure_id, f.failure_type, f.affected_apps, f.occurrences, f.version, f.signature_text)
        for f in jf
    ]
    assert [(p.pattern_id, p.name, p.failure_ids, p.affected_apps, p.description)
            for p in port.patterns_list()] == [
        (p.pattern_id, p.name, p.failure_ids, p.affected_apps, p.description)
        for p in jax_p.patterns_list()
    ]
    assert port.apps() == jax_p.apps()
    for app in apps:
        jh, ph = jax_p.health_history(app), port.health_history(app)
        assert len(jh) == len(ph)
        for a, b in zip(jh, ph):
            for key in ("score", "failure_rate", "recurrent_penalty", "avg_recovery_time_sec"):
                assert b[key] == pytest.approx(a[key], abs=1e-9)
            assert b["notes"]["window_failures"] == a["notes"]["window_failures"]


def _assert_same_verdicts(jr, pr):
    assert len(jr) == len(pr)
    for a, b in zip(jr, pr):
        assert (b.action, b.pattern_id, b.tier) == (a.action, a.pattern_id, a.tier)
        assert b.confidence == pytest.approx(a.confidence, abs=1e-5)
        assert [r.failure_id for r in b.references] == [r.failure_id for r in a.references]


def test_demo_flow_matches_jax(pair):
    jax_p, port = pair
    before = fused_topk.launches

    async def run(plat, Trace, Req):
        verdicts = []
        i = 0
        for app_id, prompt in SCENARIOS:
            verdicts.append(plat.warn(Req(agent_id="agent-1", **_req_fields(app_id, prompt))))
            await plat.ingest(Trace(**_trace_fields(i, app_id, prompt)))
            i += 1
        for j in range(8):
            prompt = "Summarize and add references" if j % 2 == 0 else "Short answer with citations"
            await plat.ingest(Trace(**_trace_fields(i, "app-A", prompt)))
            i += 1
        await plat.ingest(Trace(**_trace_fields(i, "app-A", "What's 2+2?", "4")))  # healthy
        verdicts.append(plat.warn(Req(**_req_fields("app-C", SCENARIOS[0][1]))))
        verdicts.append(plat.warn(Req(**_req_fields("app-C", "Tell me a joke", env={}))))
        return verdicts

    jv = asyncio.run(run(jax_p, JaxTrace, JaxRequest))
    pv = asyncio.run(run(port, TracePayload, WarningRequest))
    _assert_same_state(jax_p, port)
    _assert_same_verdicts(jv, pv)
    assert fused_topk.launches == before  # CPU tensors never launch the kernel

    # What the JAX e2e test asserts, on the port.
    p = port.patterns_list()
    assert len(p) == 1 and p[0].affected_apps == ["app-A", "app-B"]
    pts = port.health_points("app-A")
    assert len(pts) >= 9 and pts[-1].score < pts[0].score and pts[-1].recurrent_penalty > 0
    assert pv[-2].confidence > 0.9 and pv[-2].pattern_id == p[0].pattern_id
    assert pv[-2].references[0].failure_type == "HALLUCINATION_CITATION"


def test_batch_ingest_warn_batch_and_growth_match_jax(pair):
    jax_p, port = pair

    def traces(Trace, lo, hi):
        return [
            Trace(**_trace_fields(i, f"app-{i % 4}", f"Summarize document {i % 300} and include citations"))
            for i in range(lo, hi)
        ]

    def reqs(Req):
        return [Req(**_req_fields("z", f"Summarize document {i} and include citations", env={}))
                for i in (0, 5, 63, 64, 200, 299)] + [
            Req(**_req_fields("z", "Explain quantum physics", env={}))]

    # 64 traces, then past the initial capacity of 256 (growth), then repeats.
    for lo, hi in [(0, 64), (64, 300), (300, 364)]:
        js = asyncio.run(jax_p.ingest_batch(traces(JaxTrace, lo, hi)))
        ps = asyncio.run(port.ingest_batch(traces(TracePayload, lo, hi)))
        assert [s.trace_id for s in ps] == [s.trace_id for s in js]
        if lo == 0:
            _assert_same_verdicts(jax_p.warn_batch(reqs(JaxRequest)[:16]),
                                  port.warn_batch(reqs(WarningRequest)[:16]))
    assert port.gfkb.count == jax_p.gfkb.count == 300
    assert port.gfkb._knn.capacity == 512
    _assert_same_state(jax_p, port, apps=[f"app-{i}" for i in range(4)])
    _assert_same_verdicts(jax_p.warn_batch(reqs(JaxRequest)), port.warn_batch(reqs(WarningRequest)))
    for sig in (port.failures()[7].signature_text, "unrelated text"):
        for ft, mode in [(None, "post"), ("HALLUCINATION_CITATION", "pre"), ("OTHER", "pre")]:
            a = jax_p.gfkb.match(sig, ft, mode)
            b = port.gfkb.match(sig, ft, mode)
            assert [m.failure_id for m in b] == [m.failure_id for m in a]
            assert [m.score for m in b] == pytest.approx([m.score for m in a], abs=1e-5)
    page = port.failures_page(0, 5)
    assert [f.failure_id for f in page] == [f.failure_id for f in jax_p.failures_page(0, 5)]
    assert port.get_failure("F-0007").signature_text == jax_p.get_failure("F-0007").signature_text


def test_mine_matches_jax(pair):
    """Both Platforms ingest one stream; mine() (auto, auto again, full, then
    another threshold) gives equal patterns and equal mode / dirty counts."""
    jax_p, port = pair

    def traces(Trace, lo, hi):
        return [Trace(**_trace_fields(i, f"app-{i % 5}", prompt)) for i, prompt in (
            (i, [f"Summarize document {i % 40} and include citations",
                 f"Explain topic {i % 30} and add references",
                 "What's 2+2?"][i % 3]) for i in range(lo, hi))]

    for lo, hi in [(0, 90), (90, 200)]:
        asyncio.run(jax_p.ingest_batch(traces(JaxTrace, lo, hi)))
        asyncio.run(port.ingest_batch(traces(TracePayload, lo, hi)))
        jax_p.warn_batch([JaxRequest(**_req_fields("z", f"Summarize document {hi} and include citations"))])
        port.warn_batch([WarningRequest(**_req_fields("z", f"Summarize document {hi} and include citations"))])
    runs = [(0.6, "auto"), (0.6, "auto"), (0.6, "full"), (0.5, "auto"), (0.5, "incremental")]
    for thr, mode in runs:
        jp, ji = jax_p.mine(thr, mode)
        pp, pi = port.mine(thr, mode)
        assert [(p.pattern_id, p.name, p.failure_ids, p.affected_apps, p.description) for p in pp] == [
            (p.pattern_id, p.name, p.failure_ids, p.affected_apps, p.description) for p in jp]
        for key in ("mode", "dirty_clusters", "rows", "clusters", "delta_dispatches", "stale"):
            assert pi[key] == ji[key], (thr, mode, key)
    assert ji["mode"] == "incremental" and port.patterns_list()
    _assert_same_state(jax_p, port, apps=[f"app-{i}" for i in range(5)])


def test_capped_stream_differs_from_the_sweep_as_in_jax(tmp_path):
    """The card smoke's phase-4 stream (the demo's rows, then near-identical
    "Summarize report {i}" rows past the k-neighbour cap): the streamed
    partition is not the sweep's, in the JAX package as in the port, and
    both packages' partitions are equal, streamed and swept."""
    jax_p = JaxPlatform(data_dir=tmp_path / "jax", mesh=create_mesh("data:1"), capacity=2048, dim=1024)
    port = Platform(data_dir=tmp_path / "port", device="cpu", capacity=2048, dim=1024)
    labels = []
    for plat, Trace, Request in ((jax_p, JaxTrace, JaxRequest), (port, TracePayload, WarningRequest)):
        n = 0
        for app_id, prompt in SCENARIOS:
            plat.warn(Request(**_req_fields(app_id, prompt)))
            asyncio.run(plat.ingest(Trace(**_trace_fields(n, app_id, prompt))))
            n += 1
        for j in range(8):
            prompt = "Summarize and add references" if j % 2 == 0 else "Short answer with citations"
            asyncio.run(plat.ingest(Trace(**_trace_fields(n + j, "app-A", prompt))))
        stream = [Trace(**_trace_fields(100 + i, f"app-{i % 8}", f"Summarize report {i} and include citations"))
                  for i in range(1024)]
        for lo in (0, 512):
            asyncio.run(plat.ingest_batch(stream[lo : lo + 512]))
        _, info = plat.mine()
        streamed = plat.gfkb._mine.labels()
        plat.mine(mode="full")
        labels.append((streamed, plat.gfkb._mine.labels(), info["mode"], info["evictions"]))
    (js, jf, jmode, jev), (ps, pf, pmode, pev) = labels
    # Eviction counts may differ by a few: f32 scores of near-identical rows,
    # summed in another order, can order a near-tie either way.
    assert jmode == pmode == "incremental" and jev > 0 and pev > 0
    assert (ps == js).all() and (pf == jf).all()
    assert len(set(ps.tolist())) != len(set(pf.tolist()))  # the cap binds in both
    port.close()
    jax_p.gfkb.close()


def test_single_upsert_matches_jax(pair):
    jax_p, port = pair
    from kakveda_tpu.core.schemas import Severity as JaxSeverity
    from kakveda_tpu_torch.core.schemas import Severity

    for gfkb, sev in ((jax_p.gfkb, JaxSeverity), (port.gfkb, Severity)):
        for app in ("app-A", "app-B", "app-A"):
            gfkb.upsert_failure(
                failure_type="TOOL_TIMEOUT", signature_text="tools:search | timeout after 30s",
                app_id=app, impact_severity=sev.high, root_cause="slow tool",
            )
        gfkb.upsert_failure(
            failure_type="TOOL_TIMEOUT", signature_text="tools:calc | overflow",
            app_id="app-C", impact_severity=sev.low, context_signature={"x": 1},
        )
    _assert_same_state(jax_p, port, apps=())
    a, b = jax_p.gfkb.get_failure("F-0001"), port.gfkb.get_failure("F-0001")
    assert (b.version, b.occurrences, b.affected_apps, b.root_cause) == (
        a.version, a.occurrences, a.affected_apps, a.root_cause)
    assert port.gfkb.type_aggregate("TOOL_TIMEOUT") == jax_p.gfkb.type_aggregate("TOOL_TIMEOUT")
    m = port.gfkb.match("tools:search | timeout after 30s")
    assert [x.failure_id for x in m] == [x.failure_id for x in jax_p.gfkb.match(
        "tools:search | timeout after 30s")]


def test_torn_final_line_is_tolerated_and_truncated(tmp_path):
    port = Platform(data_dir=tmp_path, device="cpu", capacity=16, dim=1024)
    asyncio.run(port.ingest(TracePayload(**_trace_fields(0, "app-A", SCENARIOS[0][1]))))
    port.close()
    path = tmp_path / "failures.jsonl"
    good = path.read_bytes()
    path.write_bytes(good + b'{"failure_id": "F-00')  # a crash mid-append
    again = Platform(data_dir=tmp_path, device="cpu", capacity=16, dim=1024)
    assert [f.failure_id for f in again.failures()] == ["F-0001"]
    asyncio.run(again.ingest(TracePayload(**_trace_fields(1, "app-B", SCENARIOS[1][1]))))
    again.close()
    lines = path.read_bytes().splitlines()
    assert path.read_bytes().startswith(good) and len(lines) == 2 and b"F-0002" in lines[1]
    path.write_bytes(b"not json\n" + good)  # corruption with data after it
    with pytest.raises(ValueError, match="corrupt record mid-file"):
        Platform(data_dir=tmp_path, device="cpu", capacity=16, dim=1024)


def test_jax_written_data_dir_replays_in_port(tmp_path):
    d = tmp_path / "data"
    jax_p = JaxPlatform(data_dir=d, mesh=create_mesh("data:1"), capacity=256, dim=1024)

    async def feed():
        for i, (app_id, prompt) in enumerate(SCENARIOS * 2):
            await jax_p.ingest(JaxTrace(**_trace_fields(i, app_id, prompt)))
        await jax_p.ingest_batch([
            JaxTrace(**_trace_fields(10 + i, "app-C", f"Explain topic {i} with references"))
            for i in range(20)
        ])

    asyncio.run(feed())
    jax_p.gfkb.close()
    port = Platform(data_dir=d, device="cpu", capacity=16, dim=1024)
    try:
        _assert_same_state(jax_p, port, apps=())
        assert port.gfkb._knn.capacity == 32  # replay grew past 16 rows
        queries = [SCENARIOS[0][1], SCENARIOS[1][1], "Explain topic 3 with references"]
        jr = jax_p.warn_batch([JaxRequest(**_req_fields("q", p)) for p in queries])
        pr = port.warn_batch([WarningRequest(**_req_fields("q", p)) for p in queries])
        _assert_same_verdicts(jr, pr)
        assert all(r.references for r in pr)
        # The port appends to the same logs in the same format.
        asyncio.run(port.ingest(TracePayload(**_trace_fields(99, "app-D", SCENARIOS[0][1]))))
        port.close()
        again = JaxPlatform(data_dir=d, mesh=create_mesh("data:1"), capacity=256, dim=1024)
        assert [f.affected_apps for f in again.failures()] == [f.affected_apps for f in port.failures()]
        assert again.patterns_list()[0].affected_apps == port.patterns_list()[0].affected_apps
        again.gfkb.close()
    finally:
        port.close()


@pytest.mark.parametrize("model", ["TracePayload", "CanonicalFailureRecord", "PatternEntity",
                                   "WarningResponse", "HealthPoint"])
def test_schema_json_is_byte_identical(model):
    import kakveda_tpu.core.schemas as js
    import kakveda_tpu_torch.core.schemas as ts

    obj = {
        "TracePayload": dict(_trace_fields(3, "app-é", "Prompt ünïcode", "R [1]"), env={"k": [1, 2.5, None]}),
        "CanonicalFailureRecord": dict(
            failure_id="F-0001", version=2, created_at=TS, updated_at=TS, failure_type="X",
            root_cause=None, context_signature={"a": {"b": 1}}, impact_severity="high",
            occurrences=3, affected_apps=["a", "b"], signature_text="intent_tags: | x"),
        "PatternEntity": dict(pattern_id="FP-0001", name="n", created_at=TS, failure_ids=["F-0001"],
                              affected_apps=["a"], description="d"),
        "WarningResponse": dict(action="warn", confidence=0.123456789, references=[dict(
            failure_id="F-0001", version=1, score=0.5, failure_type="X")], message="m", tier="hot"),
        "HealthPoint": dict(ts=TS, app_id="a", score=85.0, failure_rate=0.1, recurrent_penalty=2.5,
                            avg_recovery_time_sec=55.0, notes={"top_failure": None}),
    }[model]
    a = getattr(js, model).model_validate(obj).model_dump_json()
    b = getattr(ts, model).model_validate(obj).model_dump_json()
    assert a == b
