"""The port's operator CLI and agent echo app against the JAX package's, on the CPU.

The cases of ``tests/test_cli.py`` run through both CLIs
(``kakveda_tpu.cli.main`` and ``kakveda_tpu_torch.cli.main``), each on the
same data dir (the same path, wiped and seeded alike before each package's
run), and their standard output and exit codes are compared. What differs by
design, and only that:

* ``version`` names each package and its own version (both ``<name> x.y.z``);
* ``--help`` describes each CLI in its own words (both list the same verbs);
* ``doctor``'s rows about the device: the reference's ``jax``, ``device
  mesh``, ``device compute`` and ``native extension``, the port's ``torch``,
  ``cuda``, ``device compute``, ``kernel build`` and ``native extension``;
  every other row is compared as printed, and the exit code;
* ``doctor``'s ``redis`` row when ``KAKVEDA_REDIS_URL`` is set: both fail it
  with the password redacted (the reference cannot import ``redis``, the port
  has no Redis tier), each with its own reason;
* process ids (``pid N``) in ``up`` / ``down`` output, and the timestamps of
  ``compact``'s posture, are normalised.

The agent echo app's three routes are compared across both
``make_agent_echo_app``.
"""

import asyncio
import http.server
import json
import os
import re
import shutil
import socket
import stat
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer

from kakveda_tpu.cli import main as jax_cli
from kakveda_tpu.cli import wizard as jax_wizard
from kakveda_tpu_torch.cli import main as port_cli
from kakveda_tpu_torch.cli import wizard as port_wizard

ROOT = Path(__file__).resolve().parent.parent
CLIS = {"jax": jax_cli, "port": port_cli}
WIZARDS = {"jax": jax_wizard, "port": port_wizard}
DEVICE_ROWS = {"jax", "device mesh", "device compute", "native extension", "torch", "cuda", "kernel build"}


def _run(pkg, argv, capsys):
    capsys.readouterr()
    rc = CLIS[pkg].main(list(argv))
    cap = capsys.readouterr()
    return rc, cap.out


def _fresh(path: Path, seed=None) -> Path:
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    if seed is not None:
        seed(path)
    return path


def _both(tmp_path, capsys, steps, seed=None):
    """``steps(pkg, root, run)`` in each package on the same path, seeded
    alike; returns ``{pkg: what steps returned}``."""
    root = tmp_path / "proj"
    out = {}
    for pkg in ("jax", "port"):
        _fresh(root, seed)
        out[pkg] = steps(pkg, root, lambda *argv: _run(pkg, argv, capsys))
    return out


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    for k in ("KAKVEDA_REDIS_URL", "KAKVEDA_ENV", "KAKVEDA_MESH_SHAPE", "DASHBOARD_JWT_SECRET",
              "KAKVEDA_GFKB_REPLAY_BUDGET_S"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("KAKVEDA_DATA_DIR", str(tmp_path / "envdata"))


def _doctor_rows(text: str) -> dict:
    rows = {}
    for line in text.splitlines():
        m = re.match(r"\[(ok|FAIL)\] ([^:]+): (.*)", line)
        if m:
            rows[m.group(2)] = (m.group(1), m.group(3))
    return rows


# ---------------------------------------------------------------------------
# the 14 cases of tests/test_cli.py, each through both CLIs
# ---------------------------------------------------------------------------


def case_help_lists_verbs(tmp_path, capsys, monkeypatch):
    verbs = {}
    for pkg in ("jax", "port"):
        parser = CLIS[pkg].build_parser()
        with pytest.raises(SystemExit) as ei:
            parser.parse_args(["--help"])
        assert ei.value.code == 0
        out = capsys.readouterr().out
        for verb in ("init", "up", "down", "status", "reset", "logs", "doctor", "version"):
            assert verb in out
        sub = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
        verbs[pkg] = sorted(sub.choices)
    return verbs


def case_no_command_errors(tmp_path, capsys, monkeypatch):
    codes = {}
    for pkg in ("jax", "port"):
        with pytest.raises(SystemExit) as ei:
            CLIS[pkg].build_parser().parse_args([])
        codes[pkg] = ei.value.code
    capsys.readouterr()
    assert codes == {"jax": 2, "port": 2}
    return codes


def case_version(tmp_path, capsys, monkeypatch):
    out = {}
    for pkg in ("jax", "port"):
        rc, text = _run(pkg, ["version"], capsys)
        m = re.fullmatch(r"(kakveda-tpu(-torch)?) (\d+\.\d+\.\d+)\n", text)
        assert rc == 0 and m
        out[pkg] = (rc, "kakveda-tpu" in text)
    return out


def case_init_and_status_and_reset(tmp_path, capsys, monkeypatch):
    def steps(pkg, root, run):
        log = [run("init", "--dir", str(root))]
        assert (root / "config" / "config.yaml").exists() and (root / "data").is_dir()
        log.append((root / "config" / "config.yaml").read_text())
        log.append(run("status", "--dir", str(root)))
        log.append(run("init", "--dir", str(root)))
        assert "already exists" in log[-1][1]
        log.append(run("reset", "--dir", str(root)))
        assert log[-1][0] == 1 and (root / "data").exists()
        log.append(run("reset", "--dir", str(root), "--yes"))
        assert log[-1][0] == 0 and not (root / "data").exists()
        log.append(run("reset", "--dir", str(root), "--yes"))
        return log

    return _both(tmp_path, capsys, steps)


class _Sink:
    """A local HTTP endpoint that takes POSTs (answering 200) and serves
    one canned ``/trace/<id>`` body; it records what it was sent."""

    def __init__(self, trace_body=None):
        sent = self.sent = []
        body = json.dumps(trace_body or {}).encode()

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                sent.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(b"{}")

            def do_GET(self):
                ok = self.path.startswith("/trace/")
                self.send_response(200 if ok else 404)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body if ok else b"{}")

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def case_dlq_list_and_replay(tmp_path, capsys, monkeypatch):
    sink = _Sink()
    dead = "http://127.0.0.1:9"  # refused: stays in the queue with its error

    def seed(root):
        (root / "data").mkdir()

    def steps(pkg, root, run):
        dlq = root / "data" / "dlq.jsonl"
        log = [run("dlq", "--dir", str(root))]
        assert json.loads(log[-1][1])["events"] == 0
        dlq.write_text(
            json.dumps({"ts": 1.0, "topic": "t", "url": sink.url + "/h", "event": {"n": 1}, "error": "boom",
                        "attempts": 3}) + "\n"
            + json.dumps({"ts": 2.0, "topic": "t", "url": sink.url + "/h", "event": {"n": 2}, "error": "later",
                          "attempts": 3}) + "\n"
            + json.dumps({"ts": 3.0, "topic": "u", "url": dead + "/h", "event": {"n": 3}, "error": "x",
                          "attempts": 1}) + "\n"
            + "not json\n"
        )
        log.append(run("dlq", "list", "--dir", str(root)))
        listed = json.loads(log[-1][1])
        assert listed["events"] == 4 and listed["entries"][1]["count"] == 2
        del sink.sent[:]
        rc, text = run("dlq", "replay", "--dir", str(root), "--timeout", "2")
        out = json.loads(text)
        assert rc == 1 and out["replayed"] == 2 and out["failed"] == 2 and [e["n"] for e in sink.sent] == [1, 2]
        left = [json.loads(ln) if ln.startswith("{") else ln for ln in dlq.read_text().splitlines()]
        assert left[0]["attempts"] == 2 and left[1] == "not json"
        # The error text of the refused POST is each HTTP client's own
        # (httpx in the reference, urllib in the port).
        left[0].pop("error")
        log.append((rc, {k: v for k, v in out.items()}, left, list(sink.sent)))
        return log

    try:
        return _both(tmp_path, capsys, steps, seed)
    finally:
        sink.close()


def case_status_counts_rows(tmp_path, capsys, monkeypatch):
    def seed(root):
        (root / "data").mkdir()
        (root / "data" / "failures.jsonl").write_text('{"a":1}\n{"a":2}\n')
        (root / "data" / "tombstones.jsonl").write_text('{"op":"tomb","id":"F-0001","reason":"aged"}\n')

    def steps(pkg, root, run):
        rc, text = run("status", "--dir", str(root))
        st = json.loads(text)
        assert rc == 0 and st["failures"] == 2 and st["patterns"] == 0
        return rc, text

    return _both(tmp_path, capsys, steps, seed)


def case_init_yes_writes_env(tmp_path, capsys, monkeypatch):
    def steps(pkg, root, run):
        log = [run("init", "--dir", str(root), "--yes")]
        env = (root / ".env").read_text()
        secret = [ln for ln in env.splitlines() if ln.startswith("DASHBOARD_JWT_SECRET=")][0].split("=", 1)[1]
        assert len(secret) == 64 and "KAKVEDA_ENV=development" in env
        log.append(env.replace(secret, "<secret>"))
        log.append(run("init", "--dir", str(root), "--yes", "--force"))
        assert secret in (root / ".env").read_text()
        return log

    return _both(tmp_path, capsys, steps)


def _wizard(pkg, root, answers):
    it = iter(answers)
    out = []
    path = WIZARDS[pkg].run_wizard(root, input_fn=lambda _: next(it), print_fn=out.append)
    env = path.read_text()
    secret = [ln for ln in env.splitlines() if ln.startswith("DASHBOARD_JWT_SECRET=")][0].split("=", 1)[1]
    return env.replace(secret, "<secret>"), out


def case_wizard_interactive_answers(tmp_path, capsys, monkeypatch):
    answers = ["production", "tpu", "/ckpts/llama3-8b", "text", "4096", "data:4,model:2", "redis://r:6379/0", "",
               ""]

    def steps(pkg, root, run):
        env, out = _wizard(pkg, root, answers)
        assert "KAKVEDA_ENV=production" in env and "KAKVEDA_MODEL_RUNTIME=tpu" in env
        assert "KAKVEDA_HF_CKPT=/ckpts/llama3-8b" in env and "KAKVEDA_MESH_SHAPE=data:4,model:2" in env
        assert "KAKVEDA_REDIS_URL=redis://r:6379/0" in env and "SMTP_HOST" not in env
        assert any("production mode" in line for line in out)
        return env, [ln.replace(str(root), "<root>") for ln in out]

    return _both(tmp_path, capsys, steps)


def case_doctor_runs(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("KAKVEDA_CONFIG_PATH", str(tmp_path / "config.yaml"))
    monkeypatch.chdir(tmp_path)

    def steps(pkg, root, run):
        rc, text = run("doctor", "--dir", str(root))
        rows = _doctor_rows(text)
        assert rc == 0 and "native extension" in rows and "device compute" in rows
        assert ("jax" in rows and "device mesh" in rows) if pkg == "jax" else ("torch" in rows and "cuda" in rows)
        return rc, {k: v for k, v in rows.items() if k not in DEVICE_ROWS}

    return _both(tmp_path, capsys, steps)


def case_doctor_redacts_redis_password(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("KAKVEDA_REDIS_URL", "redis://:s3cretpass@localhost:1/0")
    monkeypatch.chdir(tmp_path)

    def steps(pkg, root, run):
        rc, text = run("doctor", "--dir", str(root))
        assert "s3cretpass" not in text
        rows = _doctor_rows(text)
        return rc, rows["redis"][0], {k: v for k, v in rows.items() if k not in DEVICE_ROWS | {"redis"}}

    return _both(tmp_path, capsys, steps)


def case_load_dotenv_env_wins(tmp_path, capsys, monkeypatch):
    env = tmp_path / ".env"
    env.write_text("KAKVEDA_TEST_A=from_file\nKAKVEDA_TEST_B=file_b\n# comment\nbad line\n")
    out = {}
    for pkg in ("jax", "port"):
        monkeypatch.setenv("KAKVEDA_TEST_A", "from_env")
        monkeypatch.delenv("KAKVEDA_TEST_B", raising=False)
        applied = WIZARDS[pkg].load_dotenv(env)
        out[pkg] = (applied, os.environ["KAKVEDA_TEST_A"], os.environ["KAKVEDA_TEST_B"])
        monkeypatch.delenv("KAKVEDA_TEST_B", raising=False)
    assert out["port"] == (1, "from_env", "file_b")
    return out


def case_env_file_permissions(tmp_path, capsys, monkeypatch):
    def steps(pkg, root, run):
        rc, _ = run("init", "--dir", str(root), "--yes")
        return rc, oct(stat.S_IMODE(os.stat(root / ".env").st_mode))

    out = _both(tmp_path, capsys, steps)
    assert out["port"] == (0, "0o600")
    return out


def case_wizard_rejects_invalid_choice(tmp_path, capsys, monkeypatch):
    answers = ["prod", "production", "stub", "", "json", "4096", "data:-1", "", "", ""]

    def steps(pkg, root, run):
        env, _ = _wizard(pkg, root, answers)
        assert "KAKVEDA_ENV=production" in env
        return env, capsys.readouterr().out

    return _both(tmp_path, capsys, steps)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def case_up_detach_status_logs_down(tmp_path, capsys, monkeypatch):
    """Real processes: ``up --detach`` (the API and the dashboard on their
    ports), ``status`` running, a second ``up`` refused, ``logs``, ``down``,
    ``status`` stopped; the dashboard's login page answers meanwhile."""
    base_env = dict(os.environ, JAX_PLATFORMS="cpu", KAKVEDA_LOG_FORMAT="text", KAKVEDA_INDEX_CAPACITY="1024")
    base_env.pop("KAKVEDA_DATA_DIR", None)

    def steps(pkg, root, run):
        port, dash = _free_port(), _free_port()
        mod = "kakveda_tpu.cli" if pkg == "jax" else "kakveda_tpu_torch.cli"
        extra = [] if pkg == "jax" else ["--device", "cpu"]
        env = dict(base_env, KAKVEDA_DATA_DIR=str(root / "data"))

        def cli(*argv, timeout=120):
            r = subprocess.run([sys.executable, "-m", mod, *argv], capture_output=True, text=True, env=env,
                               timeout=timeout, cwd=ROOT)
            return r.returncode, re.sub(r"pid \d+", "pid <n>", r.stdout), r.stderr

        log = [cli("up", "--detach", "--dir", str(root), "--port", str(port), "--dashboard-port", str(dash),
                   *extra)[:2]]
        assert log[0][0] == 0 and (root / "server.pid").exists()
        try:
            up = False
            deadline = time.time() + 180
            while time.time() < deadline and not up:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{dash}/login", timeout=2) as r:
                        up = r.status == 200
                except OSError:
                    time.sleep(0.5)
            assert up, (root / "server.log").read_text()[-3000:]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                assert r.status == 200
            rc, out, err = cli("up", "--dir", str(root), "--port", str(port))
            assert rc == 1 and "already running" in err
            log.append((rc, out))
            rc, out, _ = cli("status", "--dir", str(root))
            st = json.loads(out)
            assert st["server"]["running"] is True
            st["server"]["pid"] = "<n>"
            st.pop("durability", None)  # the live server's logs are mid-write
            log.append((rc, {k: v for k, v in st.items() if k not in ("failures", "patterns", "health")}))
            rc, out, _ = cli("logs", "--dir", str(root), "-n", "200")
            assert rc == 0 and "platform API" in out and "dashboard on" in out
            log.append(rc)
        finally:
            rc, out, err = cli("down", "--dir", str(root), timeout=90)
        assert rc == 0, err
        log.append((rc, out))
        assert not (root / "server.pid").exists()
        rc, out, _ = cli("status", "--dir", str(root))
        assert json.loads(out)["server"]["running"] is False
        log.append(rc)
        return log

    return _both(tmp_path, capsys, steps)


# ---------------------------------------------------------------------------
# the verbs tests/test_cli.py does not run: compact, trace
# ---------------------------------------------------------------------------


def _seed_store(root: Path) -> None:
    """A data dir of 24 failures and a tombstone, written by the port's GFKB
    (whose logs the JAX package reads as its own)."""
    from kakveda_tpu_torch.index.gfkb import GFKB

    kb = GFKB(data_dir=root / "data", capacity=64, dim=256, device="cpu")
    for i in range(24):
        kb.upsert_failure(failure_type="oom" if i % 2 else "timeout", signature_text=f"compact case {i} stack",
                          app_id=f"app-{i % 3}", impact_severity="high")
    kb.close()


def case_compact(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)

    def steps(pkg, root, run):
        argv = ["compact", "--dir", str(root), "--capacity", "64", "--dim", "256"]
        rc, text = run(*(argv + (["--device", "cpu"] if pkg == "port" else [])))
        out = json.loads(text[text.index("{"):])
        assert rc == 0 and out["compact"]["compacted"] and out["durability"]["compact_generation"] == 1
        out["durability"]["last_compact_ts"] = "<ts>"
        return rc, out

    return _both(tmp_path, capsys, steps, _seed_store)


def case_trace(tmp_path, capsys, monkeypatch):
    spans = [
        {"trace_id": "a" * 32, "span_id": "1" * 16, "parent_id": None, "name": "service.request",
         "service": "replica-0", "dur_ms": 5.5, "outcome": "ok", "attrs": {"path": "/warn"}},
        {"trace_id": "a" * 32, "span_id": "2" * 16, "parent_id": "1" * 16, "name": "gfkb.warn",
         "service": "replica-0", "dur_ms": 3.25, "outcome": "ok", "attrs": {"tier": "hot"}},
    ]
    sink = _Sink({"trace_id": "a" * 32, "spans": spans, "sources": {"r0": 2}})

    def steps(pkg, root, run):
        rc, text = run("trace", "a" * 32, "--url", sink.url)
        assert rc == 0 and "└─ service.request [replica-0] 5.5ms ok  path=/warn" in text
        return [(rc, text), run("trace", "b" * 32, "--url", "http://127.0.0.1:9", "--timeout", "1")]

    try:
        return _both(tmp_path, capsys, steps)
    finally:
        sink.close()


CASES = {
    "help_lists_verbs": case_help_lists_verbs,
    "no_command_errors": case_no_command_errors,
    "version": case_version,
    "init_and_status_and_reset": case_init_and_status_and_reset,
    "dlq_list_and_replay": case_dlq_list_and_replay,
    "status_counts_rows": case_status_counts_rows,
    "init_yes_writes_env": case_init_yes_writes_env,
    "wizard_interactive_answers": case_wizard_interactive_answers,
    "doctor_runs": case_doctor_runs,
    "doctor_redacts_redis_password": case_doctor_redacts_redis_password,
    "load_dotenv_env_wins": case_load_dotenv_env_wins,
    "env_file_permissions": case_env_file_permissions,
    "wizard_rejects_invalid_choice": case_wizard_rejects_invalid_choice,
    "up_detach_status_logs_down": case_up_detach_status_logs_down,
    "compact": case_compact,
    "trace": case_trace,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_matches_jax(name, tmp_path, capsys, monkeypatch):
    """One case of tests/test_cli.py (or a verb it does not run) through both
    CLIs: the reference test's assertions in each, equal output and codes."""
    out = CASES[name](tmp_path, capsys, monkeypatch)
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# the agent echo app
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "method,path,body",
    [("GET", "/health", None), ("GET", "/capabilities", None),
     ("POST", "/invoke", {"event_type": "ask", "payload": {"prompt": "hello"}}), ("POST", "/invoke", {})],
)
def test_agent_echo_matches_jax(method, path, body):
    from kakveda_tpu.service.app import make_agent_echo_app as jax_echo
    from kakveda_tpu_torch.service.app import make_agent_echo_app as port_echo

    async def ask(app):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.request(method, path, json=body)
            return r.status, r.headers["Content-Type"], await r.json()
        finally:
            await client.close()

    jax_out = asyncio.run(ask(jax_echo("echo-x")))
    port_out = asyncio.run(ask(port_echo("echo-x")))
    assert port_out == jax_out and port_out[0] == 200


def test_agent_echo_entry_point_serves_the_contract():
    """``python -m kakveda_tpu_torch.service.agent_echo`` answers ``/health``
    over real HTTP; SIGTERM stops it."""
    port = _free_port()
    proc = subprocess.Popen([sys.executable, "-m", "kakveda_tpu_torch.service.agent_echo", "--port", str(port)],
                            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        body = None
        deadline = time.time() + 60
        while time.time() < deadline and body is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=2) as r:
                    body = json.loads(r.read())
            except OSError:
                time.sleep(0.2)
        assert body == {"ok": True, "service": "agent-echo", "status": "healthy"}
    finally:
        proc.terminate()
        proc.wait(timeout=30)
