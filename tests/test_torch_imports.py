"""The PyTorch port stands alone: it loads neither jax nor the JAX package,
and its entry points refuse to start on the CPU unless asked to."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import kakveda_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "kakveda_tpu_torch"


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="kakveda_tpu_torch.")
    )


def test_import_loads_no_jax_in_fresh_interpreter():
    mods = _modules()
    assert "kakveda_tpu_torch.platform" in mods and "kakveda_tpu_torch.ops.fused_topk" in mods
    for m in ("serving", "generate", "llama", "attention", "tokenizer", "runtime", "moe", "quant", "hf_convert",
              "speculative"):
        assert f"kakveda_tpu_torch.models.{m}" in mods
    for m in ("ops.clustering", "ops.incremental", "index.gfkb", "pipeline.patterns", "native",
              "core.runtime", "core.admission", "service.app", "service.batcher", "service.main",
              "core.faults", "core.metrics", "index.crashsweep", "index.tiers", "core.profiling",
              "core.sanitize", "core.trace", "core.otel", "core.ratelimit", "core.httpjson", "events.bus",
              "fleet.hashring", "fleet.gossip", "fleet.ownership", "fleet.router", "fleet.supervisor",
              "fleet.autoscaler", "traffic", "traffic.capture", "traffic.scenarios", "traffic.replay",
              "traffic.slo", "cli.main", "cli.__main__"):
        assert f"kakveda_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'kakveda_tpu' or m.startswith('kakveda_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize(
    "module,aiohttp_allowed",
    [
        ("kakveda_tpu_torch", False),
        ("kakveda_tpu_torch.platform", False),
        ("kakveda_tpu_torch.native", False),
        ("kakveda_tpu_torch.models.moe", False),
        ("kakveda_tpu_torch.models.quant", False),
        ("kakveda_tpu_torch.models.runtime", False),
        ("kakveda_tpu_torch.models.hf_convert", False),
        ("kakveda_tpu_torch.models.tokenizer", False),
        ("kakveda_tpu_torch.models.generate", False),
        ("kakveda_tpu_torch.models.serving", False),
        ("kakveda_tpu_torch.models.speculative", False),
        ("kakveda_tpu_torch.pipeline.classifier", False),
        ("kakveda_tpu_torch.core.faults", False),
        ("kakveda_tpu_torch.index.crashsweep", False),
        ("kakveda_tpu_torch.index.tiers", False),
        ("kakveda_tpu_torch.core.admission", False),
        ("kakveda_tpu_torch.core.metrics", False),
        ("kakveda_tpu_torch.core.profiling", False),
        ("kakveda_tpu_torch.pipeline.warning", False),
        ("kakveda_tpu_torch.core.sanitize", False),
        ("kakveda_tpu_torch.core.trace", False),
        ("kakveda_tpu_torch.core.otel", False),
        ("kakveda_tpu_torch.core.ratelimit", False),
        ("kakveda_tpu_torch.service.batcher", False),
        ("kakveda_tpu_torch.service.app", True),
        ("kakveda_tpu_torch.events.bus", False),
        ("kakveda_tpu_torch.core.httpjson", False),
        ("kakveda_tpu_torch.fleet.hashring", False),
        ("kakveda_tpu_torch.fleet.gossip", False),
        ("kakveda_tpu_torch.fleet.ownership", False),
        ("kakveda_tpu_torch.fleet.supervisor", False),
        ("kakveda_tpu_torch.fleet.router", True),
        ("kakveda_tpu_torch.fleet.autoscaler", False),
        ("kakveda_tpu_torch.traffic", False),
        ("kakveda_tpu_torch.traffic.capture", False),
        ("kakveda_tpu_torch.traffic.scenarios", False),
        ("kakveda_tpu_torch.traffic.replay", False),
        ("kakveda_tpu_torch.traffic.slo", False),
        ("kakveda_tpu_torch.cli.main", False),
    ],
)
def test_module_loads_no_jax_and_only_the_service_loads_aiohttp(module, aiohttp_allowed):
    # Each in a fresh interpreter: the library half never pulls in the
    # HTTP stack, and nothing pulls in jax or the JAX package.
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'kakveda_tpu' or m.startswith('kakveda_tpu.')]\n"
        "print(bad, 'aiohttp' in sys.modules)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["[]", str(aiohttp_allowed)], r.stdout


@pytest.mark.parametrize("module", ["kakveda_tpu_torch.platform", "kakveda_tpu_torch.service.app"])
def test_mining_imports_scipy_at_start_up(module):
    # The first /patterns/mine runs while /warn traffic is in flight: an
    # import of scipy's graph module there (about a second, under the GIL)
    # would stall every warn behind it, so it is paid when the module loads.
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "print('scipy.sparse.csgraph' in sys.modules)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["True"], r.stdout


def test_sources_name_no_jax():
    # `kakveda_tpu.` never appears (the port's own name continues with
    # `_torch`), nor an import of jax or of the bare JAX package.
    pat = re.compile(r"import jax|from jax|\bkakveda_tpu\.|import kakveda_tpu\b(?!_)")
    hits = [
        f"{path.relative_to(ROOT)}: {m.group(0)}"
        for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
        for m in pat.finditer(path.read_text())
    ]
    assert not hits, hits


@pytest.mark.parametrize(
    "entry",
    ["platform", "gfkb", "knn", "llama_runtime", "llama_init_params", "llama_init_cache", "service_app",
     "get_runtime", "tiered_platform", "hf_loader", "multi_runtime", "traffic_storm"],
)
def test_entry_points_default_to_cuda(entry, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from kakveda_tpu_torch.cli.main import run_storm
    from kakveda_tpu_torch.index.gfkb import GFKB
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.hf_convert import load_hf_checkpoint
    from kakveda_tpu_torch.models.llama import LlamaConfig, init_cache, init_params
    from kakveda_tpu_torch.models.runtime import clear_runtimes, get_runtime
    from kakveda_tpu_torch.ops.knn import Knn
    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service.app import make_app

    make = {
        "platform": lambda: Platform(data_dir=tmp_path, capacity=16, dim=64),
        "gfkb": lambda: GFKB(data_dir=tmp_path, capacity=16, dim=64),
        "knn": lambda: Knn(16, 64),
        "llama_runtime": lambda: LlamaRuntime(),
        "llama_init_params": lambda: init_params(torch.Generator(), LlamaConfig.tiny()),
        "llama_init_cache": lambda: init_cache(LlamaConfig.tiny(), batch=1, max_len=8),
        "service_app": lambda: make_app(data_dir=tmp_path, capacity=16, dim=64),
        "get_runtime": lambda: get_runtime("torch"),
        "tiered_platform": lambda: Platform(data_dir=tmp_path, capacity=16, dim=64),
        "hf_loader": lambda: load_hf_checkpoint(str(tmp_path)),
        "multi_runtime": lambda: get_runtime("torch"),
        "traffic_storm": lambda: run_storm(data_dir=tmp_path, duration_s=0.1),
    }[entry]
    if entry == "tiered_platform":
        monkeypatch.setenv("KAKVEDA_CLASSIFIER", "tiered")
        monkeypatch.setenv("KAKVEDA_MODEL_RUNTIME", "torch")
    if entry == "multi_runtime":
        monkeypatch.setenv("KAKVEDA_HF_CKPTS", str(tmp_path / "ckpt"))
    clear_runtimes()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def test_cli_up_without_device_wants_the_card(tmp_path):
    """``cli up`` with no ``--device`` builds its Platform on the card: with
    none visible it exits non-zero, naming the missing card."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "KAKVEDA_INDEX_CAPACITY": "64"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "kakveda_tpu_torch.cli", "up", "--dir", str(tmp_path), "--port", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, env=env,
    )
    assert r.returncode != 0 and "CUDA is not available" in r.stderr, r.stderr[-2000:]
    assert not (tmp_path / "server.pid").exists()


def test_cli_traffic_storm_without_device_wants_the_card(tmp_path):
    """``cli traffic storm`` with no ``--device`` runs its Platform on the
    card: with none visible it exits non-zero before any traffic."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT)}
    r = subprocess.run(
        [sys.executable, "-m", "kakveda_tpu_torch.cli", "traffic", "storm", "--duration", "0.5"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env,
    )
    assert r.returncode != 0 and "wants the CUDA card" in r.stderr, r.stderr[-2000:]
    assert '"replay"' not in r.stdout


def test_cpu_wrapper_never_builds(monkeypatch):
    # On a CPU tensor the wrapper takes the plain version: no nvcc, no launch.
    from kakveda_tpu_torch.ops import _build, fused_topk as ft

    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("built on CPU"))
    before = ft.fused_topk.launches
    emb = torch.eye(4, 16)
    v, i = ft.fused_topk(emb, torch.ones(4, dtype=torch.bool), emb[:2], 2)
    assert ft.fused_topk.launches == before
    assert i[:, 0].tolist() == [0, 1]
    assert kakveda_tpu_torch.__version__


def test_port_keeps_its_own_tokenizer():
    from kakveda_tpu_torch.models.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    ids = tok.encode("héllo", eos=True)
    assert ids[0] == tok.BOS and ids[-1] == tok.EOS and tok.vocab_size == 259
    assert tok.decode(ids) == "héllo"


def test_tokenizer_reader_loads_neither_transformers_nor_tokenizers(tmp_path):
    """Building the port's ``HFTokenizer`` over a tokenizer directory, and
    encoding and decoding with it, loads neither package in a fresh
    interpreter (the card's machine has neither). The files are written
    by hand: a byte-level BPE vocabulary with two merges."""
    import json

    from kakveda_tpu_torch.models.tokenizer import _BYTE_CHAR

    vocab = {"<|endoftext|>": 0}
    for b in range(256):
        vocab[_BYTE_CHAR[b]] = len(vocab)
    for tok in ("Ġh", "Ġhi"):
        vocab[tok] = len(vocab)
    (tmp_path / "tokenizer.json").write_text(json.dumps({
        "added_tokens": [{"id": 0, "content": "<|endoftext|>", "special": True, "normalized": False}],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "use_regex": True},
        "decoder": {"type": "ByteLevel"},
        "model": {"type": "BPE", "vocab": vocab, "merges": [["Ġ", "h"], ["Ġh", "i"]]},
    }))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"eos_token": "<|endoftext|>"}))
    code = (
        "import sys\n"
        "from kakveda_tpu_torch.models.tokenizer import HFTokenizer\n"
        f"tok = HFTokenizer({str(tmp_path)!r})\n"
        "ids = tok.encode('say hi hi', bos=False)\n"
        "assert tok.decode(ids) == 'say hi hi' and ids[-1] == 258, ids\n"
        "print([m for m in sys.modules if m.split('.')[0] in ('transformers', 'tokenizers')])\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["[]"], r.stdout
