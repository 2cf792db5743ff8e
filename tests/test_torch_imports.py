"""The PyTorch port stands alone: it loads neither jax nor the JAX package,
and its entry points refuse to start on the CPU unless asked to."""

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
              "core.faults", "core.metrics", "index.crashsweep", "index.tiers"):
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
        ("kakveda_tpu_torch.pipeline.warning", False),
        ("kakveda_tpu_torch.service.app", True),
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
     "get_runtime", "tiered_platform", "hf_loader", "multi_runtime"],
)
def test_entry_points_default_to_cuda(entry, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
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
    }[entry]
    if entry == "tiered_platform":
        monkeypatch.setenv("KAKVEDA_CLASSIFIER", "tiered")
        monkeypatch.setenv("KAKVEDA_MODEL_RUNTIME", "torch")
    if entry == "multi_runtime":
        monkeypatch.setenv("KAKVEDA_HF_CKPTS", str(tmp_path / "ckpt"))
    clear_runtimes()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


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
