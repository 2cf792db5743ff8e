"""Model runtimes: stub | ollama | torch (the in-tree Llama on the card).

Counterpart of ``kakveda_tpu/models/runtime.py``. Every runtime returns a
:class:`GenerateResult` with provider/model/latency metadata:

* :class:`StubRuntime` — the reference's canned, citation-bearing response,
  byte for byte; the hermetic default.
* ``LlamaRuntime`` (``models/generate.py``) — the in-tree Llama, on the
  same card as the GFKB index, so an LLM judge is a forward pass in the
  process, not an HTTP hop.
* :class:`OllamaRuntime` — an HTTP client for an external Ollama that falls
  back to the stub on any error, as the reference does.

``get_runtime`` resolves ``KAKVEDA_MODEL_RUNTIME`` (``stub``, ``ollama``,
``torch``; ``tpu``, the JAX package's value, selects the same in-tree
Llama, so a deployment's environment carries over). The multi-checkpoint
router (``KAKVEDA_HF_CKPTS``) waits for the checkpoint converter and raises.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Protocol

# The reference's exact stub text: fake citations that trip the rule
# classifier deterministically.
STUB_RESPONSE = (
    "Here is a summary with references.\n\n"
    "References:\n"
    "[1] Smith et al. (2020) A Study on Things.\n"
    "[2] Doe (2021) Another Paper.\n"
)


@dataclass
class GenerateResult:
    text: str
    meta: Dict[str, Any] = field(default_factory=dict)


class ModelRuntime(Protocol):
    name: str

    def generate(self, prompt: str, *, model: Optional[str] = None, max_tokens: int = 256) -> GenerateResult: ...


def generate_batch(
    runtime: "ModelRuntime", prompts: list, *, model: Optional[str] = None, max_tokens: int = 256
) -> list:
    """Batched generation through whatever the runtime offers: its own
    ``generate_batch`` (the Llama runtime's shared slot pool), else one
    ``generate`` per prompt."""
    fn = getattr(runtime, "generate_batch", None)
    if callable(fn):
        return fn(prompts, model=model, max_tokens=max_tokens)
    return [runtime.generate(p, model=model, max_tokens=max_tokens) for p in prompts]


def list_models(runtime: "ModelRuntime") -> list:
    """Model names the runtime serves (its ``list_models``), else one entry
    named after it."""
    fn = getattr(runtime, "list_models", None)
    if callable(fn):
        try:
            return list(fn()) or [getattr(runtime, "name", "model")]
        except Exception:  # noqa: BLE001 — listing is best-effort
            pass
    return [getattr(runtime, "name", "model")]


def _serving_stats_unavailable(name: str) -> Dict[str, Any]:
    """``serving_stats`` of a runtime with no serving engine."""
    return {"runtime": name, "engine": None}


class StubRuntime:
    """Deterministic canned-response backend — the hermetic test model."""

    name = "stub"

    def __init__(self, model_label: str = "stub"):
        self.model_label = model_label

    def list_models(self) -> list:
        return [self.model_label]

    def serving_stats(self) -> Dict[str, Any]:
        return _serving_stats_unavailable("stub")

    def generate(self, prompt: str, *, model: Optional[str] = None, max_tokens: int = 256) -> GenerateResult:
        started = time.perf_counter()
        return GenerateResult(
            text=STUB_RESPONSE,
            meta={
                "provider": "stub",
                "model": model or self.model_label,
                "latency_ms": int((time.perf_counter() - started) * 1000),
            },
        )

    def generate_stream(self, prompt: str, *, model: Optional[str] = None, max_tokens: int = 256, cancel=None):
        """The canned response word by word, joining to ``generate().text``."""
        words = STUB_RESPONSE.split(" ")
        for i, w in enumerate(words):
            if cancel is not None and cancel.is_set():
                return
            yield w if i == len(words) - 1 else w + " "


class OllamaRuntime:
    """HTTP client for an external Ollama (``OLLAMA_URL``, ``OLLAMA_MODEL``),
    with the stub's answer on any error. ``httpx`` is imported at call time,
    so the runtime costs nothing until it is used."""

    name = "ollama"

    def __init__(self, url: Optional[str] = None, model: Optional[str] = None, timeout: float = 8.0):
        self.url = url or os.environ.get("OLLAMA_URL", "http://localhost:11434")
        self.model = model or os.environ.get("OLLAMA_MODEL", "llama3")
        self.timeout = timeout
        self._stub = StubRuntime()

    def list_models(self) -> list:
        """Installed models from ``/api/tags``; the configured one on failure."""
        import httpx

        try:
            r = httpx.get(f"{self.url}/api/tags", timeout=3.0)
            r.raise_for_status()
            names = [m.get("name") for m in r.json().get("models", []) if m.get("name")]
            return names or [self.model]
        except Exception:  # noqa: BLE001
            return [self.model]

    def serving_stats(self) -> Dict[str, Any]:
        return _serving_stats_unavailable("ollama")

    def generate(self, prompt: str, *, model: Optional[str] = None, max_tokens: int = 256) -> GenerateResult:
        import httpx

        mdl = model or self.model
        started = time.perf_counter()
        try:
            r = httpx.post(
                f"{self.url}/api/generate",
                json={"model": mdl, "prompt": prompt, "stream": False},
                timeout=self.timeout,
            )
            r.raise_for_status()
            latency_ms = int((time.perf_counter() - started) * 1000)
            return GenerateResult(
                text=r.json().get("response") or "",
                meta={"provider": "ollama", "model": mdl, "url": self.url, "latency_ms": latency_ms},
            )
        except Exception as e:  # noqa: BLE001 — any failure falls back to the stub
            latency_ms = int((time.perf_counter() - started) * 1000)
            res = self._stub.generate(prompt, model=mdl)
            res.meta.update({"latency_ms": latency_ms, "url": self.url, "error": f"{type(e).__name__}: {e}"})
            return res


_RUNTIMES: Dict[tuple, Any] = {}
_RUNTIMES_LOCK = threading.Lock()


def get_runtime(name: Optional[str] = None, device=None) -> ModelRuntime:
    """The configured runtime (``KAKVEDA_MODEL_RUNTIME``, default ``stub``),
    one per (name, device) for the process. ``torch`` (or ``tpu``) builds
    ``LlamaRuntime.from_env(device=device)``: on the card unless ``device``
    names another, raising without a card as ``resolve_device`` does."""
    name = (name or os.environ.get("KAKVEDA_MODEL_RUNTIME", "stub")).lower()
    if name == "tpu":
        name = "torch"
    if name not in ("stub", "ollama", "torch"):
        raise ValueError(f"unknown model runtime: {name!r}")
    dev_key = None
    if name == "torch":
        if os.environ.get("KAKVEDA_HF_CKPTS"):
            raise NotImplementedError(
                "KAKVEDA_HF_CKPTS: the multi-checkpoint runtime is not ported yet"
            )
        from kakveda_tpu_torch.ops.device import resolve_device

        dev_key = str(resolve_device(device))
    with _RUNTIMES_LOCK:
        rt = _RUNTIMES.get((name, dev_key))
        if rt is None:
            if name == "stub":
                rt = StubRuntime()
            elif name == "ollama":
                rt = OllamaRuntime()
            else:
                from kakveda_tpu_torch.models.generate import LlamaRuntime

                rt = LlamaRuntime.from_env(device=dev_key)
            _RUNTIMES[(name, dev_key)] = rt
        return rt


def clear_runtimes() -> None:
    """Forget the cached runtimes, closing any engine they started (tests,
    or a process that changes its model settings)."""
    with _RUNTIMES_LOCK:
        rts = list(_RUNTIMES.values())
        _RUNTIMES.clear()
    for rt in rts:
        close = getattr(rt, "close", None)
        if callable(close):
            close()
