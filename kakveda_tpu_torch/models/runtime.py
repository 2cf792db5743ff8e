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

* :class:`MultiModelRuntime` — several local HF checkpoints behind one
  runtime (``KAKVEDA_HF_CKPTS``), loaded lazily, routed by label, under an
  HBM budget with LRU eviction of idle models.

``get_runtime`` resolves ``KAKVEDA_MODEL_RUNTIME`` (``stub``, ``ollama``,
``torch``; ``tpu``, the JAX package's value, selects the same in-tree
Llama, so a deployment's environment carries over).
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


class UnknownModelError(ValueError):
    """The requested model label is not among the runtime's checkpoints (a
    type of its own, so a caller can tell a stale label from a serving
    error)."""


class HBMBudgetError(RuntimeError):
    """Loading a checkpoint would pass the runtime's HBM weight budget and
    nothing (more) can be evicted. Raised before anything is uploaded."""


def _parse_bytes(s) -> Optional[int]:
    """'8GiB' | '8G' | '512M' | a number → bytes (None or '' → None)."""
    if s is None or s == "":
        return None
    if isinstance(s, (int, float)):
        return int(s)
    t = str(s).strip().upper().removesuffix("B").removesuffix("I")
    mult = {"K": 2**10, "M": 2**20, "G": 2**30, "T": 2**40}.get(t[-1:], 1)
    if mult != 1:
        t = t[:-1]
    return int(float(t) * mult)


def _tree_bytes(params) -> int:
    """Bytes of a param tree's tensors (an int8 pair counts its matrix and
    its scales)."""
    if isinstance(params, dict):
        return sum(_tree_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(_tree_bytes(v) for v in params)
    if hasattr(params, "element_size"):
        return params.numel() * params.element_size()
    return 0


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


def _param_bytes_estimate(cfg, quant: Optional[str]) -> int:
    """The bytes the port's param tree for ``cfg`` takes, by arithmetic on
    its shapes (``llama.init_params`` and the HF loader make the same
    ones): matrices, the embedding and ``lm_head`` at ``cfg.dtype`` (under
    ``quant="int8"`` the dense projections and ``lm_head`` at one byte an
    element plus an f32 scale per output column), norm gains, biases and
    the router charged at f32, the widest they are stored at."""
    import torch

    item = torch.empty(0, dtype=cfg.dtype).element_size()
    d, f, e, hd = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.head_dim
    q_out, kv_out = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def mat(fan_in, out, stack=1):
        if quant == "int8":
            return stack * (fan_in * out + 4 * out)
        return stack * fan_in * out * item

    layer = mat(d, q_out) + 2 * mat(d, kv_out) + mat(q_out, d) + 4 * 2 * d
    if e:
        layer += 4 * d * e + 2 * mat(d, f, e) + mat(f, d, e)
    else:
        layer += 2 * mat(d, f) + mat(f, d)
    if cfg.attn_bias:
        layer += 4 * (q_out + 2 * kv_out)
    if cfg.post_norms:
        layer += 4 * 2 * d
    if cfg.qk_norm:
        layer += 4 * 2 * hd
    return cfg.n_layers * layer + cfg.vocab_size * d * item + mat(d, cfg.vocab_size) + 4 * d


class MultiModelRuntime:
    """Several HF checkpoints behind one runtime, routed by model label (the
    port's twin of the reference's router).

    ``KAKVEDA_HF_CKPTS=/ckpts/llama-1b:/ckpts/qwen3-0.6b`` (``os.pathsep``
    between checkpoint directories of any family ``models/hf_convert.py``
    takes). Labels are the directories' names, the first is the default,
    and a checkpoint loads (``LlamaRuntime.from_hf`` on ``device``) on its
    first request, so only models that are asked for occupy the card.

    **HBM budget** (``hbm_budget_bytes`` or ``KAKVEDA_HBM_BUDGET=12GiB``):
    each loaded model is charged its exact weight bytes plus its serving
    engine's KV pool; before a load, an estimate from ``config.json`` alone
    (arithmetic on the param shapes, no weight read) that would pass the
    budget evicts idle models, least recently used first, and raises
    :class:`HBMBudgetError` before any upload when eviction cannot make
    room. No budget: no accounting limit. ``kakveda_hbm_budget_bytes`` and
    ``kakveda_hbm_loaded_bytes`` report both on the metrics plane."""

    name = "torch"

    def __init__(
        self,
        paths: list,
        *,
        quant: Optional[str] = None,
        hbm_budget_bytes: Optional[int] = None,
        device=None,
    ):
        if not paths:
            raise ValueError("MultiModelRuntime needs at least one checkpoint path")
        if quant not in (None, "none", "int8"):
            raise ValueError(f"unknown quant mode {quant!r} (int8|none)")
        self._paths = {os.path.basename(os.path.normpath(p)): p for p in paths}
        if len(self._paths) != len(paths):
            raise ValueError(f"duplicate checkpoint basenames in {paths}")
        self._default = os.path.basename(os.path.normpath(paths[0]))
        self._quant = quant
        self._device = device
        self._budget = (
            hbm_budget_bytes if hbm_budget_bytes is not None else _parse_bytes(os.environ.get("KAKVEDA_HBM_BUDGET"))
        )
        self._loaded: Dict[str, Any] = {}  # label -> LlamaRuntime, least recently used first
        self._bytes: Dict[str, int] = {}  # label -> exact weight + KV bytes
        self._load_lock = threading.Lock()  # loads, evictions and the budget
        self._lru_lock = threading.Lock()  # the order of _loaded only
        from kakveda_tpu_torch.core import metrics as _metrics

        reg = _metrics.get_registry()
        self._m_budget = reg.gauge("kakveda_hbm_budget_bytes", "Configured HBM weight+KV budget (0 = unbudgeted)")
        self._m_loaded = reg.gauge(
            "kakveda_hbm_loaded_bytes", "Resident weight+KV bytes accounted by the model router"
        )
        self._m_budget.set(self._budget or 0)

    def _estimate_bytes(self, path: str) -> int:
        """A load's footprint before it happens, from ``config.json`` alone:
        the param tree's bytes (:func:`_param_bytes_estimate`) plus the
        engine's KV pool. Exact accounting replaces it after the load."""
        import json

        from kakveda_tpu_torch.models.hf_convert import hf_config_to_llama

        with open(os.path.join(path, "config.json")) as f:
            cfg = hf_config_to_llama(json.load(f))
        return _param_bytes_estimate(cfg, self._quant) + self._engine_pool_bytes(cfg)

    @staticmethod
    def _engine_pool_bytes(cfg) -> int:
        """KV bytes the serving engine pins once this model serves (slots ×
        window × layers × K and V), from the knobs ``LlamaRuntime.engine``
        reads; an int8 pool (``KAKVEDA_KV_QUANT=int8``) is one byte an
        element plus one f32 scale per row of head_dim elements."""
        import torch

        slots = int(os.environ.get("KAKVEDA_SERVE_SLOTS", "8"))
        window = min(int(os.environ.get("KAKVEDA_SERVE_WINDOW", min(512, cfg.max_seq_len))), cfg.max_seq_len)
        if os.environ.get("KAKVEDA_KV_QUANT", "").lower() == "int8":
            itemsize = 1.0 + 4.0 / cfg.head_dim
        else:
            itemsize = float(torch.empty(0, dtype=cfg.dtype).element_size())
        return int(slots * window * cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * itemsize)

    def _evict_lru(self, keep: str) -> bool:
        """Drop the least recently used loaded model other than ``keep``;
        False when there is none. The caller holds ``_load_lock``. The
        evicted runtime is retired: a caller still holding it finishes on
        the solo path and never rebuilds a KV pool past the budget."""
        with self._lru_lock:
            victim = next((lb for lb in self._loaded if lb != keep), None)
            rt = self._loaded.pop(victim) if victim is not None else None
        if rt is None:
            return False
        self._bytes.pop(victim, None)
        rt.retire()
        self._m_loaded.set(self.loaded_bytes())
        return True

    def loaded_bytes(self) -> int:
        return sum(dict(self._bytes).values())

    def serving_stats(self) -> Dict[str, Any]:
        """The budget's accounting and each resident model's engine stats."""
        with self._lru_lock:
            resident = list(self._loaded.items())
        return {
            "runtime": "torch-multi",
            "budget_bytes": self._budget,
            "loaded_bytes": self.loaded_bytes(),
            "models": {label: {"bytes": self._bytes.get(label, 0), **rt.serving_stats()} for label, rt in resident},
            "available": sorted(self._paths),
        }

    def _get(self, model: Optional[str]):
        label = model or self._default
        if label not in self._paths:
            raise UnknownModelError(f"unknown model {label!r}; available: {sorted(self._paths)}")
        rt = self._loaded.get(label)
        if rt is not None:
            # No load lock on the hot path: touch the LRU order only. A label
            # evicted meanwhile still serves this request on the runtime in hand.
            with self._lru_lock:
                cur = self._loaded.pop(label, None)
                if cur is not None:
                    self._loaded[label] = cur
            return rt
        with self._load_lock:  # one load per label, however many first requests
            rt = self._loaded.get(label)
            if rt is not None:
                return rt
            if self._budget is not None:
                est = self._estimate_bytes(self._paths[label])
                while self.loaded_bytes() + est > self._budget and self._evict_lru(keep=label):
                    pass
                if self.loaded_bytes() + est > self._budget:
                    raise HBMBudgetError(
                        f"loading {label!r} needs ~{est / 2**20:.0f} MiB but only "
                        f"{(self._budget - self.loaded_bytes()) / 2**20:.0f} MiB of the "
                        f"{self._budget / 2**20:.0f} MiB HBM budget remains "
                        "(KAKVEDA_HBM_BUDGET) and nothing is left to evict"
                    )
            from kakveda_tpu_torch.models.generate import LlamaRuntime

            rt = LlamaRuntime.from_hf(self._paths[label], quant=self._quant, device=self._device)
            self._bytes[label] = _tree_bytes(rt.params) + self._engine_pool_bytes(rt.cfg)
            with self._lru_lock:
                self._loaded[label] = rt
            self._m_loaded.set(self.loaded_bytes())
            return rt

    def list_models(self) -> list:
        return list(self._paths)

    def generate(self, prompt: str, *, model: Optional[str] = None, max_tokens: int = 256) -> GenerateResult:
        return self._get(model).generate(prompt, model=model, max_tokens=max_tokens)

    def generate_batch(self, prompts: list, *, model: Optional[str] = None, max_tokens: int = 256) -> list:
        return self._get(model).generate_batch(prompts, model=model, max_tokens=max_tokens)

    def generate_stream(self, prompt: str, *, model: Optional[str] = None, max_tokens: int = 256, cancel=None):
        """The resolved model's ``generate_stream``, with the same default
        budget as :meth:`generate`."""
        return self._get(model).generate_stream(prompt, model=model, max_tokens=max_tokens, cancel=cancel)

    def close(self) -> None:
        """Stop every loaded model's engine thread."""
        with self._lru_lock:
            resident = list(self._loaded.values())
        for rt in resident:
            rt.close()


_RUNTIMES: Dict[tuple, Any] = {}
_RUNTIMES_LOCK = threading.Lock()


def get_runtime(name: Optional[str] = None, device=None) -> ModelRuntime:
    """The configured runtime (``KAKVEDA_MODEL_RUNTIME``, default ``stub``),
    one per (name, device) for the process. ``torch`` (or ``tpu``) builds
    ``LlamaRuntime.from_env(device=device)``, or with ``KAKVEDA_HF_CKPTS``
    a :class:`MultiModelRuntime` over the listed checkpoints
    (``KAKVEDA_QUANT`` applies to each); on the card unless ``device``
    names another, raising without a card as ``resolve_device`` does."""
    name = (name or os.environ.get("KAKVEDA_MODEL_RUNTIME", "stub")).lower()
    if name == "tpu":
        name = "torch"
    if name not in ("stub", "ollama", "torch"):
        raise ValueError(f"unknown model runtime: {name!r}")
    dev_key = None
    if name == "torch":
        from kakveda_tpu_torch.ops.device import resolve_device

        dev_key = str(resolve_device(device))
    with _RUNTIMES_LOCK:
        rt = _RUNTIMES.get((name, dev_key))
        if rt is None:
            if name == "stub":
                rt = StubRuntime()
            elif name == "ollama":
                rt = OllamaRuntime()
            elif os.environ.get("KAKVEDA_HF_CKPTS"):
                multi = os.environ["KAKVEDA_HF_CKPTS"]
                quant = os.environ.get("KAKVEDA_QUANT") or None
                rt = MultiModelRuntime([p for p in multi.split(os.pathsep) if p], quant=quant, device=dev_key)
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
