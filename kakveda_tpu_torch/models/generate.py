"""Sampling loops and the Llama runtime over the in-tree model.

Counterpart of ``kakveda_tpu/models/generate.py``. ``decode_step`` runs
eagerly (PyTorch needs no jit), so the loops here are plain Python over it.
Greedy decoding is exact against the JAX package; temperature sampling
draws from a ``torch.Generator``, whose numbers differ from ``jax.random``
by design.

``prefill(..., chunk=)`` prefills a prompt batch in fixed pieces, each one
``decode_step`` over the shared cache, and :class:`DecodeSession` decodes a
left-padded batch in resumable chunks on top of it.

``generate_tokens(..., top_p=)`` samples from the nucleus
(:func:`_sample_top_p`); its kept set equals the reference's on the same
logits (at a 128,256-token vocabulary, but for the boundary token), and
the draw comes from a ``torch.Generator``.

``LlamaRuntime`` serves ``generate``/``generate_batch`` through the shared
continuous-batching engine (``models/serving.py``), with its prefix cache,
and falls back to the reference's solo path (a :class:`DecodeSession` with
``KAKVEDA_PREFILL_CHUNK`` chunked prefill) when the engine is off or a
request does not fit its window. ``generate_stream`` yields text deltas as
decode chunks land (the engine's ``on_tokens``, or one delta per solo
chunk) and cancels its request when the consumer closes it or sets
``cancel``. Without weights it serves a model drawn from a seed, as the JAX
runtime does without a checkpoint, or a local HF checkpoint
(``LlamaRuntime.from_hf``; ``KAKVEDA_HF_CKPT`` / ``KAKVEDA_HF_DIR`` in
``from_env``). While ``DeviceHealth`` is latched DEGRADED, every generation
entry point fails fast with ``DeviceUnavailableError``. ``KAKVEDA_SPEC=1``
makes ``generate`` the solo speculative path
(``models/speculative.generate_tokens_speculative``: token-identical to
greedy decoding, 1..k+1 tokens a forward), and ``KAKVEDA_SERVE_SPEC=k``
makes the engine's chunks verify chunks.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import time
from typing import List, Optional

import numpy as np
import torch

from kakveda_tpu_torch.core import sanitize
from kakveda_tpu_torch.core import profiling
from kakveda_tpu_torch.core.admission import get_device_health
from kakveda_tpu_torch.models.llama import (
    LlamaConfig,
    Params,
    decode_step,
    init_cache,
    init_params,
    mask_pad_vocab,
)
from kakveda_tpu_torch.models.quant import quantize_params_int8
from kakveda_tpu_torch.models.runtime import GenerateResult
from kakveda_tpu_torch.models.tokenizer import ByteTokenizer
from kakveda_tpu_torch.ops.device import resolve_device
from kakveda_tpu_torch.ops.knn import pow2_bucket


def _last_logits(logits: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """[B, S, V] -> [B, V] of the final position, padded vocab masked."""
    return mask_pad_vocab(logits[:, -1, :], cfg)


def _sample(last: torch.Tensor, temperature: float, generator, top_p: float = 1.0) -> torch.Tensor:
    """[B] next ids: argmax (first maximum) at temperature 0, else a draw
    from softmax(last / temperature), from its nucleus when top_p < 1."""
    if temperature <= 0.0:
        return last.argmax(dim=-1)
    if top_p < 1.0:
        return _sample_top_p(last, temperature, top_p, generator)
    return torch.multinomial(torch.softmax(last / temperature, dim=-1), 1, generator=generator)[:, 0]


def top_p_keep(last: torch.Tensor, temperature: float, top_p: float) -> torch.Tensor:
    """[B, V] bool: the nucleus of ``softmax(last / temperature)``. A token
    is kept when the probability mass sorted before it is ``< top_p``, so
    the most likely token always is; every token whose scaled logit ties
    the cutoff's is kept with it, so the set does not depend on how a sort
    orders equal values. The mass is summed in float64: an f32 cumulative
    sum over a 128,256-token vocabulary moves between the card's scan and
    the CPU's by more than a boundary token's mass, and the set would
    depend on the device. The reference sums in f32, so at that vocabulary
    the two packages may disagree on the boundary token; at small ones the
    sets are equal. Called only for ``top_p < 1``: at 1 the sampler takes
    the full softmax, as the reference's ``generate_tokens`` does."""
    scaled = last / temperature
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.double(), dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
    inf = torch.tensor(float("inf"), device=last.device, dtype=scaled.dtype)
    cutoff = torch.where(keep_sorted, sorted_logits, inf).amin(dim=-1, keepdim=True)
    return scaled >= cutoff


def _sample_top_p(last: torch.Tensor, temperature: float, top_p: float, generator) -> torch.Tensor:
    """[B] nucleus draws: keep :func:`top_p_keep`, renormalize, sample from
    ``generator``. The reference's ``_sample_top_p`` on the device, with
    its kept set but for the boundary token at large vocabularies (see
    :func:`top_p_keep`); ``jax.random`` and ``torch.Generator`` draw
    different numbers, so the drawn token is held to that set, not to the
    reference's token."""
    scaled = last / temperature
    masked = torch.where(top_p_keep(last, temperature, top_p), scaled, float("-inf"))
    return torch.multinomial(torch.softmax(masked, dim=-1), 1, generator=generator)[:, 0]


def _prefill_width(plen: int, chunk: int) -> int:
    """Prompt-window width under chunked prefill: unchanged when the prompt
    fits one chunk (prefill then takes one piece), else the next chunk
    multiple. The one place the rounding lives: DecodeSession's pack width
    and the runtime's cache sizing agree on it."""
    if chunk <= 0 or plen <= chunk:
        return plen
    return -(-plen // chunk) * chunk


def _bucket_len(need: int, cap: int) -> int:
    """Power-of-two cache window ≥ need (floor 64, capped)."""
    return pow2_bucket(need, floor=64, cap=cap)


def _pack_prompts(prompts: List[List[int]], ml: int, plen: Optional[int] = None):
    """Left-pad a ragged prompt batch: (tokens [B, plen] int64, kv_valid
    [B, ml] bool, pos_offset [B] int64, plen) as numpy arrays. Sequence i's
    real tokens occupy columns [off_i, plen); its cache rows [off_i, …) are
    valid and its RoPE positions are slot − off_i. An explicit ``plen`` (≥
    the longest prompt) widens the left padding: chunked prefill rounds the
    prompt window to a chunk multiple with it."""
    plen = max(plen or 0, max(len(p) for p in prompts))
    toks = np.zeros((len(prompts), plen), np.int64)
    valid = np.zeros((len(prompts), ml), bool)
    offsets = np.zeros((len(prompts),), np.int64)
    for i, p in enumerate(prompts):
        off = plen - len(p)
        toks[i, off:] = p
        offsets[i] = off
        valid[i, off:] = True  # real prompt slots + all future decode slots
    return toks, valid, offsets, plen


def prefill(params: Params, cfg: LlamaConfig, prompt, cache, kv_valid, pos_offset, chunk: int = 0):
    """Prefill the cache for a left-padded prompt batch [B, P]; returns
    (last logits [B, V] vocab-masked, cache).

    ``chunk`` > 0 runs the prompt in pieces of ``chunk`` rows, each one
    ``decode_step`` over the shared cache, so piece k's attention runs at
    S = chunk from cache row k·chunk and its activations are O(chunk · d_ff)
    instead of O(P · d_ff). The width must be a chunk multiple (widen the
    left padding with ``_pack_prompts(..., plen=)``). Cached attention makes
    the chunked and the one-piece prefill the same function. Under Phi-3
    longrope each piece rotates with the regime of its row's whole prompt
    (``seq_total`` = width − left pad), as the one-piece prefill does."""
    width = prompt.shape[1]
    if chunk > 0 and width > chunk and width % chunk:
        raise ValueError(
            f"chunked prefill needs the prompt width ({width}) padded "
            f"to a multiple of chunk={chunk} (pack with plen=rounded)"
        )
    step = width if chunk <= 0 else chunk
    seq_total = None
    if step < width and cfg.rope_dim_factors_long:
        seq_total = width - pos_offset
    for s in range(0, width, step):
        logits, cache = decode_step(
            params, cfg, prompt[:, s : s + step], cache,
            kv_valid=kv_valid, pos_offset=pos_offset, last_only=True, seq_total=seq_total,
        )
    return _last_logits(logits, cfg), cache


def generate_tokens(
    params: Params,
    cfg: LlamaConfig,
    prompt_ids: List[int],
    *,
    max_new_tokens: int = 64,
    temperature: float = 0.0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    eos_id: Optional[int] = None,
    max_len: Optional[int] = None,
) -> List[int]:
    """Autoregressive decode of one prompt; returns only the new ids.
    ``temperature`` > 0 samples from ``generator``, from the nucleus of mass
    ``top_p`` when it is below 1."""
    dev = params["embed"].device
    ml = max_len or _bucket_len(len(prompt_ids) + max_new_tokens + 1, cfg.max_seq_len)
    cache = init_cache(cfg, batch=1, max_len=ml, device=dev)
    prompt = torch.tensor([prompt_ids], dtype=torch.long, device=dev)
    logits, cache = decode_step(params, cfg, prompt, cache, last_only=True)
    last = _last_logits(logits, cfg)
    out: List[int] = []
    for _ in range(max_new_tokens):
        nxt = _sample(last, temperature, generator, top_p)
        tok = int(nxt[0])
        if eos_id is not None and tok == eos_id:
            break
        out.append(tok)
        if len(prompt_ids) + len(out) >= ml:
            break
        logits, cache = decode_step(params, cfg, nxt[:, None], cache)
        last = _last_logits(logits, cfg)
    return out


class DecodeSession:
    """Resumable chunked generation over one left-padded prompt batch.

    The constructor prefills (in ``prefill_chunk`` pieces when > 0, the
    prompt window widened to a chunk multiple by ``_prefill_width``);
    ``step_chunk()`` runs the next ``chunk_steps`` decode steps and copies
    their tokens to the host once. Greedy tokens equal the JAX
    ``DecodeSession``'s; sampling draws from ``generator``."""

    def __init__(
        self,
        params: Params,
        cfg: LlamaConfig,
        prompts: List[List[int]],
        *,
        chunk_steps: int = 8,
        max_len: Optional[int] = None,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
        prefill_chunk: int = 0,
    ):
        if not prompts:
            raise ValueError("empty prompt batch")
        self.params, self.cfg = params, cfg
        self.chunk_steps = chunk_steps
        self.temperature = temperature
        self.generator = generator
        natural_plen = max(len(p) for p in prompts)
        # The chunk-multiple width can take up to chunk - 1 decode rows
        # from a window capped at max_seq_len.
        plen = _prefill_width(natural_plen, prefill_chunk)
        ml = max_len or cfg.max_seq_len
        if plen + 1 > ml:
            raise ValueError(
                f"longest prompt ({natural_plen}"
                + (f", padded to {plen} for prefill_chunk={prefill_chunk}" if plen != natural_plen else "")
                + f") leaves no room (max_len={ml})"
            )
        dev = params["embed"].device
        toks, valid, offsets, plen = _pack_prompts(prompts, ml, plen=plen)
        self.kv_valid = torch.from_numpy(valid).to(dev)
        self.pos_offset = torch.from_numpy(offsets).to(dev)
        cache = init_cache(cfg, batch=len(prompts), max_len=ml, device=dev)
        self._last, self._cache = prefill(
            params, cfg, torch.from_numpy(toks).to(dev), cache, self.kv_valid, self.pos_offset,
            chunk=prefill_chunk,
        )
        self._pos = plen
        self._max_len = ml

    @property
    def steps_left(self) -> int:
        return max(0, self._max_len - 1 - self._pos)

    def step_chunk(self, n: Optional[int] = None) -> Optional[np.ndarray]:
        """Run the next min(n, steps_left) decode steps; returns the sampled
        tokens [B, steps] as a numpy array (None when the window is used up)."""
        steps = min(n or self.chunk_steps, self.steps_left)
        if steps <= 0:
            return None
        last = self._last
        toks = torch.empty((last.shape[0], steps), dtype=torch.long, device=last.device)
        for t in range(steps):
            nxt = _sample(last, self.temperature, self.generator)
            toks[:, t] = nxt
            logits, self._cache = decode_step(
                self.params, self.cfg, nxt[:, None], self._cache,
                kv_valid=self.kv_valid, pos_offset=self.pos_offset,
            )
            last = _last_logits(logits, self.cfg)
        self._last = last
        self._pos += steps
        return toks.cpu().numpy()


class LlamaRuntime:
    """On-device Llama generation with the shared ``GenerateResult`` meta
    shape. Runs on the card unless ``device`` names another. The card
    serves any dtype and head_dim the CPU port takes, each layer's
    attention where ``models/attention.card_path`` sends it: bf16 at
    head_dim 32, 64, 96, 128 or 256 and f32 at 64 or 128 through the flash
    kernel's bodies, anything else (f16, head_dim 80, an f32 model over an
    int8 cache) through ``gqa_grouped``, as the JAX package takes
    ``_gqa_xla`` there.
    ``quant="int8"`` serves int8 weight-only weights
    (``models/quant.py``): drawn from the seed, each matrix is quantized as
    it is drawn, so no bf16 copy of the model ever exists; given ``params``,
    they are quantized unless they already are."""

    name = "torch"

    def __init__(
        self,
        cfg: Optional[LlamaConfig] = None,
        params: Optional[Params] = None,
        seed: int = 0,
        tokenizer=None,
        model_label: Optional[str] = None,
        quant: Optional[str] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg or LlamaConfig.tiny()
        self.tokenizer = tokenizer if tokenizer is not None else ByteTokenizer()
        if self.cfg.vocab_size < self.tokenizer.vocab_size:
            raise ValueError("model vocab smaller than tokenizer vocab")
        if quant not in (None, "none", "int8"):
            raise ValueError(f"unknown quant mode {quant!r} (int8|none)")
        kvq = os.environ.get("KAKVEDA_KV_QUANT", "")
        if kvq and kvq != "none":
            if kvq != "int8":
                raise ValueError(f"unknown KAKVEDA_KV_QUANT={kvq!r} (int8|none)")
            self.cfg = dataclasses.replace(self.cfg, kv_quant="int8")
        if self.cfg.effective_vocab is None and self.tokenizer.vocab_size < self.cfg.vocab_size:
            # A table padded past the tokenizer: mask the pad columns so no
            # decode path can emit an id the tokenizer cannot decode.
            self.cfg = dataclasses.replace(self.cfg, effective_vocab=self.tokenizer.vocab_size)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, self.cfg, self.device, quant=quant)
        elif quant == "int8":
            params = quantize_params_int8(params)
        self.params = params
        self.quant = quant
        self.model_label = model_label or f"llama-{self.cfg.n_layers}L-{self.cfg.d_model}d"
        self._engine = None
        self._engine_lock = sanitize.named_lock("LlamaRuntime._engine_lock")
        self._retired = False

    @classmethod
    def from_env(cls, device=None) -> "LlamaRuntime":
        """``KAKVEDA_HF_CKPT`` (or its alias ``KAKVEDA_HF_DIR``; the first
        wins when both are set) serves that local HF checkpoint
        (:meth:`from_hf`); else ``KAKVEDA_LLAMA_PRESET`` (``tiny`` or
        ``8b``) with random weights. ``KAKVEDA_QUANT`` (``int8`` or
        ``none``), ``KAKVEDA_KV_QUANT`` and the ``KAKVEDA_SERVE_*`` engine
        knobs as the JAX runtime reads them. ``KAKVEDA_LLAMA_CKPT`` (an
        orbax checkpoint, a JAX format) raises."""
        quant = os.environ.get("KAKVEDA_QUANT") or None
        if quant not in (None, "none", "int8"):
            raise ValueError(f"unknown KAKVEDA_QUANT={quant!r} (int8|none)")
        hf_ckpt = os.environ.get("KAKVEDA_HF_CKPT") or os.environ.get("KAKVEDA_HF_DIR")
        if hf_ckpt:
            return cls.from_hf(hf_ckpt, quant=quant, device=device)
        if os.environ.get("KAKVEDA_LLAMA_CKPT"):
            raise NotImplementedError(
                "KAKVEDA_LLAMA_CKPT: orbax checkpoints are a JAX format; serve an HF checkpoint "
                "with KAKVEDA_HF_CKPT"
            )
        preset = os.environ.get("KAKVEDA_LLAMA_PRESET", "tiny").lower()
        cfg = LlamaConfig.llama3_8b() if preset in ("8b", "llama3-8b") else LlamaConfig.tiny()
        return cls(cfg=cfg, quant=quant, device=device)

    @classmethod
    def from_hf(cls, path: str, *, quant: Optional[str] = None, device=None) -> "LlamaRuntime":
        """Serve a local HF checkpoint directory (weights, ``config.json``
        and tokenizer files): ``hf_convert.load_hf_checkpoint`` onto
        ``device`` (the card unless named), an ``HFTokenizer`` from the same
        directory (the port's own ``tokenizer.json`` reader: no
        ``transformers`` needed), labelled by the directory's name.
        ``quant="int8"`` quantizes the loaded weights."""
        from kakveda_tpu_torch.models.hf_convert import load_hf_checkpoint
        from kakveda_tpu_torch.models.tokenizer import HFTokenizer

        if quant not in (None, "none", "int8"):
            raise ValueError(f"unknown quant mode {quant!r} (int8|none)")
        params, cfg = load_hf_checkpoint(path, device=device)
        if quant == "int8":
            params = quantize_params_int8(params)
        tok = HFTokenizer(path)
        label = os.path.basename(os.path.normpath(path))
        rt = cls(cfg=cfg, params=params, tokenizer=tok, model_label=label, device=device)
        rt.quant = "int8" if quant == "int8" else None
        return rt

    def engine(self):
        """The shared online ServingEngine, built at first use, or None when
        ``KAKVEDA_SERVE_CONTINUOUS=0`` or the runtime is retired.
        ``KAKVEDA_SERVE_SLOTS`` / ``_WINDOW`` / ``_CHUNK`` size the pool (8
        slots, window min(512, max_seq_len), chunk 8)."""
        if os.environ.get("KAKVEDA_SERVE_CONTINUOUS", "1") == "0" or self._retired:
            return None
        with self._engine_lock:
            if self._engine is None and not self._retired:
                from kakveda_tpu_torch.models.serving import ServingEngine

                window = int(os.environ.get("KAKVEDA_SERVE_WINDOW", min(512, self.cfg.max_seq_len)))
                self._engine = ServingEngine(
                    self.params, self.cfg,
                    batch_slots=int(os.environ.get("KAKVEDA_SERVE_SLOTS", "8")),
                    max_len=min(window, self.cfg.max_seq_len),
                    chunk_steps=int(os.environ.get("KAKVEDA_SERVE_CHUNK", "8")),
                    eos_id=self.tokenizer.EOS,
                    name=self.model_label,
                )
            return self._engine

    def close(self) -> None:
        """Stop the engine's loop thread (pending requests fail); the next
        request builds a new one."""
        with self._engine_lock:
            if self._engine is not None:
                self._engine.close()
                self._engine = None

    def retire(self) -> None:
        """Stop the engine and bar rebuilding it: later requests take the
        solo path."""
        with self._engine_lock:
            self._retired = True
            if self._engine is not None:
                self._engine.close()
                self._engine = None

    def serving_stats(self) -> dict:
        """The engine pool's state for an operator (``ServingEngine.stats``
        plus occupancy, size and window), without building an engine:
        looking must not allocate a KV pool. ``engine`` is None before the
        first request."""
        eng = self._engine
        stats = None
        if eng is not None:
            stats = {
                **eng.stats(),
                "active": eng.cb.active,
                "slots": eng.cb.B,
                "window": eng.cb.max_len,
                "closed": eng._closed.is_set(),
            }
            if not eng.cb.spec_k:
                stats["spec"] = None
        return {
            "runtime": self.name,
            "model": self.model_label,
            "quant": self.quant or "none",
            "kv_quant": self.cfg.kv_quant or "none",
            "retired": self._retired,
            "engine": stats,
        }

    def _encode(self, prompt: str) -> List[int]:
        return self.tokenizer.encode(prompt)[-self.cfg.max_seq_len // 2 :]

    def list_models(self) -> list:
        return [self.model_label]

    def register_prefix(self, prefix: str) -> bool:
        """Precompute a shared prompt head (a judge template, a system
        preamble) on the engine, so later requests that start with it
        prefill only their suffix. False when the engine is off, closed, or
        refuses the prefix (``ContinuousBatcher.register_prefix``)."""
        eng = self.engine()
        if eng is None:
            return False
        try:
            return eng.register_prefix(self.tokenizer.encode(prefix))
        except (RuntimeError, TimeoutError):
            return False  # engine closed or a registration that timed out

    def _generate_ids_chunked(self, ids: List[List[int]], max_tokens: int) -> List[List[int]]:
        """The solo path: greedy decode of the whole list in one
        :class:`DecodeSession` (16 steps a chunk, EOS checked between
        chunks), prefilled in ``KAKVEDA_PREFILL_CHUNK`` pieces when set."""
        plen = max(len(p) for p in ids)
        pchunk = int(os.environ.get("KAKVEDA_PREFILL_CHUNK", "0"))
        plen = _prefill_width(plen, pchunk)
        ml = _bucket_len(plen + max_tokens + 1, self.cfg.max_seq_len)
        sess = DecodeSession(self.params, self.cfg, ids, chunk_steps=16, max_len=ml, prefill_chunk=pchunk)
        eos = self.tokenizer.EOS
        outs: List[List[int]] = [[] for _ in ids]
        done = [False] * len(ids)
        budget = min(max_tokens, sess.steps_left)
        while budget > 0 and not all(done):
            chunk = sess.step_chunk(min(16, budget))
            if chunk is None:
                break
            budget -= chunk.shape[1]
            for i, row in enumerate(chunk.tolist()):
                for t in row:
                    if done[i]:
                        break
                    if t == eos:
                        done[i] = True
                    elif len(outs[i]) < max_tokens:
                        outs[i].append(t)
        return outs

    def _generate_ids(self, ids: List[List[int]], max_tokens: int, span: str):
        """Token lists for ``ids``: through the engine when every request
        fits its window, else (or when the engine closed meanwhile) the solo
        path. A batch of two or more first registers its common token head
        of 16 or more as a prefix, best-effort. The engine's wait is the
        profiler range ``<span>_online``, the solo path's ``<span>``.
        Returns (ids, meta extras)."""
        eng = self.engine()
        if eng is not None and all(eng.fits(len(i), max_tokens) for i in ids):
            try:
                if len(ids) >= 2:
                    common = os.path.commonprefix(ids)
                    if len(common) >= 16:
                        try:
                            eng.register_prefix(list(common))
                        except (RuntimeError, TimeoutError):
                            pass  # an optimization only: the batch still runs
                with profiling.annotate(f"{span}_online"):
                    futs = [eng.submit(i, max_new_tokens=max_tokens) for i in ids]
                    outs = [f.result() for f in futs]
                extra = {"continuous": True}
                tl = getattr(futs[0], "timeline", None)
                if len(futs) == 1 and tl is not None:
                    extra["serve"] = tl  # queue wait, prefill, TTFT, tokens/s
                return outs, extra
            except RuntimeError:
                pass  # engine closed or died between fits() and the results
        with profiling.annotate(span):
            return self._generate_ids_chunked(ids, max_tokens), {}

    def generate(self, prompt: str, *, model: Optional[str] = None, max_tokens: int = 64) -> GenerateResult:
        """One completion: through the engine (or the solo path), or with
        ``KAKVEDA_SPEC=1`` the solo speculative path, whose meta carries
        ``speculative`` and ``tokens_per_round``. Its text equals the
        others'; the whole generation runs on this thread, beside the
        engine's chunks, not inside them."""
        started = time.perf_counter()
        get_device_health().check()  # degraded: fail fast, never dispatch
        if os.environ.get("KAKVEDA_SPEC", "") == "1":
            from kakveda_tpu_torch.models.speculative import generate_tokens_speculative

            with profiling.annotate("llama.generate_spec"):
                new_ids, stats = generate_tokens_speculative(
                    self.params, self.cfg, self._encode(prompt), max_new_tokens=max_tokens,
                    eos_id=self.tokenizer.EOS, return_stats=True,
                )
            extra = {"speculative": True, "tokens_per_round": round(stats["tokens_per_round"], 2)}
        else:
            (new_ids,), extra = self._generate_ids([self._encode(prompt)], max_tokens, "llama.generate")
        return GenerateResult(
            text=self.tokenizer.decode(new_ids),
            meta={
                "provider": self.name,
                "model": model or self.model_label,
                "latency_ms": int((time.perf_counter() - started) * 1000),
                "tokens_generated": len(new_ids),
                **extra,
            },
        )

    def generate_stream(
        self, prompt: str, *, model: Optional[str] = None, max_tokens: int = 64, cancel=None,
    ):
        """Text deltas as decode chunks land; joined, they equal
        :meth:`generate`'s text.

        Through the engine, each chunk's accepted tokens arrive by
        ``on_tokens`` on the engine's loop thread, which only puts them in
        a queue (a consumer that blocks must not stall every slot); when
        the engine is off or the request does not fit, a solo
        :class:`DecodeSession` yields one delta per chunk. A partial UTF-8
        tail is held back until its bytes complete. ``cancel`` (a
        ``threading.Event``) is read between deltas, also before the first
        (a request still waiting for a slot cancels at once); closing the
        generator does the same. Either frees the engine slot."""
        get_device_health().check()  # degraded: fail fast, never dispatch
        ids = self._encode(prompt)

        def delta(all_ids: list, done: bool, prev: str):
            text = self.tokenizer.decode(all_ids)
            if not done:
                text = text.rstrip("\ufffd")  # a partial multi-byte tail
            if text.startswith(prev) and len(text) > len(prev):
                return text[len(prev):], text
            return "", prev

        eng = self.engine()
        if eng is not None and eng.fits(len(ids), max_tokens):
            ch: "queue.Queue" = queue.Queue()
            try:
                fut = eng.submit(ids, max_tokens, on_tokens=lambda new, done: ch.put((list(new), done)))
            except RuntimeError:
                fut = None  # engine closed or dead: the solo path below
            if fut is not None:
                out: list = []
                prev = ""
                try:
                    while True:
                        try:
                            new, done = ch.get(timeout=0.5)
                        except queue.Empty:
                            if cancel is not None and cancel.is_set():
                                break
                            if fut.done():  # the request failed or was cancelled
                                fut.result()
                                break
                            continue
                        out.extend(new)
                        d, prev = delta(out, done, prev)
                        if d:
                            yield d
                        if done:
                            break
                finally:
                    # Abandoned (cancel, or close() raising GeneratorExit
                    # at the yield): free the slot instead of decoding a
                    # result nobody reads.
                    if not fut.done():
                        eng.cancel(fut)
                return

        pchunk = int(os.environ.get("KAKVEDA_PREFILL_CHUNK", "0"))
        ml = _bucket_len(_prefill_width(len(ids), pchunk) + max_tokens + 1, self.cfg.max_seq_len)
        sess = DecodeSession(self.params, self.cfg, [ids], chunk_steps=16, max_len=ml, prefill_chunk=pchunk)
        eos = self.tokenizer.EOS
        out = []
        prev = ""
        budget = min(max_tokens, sess.steps_left)
        done = False
        while budget > 0 and not done:
            if cancel is not None and cancel.is_set():
                break
            chunk = sess.step_chunk(min(16, budget))
            if chunk is None:
                break
            budget -= chunk.shape[1]
            for t in chunk[0].tolist():
                if t == eos or len(out) >= max_tokens:
                    done = True
                    break
                out.append(t)
            d, prev = delta(out, done or budget <= 0, prev)
            if d:
                yield d

    def generate_batch(self, prompts: list, *, model: Optional[str] = None, max_tokens: int = 64) -> list:
        """Batched generation: the whole list joins the shared slot pool, with
        exact per-sequence parity with :meth:`generate`."""
        started = time.perf_counter()
        # Device-loss fail-fast: while the card is latched DEGRADED every
        # decode path (engine and solo) would dispatch into a dead card;
        # raise the typed retryable error at once instead.
        get_device_health().check()
        if not prompts:
            return []
        new_ids, extra = self._generate_ids([self._encode(p) for p in prompts], max_tokens, "llama.generate_batch")
        latency_ms = int((time.perf_counter() - started) * 1000)
        label = model or self.model_label
        return [
            GenerateResult(
                text=self.tokenizer.decode(out),
                meta={
                    "provider": self.name,
                    "model": label,
                    "latency_ms": latency_ms,
                    "tokens_generated": len(out),
                    "batched": len(prompts),
                    **extra,
                },
            )
            for out in new_ids
        ]
