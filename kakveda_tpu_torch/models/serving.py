"""Continuous batching — the online serving path.

Counterpart of ``kakveda_tpu/models/serving.py``: its core, the prefix
cache, the request lifecycle (streaming, cancel, deadlines), the
supervisor, the weighted-fair slot pick and speculative verify chunks
(``spec_k`` / ``KAKVEDA_SERVE_SPEC``: host prompt-lookup drafts, per-slot
draft lengths, the acceptance gate, pipelined verify chunks whose
positions stay on the card), reporting to the metrics plane
(``core/metrics.py``). Not ported yet (ROADMAP): the brownout ladder's
class shed, token cap and speculation veto, and the ledger and trace
hooks.

A :class:`ContinuousBatcher` owns a fixed ``[B, KV, max_len, D]`` KV cache
and treats the batch axis as B independent slots:

* **admit** prefills one prompt, left-padded to a power-of-two bucket, into
  a ``[1, ...]`` scratch cache (so its attention sees only this prompt) and
  copies the rows into its slot, in place. A prompt that starts with a
  registered prefix (:meth:`ContinuousBatcher.register_prefix`) gets the
  prefix's K/V slab in its scratch and prefills only a power-of-two tail;
* **step** advances every active slot by ``chunk_steps`` tokens, one
  :func:`_forward_wide` per token with per-slot positions; inactive slots
  decode garbage into their own rows, masked from everyone by ``kv_valid``.
  In a speculating greedy pool a step is one verify chunk
  (:func:`_spec_chunk`): :func:`_forward_wide` over k+1 tokens a slot, the
  flash kernel reading each slot's position from the card;
* **retire** frees EOS- or budget-finished slots on the host between
  chunks, and :meth:`ContinuousBatcher.cancel_request` frees a cancelled
  or expired one.

Greedy outputs are slot-for-slot identical to a solo ``generate_tokens``.
Everything runs eagerly on one CUDA stream: a chunk is enqueued without
waiting for the card (host mirrors go up through pinned memory), and only
:meth:`ContinuousBatcher.process_chunk` copies its tokens back, so the
engine can enqueue chunk i+1 before it reads chunk i.

:class:`ServingEngine` puts one batcher behind a thread-safe ``submit`` →
``Future`` API: one loop thread admits, steps and retires for every caller,
under a supervisor that rebuilds the batcher after a crash.
"""

from __future__ import annotations

import copy
import logging
import os
import queue
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kakveda_tpu_torch.core import admission as _admission
from kakveda_tpu_torch.core import faults as _faults
from kakveda_tpu_torch.core import metrics as _metrics
from kakveda_tpu_torch.core.admission import get_device_health
from kakveda_tpu_torch.models.attention import gqa_cache_attention
from kakveda_tpu_torch.models.llama import (
    LlamaConfig,
    Params,
    _kv_quant_rows,
    _rope_freqs,
    apply_rope,
    attn_residual,
    decode_step,
    embed_tokens,
    init_cache,
    mask_pad_vocab,
    qkv_proj,
    rms_norm,
    softcap_logits,
    wmat,
)
from kakveda_tpu_torch.models.speculative import NgramIndex, copy_run
from kakveda_tpu_torch.ops.knn import pow2_bucket

log = logging.getLogger("kakveda.serving")

_GATE_STATES = ("disabled", "warmup", "on", "off")


class EngineRetryableError(RuntimeError):
    """An in-flight request was lost to a loop death; the supervisor is
    rebuilding the engine, so resubmitting is safe (no tokens reached the
    Future). A RuntimeError, so the runtime's solo fallback takes it."""


class EngineDeadError(RuntimeError):
    """The engine is dead for good: the restart budget
    (``KAKVEDA_SERVE_RESTARTS``) is spent, or a rebuild failed. ``submit``
    and ``register_prefix`` raise it at once."""


class DeadlineExceededError(RuntimeError):
    """A request's ``deadline_s`` passed before it completed; ``tokens``
    holds what was decoded (empty when it expired while queued)."""

    def __init__(self, message: str, tokens: Optional[List[int]] = None):
        super().__init__(message)
        self.tokens: List[int] = list(tokens or [])


def _h2d(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of a host array on ``device`` that does not wait for the card:
    staged through pinned memory and copied on the current stream. A copy,
    because the host mirrors keep changing while queued work reads it."""
    t = torch.from_numpy(np.array(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _d2h_async(t: torch.Tensor):
    """Start copying a device tensor to the host without waiting: into
    pinned memory on the current stream, with an event to wait on (a CPU
    tensor is its own copy). :func:`_host` finishes it. A pipelined engine
    reads chunk i's tokens while chunk i+1 still runs."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _host(pending) -> np.ndarray:
    """The numpy array of a :func:`_d2h_async` copy, once it has landed."""
    host, ev = pending
    if ev is not None:
        ev.synchronize()
    return host.numpy()


def _forward_wide(
    params: Params,
    cfg: LlamaConfig,
    cache: Params,
    tokens: torch.Tensor,  # [B, S]
    slot_pos: torch.Tensor,  # [B] cache row each slot's first token writes
    kv_valid: torch.Tensor,  # [B, L] bool
    pos_offset: torch.Tensor,  # [B]
    reach: Optional[int] = None,  # host int: one past the last row a query of an active slot sees
) -> torch.Tensor:
    """The serving forward, S tokens for every slot with PER-SLOT positions:
    token i of slot b writes cache row ``slot_pos[b] + i`` (in place) and
    attends rows ``col <= slot_pos[b] + i`` within ``kv_valid`` (and the
    sliding-window band). ``reach`` tells the kernel's schedule which rows
    the mask can show (a hint, exact either way). The family flags apply as
    in ``decode_step``: each layer takes the window band only when
    ``cfg.layer_window`` gives it one (Gemma-2's even layers), and the
    sandwich norms through ``attn_residual``. Returns logits [B, S, V] f32,
    vocab-masked.

    One path for the decode step (S = 1) and the speculative verify chunk
    (S = k+1, whose positions may live on the card): ``slot_pos`` goes to
    the flash kernel as its per-row ``pos0`` with the raw ``kv_valid`` and
    the layer's window, the mask the JAX package builds as a ``[B, S, L]``
    ``full_mask`` (and, at S = 1, as a ``[B, L]`` mask), with no mask in
    memory. Rows past the window are dropped, as the JAX scatter's
    ``mode="drop"``, with no host sync: such a row is redirected, with the
    value of the slot's first row, to the row that first write takes
    (``slot_pos[b]``, or the last row of a slot whose position passed the
    window: a retired or idle slot, whose rows no emitted token reads and
    admission rewrites)."""
    b, s = tokens.shape
    max_len = cache["k"][0].shape[2]
    kq = cfg.kv_quant == "int8"
    dev = tokens.device

    ar = torch.arange(s, device=dev)
    cos, sin = _rope_freqs(cfg, slot_pos[:, None] + ar[None, :] - pos_offset[:, None])
    x = embed_tokens(params, cfg, tokens)
    wc = slot_pos[:, None] + ar[None, :]  # [B, S]
    inside = wc < max_len
    wcols = torch.where(inside, wc, slot_pos.clamp(max=max_len - 1)[:, None])
    rows = torch.arange(b, device=dev)[:, None].expand(b, s)
    keep = inside[:, :, None, None]
    pos_vec = slot_pos.to(torch.int32)

    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        dt = h.dtype
        q, k, v = qkv_proj(h, layer, cfg, dt)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)  # [B, S, KV, D]
        k_new, v_new = k, v
        if s > 1:  # a dropped row carries row 0's value to row 0's target (at S = 1 no two share one)
            k_new = torch.where(keep, k, k[:, :1])
            v_new = torch.where(keep, v, v[:, :1])
        ks = vs = None
        if kq:
            # The same quantizer as decode_step: a slot's cache bytes equal
            # its solo decode's.
            k_i8, k_sc = _kv_quant_rows(k_new)
            v_i8, v_sc = _kv_quant_rows(v_new)
            cache["k"][li][rows, :, wcols] = k_i8
            cache["v"][li][rows, :, wcols] = v_i8
            cache["ks"][li][rows, :, wcols] = k_sc
            cache["vs"][li][rows, :, wcols] = v_sc
            ks, vs = cache["ks"][li], cache["vs"][li]
        else:
            cache["k"][li][rows, :, wcols] = k_new.to(cfg.dtype)
            cache["v"][li][rows, :, wcols] = v_new.to(cfg.dtype)
        attn = gqa_cache_attention(
            q, cache["k"][li], cache["v"][li], pos_vec, kv_valid, window=cfg.layer_window(li),
            softcap=cfg.attn_softcap, k_scale=ks, v_scale=vs, reach=reach,
        )
        x = attn_residual(x, attn, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ wmat(params["lm_head"], cfg.dtype)).float()
    logits = softcap_logits(logits, cfg.final_softcap)
    return mask_pad_vocab(logits, cfg)


def _spec_chunk(
    params: Params,
    cfg: LlamaConfig,
    cache: Params,
    last: torch.Tensor,  # [B, V] logits after each slot's last emitted token
    slot_pos: torch.Tensor,  # [B] next cache row of each slot
    kv_valid: torch.Tensor,
    pos_offset: torch.Tensor,
    drafts: torch.Tensor,  # [B, k] host prompt-lookup guesses after t0
    reach: Optional[int] = None,
):
    """The speculative verify chunk (``_spec_chunk_jit``): every slot
    advances 1..k+1 greedy tokens in one :func:`_forward_wide` over k+1
    positions. ``t0 = argmax(last)`` is committed on the card, so each chunk
    emits at least one token; the accepted drafts are the run that equals
    its own greedy verdicts. Rows written past the accepted point hold K/V
    of rejected tokens: no query reads them (each sees only rows up to its
    own position) and real decoding overwrites them. Decode is bound by the
    weight stream, which the k+1-wide forward reads once, as a 1-wide step
    does. Nothing here waits for the card. Returns (new last [B, V], the
    slots' positions after acceptance [B], tokens [B, k+1], counts [B]):
    the host emits ``tokens[b, :counts[b]]``."""
    t0 = last.argmax(dim=-1)
    tokens = torch.cat([t0[:, None], drafts], dim=1)  # [B, k+1]
    logits = _forward_wide(params, cfg, cache, tokens, slot_pos, kv_valid, pos_offset, reach=reach)
    greedy = logits.argmax(dim=-1)  # [B, k+1]; [b, i] follows tokens[b, :i+1]
    m_acc = torch.cumprod((drafts == greedy[:, :-1]).long(), dim=1).sum(dim=1)  # accepted drafts
    counts = m_acc + 1  # t0 and the accepted drafts
    new_last = logits.gather(1, m_acc[:, None, None].expand(-1, 1, logits.shape[-1]))[:, 0]
    return new_last, slot_pos + counts, tokens, counts


@dataclass
class _Prefix:
    """One registered prompt prefix: its token ids and per-layer K/V slabs
    ``[1, KV, plen, D]`` (int8 with f32 scales ``[1, KV, plen]`` under an
    int8 cache), and in a speculating pool an n-gram index over the ids, so
    a slot can draft a template's continuation before its own history
    holds it."""

    ids: Tuple[int, ...]
    kv: Dict[str, List[torch.Tensor]]
    index: Optional[NgramIndex] = None


@dataclass
class _Slot:
    req_id: int
    prompt_len: int
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False
    on_tokens: Optional[Callable[[List[int], bool], None]] = None
    # Speculation (spec_k > 0): the prompt ids (prompt + out is the draft
    # corpus), its suffix index (built at the first draft), the slot's
    # adaptive draft length in [1, spec_k], the acceptance EMA behind it,
    # and the pipelined copy cursor (corpus, next index, period, frozen
    # length): the head of the predicted continuation, alive only while
    # every processed chunk matched its own prediction.
    prompt_ids: List[int] = field(default_factory=list)
    index: Optional[NgramIndex] = None
    k: int = 0
    accept_ema: float = 0.0
    spec_cursor: Optional[Tuple] = None


class ContinuousBatcher:
    """Admit-as-you-go generation over a fixed slot pool. Greedy by
    default; a request's ``temperature`` samples that slot only.

    ``name`` labels its metric children (``kakveda_serving_*{engine=…}``,
    resolved once here, so a per-chunk update is a lock and an add);
    ``recorder`` is its engine's flight recorder.

    ``spec_k > 0`` speculates (the reference's engine speculation): a greedy
    pool's chunk is a verify chunk (:meth:`step_spec_async`) of k+1 tokens
    a slot, k of them host prompt-lookup drafts, which emits 1..k+1 tokens a
    slot for one forward. Each slot adapts its own draft length; an
    acceptance gate (:meth:`_gate_eval`) turns speculation off for a pool
    whose tokens per verify do not pay for the verify chunk's wall against
    the plain chunk's per-token wall (``KAKVEDA_SERVE_SPEC_WARMUP`` chunks
    of warm-up, the first ``KAKVEDA_SERVE_SPEC_CALIB`` chunks plain to
    measure that wall, ``KAKVEDA_SERVE_SPEC_BREAKEVEN`` as the prior before
    there is one, a re-probe after ``KAKVEDA_SERVE_SPEC_REPROBE`` plain
    chunks); a pool with a sampled slot decodes plain. ``spec_stats`` and
    the ``kakveda_serving_spec_*`` families report it."""

    def __init__(
        self,
        params: Params,
        cfg: LlamaConfig,
        *,
        batch_slots: int = 8,
        max_len: int = 512,
        chunk_steps: int = 8,
        eos_id: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        spec_k: int = 0,
        name: str = "default",
        recorder: Optional[_metrics.FlightRecorder] = None,
    ):
        self.params, self.cfg = params, cfg
        self.device = params["embed"].device
        self.B, self.max_len = batch_slots, max_len
        self.chunk_steps = chunk_steps
        self.spec_k = spec_k
        self.eos_id = eos_id
        self.generator = generator
        self.name = name
        self.recorder = recorder
        # The loop thread mutates the stats while readers take snapshots:
        # every mutation holds stats_lock (re-entrant: the gate transition
        # nests in locked sections), and readers go through stats_snapshot
        # / ServingEngine.stats.
        self.stats_lock = threading.RLock()
        self.spec_stats = {
            "chunks": 0, "emitted": 0, "slot_chunks": 0,
            "drafted": 0, "accepted": 0,
            "gate_state": "warmup" if spec_k else "disabled",
            "tokens_per_verify": 0.0,
            "break_even": 0.0,
            "k_trace": [],  # the pool's verify width per chunk, the last 64
        }
        reg = _metrics.get_registry()
        self._gate_gauge = reg.gauge(
            "kakveda_serving_spec_gate_state",
            "1 for the pool's current speculation gate state "
            "(disabled|warmup|on|off)", ("engine", "state"),
        )
        self._gate_transitions = reg.counter(
            "kakveda_serving_gate_transitions_total",
            "Speculation auto-gate state transitions", ("engine", "from", "to"),
        )
        for gs in _GATE_STATES:
            self._gate_gauge.labels(engine=name, state=gs).set(1.0 if gs == self.spec_stats["gate_state"] else 0.0)
        chunk_hist = reg.histogram(
            "kakveda_serving_chunk_seconds",
            "Effective decode-chunk wall (dispatch to process, overlapped "
            "under pipelining)", ("engine", "flavor"),
        )
        prefix_ctr = reg.counter(
            "kakveda_serving_prefix_requests_total",
            "Admissions by prefix-cache result", ("engine", "result"),
        )
        self._mx = {
            "chunk_plain": chunk_hist.labels(engine=name, flavor="plain"),
            "chunk_spec": chunk_hist.labels(engine=name, flavor="spec"),
            "tokens": reg.counter(
                "kakveda_serving_tokens_total", "Decode tokens emitted to callers", ("engine",),
            ).labels(engine=name),
            "drafted": reg.counter(
                "kakveda_serving_spec_drafted_total",
                "Speculative draft tokens sent to verify chunks", ("engine",),
            ).labels(engine=name),
            "accepted": reg.counter(
                "kakveda_serving_spec_accepted_total",
                "Speculative draft tokens accepted by verify chunks", ("engine",),
            ).labels(engine=name),
            "prefix_hit": prefix_ctr.labels(engine=name, result="hit"),
            "prefix_miss": prefix_ctr.labels(engine=name, result="miss"),
            "active": reg.gauge(
                "kakveda_serving_active_slots",
                "Occupied slots in the continuous-batching pool", ("engine",),
            ).labels(engine=name),
            "spec_k": reg.gauge(
                "kakveda_serving_spec_k",
                "Pool verify width of the most recent speculative chunk", ("engine",),
            ).labels(engine=name),
        }
        reg.gauge(
            "kakveda_serving_slots", "Total slots in the continuous-batching pool", ("engine",),
        ).labels(engine=name).set(batch_slots)
        self._last_k_rec = 0
        # The gate's inputs: recent chunk walls of each flavor (medians, so
        # one slow chunk cannot flip it), recent per-slot emitted counts,
        # and the knobs. A wall runs on the host clock from the chunk's
        # dispatch to the loop's next move: the next dispatch or admission,
        # or the end of the chunk's own processing when that comes first
        # (_wall_open, _wall_close). For both flavors alike it is the
        # loop's period per chunk, the cost a chunk adds. (Dispatch to
        # process, the reference's wall, holds the next chunk's dispatch
        # too under pipelining, a plain chunk's always and a verify chunk's
        # only while its chain is alive: on a host-bound card it doubled
        # the plain wall and halved the break-even.) The first wall of each
        # program shape is dropped (the reference drops its compile). The
        # chunk histograms keep dispatch to process, as their help says.
        self._spec_walls: deque = deque(maxlen=16)
        self._plain_walls: deque = deque(maxlen=16)
        self._wall_cell: Optional[list] = None  # [dispatch, next move] of the last chunk dispatched
        self._tpv_recent: deque = deque(maxlen=32)
        self._gate_warmup = int(os.environ.get("KAKVEDA_SERVE_SPEC_WARMUP", "8"))
        self._gate_calib = int(os.environ.get("KAKVEDA_SERVE_SPEC_CALIB", "2"))
        self._gate_reprobe = int(os.environ.get("KAKVEDA_SERVE_SPEC_REPROBE", "256"))
        self._gate_prior = float(os.environ.get("KAKVEDA_SERVE_SPEC_BREAKEVEN", "1.35"))
        self._gate_spec_chunks = 0  # spec chunks since (re)entering warm-up
        self._gate_plain_since_off = 0
        self._gate_reprobes = 0
        self._spec_widths_warm: set = set()
        self._plain_warm = False
        # Pipelined speculation: the positions the last verify chunk left
        # on the card (the next dispatch reads them there, no host sync),
        # and the verify chunks in flight and their widths (the budget of
        # read validity). Valid only while no admission or plain chunk
        # comes between: both reset or refuse.
        self._spec_pos_dev: Optional[torch.Tensor] = None
        self._spec_pending = 0
        self._spec_pending_width = 0
        # Chaos sites (core/faults.py): dispatch fires before a chunk is
        # enqueued, fetch before a handle's tokens are read. Both escape to
        # the engine's supervisor, which rebuilds the batcher wholesale.
        self._fault_dispatch = _faults.site("engine.dispatch")
        self._fault_fetch = _faults.site("engine.fetch")
        self.cache = init_cache(cfg, batch=batch_slots, max_len=max_len, device=self.device)
        self.last = torch.full((batch_slots, cfg.vocab_size), -1e30, device=self.device)
        # Host mirrors of the per-slot bookkeeping, uploaded once per chunk.
        self._kv_np = np.zeros((batch_slots, max_len), bool)
        self._off_np = np.zeros((batch_slots,), np.int64)
        self._pos_np = np.zeros((batch_slots,), np.int64)
        self._temp_np = np.zeros((batch_slots,), np.float32)  # <= 0: greedy
        self.slots: Dict[int, _Slot] = {}
        self.free = list(range(batch_slots))
        self.results: Dict[int, List[int]] = {}
        self._next_id = 0
        # Forward passes run: one per admission, prefix registration, decode
        # step and verify chunk. Each runs every layer's attention once.
        self.forwards = 0
        # Registered prefixes, least recently used first.
        self._prefixes: Dict[Tuple[int, ...], _Prefix] = {}
        self.prefix_stats = {"registered": 0, "hits": 0, "hit_tokens_saved": 0}

    @staticmethod
    def bucket_for(prompt_len: int, max_len: int) -> int:
        """Admission pad width: power of two ≥ prompt (min 8), capped at the
        slot window. Shared by admit() and ServingEngine.fits()."""
        return pow2_bucket(prompt_len, floor=8, cap=max_len - 1)

    def register_prefix(self, prefix_ids: List[int]) -> bool:
        """Prefill a shared prompt prefix once and keep its K/V rows, so that
        later admissions of prompts that start with it prefill only their
        suffix. Refused (False) when shorter than 8 tokens, when len + 9
        reaches the slot window, and under longrope (whose rotation depends
        on the whole prompt's length); registering a held prefix again is a
        no-op (True). ``KAKVEDA_SERVE_PREFIX_MAX`` (4) caps the store: the
        least recently used prefix goes first."""
        ids = tuple(int(t) for t in prefix_ids)
        if len(ids) < 8 or len(ids) + 9 >= self.max_len:
            return False
        if getattr(self.cfg, "rope_dim_factors_long", None):
            return False
        if ids in self._prefixes:
            return True
        scratch = self._prefix_prefill(ids)
        keys = ("k", "v") + (("ks", "vs") if self.cfg.kv_quant == "int8" else ())
        maxp = int(os.environ.get("KAKVEDA_SERVE_PREFIX_MAX", "4"))
        while len(self._prefixes) >= max(1, maxp):
            self._prefixes.pop(next(iter(self._prefixes)))
        self._prefixes[ids] = _Prefix(
            ids=ids, kv={k: scratch[k] for k in keys}, index=NgramIndex(ids) if self.spec_k else None,
        )
        with self.stats_lock:
            self.prefix_stats["registered"] += 1
        return True

    def stats_snapshot(self) -> dict:
        """The spec and prefix stats, copied under the stats lock: the read
        API (the loop thread appends to ``k_trace`` meanwhile)."""
        with self.stats_lock:
            return {"spec": copy.deepcopy(self.spec_stats), "prefix": dict(self.prefix_stats)}

    def _set_gate_state(self, new: str) -> None:
        """The one gate transition: ``spec_stats``, the state gauges, the
        transition counter and the flight recorder move together, under the
        stats lock."""
        with self.stats_lock:
            old = self.spec_stats["gate_state"]
            if new == old:
                return
            self.spec_stats["gate_state"] = new
            self._gate_gauge.labels(engine=self.name, state=old).set(0.0)
            self._gate_gauge.labels(engine=self.name, state=new).set(1.0)
            self._gate_transitions.labels(**{"engine": self.name, "from": old, "to": new}).inc()
            if self.recorder is not None:
                self.recorder.record("gate", **{
                    "from": old, "to": new,
                    "tokens_per_verify": self.spec_stats["tokens_per_verify"],
                    "break_even": self.spec_stats["break_even"],
                })

    def _prefix_prefill(self, ids: Tuple[int, ...]) -> dict:
        """One ``decode_step`` of the prefix into an exact-length ``[1, plen]``
        cache; returns that cache."""
        scratch = init_cache(self.cfg, batch=1, max_len=len(ids), device=self.device)
        decode_step(
            self.params, self.cfg, torch.tensor([list(ids)], dtype=torch.long, device=self.device),
            scratch, last_only=True,
        )
        self.forwards += 1
        return scratch

    def _match_prefix(self, prompt_ids: List[int]):
        """The longest registered prefix of ``prompt_ids`` and the split:
        (entry, split, suffix width) or None. The suffix is a power-of-two
        tail (floor 8) of width sw ≥ len(prompt) − len(prefix); ``split =
        len(prompt) − sw`` rows come from the slab and the suffix recomputes
        the overlap with the same values. None when split ≤ 0 (the suffix
        covers the whole prompt); a match moves its entry to the end of the
        LRU order either way."""
        if not self._prefixes:
            return None
        best = None
        for pe in self._prefixes.values():
            pl_ = len(pe.ids)
            if best is not None and pl_ <= len(best.ids):
                continue
            if len(prompt_ids) >= pl_ and tuple(prompt_ids[:pl_]) == pe.ids:
                best = pe
        if best is None:
            return None
        self._prefixes[best.ids] = self._prefixes.pop(best.ids)
        p = len(prompt_ids)
        sw = 8
        while sw < p - len(best.ids):
            sw <<= 1
        split = p - sw
        if split <= 0:
            return None
        return best, split, sw

    @property
    def has_capacity(self) -> bool:
        return bool(self.free)

    @property
    def active(self) -> int:
        return len(self.slots)

    def admit(
        self,
        prompt_ids: List[int],
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        on_tokens: Optional[Callable[[List[int], bool], None]] = None,
    ) -> int:
        """Prefill into a free slot; returns a request id. With a prefix
        match (unless ``KAKVEDA_SERVE_PREFIX=0``) the slab goes to rows
        ``[off, off + plen)`` of the scratch cache and one ``decode_step``
        of the suffix runs from row ``off + split``: RoPE rotates by the
        logical position (row − off), so one slab serves every bucket.
        ``on_tokens(new, done)`` streams each chunk's accepted tokens.
        Refused while a verify chunk is in flight: its successor would read
        the positions it left on the card, not the host's."""
        if not self.free:
            raise RuntimeError("no free slot; call step() until one retires")
        if self._spec_pending:
            raise RuntimeError("admit() with a speculative chunk in flight; process_spec_chunk first")
        self._spec_pos_dev = None
        self._wall_cut()
        p = len(prompt_ids)
        if p + 1 >= self.max_len:
            raise ValueError("prompt too long for the slot window")
        bucket = self.bucket_for(p, self.max_len)
        off = bucket - p
        slot = self.free.pop()
        try:
            return self._prefill_into(slot, prompt_ids, bucket, off, max_new_tokens, temperature, on_tokens)
        except BaseException:
            # A failed prefill (an OOM, a CUDA error) gives its slot back.
            self.free.append(slot)
            self._kv_np[slot] = False
            raise

    def _prefill_into(self, slot, prompt_ids, bucket, off, max_new_tokens, temperature, on_tokens) -> int:
        rid = self._next_id
        self._next_id += 1
        ar = np.arange(self.max_len)
        self._kv_np[slot] = (ar >= off) & (ar < bucket)  # the real prompt rows
        self._off_np[slot] = off
        self._pos_np[slot] = bucket
        self._temp_np[slot] = temperature

        dev = self.device
        scratch = init_cache(self.cfg, batch=1, max_len=self.max_len, device=dev)
        m = self._match_prefix(list(prompt_ids)) if os.environ.get("KAKVEDA_SERVE_PREFIX", "1") != "0" else None
        if m is not None:
            pe, split, _ = m
            with self.stats_lock:
                self.prefix_stats["hits"] += 1
                self.prefix_stats["hit_tokens_saved"] += split
            self._mx["prefix_hit"].inc()
            plen = len(pe.ids)
            for key, slabs in pe.kv.items():
                for sk, pk in zip(scratch[key], slabs):
                    sk[:, :, off : off + plen] = pk
            scratch["pos"] = off + split
            prompt = torch.tensor([list(prompt_ids[split:])], dtype=torch.long, device=dev)
        else:
            self._mx["prefix_miss"].inc()
            prompt = torch.tensor([[0] * off + list(prompt_ids)], dtype=torch.long, device=dev)
        logits, scratch = decode_step(
            self.params, self.cfg, prompt, scratch,
            kv_valid=_h2d(self._kv_np[slot : slot + 1], dev),
            pos_offset=_h2d(self._off_np[slot : slot + 1], dev),
            last_only=True,
        )
        for key in ("k", "v", "ks", "vs"):
            for ck, sk in zip(self.cache.get(key, []), scratch.get(key, [])):
                ck[slot].copy_(sk[0])
        self.last[slot] = mask_pad_vocab(logits[:, -1, :], self.cfg)[0]
        self.forwards += 1
        # The slot's suffix index is built at its first draft: a pool whose
        # gate is off pays no index upkeep.
        self.slots[slot] = _Slot(
            req_id=rid, prompt_len=bucket, max_new=max_new_tokens, on_tokens=on_tokens,
            prompt_ids=list(prompt_ids), k=self.spec_k,
        )
        self._mx["active"].set(len(self.slots))
        return rid

    def step_async(self):
        """Enqueue one decode chunk without reading its tokens; returns a
        handle for :meth:`process_chunk` (None when no slot is active).

        Retirement is then seen one chunk late: the overshoot steps write
        nothing past the window, each slot attends only its own rows, and
        :meth:`process_chunk` drops tokens of slots already done — outputs
        equal the unpipelined path's. The handle's snapshot shares the
        ``_Slot`` objects: a slot retired meanwhile (by an earlier handle,
        or by :meth:`cancel_request`) shows ``done`` there, and a slot
        admitted again gets a new ``_Slot`` the snapshot does not hold, so
        a stale chunk's tokens never reach its next occupant."""
        if not self.slots:
            return None
        if self._spec_pending:
            raise RuntimeError("step_async() with a speculative chunk in flight; process_spec_chunk first")
        self._fault_dispatch.fire()
        # A plain chunk moves the positions through the host mirrors: any
        # left on the card by a verify chunk are stale from here on.
        self._spec_pos_dev = None
        wall = self._wall_open()
        self._grow_valid(self.chunk_steps)
        dev = self.device
        kv_valid = _h2d(self._kv_np, dev)
        pos_offset = _h2d(self._off_np, dev)
        pos_h = self._pos_np.copy()
        pos = _h2d(pos_h, dev)
        temps = _h2d(self._temp_np, dev) if (self._temp_np > 0).any() else None
        toks = torch.empty((self.B, self.chunk_steps), dtype=torch.long, device=dev)
        last = self.last
        top = int(pos_h[list(self.slots)].max())  # inactive slots see nothing
        for t in range(self.chunk_steps):
            nxt = last.argmax(dim=-1)
            if temps is not None:
                probs = torch.softmax(last / temps.clamp_min(1e-6)[:, None], dim=-1)
                drawn = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
                nxt = torch.where(temps > 0, drawn, nxt)
            toks[:, t] = nxt
            logits = _forward_wide(
                self.params, self.cfg, self.cache, nxt[:, None], pos + t, kv_valid, pos_offset, reach=top + t + 1,
            )
            last = logits[:, -1, :]
            self.forwards += 1
        self.last = last
        self._pos_np += self.chunk_steps  # every slot advances in lockstep
        return toks, dict(self.slots), wall

    def process_chunk(self, handle) -> List[int]:
        """Read an enqueued chunk's tokens and retire finished slots;
        returns the request ids that chunk completed. In a speculating pool
        its wall feeds the gate."""
        if handle is None:
            return []
        self._fault_fetch.fire()
        toks, snapshot, wall = handle
        toks_h = toks.cpu().numpy()
        self._mx["chunk_plain"].observe(time.perf_counter() - wall[0])
        live = any(not st.done for st in snapshot.values())
        finished: List[int] = []
        for slot, st in snapshot.items():
            if st.done:
                continue  # retired by an earlier chunk or cancelled: overshoot tokens
            self._emit(slot, st, toks_h[slot], finished)
        if self.spec_k and live:
            self.note_plain_wall(self._wall_close(wall))
        return finished

    def _emit(self, slot: int, st: _Slot, tok_row, finished: List[int]) -> None:
        """Accept a chunk's tokens into a slot (EOS / budget / window stops),
        keep its draft corpus current, stream them to ``on_tokens``, retire
        the slot when done. Shared by the plain and the verify chunks."""
        n_before = len(st.out)
        for t in tok_row:
            t = int(t)
            if self.eos_id is not None and t == self.eos_id:
                st.done = True
                break
            st.out.append(t)
            if st.index is not None:
                st.index.append(t)
            if len(st.out) >= st.max_new or st.prompt_len + len(st.out) + 1 >= self.max_len:
                st.done = True
                break
        if len(st.out) > n_before:
            self._mx["tokens"].inc(len(st.out) - n_before)
        if st.on_tokens is not None:
            # A consumer that raises just stops receiving; the loop goes on.
            try:
                st.on_tokens(st.out[n_before:], st.done)
            except Exception:  # noqa: BLE001 — a gone stream consumer must not kill the loop
                st.on_tokens = None
        if st.done:
            self.results[st.req_id] = st.out
            finished.append(st.req_id)
            self._retire(slot)

    def _retire(self, slot: int) -> None:
        del self.slots[slot]
        self.free.append(slot)
        self._kv_np[slot] = False
        self._mx["active"].set(len(self.slots))

    def cancel_request(self, rid: int) -> Optional[List[int]]:
        """Retire a mid-decode request now, between chunks: returns its
        partial tokens, frees the slot, and marks its ``_Slot`` done first,
        so a chunk already enqueued under the pipelined loop (plain or
        verify) treats the slot's tokens as overshoot. None when ``rid`` is
        not active (done, or never admitted)."""
        for slot, st in list(self.slots.items()):
            if st.req_id == rid:
                st.done = True
                self._retire(slot)
                return st.out
        return None

    def _grow_valid(self, steps: int) -> None:
        """Each active slot may read its next ``steps`` rows as it writes
        them (reads stay bounded per query by its own position); the left
        pad [0, pos_offset) stays invalid. One definition for both chunk
        flavors."""
        ar = np.arange(self.max_len)[None, :]
        active = np.zeros((self.B,), bool)
        active[list(self.slots)] = True
        limit = (self._pos_np + steps)[:, None]
        self._kv_np |= active[:, None] & (ar >= self._off_np[:, None]) & (ar < limit)

    # --- speculation: host drafts --------------------------------------------

    def _anchor(self, st: _Slot):
        """A slot's anchor: its own suffix index first; a weak self-anchor
        (under 3 tokens) defers to a longer match inside a registered
        prefix's ids (template traffic repeats the template before its own
        history holds the continuation). Returns ``(corpus, j, period)``,
        period 0 for a hit in a prefix (copied literally, no wrap)."""
        if st.index is None:
            st.index = NgramIndex(st.prompt_ids + st.out)
        j, m = st.index.anchor
        corpus, period = st.index.toks, (len(st.index.toks) - 1 - j if j >= 0 else 0)
        if m < 3 and self._prefixes:
            tail = st.index.toks[-3:]
            for pe in self._prefixes.values():
                if pe.index is None:
                    continue
                pj, pm = pe.index.lookup(tail)
                if pm > m and pj + 2 < len(pe.index.toks):
                    j, m, corpus, period = pj, pm, pe.index.toks, 0
        return corpus, j, period

    @staticmethod
    def _copy_drafts(corpus, start: int, k: int, period: int, n: int, skip: int = 1):
        """The drafts' shared tail: copy ``k + skip`` tokens of ``corpus``
        from ``start`` (:func:`copy_run`: past the frozen end ``n`` a run
        repeats with ``period``), keep the last k as drafts (the first
        ``skip`` the card commits itself), PAD (0) a short run. Returns
        ``(drafts[k], cursor, predicted emission)``: the cursor continues
        the run and the prediction is what the chunk emits if it accepts in
        full, both None when the run ran short (a chunk then breaks the
        chain whatever it emits)."""
        seq, nxt = copy_run(corpus, start, k + skip, period, n=n)
        drafts = seq[skip:] + [0] * (k + skip - len(seq))
        if len(seq) < k + skip:
            return drafts, None, None
        return drafts, (corpus, nxt, period, n), seq[skip - 1 :]

    def _draft_slot(self, st: _Slot, k: int):
        """Drafts for a slot whose history the host has: the anchor's
        continuation, the verify chunk's t0 (committed on the card)
        first."""
        corpus, j, period = self._anchor(st)
        if j < 0:
            return [0] * k, None, None
        return self._copy_drafts(corpus, j + 1, k, period, len(corpus))

    @classmethod
    def _draft_cursor(cls, st: _Slot, k: int):
        """Drafts for a slot whose last verify chunk is still in flight and
        whose prediction chain is alive: the same copy run continues past
        the predicted emission (a bet that the chunk in flight accepts in
        full, the traffic where speculation pays; process_spec_chunk drops
        the cursor when it does not)."""
        corpus, idx, period, n = st.spec_cursor
        return cls._copy_drafts(corpus, idx, k, period, n)

    def _draft_slot_stale(self, st: _Slot, k: int):
        """Drafts for a slot whose chain broke while a chunk is in flight:
        anchor on the history the host has. The chunk in flight carried no
        live drafts, so it will most likely commit one unseen token, the
        anchor's own first prediction: predict k+2 ahead and skip that token
        and this chunk's t0. A surprise only misses, and the next dispatch
        anchors again."""
        corpus, j, period = self._anchor(st)
        if j < 0:
            return [0] * k, None, None
        return self._copy_drafts(corpus, j + 1, k, period, len(corpus), skip=2)

    def _pool_k(self) -> int:
        """The next verify chunk's width: the active slots' largest draft
        length, rounded up to a power of two, at most ``spec_k``."""
        top = max(st.k for st in self.slots.values())
        k = 1
        while k < top:
            k <<= 1
        return max(1, min(k, self.spec_k))

    # --- speculation: the verify chunk ---------------------------------------

    def step_spec_async(self):
        """Enqueue one verify chunk without reading its acceptance; returns
        a handle for :meth:`process_spec_chunk` (None when no slot is
        active).

        The chunk leaves the slots' positions after acceptance on the card
        and the next dispatch reads them there, so verify chunks pipeline
        with no host sync between them: the host drafts chunk i+1 from each
        slot's copy cursor, read validity grows by the whole width in flight
        from the last position the host knows, and the kernel's schedule
        hint is that position plus the width in flight. Overshoot follows
        the plain chunk's contract (rows past the window dropped, stale
        snapshots skip done slots, rejected rows overwritten before any
        query reaches them). Admissions need the host's positions: callers
        process the handles in flight first (``admit`` refuses otherwise)."""
        if not self.slots:
            return None
        self._fault_dispatch.fire()
        wall = self._wall_open()  # drafting is part of the chunk's cost
        k = self._pool_k()
        pipelined = self._spec_pending > 0
        drafts = np.zeros((self.B, k), np.int64)
        kmap: Dict[int, int] = {}
        pmap: Dict[int, Optional[List[int]]] = {}
        for slot, st in self.slots.items():
            kd = min(max(st.k, 1), k)
            kmap[slot] = kd
            if not pipelined:
                row, cursor, pred = self._draft_slot(st, kd)
            elif st.spec_cursor is not None:
                row, cursor, pred = self._draft_cursor(st, kd)
            else:
                row, cursor, pred = self._draft_slot_stale(st, kd)
            drafts[slot, : len(row)] = row  # columns past kd stay PAD
            st.spec_cursor = cursor
            pmap[slot] = pred
        # Validity covers every chunk in flight from the last position the
        # host knows; rows past a slot's true frontier are valid garbage,
        # hidden from each query by its own position.
        self._grow_valid(self._spec_pending_width + k + 1)
        reach = int(self._pos_np[list(self.slots)].max()) + self._spec_pending_width + k + 1
        dev = self.device
        slot_pos = self._spec_pos_dev if self._spec_pos_dev is not None else _h2d(self._pos_np, dev)
        self.last, self._spec_pos_dev, toks, counts = _spec_chunk(
            self.params, self.cfg, self.cache, self.last, slot_pos,
            _h2d(self._kv_np, dev), _h2d(self._off_np, dev), _h2d(drafts, dev), reach=reach,
        )
        self.forwards += 1
        self._spec_pending += 1
        self._spec_pending_width += k + 1
        return _d2h_async(toks), _d2h_async(counts), dict(self.slots), k, kmap, pmap, wall

    def process_spec_chunk(self, handle) -> List[int]:
        """Read a verify chunk's tokens and acceptance, emit each slot's
        accepted run, adapt each slot's draft length, feed the gate;
        returns the request ids that chunk completed."""
        if handle is None:
            return []
        self._fault_fetch.fire()
        toks, counts, snapshot, k, kmap, pmap, wall = handle
        toks_h = _host(toks)
        counts_h = _host(counts)
        self._spec_pending -= 1
        self._spec_pending_width -= k + 1
        self._mx["chunk_spec"].observe(time.perf_counter() - wall[0])
        # Every slot's mirror moves by its own count (inactive slots drift
        # harmlessly: admission resets them).
        self._pos_np += counts_h
        finished: List[int] = []
        self._gate_spec_chunks += 1
        # The chunk's stats land in spec_stats under one lock acquire, never
        # held across _emit (its callbacks are caller code).
        em = sc = dr = ac = 0
        for slot, st in snapshot.items():
            if st.done:
                st.spec_cursor = None
                continue  # retired earlier: overshoot tokens
            n = int(counts_h[slot])
            kd = kmap.get(slot, k)
            a = max(0, min(n - 1, kd))  # accepted drafts (t0 comes free)
            em += n
            sc += 1
            dr += kd
            ac += a
            self._tpv_recent.append(n)
            # A chunk accepted in full doubles the slot's draft length (the
            # rejected drafts ride the same weight stream, so recovering is
            # nearly free); one rejected in full halves it toward 1.
            st.accept_ema = 0.7 * st.accept_ema + 0.3 * (a / kd if kd else 0.0)
            if a >= kd:
                st.k = min(self.spec_k, max(st.k, kd) * 2)
            elif a == 0:
                st.k = max(1, st.k // 2)
            # The prediction chain survives only a chunk accepted in full
            # whose tokens match its own prediction (from the handle: a
            # newer dispatch has moved the slot's cursor already).
            pred = pmap.get(slot)
            if pred is None or n != kd + 1 or [int(t) for t in toks_h[slot][:n]] != pred[:n]:
                st.spec_cursor = None
            self._emit(slot, st, toks_h[slot][:n], finished)
        with self.stats_lock:
            s = self.spec_stats
            s["chunks"] += 1
            s["emitted"] += em
            s["slot_chunks"] += sc
            s["drafted"] += dr
            s["accepted"] += ac
            s["k_trace"].append(k)
            if len(s["k_trace"]) > 64:
                del s["k_trace"][0]
        self._mx["drafted"].inc(dr)
        self._mx["accepted"].inc(ac)
        self._mx["spec_k"].set(k)
        if self.recorder is not None and k != self._last_k_rec:
            self.recorder.record("pool_k", k=k)
            self._last_k_rec = k
        wall = self._wall_close(wall)
        if k in self._spec_widths_warm:
            self._spec_walls.append(wall)
        else:
            self._spec_widths_warm.add(k)  # the first chunk of a width: not a cost sample
        self._gate_eval()
        return finished

    def step_spec(self) -> List[int]:
        """One verify chunk for every active slot, processed at once."""
        return self.process_spec_chunk(self.step_spec_async())

    def spec_pipeline_ready(self) -> bool:
        """True when the next verify chunk may go before the one in flight
        is read: every active slot is on a live prediction chain and has
        been accepting (EMA ≥ 0.5). A cursor bets on the chunk in flight
        accepting in full; on traffic that accepts halfway the bet loses,
        and the synchronous order (read, anchor, draft) keeps acceptance."""
        return all(st.spec_cursor is not None and st.accept_ema >= 0.5 for st in self.slots.values())

    def _wall_open(self) -> list:
        """Open the wall of a chunk being dispatched (``[dispatch, next
        move]``), closing the one still open: this dispatch is its next
        move."""
        self._wall_cut()
        self._wall_cell = [time.perf_counter(), None]
        return self._wall_cell

    def _wall_cut(self) -> None:
        """The loop moves on (a dispatch, an admission): the open wall ends
        here."""
        if self._wall_cell is not None:
            self._wall_cell[1] = time.perf_counter()
            self._wall_cell = None

    def _wall_close(self, cell: list) -> float:
        """A processed chunk's wall in seconds; one still open ends now, as
        its processing does."""
        if cell[1] is None:
            cell[1] = time.perf_counter()
            if cell is self._wall_cell:
                self._wall_cell = None
        return cell[1] - cell[0]

    def note_plain_wall(self, wall: float) -> None:
        """One plain chunk's wall (``chunk_steps`` tokens a slot): the cost
        the gate holds verify chunks against. While the gate is off, each
        plain chunk counts toward the re-probe that sends it back to
        warm-up."""
        if self._plain_warm:
            self._plain_walls.append(wall)
        else:
            self._plain_warm = True  # the first plain chunk: not a cost sample
        with self.stats_lock:
            if self.spec_stats["gate_state"] == "off":
                self._gate_plain_since_off += 1
                if self._gate_reprobe and self._gate_plain_since_off >= self._gate_reprobe:
                    self._set_gate_state("warmup")
                    self._gate_spec_chunks = 0
                    self._gate_plain_since_off = 0
                    self._gate_reprobes += 1
                    self._tpv_recent.clear()

    def _gate_eval(self) -> None:
        """The acceptance gate: speculation pays when the tokens a verify
        chunk emits clear the break-even, its wall over the plain chunk's
        per-token wall (medians of recent chunks; the prior until a plain
        chunk was measured). After warm-up a pool below it turns off and
        decodes plain; a re-probe sends it back to warm-up with a 10 %
        margin, so a borderline pool does not flap."""
        if not self.spec_k:
            return
        tpv = float(np.mean(self._tpv_recent)) if self._tpv_recent else 0.0
        if self._spec_walls and self._plain_walls:
            spec_w = float(np.median(self._spec_walls))
            plain_w = float(np.median(self._plain_walls)) / max(self.chunk_steps, 1)
            be = spec_w / max(plain_w, 1e-9)
        else:
            be = self._gate_prior
        with self.stats_lock:
            g = self.spec_stats
            g["tokens_per_verify"] = round(tpv, 3)
            g["break_even"] = round(be, 3)
            if g["gate_state"] in ("warmup", "on") and self._gate_spec_chunks >= self._gate_warmup:
                if tpv < be * (1.1 if self._gate_reprobes else 1.0):
                    self._set_gate_state("off")
                    self._gate_plain_since_off = 0
                else:
                    self._set_gate_state("on")

    def spec_ready(self) -> bool:
        """True when the next chunk should be a verify chunk: speculation
        on, the gate not off, the gate's plain-wall calibration done, and
        every active slot greedy. The one predicate of step() and of the
        engine loop. (The reference's brownout ladder may veto speculation
        too; the port stays at its level 0, which never does.)"""
        return bool(
            self.spec_k
            and self.slots
            and self.spec_stats["gate_state"] != "off"
            and len(self._plain_walls) >= self._gate_calib
            and all(self._temp_np[s] <= 0.0 for s in self.slots)
        )

    def step(self) -> List[int]:
        """One chunk for every active slot (a verify chunk when
        :meth:`spec_ready`); returns the request ids it finished (their
        tokens land in ``results``)."""
        if self.spec_ready():
            return self.step_spec()
        return self.process_chunk(self.step_async())

    def run_all(self, prompts: List[List[int]], max_new_tokens: int = 64) -> List[List[int]]:
        """Drain a request list through the slot pool, admitting as slots
        free up; returns outputs in request order."""
        pending = list(enumerate(prompts))
        order: Dict[int, int] = {}
        while pending or self.slots:
            while pending and self.free:
                idx, p = pending.pop(0)
                order[self.admit(p, max_new_tokens)] = idx
            self.step()
        outs: List[List[int]] = [[] for _ in prompts]
        for rid, idx in order.items():
            outs[idx] = self.results.pop(rid, [])
        return outs


def _fail(fut: Future, err: BaseException) -> None:
    """set_exception that tolerates losing the race to set_result."""
    try:
        if not fut.done():
            fut.set_exception(err)
    except InvalidStateError:
        pass


class ServingEngine:
    """One shared ContinuousBatcher behind a thread-safe submit API: a loop
    thread admits requests as slots free up, steps every active slot
    together and resolves each caller's Future.

    The request lifecycle is the reference's: ``on_tokens`` streams each
    chunk's tokens (on the loop thread: push to a queue and return),
    :meth:`cancel` frees a request's slot at the next chunk boundary,
    ``deadline_s`` retires a request that cannot finish in time with
    :class:`DeadlineExceededError`, and ``tenant`` enters it into the
    weighted-fair slot pick. Each request's timeline (queue wait, prefill,
    TTFT, wall, tokens/s) goes to the ``kakveda_serving_*`` families, the
    flight recorder ``serving/<name>`` and ``fut.timeline``.

    A supervisor runs the loop: a crash fails the in-flight requests with
    :class:`EngineRetryableError`, rebuilds the batcher (a fresh cache, the
    registered prefixes registered again) and re-admits the queued ones,
    with bounded exponential backoff, at most ``KAKVEDA_SERVE_RESTARTS``
    (2) times; past that the engine is dead and ``submit`` raises
    :class:`EngineDeadError` at once.

    ``spec_k`` (``KAKVEDA_SERVE_SPEC``, read once, when not given) makes the
    pool speculate (:class:`ContinuousBatcher`); a rebuild keeps it. The
    loop pipelines verify chunks as it does plain ones, one in flight while
    the next is enqueued, and processes the one in flight before it admits
    (admission needs the host's positions). ``KAKVEDA_SERVE_PIPELINE=0``
    processes every chunk before the next."""

    def __init__(
        self,
        params: Params,
        cfg: LlamaConfig,
        *,
        batch_slots: int = 8,
        max_len: int = 512,
        chunk_steps: int = 8,
        eos_id: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        spec_k: Optional[int] = None,
        name: Optional[str] = None,
    ):
        if spec_k is None:
            spec_k = int(os.environ.get("KAKVEDA_SERVE_SPEC", "0"))
        self.name = name or "default"
        self.recorder = _metrics.FlightRecorder(f"serving/{self.name}")
        # What a rebuild needs to construct a fresh batcher.
        self._params, self._cfg = params, cfg
        self._cb_kw = dict(
            batch_slots=batch_slots, max_len=max_len, chunk_steps=chunk_steps,
            eos_id=eos_id, generator=generator, spec_k=spec_k,
        )
        self.cb = ContinuousBatcher(params, cfg, name=self.name, recorder=self.recorder, **self._cb_kw)
        # The restart budget is read once: the supervisor must not change
        # behaviour mid-life because the environment moved.
        self._restart_budget = int(os.environ.get("KAKVEDA_SERVE_RESTARTS", "2"))
        self._restarts = 0  # written by the loop thread only
        self._dead = threading.Event()
        # Prefixes registered on the live batcher, in order: a rebuild
        # registers them again.
        self._prefix_ids: List[Tuple[int, ...]] = []
        reg = _metrics.get_registry()
        el = {"engine": self.name}
        self._m_requests = reg.counter(
            "kakveda_serving_requests_total", "Serving requests by outcome", ("engine", "outcome"),
        )
        self._mx = {
            "queue_wait": reg.histogram(
                "kakveda_serving_queue_wait_seconds",
                "Submit-to-admission wait in the serving engine queue", ("engine",),
            ).labels(**el),
            "prefill": reg.histogram(
                "kakveda_serving_prefill_seconds",
                "Admission prefill dispatch wall per request", ("engine",),
            ).labels(**el),
            "ttft": reg.histogram(
                "kakveda_serving_ttft_seconds",
                "Submit-to-first-token latency per request", ("engine",),
            ).labels(**el),
            "request": reg.histogram(
                "kakveda_serving_request_seconds",
                "Submit-to-completion wall per request", ("engine",),
            ).labels(**el),
            "rate": reg.histogram(
                "kakveda_serving_tokens_per_second",
                "Per-request decode rate (tokens / request wall)",
                ("engine",), buckets=_metrics.RATE_BUCKETS,
            ).labels(**el),
            "errors": reg.counter(
                "kakveda_serving_engine_errors_total",
                "Serving-engine loop deaths (flight recorder dumped on each)", ("engine",),
            ).labels(**el),
            "restarts": reg.counter(
                "kakveda_serving_engine_restarts_total",
                "Supervisor restarts of a serving-engine loop after a crash "
                "(bounded by KAKVEDA_SERVE_RESTARTS)", ("engine",),
            ).labels(**el),
        }
        # The submit-side backlog bound: past it, submit sheds with a typed
        # OverloadError (429 + Retry-After at the HTTP tier).
        self._admit_queue = int(os.environ.get("KAKVEDA_ADMIT_QUEUE", "64"))
        # Weighted-fair slot admission: a freed slot goes to the waiting
        # head of the least-served tenant, and an item passed over
        # KAKVEDA_TENANT_PROMOTE_ROUNDS times goes next whatever the
        # deficit. Tenant-blind traffic, or KAKVEDA_TENANT_FAIR=0, is FIFO.
        self._tenant_fair = _admission.tenant_fair_enabled()
        self._promote_rounds = max(1, int(os.environ.get("KAKVEDA_TENANT_PROMOTE_ROUNDS", "8")))
        self._fair_table_max = max(2, int(os.environ.get("KAKVEDA_TENANT_TABLE", "512")))
        self._fair_served: Dict[str, int] = {}  # recent slot admissions per tenant
        self._fair_picks = 0
        self._fair_promotions = 0
        # Generation items: (ids, max_new, temp, on_tokens, t_submit,
        # deadline or None, fut); control items: ("cancel"|"prefix", …, fut).
        self._q: "queue.Queue[tuple]" = queue.Queue()
        self._closed = threading.Event()
        self._submit_lock = threading.Lock()  # the submit/close race and _waiting
        self._pend: Dict[int, Future] = {}  # loop-owned: admitted requests
        self._waiting: List[tuple] = []  # submitted, waiting for a slot
        self._track: Dict[int, dict] = {}  # loop-owned: per-request timelines
        self._stats = {"submitted": 0, "completed": 0, "max_active": 0, "chunks": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True, name="serving-engine")
        self._thread.start()

    def stats(self) -> dict:
        """A copy of the engine's counters and the batcher's spec and prefix
        stats, taken under the stats lock, with the supervisor's state and
        the fair pick's: the read API (never the live dicts)."""
        with self.cb.stats_lock:
            snap = dict(self._stats)
            snap["spec"] = copy.deepcopy(self.cb.spec_stats)
            snap["prefix"] = dict(self.cb.prefix_stats)
        snap["restarts"] = self._restarts
        snap["dead"] = self._dead.is_set()
        with self._submit_lock:
            snap["tenant_fair"] = {
                "enabled": self._tenant_fair,
                "served": dict(self._fair_served),
                "promotions": self._fair_promotions,
            }
        return snap

    def _bump(self, key: str, v: int = 1) -> None:
        with self.cb.stats_lock:
            self._stats[key] += v

    def _note_active(self) -> None:
        with self.cb.stats_lock:
            self._stats["max_active"] = max(self._stats["max_active"], self.cb.active)

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """True when the request runs in the pool without truncating where a
        solo decode would not: the admission bucket plus the whole token
        budget must fit the slot window."""
        ml = self.cb.max_len
        if prompt_len + 1 >= ml:
            return False
        return ContinuousBatcher.bucket_for(prompt_len, ml) + max_new_tokens + 1 <= ml

    def _dead_error(self) -> EngineDeadError:
        return EngineDeadError(
            f"ServingEngine {self.name!r} is dead (restart budget exhausted after {self._restarts} restart(s))"
        )

    def submit(
        self,
        prompt_ids: List[int],
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        on_tokens: Optional[Callable[[List[int], bool], None]] = None,
        deadline_s: Optional[float] = None,
        klass: str = "interactive",
        tenant: str = "",
    ) -> Future:
        """Enqueue a request; the Future resolves to the generated id list.

        ``on_tokens(new_ids, done)`` streams each chunk's accepted tokens,
        on the loop thread: it must not block. ``deadline_s`` bounds the
        submit-to-completion wall: past it the request retires at the next
        chunk boundary and its Future fails with
        :class:`DeadlineExceededError` carrying the partial tokens.
        ``klass`` is the admission class; ``tenant`` (the app key) enters
        the weighted-fair slot pick, and an empty one keeps the request
        tenant-blind.

        Before anything is enqueued: a degraded card fails fast with
        ``DeviceUnavailableError``; a backlog of ``KAKVEDA_ADMIT_QUEUE``
        (64) sheds with ``OverloadError``; and with a live backlog, a
        ``deadline_s`` the observed queue waits say cannot be met is shed
        now. Neither error is a RuntimeError, so a shed never takes a
        caller's solo-decode fallback. (The brownout ladder is not ported:
        the port stays at its level 0, which sheds no class and caps no
        tokens.)"""
        _admission.get_device_health().check()
        adm = _admission.get_admission()
        if adm.enabled:
            with self._submit_lock:
                backlog = self._q.qsize() + len(self._waiting)
            if backlog >= self._admit_queue:
                self._m_requests.labels(engine=self.name, outcome="shed").inc()
                adm.shed(klass, "queue_full", detail=f"engine backlog {backlog} >= {self._admit_queue}",
                         tenant=tenant)
            if deadline_s is not None and backlog > 0:
                # Only with a live backlog: an empty queue says the wait
                # history describes a past storm, not this request's fate.
                predicted = adm.predicted_wait(klass)
                if predicted > deadline_s:
                    self._m_requests.labels(engine=self.name, outcome="shed").inc()
                    adm.shed(
                        klass, "deadline",
                        detail=f"predicted queue wait {predicted:.2f}s exceeds deadline {deadline_s:.2f}s",
                        tenant=tenant,
                    )
        with self._submit_lock:
            # Atomic with close()'s drain: a put between its _closed.set()
            # and the drain would hang its caller.
            if self._dead.is_set():
                raise self._dead_error()
            if self._closed.is_set():
                raise RuntimeError("ServingEngine is closed")
            t0 = time.perf_counter()
            fut: Future = Future()
            fut.tenant = tenant
            fut.fair_rounds = 0
            self._q.put((
                list(prompt_ids), max_new_tokens, temperature, on_tokens, t0,
                t0 + deadline_s if deadline_s is not None else None, fut,
            ))
            self._bump("submitted")
            return fut

    def generate_ids(self, prompt_ids: List[int], max_new_tokens: int = 64, temperature: float = 0.0) -> List[int]:
        """Blocking submit."""
        return self.submit(prompt_ids, max_new_tokens, temperature).result()

    def cancel(self, fut: Future) -> None:
        """Best-effort cancel: a request still queued cancels its Future
        (never admitted, not counted); one mid-decode is retired by the loop
        at the next chunk boundary, its slot freed, and its Future resolves
        to the tokens decoded so far (outcome ``cancelled``)."""
        if fut.cancel():
            return
        with self._submit_lock:
            if self._closed.is_set():
                return
            self._q.put(("cancel", fut, fut))

    def register_prefix(self, prefix_ids: List[int], timeout: float = 120.0) -> bool:
        """``ContinuousBatcher.register_prefix`` on the loop thread (the
        batcher is the loop's, so a registration never races a chunk);
        blocks for the answer. A rebuild after a crash registers it again."""
        with self._submit_lock:
            if self._dead.is_set():
                raise self._dead_error()
            if self._closed.is_set():
                raise RuntimeError("ServingEngine is closed")
            fut: Future = Future()
            self._q.put(("prefix", list(prefix_ids), fut))
        return bool(fut.result(timeout=timeout))

    def close(self) -> None:
        with self._submit_lock:
            self._closed.set()
        self._thread.join(timeout=60.0)
        self._fail_all(RuntimeError("ServingEngine closed"))

    def _fail_all(self, err: BaseException) -> None:
        """Fail everything queued, waiting for a slot or mid-decode (close,
        and the loop's own exit and death). Under the submit lock, so a
        close() racing a loop that outlived its join cannot strand an item
        both sides miss."""
        with self._submit_lock:
            while True:
                try:
                    *_, fut = self._q.get_nowait()
                except queue.Empty:
                    break
                _fail(fut, err)
            for item in self._waiting:
                _fail(item[-1], err)
            self._waiting.clear()
            for fut in list(self._pend.values()):
                _fail(fut, err)
            self._pend.clear()
            self._track.clear()

    def _fail_inflight(self, err: BaseException) -> None:
        """Fail only the requests admitted into the dead batcher (their slot
        state is gone); queued and waiting ones stay for the rebuilt loop."""
        with self._submit_lock:
            for fut in list(self._pend.values()):
                _fail(fut, err)
            self._pend.clear()
            self._track.clear()

    def _pick_waiting_locked(self):
        """Pop the next waiting generation item for a freed slot (the
        caller holds ``_submit_lock``; ``_waiting`` is not empty).

        With the fair pick on: first, the earliest item passed over
        ``_promote_rounds`` times goes, whatever the deficit (the
        starvation bound: every pick ages every item left behind); else,
        among each tenant's FIFO head, the tenant with the fewest recent
        slot admissions. Tenant-blind traffic reduces to index 0 both ways,
        exact FIFO, and ``KAKVEDA_TENANT_FAIR=0`` is ``pop(0)``."""
        if not self._tenant_fair or len(self._waiting) <= 1:
            return self._waiting.pop(0)
        pick = None
        for i, item in enumerate(self._waiting):
            if getattr(item[-1], "fair_rounds", 0) >= self._promote_rounds:
                pick = i
                self._fair_promotions += 1
                _admission.note_tenant_promotion("serving")
                break
        if pick is None:
            seen = set()
            best = None
            pick = 0
            for i, item in enumerate(self._waiting):
                t = getattr(item[-1], "tenant", "")
                if t in seen:
                    continue  # only each tenant's FIFO head competes
                seen.add(t)
                s = self._fair_served.get(t, 0)
                if best is None or s < best:
                    best, pick = s, i
        item = self._waiting.pop(pick)
        t = getattr(item[-1], "tenant", "")
        if t not in self._fair_served and len(self._fair_served) >= self._fair_table_max:
            # A bounded table: the heaviest-served key goes, and re-enters
            # at zero (a brief boost, the safe direction).
            del self._fair_served[max(self._fair_served, key=self._fair_served.get)]
        self._fair_served[t] = self._fair_served.get(t, 0) + 1
        self._fair_picks += 1
        if self._fair_picks % 1024 == 0:
            # Decay: a fair share is a recent share, and zeros drop.
            self._fair_served = {k: v // 2 for k, v in self._fair_served.items() if v // 2 > 0}
        for other in self._waiting:
            fut = other[-1]
            fut.fair_rounds = getattr(fut, "fair_rounds", 0) + 1
        return item

    def _rebuild(self, dead: ContinuousBatcher) -> None:
        """A fresh batcher after a loop death: the dead one's cache and
        prefix slabs are dropped first (on the card the new cache takes
        their memory, not memory beside them), the fair pick restarts from
        what is still queued, and every registered prefix is registered
        again, all before the new batcher is published as ``self.cb``. Loop
        thread only."""
        for key, val in dead.cache.items():
            if isinstance(val, list):
                val.clear()
        dead._prefixes.clear()
        dead.last = None
        cb = ContinuousBatcher(self._params, self._cfg, name=self.name, recorder=self.recorder, **self._cb_kw)
        for ids in list(self._prefix_ids):
            try:
                cb.register_prefix(list(ids))
            except Exception as e:  # noqa: BLE001 — prefix reuse is an optimization; the rebuild must come up
                log.warning("prefix re-registration failed after engine restart: %s", e)
        with self._submit_lock:
            self._fair_served.clear()
            self._fair_picks = 0
            for item in self._waiting:
                item[-1].fair_rounds = 0
        self.cb = cb

    def _finish_telemetry(self, rid: int, n_tokens: int) -> Optional[dict]:
        """Close a request's timeline: the lifecycle histograms, the
        ``completed`` outcome, one flight-recorder event; returns the
        timeline (it rides the caller's Future)."""
        tr = self._track.pop(rid, None)
        if tr is None:
            return None
        wall = time.perf_counter() - tr["submit"]
        rate = n_tokens / wall if wall > 0 else 0.0
        self._mx["request"].observe(wall)
        if n_tokens:
            self._mx["rate"].observe(rate)
        self._m_requests.labels(engine=self.name, outcome="completed").inc()
        tl = {
            "request_id": rid,
            "queue_wait_ms": round((tr["admit"] - tr["submit"]) * 1000, 3),
            "prefill_ms": round(tr.get("prefill_s", 0.0) * 1000, 3),
            "ttft_ms": round((tr["first"] - tr["submit"]) * 1000, 3) if tr["first"] is not None else None,
            "wall_ms": round(wall * 1000, 3),
            "tokens": n_tokens,
            "tokens_per_s": round(rate, 2),
        }
        self.recorder.record("request", **tl)
        return tl

    def _finish_rids(self, rids: List[int]) -> None:
        """Resolve completed requests' Futures, timelines attached: the one
        completion path, shared by the serve loop and the deadline sweep."""
        for rid in rids:
            self._bump("completed")
            fut = self._pend.pop(rid, None)
            toks = self.cb.results.pop(rid, [])
            tl = self._finish_telemetry(rid, len(toks))
            if fut is not None:
                if tl is not None:
                    fut.timeline = tl
                if not fut.done():
                    try:
                        fut.set_result(toks)
                    except InvalidStateError:  # close() won the race
                        pass

    def _expire_item(self, fut: Future, tokens: List[int], where: str) -> None:
        """Fail one request with the typed deadline error (its outcome and a
        flight-recorder event ride along). Loop thread only."""
        self._m_requests.labels(engine=self.name, outcome="deadline").inc()
        self.recorder.record("deadline", tokens=len(tokens), where=where)
        _fail(fut, DeadlineExceededError(f"deadline exceeded {where} ({len(tokens)} tokens decoded)", tokens))

    def _expire_deadlines(self) -> None:
        """Retire every request whose deadline passed: admitted ones through
        ``cancel_request`` (done flag first, so a chunk in flight skips the
        freed slot), waiting ones without taking a slot. Loop thread only."""
        now = time.perf_counter()
        for rid, tr in list(self._track.items()):
            dl = tr.get("deadline")
            if dl is None or now < dl:
                continue
            toks = self.cb.cancel_request(rid)
            if toks is None:
                if rid in self.cb.results:
                    self._finish_rids([rid])  # finished before the sweep saw it
                continue
            fut = self._pend.pop(rid, None)
            self._track.pop(rid, None)
            if fut is not None:
                self._expire_item(fut, toks, "mid-decode")
        with self._submit_lock:
            still = []
            for item in self._waiting:
                dl = item[5]
                if dl is not None and now >= dl:
                    self._expire_item(item[-1], [], "while queued")
                else:
                    still.append(item)
            self._waiting[:] = still

    def _control(self, item) -> None:
        """A cancel or a prefix registration, at once (a cancel matters most
        when the pool is full, so it never waits for a slot)."""
        kind, a, fut = item
        if kind == "cancel":
            rid = next((r for r, f in self._pend.items() if f is fut), None)
            if rid is None:
                return  # already finished, or never admitted
            toks = self.cb.cancel_request(rid)
            self._pend.pop(rid, None)
            self._track.pop(rid, None)
            self._m_requests.labels(engine=self.name, outcome="cancelled").inc()
            self.recorder.record("cancel", request_id=rid, tokens=len(toks or []))
            if toks is None:
                toks = self.cb.results.pop(rid, [])  # finished between chunks
            if not fut.done():
                try:
                    fut.set_result(toks)
                except InvalidStateError:  # lost the race with completion
                    pass
            return
        if not fut.set_running_or_notify_cancel():
            return
        try:
            ok = self.cb.register_prefix(a)
            if ok:
                key = tuple(int(t) for t in a)
                if key not in self._prefix_ids:
                    self._prefix_ids.append(key)
            fut.set_result(ok)
        except Exception as e:  # noqa: BLE001 — a registration's error is its caller's
            _fail(fut, e)

    def _admit_one(self, item) -> None:
        ids, max_new, temp, on_tokens, t_submit, deadline, fut = item
        if deadline is not None and time.perf_counter() >= deadline:
            self._expire_item(fut, [], "expired before admission")
            return
        if not fut.set_running_or_notify_cancel():
            return  # cancelled while waiting
        t_admit = time.perf_counter()
        self._mx["queue_wait"].observe(t_admit - t_submit)
        # The live queue-wait history the deadline-aware shed reads.
        _admission.get_admission().note_wait("interactive", t_admit - t_submit)
        track = {"submit": t_submit, "admit": t_admit, "first": None, "tokens": 0, "deadline": deadline}
        mx_ttft = self._mx["ttft"]

        def _on_tokens(new, done, _orig=on_tokens, _tr=track):
            if _tr["first"] is None and new:
                _tr["first"] = time.perf_counter()
                mx_ttft.observe(_tr["first"] - _tr["submit"])
            _tr["tokens"] += len(new)
            if _orig is not None:
                _orig(new, done)

        try:
            rid = self.cb.admit(ids, max_new_tokens=max_new, temperature=temp, on_tokens=_on_tokens)
        except Exception as e:  # noqa: BLE001 — admission errors belong to the caller
            # The future is RUNNING and in neither _waiting nor _pend: fail it
            # here or its caller waits for ever. A CUDA error also latches
            # degraded mode; a sticky one then fails the next chunk, and the
            # supervisor takes over.
            self._m_requests.labels(engine=self.name, outcome="rejected").inc()
            get_device_health().note_failure(e, where="engine.admit")
            _fail(fut, e)
            return
        track["prefill_s"] = time.perf_counter() - t_admit
        self._mx["prefill"].observe(track["prefill_s"])
        self._track[rid] = track
        self._pend[rid] = fut

    def _pump(self, block: bool, drain: Optional[Callable[[], None]] = None) -> None:
        """Act on control items at once and move new submissions to the
        waiting list (blocking briefly when idle), then admit while slots
        are free, calling ``drain`` first (it processes a verify chunk in
        flight). The hand-off to ``_waiting`` holds the submit lock;
        admission runs outside it."""
        try:
            while True:
                item = self._q.get(timeout=0.1) if block else self._q.get_nowait()
                block = False
                if item[0] in ("cancel", "prefix"):
                    self._control(item)
                    continue
                with self._submit_lock:
                    self._waiting.append(item)
        except queue.Empty:
            pass
        while self.cb.has_capacity:
            with self._submit_lock:
                if not self._waiting:
                    break
                item = self._pick_waiting_locked()
            if drain is not None:
                drain()
            self._admit_one(item)

    def _loop(self) -> None:
        """Supervise the serve loop (see the class docstring). Whatever ends
        it, nothing pending is left to hang."""
        try:
            self._supervise()
        finally:
            self._fail_all(RuntimeError("ServingEngine closed"))

    def _supervise(self) -> None:
        if self.cb.device.type == "cuda":
            torch.cuda.set_device(self.cb.device)
        backoff = 0.1
        while True:
            try:
                self._serve()
                return  # clean close()
            except Exception as e:  # noqa: BLE001 — a dead loop must not strand its callers
                self._mx["errors"].inc()
                # A death that looks like the card going away (not a
                # software fault) latches degraded mode: generation fails
                # fast from then on and the probe owns recovery.
                get_device_health().note_failure(e, where="engine.loop")
                self.recorder.record("engine_error", error=f"{type(e).__name__}: {e}")
                log.error(
                    "serving engine %s loop died (%s: %s); flight recorder dump: %s",
                    self.name, type(e).__name__, e, self.recorder.dump_json(),
                )
                # The frames of the failed chunk hold the dead batcher's
                # tensors; let them go before the rebuild allocates.
                traceback.clear_frames(e.__traceback__)
                if self._closed.is_set():
                    self._fail_all(RuntimeError(f"ServingEngine closed (loop died during shutdown: {e})"))
                    return
                if self._restarts >= self._restart_budget:
                    self._die(e)
                    return
                self._restarts += 1
                self._mx["restarts"].inc()
                self._fail_inflight(EngineRetryableError(
                    f"ServingEngine loop died mid-decode ({type(e).__name__}: {e}); restarting — safe to resubmit"
                ))
                try:
                    self._rebuild(self.cb)
                except Exception as rebuild_err:  # noqa: BLE001 — a sticky CUDA error, an OOM
                    log.error("serving engine %s rebuild failed: %s", self.name, rebuild_err)
                    self._die(rebuild_err)
                    return
                self.recorder.record(
                    "engine_restart", attempt=self._restarts, budget=self._restart_budget,
                    backoff_s=round(backoff, 3),
                )
                log.warning(
                    "serving engine %s restarted (%d/%d) after %s: %s; re-admitting queued requests",
                    self.name, self._restarts, self._restart_budget, type(e).__name__, e,
                )
                if self._closed.wait(backoff):
                    return
                backoff = min(backoff * 2.0, 5.0)

    def _die(self, cause: BaseException) -> None:
        """Terminal death: latch ``_dead`` (submit and register_prefix
        raise EngineDeadError from then on) and fail everything pending."""
        with self._submit_lock:
            self._dead.set()
            self._closed.set()
        self._fail_all(EngineDeadError(
            f"ServingEngine loop died terminally after {self._restarts} restart(s): "
            f"{type(cause).__name__}: {cause}"
        ))

    def _serve(self) -> None:
        # Pipelined: enqueue chunk i+1 before reading chunk i's tokens, so the
        # host's bookkeeping and the next chunk's launches overlap the card.
        # Verify chunks pipeline the same way (their positions stay on the
        # card) while every slot is on a live prediction chain; otherwise
        # the loop reads the chunk in flight, drafts on real history and
        # enqueues the next. A switch of flavor processes the other
        # flavor's chunk in flight first, and so does an admission.
        pipelined = os.environ.get("KAKVEDA_SERVE_PIPELINE", "1") != "0"
        finish = self._finish_rids
        pending = None  # plain chunk in flight
        pending_spec = None  # verify chunk in flight

        def drain_spec() -> None:
            nonlocal pending_spec
            if pending_spec is not None:
                handle, pending_spec = pending_spec, None
                finish(self.cb.process_spec_chunk(handle))

        while not self._closed.is_set():
            self._pump(
                block=not self.cb.slots and pending is None and pending_spec is None and not self._waiting,
                drain=drain_spec,
            )
            # Between chunks: expired requests retire through the done-flag
            # path, safe while a chunk of either flavor is in flight.
            self._expire_deadlines()
            cb = self.cb
            if cb.spec_ready():
                finish(cb.process_chunk(pending))
                pending = None
                if not cb.slots:
                    drain_spec()
                    continue
                self._note_active()
                if pipelined and pending_spec is not None and cb.spec_pipeline_ready():
                    nxt = cb.step_spec_async()
                    drain_spec()
                    pending_spec = nxt
                    self._bump("chunks")
                else:
                    drain_spec()
                    if cb.slots and cb.spec_ready():
                        handle = cb.step_spec_async()
                        self._bump("chunks")
                        if pipelined:
                            pending_spec = handle
                        else:
                            finish(cb.process_spec_chunk(handle))
            elif cb.slots:
                drain_spec()
                if not cb.slots:
                    continue  # the drain retired the whole pool
                self._note_active()
                handle = cb.step_async()
                self._bump("chunks")
                if pipelined:
                    finish(cb.process_chunk(pending))
                    pending = handle
                else:
                    finish(cb.process_chunk(handle))
            else:
                finish(cb.process_chunk(pending))
                pending = None
                drain_spec()
