"""Continuous batching — the online serving path.

Counterpart of ``kakveda_tpu/models/serving.py`` (its core and the prefix
cache; see the ROADMAP for what is not ported yet: speculative chunks and
the prefix store's n-gram index they draft from, deadlines and cancel, the
supervisor's restarts and its list of prefixes to register again, and the
admission, metrics, ledger and trace hooks).

A :class:`ContinuousBatcher` owns a fixed ``[B, KV, max_len, D]`` KV cache
and treats the batch axis as B independent slots:

* **admit** prefills one prompt, left-padded to a power-of-two bucket, into
  a ``[1, ...]`` scratch cache (so its attention sees only this prompt) and
  copies the rows into its slot, in place. A prompt that starts with a
  registered prefix (:meth:`ContinuousBatcher.register_prefix`) gets the
  prefix's K/V slab in its scratch and prefills only a power-of-two tail;
* **step** advances every active slot by ``chunk_steps`` tokens, one
  :func:`_forward_wide` per token with per-slot positions; inactive slots
  decode garbage into their own rows, masked from everyone by ``kv_valid``;
* **retire** frees EOS- or budget-finished slots on the host between chunks.

Greedy outputs are slot-for-slot identical to a solo ``generate_tokens``.
Everything runs eagerly on one CUDA stream: a chunk is enqueued without
waiting for the card (host mirrors go up through pinned memory), and only
:meth:`ContinuousBatcher.process_chunk` copies its tokens back, so the
engine can enqueue chunk i+1 before it reads chunk i.

:class:`ServingEngine` puts one batcher behind a thread-safe ``submit`` →
``Future`` API: one loop thread admits, steps and retires for every caller.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kakveda_tpu_torch.core.admission import get_device_health
from kakveda_tpu_torch.models.attention import gqa_cache_attention
from kakveda_tpu_torch.models.llama import (
    LlamaConfig,
    Params,
    _kv_quant_rows,
    _rope_freqs,
    apply_rope,
    decode_step,
    embed_tokens,
    init_cache,
    mask_pad_vocab,
    mlp_block,
    qkv_proj,
    rms_norm,
    softcap_logits,
    wmat,
)
from kakveda_tpu_torch.ops.knn import pow2_bucket

log = logging.getLogger("kakveda.serving")


def _h2d(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of a host array on ``device`` that does not wait for the card:
    staged through pinned memory and copied on the current stream. A copy,
    because the host mirrors keep changing while queued work reads it."""
    t = torch.from_numpy(np.array(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _forward_wide(
    params: Params,
    cfg: LlamaConfig,
    cache: Params,
    tokens: torch.Tensor,  # [B, 1]
    slot_pos: torch.Tensor,  # [B] cache row each slot writes
    kv_valid: torch.Tensor,  # [B, L] bool
    pos_offset: torch.Tensor,  # [B]
    write_rows: Optional[torch.Tensor] = None,  # slots whose row is inside the window
    reach: Optional[int] = None,  # host int: 1 + the largest slot_pos of an active slot
) -> torch.Tensor:
    """One decode token for every slot with PER-SLOT positions: slot b writes
    cache row ``slot_pos[b]`` (in place) and attends rows ``col <=
    slot_pos[b]`` within ``kv_valid`` (and the sliding-window band). The
    mask is a ``[B, L]`` ``kv_valid`` with ``pos0 = max_len``, so the flash
    kernel's scalar causal term is a no-op; ``reach`` tells the kernel's
    schedule which rows the mask can show (a hint, exact either way). Slots
    whose row lies past the window (overshoot, discarded on the host) are
    left out of ``write_rows`` and write nothing — the JAX scatter's
    ``mode="drop"``. Returns logits [B, 1, V] f32, vocab-masked."""
    b, s = tokens.shape
    if s != 1:
        raise ValueError("_forward_wide: one token per slot (speculative chunks are not ported)")
    hd = cfg.head_dim
    max_len = cache["k"][0].shape[2]
    kq = cfg.kv_quant == "int8"
    dev = tokens.device

    cos, sin = _rope_freqs(cfg, (slot_pos - pos_offset)[:, None])
    x = embed_tokens(params, cfg, tokens)
    col = torch.arange(max_len, device=dev)[None, :]
    base_mask = kv_valid & (col <= slot_pos[:, None])  # [B, L]
    win_mask = base_mask
    if cfg.sliding_window:
        win_mask = base_mask & (col > slot_pos[:, None] - cfg.sliding_window)
    rows = torch.arange(b, device=dev) if write_rows is None else write_rows
    wcols = slot_pos[rows]

    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        dt = h.dtype
        q, k, v = qkv_proj(h, layer, cfg, dt)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_new, v_new = k[rows, 0], v[rows, 0]  # [n, KV, D]
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
        mask = win_mask if cfg.layer_window(li) else base_mask
        attn = gqa_cache_attention(
            q, cache["k"][li], cache["v"][li], max_len, mask,
            softcap=cfg.attn_softcap, k_scale=ks, v_scale=vs, reach=reach,
        )
        x = x + attn.reshape(b, s, cfg.n_heads * hd) @ wmat(layer["wo"], dt)
        x = x + mlp_block(rms_norm(x, layer["mlp_norm"], cfg.norm_eps), layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ wmat(params["lm_head"], cfg.dtype)).float()
    logits = softcap_logits(logits, cfg.final_softcap)
    return mask_pad_vocab(logits, cfg)


@dataclass
class _Prefix:
    """One registered prompt prefix: its token ids and per-layer K/V slabs
    ``[1, KV, plen, D]`` (int8 with f32 scales ``[1, KV, plen]`` under an
    int8 cache)."""

    ids: Tuple[int, ...]
    kv: Dict[str, List[torch.Tensor]]


@dataclass
class _Slot:
    req_id: int
    prompt_len: int
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Admit-as-you-go generation over a fixed slot pool. Greedy by
    default; a request's ``temperature`` samples that slot only."""

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
    ):
        self.params, self.cfg = params, cfg
        self.device = params["embed"].device
        self.B, self.max_len = batch_slots, max_len
        self.chunk_steps = chunk_steps
        self.eos_id = eos_id
        self.generator = generator
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
        # Forward passes run: one per admission, prefix registration and
        # decode step. Each runs every layer's attention once.
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
        self._prefixes[ids] = _Prefix(ids=ids, kv={k: scratch[k] for k in keys})
        self.prefix_stats["registered"] += 1
        return True

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

    def admit(self, prompt_ids: List[int], max_new_tokens: int = 64, temperature: float = 0.0) -> int:
        """Prefill into a free slot; returns a request id. With a prefix
        match (unless ``KAKVEDA_SERVE_PREFIX=0``) the slab goes to rows
        ``[off, off + plen)`` of the scratch cache and one ``decode_step``
        of the suffix runs from row ``off + split``: RoPE rotates by the
        logical position (row − off), so one slab serves every bucket."""
        if not self.free:
            raise RuntimeError("no free slot; call step() until one retires")
        p = len(prompt_ids)
        if p + 1 >= self.max_len:
            raise ValueError("prompt too long for the slot window")
        bucket = self.bucket_for(p, self.max_len)
        off = bucket - p
        slot = self.free.pop()
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
            self.prefix_stats["hits"] += 1
            self.prefix_stats["hit_tokens_saved"] += split
            plen = len(pe.ids)
            for key, slabs in pe.kv.items():
                for sk, pk in zip(scratch[key], slabs):
                    sk[:, :, off : off + plen] = pk
            scratch["pos"] = off + split
            prompt = torch.tensor([list(prompt_ids[split:])], dtype=torch.long, device=dev)
        else:
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
        self.slots[slot] = _Slot(req_id=rid, prompt_len=bucket, max_new=max_new_tokens)
        return rid

    def step_async(self):
        """Enqueue one decode chunk without reading its tokens; returns a
        handle for :meth:`process_chunk` (None when no slot is active).

        Retirement is then seen one chunk late: the overshoot steps write
        nothing past the window, each slot attends only its own rows, and
        :meth:`process_chunk` drops tokens of slots already done — outputs
        equal the unpipelined path's."""
        if not self.slots:
            return None
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
            inside = pos_h + t < self.max_len
            rows = None if inside.all() else _h2d(np.flatnonzero(inside), dev)
            logits = _forward_wide(
                self.params, self.cfg, self.cache, nxt[:, None], pos + t, kv_valid, pos_offset, rows,
                reach=top + t + 1,
            )
            last = logits[:, -1, :]
            self.forwards += 1
        self.last = last
        self._pos_np += self.chunk_steps  # every slot advances in lockstep
        return toks, dict(self.slots)

    def process_chunk(self, handle) -> List[int]:
        """Read an enqueued chunk's tokens and retire finished slots;
        returns the request ids that chunk completed."""
        if handle is None:
            return []
        toks, snapshot = handle
        toks_h = toks.cpu().numpy()
        finished: List[int] = []
        for slot, st in snapshot.items():
            if st.done:
                continue  # retired by an earlier chunk: overshoot tokens
            self._emit(slot, st, toks_h[slot], finished)
        return finished

    def _emit(self, slot: int, st: _Slot, tok_row, finished: List[int]) -> None:
        """Accept a chunk's tokens into a slot (EOS / budget / window stops);
        retire it when done."""
        for t in tok_row:
            t = int(t)
            if self.eos_id is not None and t == self.eos_id:
                st.done = True
                break
            st.out.append(t)
            if len(st.out) >= st.max_new or st.prompt_len + len(st.out) + 1 >= self.max_len:
                st.done = True
                break
        if st.done:
            self.results[st.req_id] = st.out
            finished.append(st.req_id)
            del self.slots[slot]
            self.free.append(slot)
            self._kv_np[slot] = False

    def _grow_valid(self, steps: int) -> None:
        """Each active slot may read its next ``steps`` rows as it writes
        them (reads stay bounded per step by ``col <= slot_pos``); the left
        pad [0, pos_offset) stays invalid."""
        ar = np.arange(self.max_len)[None, :]
        active = np.zeros((self.B,), bool)
        active[list(self.slots)] = True
        limit = (self._pos_np + steps)[:, None]
        self._kv_np |= active[:, None] & (ar >= self._off_np[:, None]) & (ar < limit)

    def step(self) -> List[int]:
        """One decode chunk for every active slot; returns the request ids
        it finished (their tokens land in ``results``)."""
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
    together and resolves each caller's Future. An exception in the loop
    fails every pending Future and closes the engine (``submit`` then
    raises); ``close()`` does the same for whatever is still pending."""

    def __init__(
        self,
        params: Params,
        cfg: LlamaConfig,
        *,
        batch_slots: int = 8,
        max_len: int = 512,
        chunk_steps: int = 8,
        eos_id: Optional[int] = None,
    ):
        self.cb = ContinuousBatcher(
            params, cfg, batch_slots=batch_slots, max_len=max_len, chunk_steps=chunk_steps,
            eos_id=eos_id,
        )
        self._q: "queue.Queue[tuple]" = queue.Queue()
        self._closed = threading.Event()
        self._lock = threading.Lock()  # the submit/close race and _waiting
        self._pend: Dict[int, Future] = {}  # loop-owned: admitted requests
        self._waiting: List[tuple] = []  # submitted, waiting for a slot
        self._thread = threading.Thread(target=self._loop, daemon=True, name="serving-engine")
        self._thread.start()

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """True when the request runs in the pool without truncating where a
        solo decode would not: the admission bucket plus the whole token
        budget must fit the slot window."""
        ml = self.cb.max_len
        if prompt_len + 1 >= ml:
            return False
        return ContinuousBatcher.bucket_for(prompt_len, ml) + max_new_tokens + 1 <= ml

    def submit(self, prompt_ids: List[int], max_new_tokens: int = 64, temperature: float = 0.0) -> Future:
        """Enqueue a request; the Future resolves to the generated id list.
        While the card is latched DEGRADED it raises
        ``DeviceUnavailableError`` at once (fail fast, never a hang)."""
        get_device_health().check()
        with self._lock:
            if self._closed.is_set():
                raise RuntimeError("ServingEngine is closed")
            fut: Future = Future()
            self._q.put((list(prompt_ids), max_new_tokens, temperature, fut))
            return fut

    def register_prefix(self, prefix_ids: List[int], timeout: float = 120.0) -> bool:
        """``ContinuousBatcher.register_prefix`` on the loop thread (the
        batcher is the loop's, so a registration never races a chunk);
        blocks for the answer."""
        with self._lock:
            if self._closed.is_set():
                raise RuntimeError("ServingEngine is closed")
            fut: Future = Future()
            self._q.put(("prefix", list(prefix_ids), fut))
        return bool(fut.result(timeout=timeout))

    def close(self) -> None:
        with self._lock:
            self._closed.set()
        self._thread.join(timeout=60.0)
        self._fail_all(RuntimeError("ServingEngine closed"))

    def _fail_all(self, err: BaseException) -> None:
        with self._lock:
            while True:
                try:
                    *_, fut = self._q.get_nowait()
                except queue.Empty:
                    break
                _fail(fut, err)
            for item in self._waiting:
                _fail(item[-1], err)
            self._waiting.clear()
            for fut in self._pend.values():
                _fail(fut, err)
            self._pend.clear()

    def _loop(self) -> None:
        err: Optional[BaseException] = None
        try:
            if self.cb.device.type == "cuda":
                torch.cuda.set_device(self.cb.device)
            self._serve()
        except Exception as e:  # noqa: BLE001 — a dead loop must not strand its callers
            err = e
            log.exception("serving engine loop died")
            # A death that looks like the card going away (not a software
            # fault) latches degraded mode: generation fails fast from then
            # on and the probe owns recovery.
            get_device_health().note_failure(e, where="engine.loop")
        finally:
            with self._lock:
                self._closed.set()
            self._fail_all(
                RuntimeError(f"ServingEngine loop died: {type(err).__name__}: {err}")
                if err is not None else RuntimeError("ServingEngine closed")
            )

    def _register(self, item) -> None:
        _, ids, fut = item
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(self.cb.register_prefix(ids))
        except Exception as e:  # noqa: BLE001 — a registration's error is its caller's
            _fail(fut, e)

    def _admit_one(self, item) -> None:
        ids, max_new, temp, fut = item
        if not fut.set_running_or_notify_cancel():
            return  # cancelled while waiting
        try:
            rid = self.cb.admit(ids, max_new_tokens=max_new, temperature=temp)
        except ValueError as e:  # the request's own fault (too long): the caller's error
            fut.set_exception(e)
            return
        self._pend[rid] = fut

    def _pump(self, block: bool) -> None:
        """Run prefix registrations at once and move new submissions to the
        waiting list (blocking briefly when idle), then admit while slots
        are free."""
        try:
            while True:
                item = self._q.get(timeout=0.1) if block else self._q.get_nowait()
                block = False
                if item[0] == "prefix":
                    self._register(item)
                    continue
                with self._lock:
                    self._waiting.append(item)
        except queue.Empty:
            pass
        while self.cb.has_capacity:
            with self._lock:
                if not self._waiting:
                    break
                item = self._waiting.pop(0)
            self._admit_one(item)

    def _finish(self, rids: List[int]) -> None:
        for rid in rids:
            fut = self._pend.pop(rid, None)
            toks = self.cb.results.pop(rid, [])
            if fut is not None and not fut.done():
                fut.set_result(toks)

    def _serve(self) -> None:
        # Pipelined: enqueue chunk i+1 before reading chunk i's tokens, so the
        # host's bookkeeping and the next chunk's launches overlap the card.
        pending = None
        while not self._closed.is_set():
            self._pump(block=not self.cb.slots and pending is None and not self._waiting)
            if self.cb.slots:
                handle = self.cb.step_async()
                self._finish(self.cb.process_chunk(pending))
                pending = handle
            else:
                self._finish(self.cb.process_chunk(pending))
                pending = None
