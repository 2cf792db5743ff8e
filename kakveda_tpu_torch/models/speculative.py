"""Draft-free speculative decoding (prompt lookup).

Counterpart of ``kakveda_tpu/models/speculative.py``. Decode at batch 1
reads every weight once per token; a verify forward over k+1 positions
reads them once too, so guessing the next k tokens and keeping the longest
run the model agrees with emits 1..k+1 tokens per weight stream, and the
tokens equal plain greedy decoding by construction. Drafts come from the
sequence itself (n-gram continuation), which pays on the repetitive text
of judge templates and citation lists.

* :func:`copy_run` and :class:`NgramIndex` are the host half of the
  serving engine's speculation (``models/serving.py``): its drafts are
  host lookups between chunks, kept O(k) per slot by an incremental suffix
  index and a copy cursor. Own copies of the JAX package's, line for line.
* :func:`generate_tokens_speculative` is the solo path
  (``KAKVEDA_SPEC=1``). The JAX package runs it as one ``lax.while_loop``;
  here it is a host loop of :func:`decode_step` at S = k+1 from a host
  ``pos0``, whose bigram draft lookup, acceptance and token buffer stay on
  the device. Each round copies one accepted count back, the position the
  next round's forward starts from; the logits never leave the device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from kakveda_tpu_torch.models.llama import LlamaConfig, Params, decode_step, init_cache, mask_pad_vocab


def copy_run(
    toks: List[int], start: int, count: int, period: int, n: Optional[int] = None
) -> Tuple[List[int], int]:
    """Copy ``count`` tokens from ``toks`` starting at ``start``, wrapping
    back by ``period`` past index ``n`` (default: the length at call time).

    The wrap extrapolates periodically: a suffix that matched at anchor j
    hypothesizes ``hist[t] == hist[t - p]`` with ``p = n - 1 - j``, so a copy
    that runs off the end of history re-enters one period back instead of
    going empty (a trailing run of one token, period 1, tiles forward).
    ``period <= 0`` (a copy out of another corpus) stops at the end instead.
    ``n`` freezes the wrap boundary, so a cursor stays deterministic while
    the history list grows. Returns ``(tokens, next_index)``; the tokens
    fall short of ``count`` only when ``period <= 0``."""
    n = len(toks) if n is None else n
    out: List[int] = []
    idx = start
    for _ in range(count):
        while idx >= n:
            if period <= 0:
                return out, idx
            idx -= period
        out.append(toks[idx])
        idx += 1
    return out, idx


class NgramIndex:
    """Incremental suffix index over a token stream: three dicts map every
    1/2/3-gram to its most recent end position, so ``append`` is O(1), and
    ``anchor`` — the most recent earlier occurrence of the longest suffix
    (3, then 2, then 1 tokens) ending at the tail — is kept as tokens
    arrive. ``lookup`` answers the same question for a foreign tail (drafts
    out of a registered prefix's ids)."""

    __slots__ = ("toks", "_maps", "anchor")

    def __init__(self, toks=()):
        self.toks: List[int] = []
        self._maps: Tuple[dict, dict, dict] = ({}, {}, {})
        self.anchor: Tuple[int, int] = (-1, 0)  # (end pos, match len)
        for t in toks:
            self.append(t)

    def append(self, t: int) -> None:
        toks = self.toks
        toks.append(int(t))
        i = len(toks) - 1
        # The anchor before position i is indexed: the maps hold only earlier
        # occurrences, so the suffix never matches itself.
        self.anchor = (-1, 0)
        for m in (3, 2, 1):
            if i + 1 >= m:
                j = self._maps[m - 1].get(tuple(toks[i - m + 1 : i + 1]), -1)
                if j >= 0:
                    self.anchor = (j, m)
                    break
        for m in (1, 2, 3):
            if i + 1 >= m:
                self._maps[m - 1][tuple(toks[i - m + 1 : i + 1])] = i

    def lookup(self, tail: List[int]) -> Tuple[int, int]:
        """(end pos, match len) of the most recent occurrence in this corpus
        of the longest suffix of ``tail`` (3, 2, 1); (-1, 0) on a miss. The
        hit may be the corpus's own tail: a caller copying what follows it
        checks that the copy is not empty."""
        for m in (3, 2, 1):
            if len(tail) >= m:
                j = self._maps[m - 1].get(tuple(tail[-m:]), -1)
                if j >= 0:
                    return j, m
        return -1, 0


def generate_tokens_speculative(
    params: Params,
    cfg: LlamaConfig,
    prompt_ids: List[int],
    *,
    max_new_tokens: int = 64,
    k: int = 4,
    eos_id: Optional[int] = None,
    max_len: Optional[int] = None,
    return_stats: bool = False,
):
    """Greedy decode with prompt-lookup speculation; token for token the
    plain greedy ``generate_tokens`` (when the cache window cuts the
    generation, the verify chunk's k+1 rows of headroom may cost up to k+1
    trailing tokens; what is emitted is always the same prefix). ``k`` is
    the draft length of a round; each round is one forward of k+1 rows at
    the host position ``vl`` and emits 1..k+1 tokens. A round drafts, on the
    device, the k tokens that followed the most recent earlier occurrence
    of the bigram (previous token, this round's first token), the JAX
    package's vectorized lookup. With ``return_stats`` returns ``(tokens,
    {"rounds", "tokens_per_round"})``: rounds is the number of weight
    streams the generation cost."""
    from kakveda_tpu_torch.models.generate import _bucket_len

    dev = params["embed"].device
    plen = len(prompt_ids)
    ml = max_len or _bucket_len(plen + max_new_tokens + k + 2, cfg.max_seq_len)
    # A round writes k+1 cache rows, so the window keeps k+2 rows of
    # headroom: the budget is clamped to it, and a prompt that leaves none
    # is refused.
    max_new = min(max_new_tokens, ml - plen - k - 2)
    if max_new <= 0:
        raise ValueError(
            f"prompt ({plen} tokens) leaves no speculative decode room in the "
            f"cache window (max_len={ml}, k={k}); truncate the prompt or raise max_len"
        )
    cache = init_cache(cfg, batch=1, max_len=ml, device=dev)
    buf = torch.zeros(ml, dtype=torch.long, device=dev)
    buf[:plen] = torch.tensor(prompt_ids, dtype=torch.long)
    logits, cache = decode_step(params, cfg, buf[None, :plen], cache, last_only=True)
    last = mask_pad_vocab(logits[0, -1], cfg)  # [V]
    sl = torch.arange(ml, device=dev)
    ar = torch.arange(k, device=dev)
    vl, rounds = plen, 0
    while vl < plen + max_new:
        t0 = last.argmax()
        buf[vl] = t0
        prev = buf[max(vl - 1, 0)]
        hit = (torch.roll(buf, 1) == prev) & (buf == t0) & (sl >= 1) & (sl <= vl - 1)
        j = torch.where(hit, sl, 0).max()  # 0 on a miss: a draft verification rejects
        draft = buf[(j + 1).clamp(0, ml - k - 1) + ar]
        cache["pos"] = vl
        logits, cache = decode_step(params, cfg, torch.cat([t0[None], draft])[None], cache)
        preds = mask_pad_vocab(logits[0], cfg).argmax(dim=-1)  # [k+1]
        a = torch.cumprod((draft == preds[:k]).long(), 0).sum()
        # The accepted drafts into rows vl+1 .. vl+a (the draft may come from
        # anywhere in the buffer); the window never clips: vl + k + 1 < ml.
        buf[vl + 1 : vl + 1 + k] = torch.where(ar < a, draft, buf[vl + 1 : vl + 1 + k])
        last = logits[0].index_select(0, a[None])[0]  # after the accepted run
        vl += int(a) + 1  # the round's one copy to the host
        rounds += 1
    n = min(vl - plen, max_new)
    toks = buf[plen : plen + n].tolist()
    if eos_id is not None and eos_id in toks:
        toks = toks[: toks.index(eos_id)]
    if return_stats:
        return toks, {"rounds": rounds, "tokens_per_round": (vl - plen) / max(rounds, 1)}
    return toks
