"""Tokenizers for the in-tree Llama: bytes by default, or a checkpoint's own.

:class:`ByteTokenizer` is a copy of ``kakveda_tpu/models/tokenizer.py``'s,
the hermetic default: token = byte value + 3, plus BOS/EOS/PAD specials;
any utf-8 string round-trips. :class:`HFTokenizer` has the reference's
surface over a local HF checkpoint directory, but reads the tokenizer files
itself: it needs neither ``transformers`` nor ``tokenizers``, so it serves
on a machine that has neither.

What the reader takes, as ``transformers.AutoTokenizer`` over ``tokenizers``
runs it (``encode`` without the post-processor's specials, ``decode`` with
``skip_special_tokens=True``), and every other component raises a
``ValueError`` that names it:

* the model: BPE, with its ``vocab``, its ``merges`` as ``"a b"``
  strings or as ``["a", "b"]`` pairs (``tokenizers`` 0.20+) and an
  ``unk_token``;
* the added tokens of ``tokenizer.json`` (and any of
  ``tokenizer_config.json``'s ``added_tokens_decoder`` missing there), split
  out of the text before the pre-tokenizer, leftmost-longest (an added
  token's ``lstrip``, ``rstrip`` or ``single_word`` raises);
* no normalizer;
* the pre-tokenizers ``Whitespace`` (``\\w+|[^\\w\\s]+``), ``ByteLevel``
  (GPT-2's split, with ``add_prefix_space`` and ``use_regex``) and a
  ``Sequence`` of them. Python's ``re`` has no ``\\p{L}`` / ``\\p{N}``, so
  both splits are scanners over ``unicodedata`` categories. A top-level
  pre-tokenizer's ``add_prefix_space`` is ``tokenizer_config.json``'s
  (False when it has none), as ``transformers`` overrides it at load;
* the ``ByteLevel`` decoder, or none (tokens joined with a space), then
  ``clean_up_tokenization_spaces`` when the config asks for it;
* the names of the special tokens from ``tokenizer_config.json`` and
  ``special_tokens_map.json`` (the latter wins), a named token missing from
  the vocabulary appended to it as ``transformers`` does.
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Optional, Tuple


class ByteTokenizer:
    PAD = 0
    BOS = 1
    EOS = 2
    _OFFSET = 3

    vocab_size = 256 + _OFFSET

    def encode(self, text: str, *, bos: bool = True, eos: bool = False) -> List[int]:
        ids = [b + self._OFFSET for b in text.encode("utf-8")]
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: List[int]) -> str:
        data = bytes(i - self._OFFSET for i in ids if i >= self._OFFSET)
        return data.decode("utf-8", errors="replace")


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte → printable character map (the ``ByteLevel`` alphabet)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_CHAR = _bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}
_WORD_CATS = {"Lu", "Ll", "Lt", "Lm", "Lo", "Nl", "Mn", "Mc", "Me", "Nd", "Pc"}


def _is_word(ch: str) -> bool:
    """Regex ``\\w`` over Unicode: letters, marks, decimal digits,
    connector punctuation and the joiners."""
    return unicodedata.category(ch) in _WORD_CATS or ch in "‌‍"


def _class(ch: str) -> str:
    """GPT-2's classes: ``s`` whitespace, ``L`` a letter, ``N`` a number,
    ``o`` anything else."""
    if ch.isspace():
        return "s"
    cat = unicodedata.category(ch)
    return cat[0] if cat[0] in "LN" else "o"


def _split_whitespace(text: str) -> List[str]:
    """The ``Whitespace`` pre-tokenizer: runs of ``\\w`` and runs of
    ``[^\\w\\s]``; whitespace separates and is dropped."""
    out, i, n = [], 0, len(text)
    while i < n:
        if text[i].isspace():
            i += 1
            continue
        word = _is_word(text[i])
        j = i + 1
        while j < n and not text[j].isspace() and _is_word(text[j]) == word:
            j += 1
        out.append(text[i:j])
        i = j
    return out


_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _split_gpt2(text: str) -> List[str]:
    """GPT-2's pattern, ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
    ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, as a leftmost-first scanner."""
    out, i, n = [], 0, len(text)
    cls = [_class(c) for c in text]
    while i < n:
        if text[i] == "'":
            suf = next((s for s in _CONTRACTIONS if text.startswith(s, i + 1)), None)
            if suf is not None:
                out.append(text[i : i + 1 + len(suf)])
                i += 1 + len(suf)
                continue
        j = i + 1 if text[i] == " " and i + 1 < n and cls[i + 1] != "s" else i
        if cls[j] != "s":
            k = j + 1
            while k < n and cls[k] == cls[j]:
                k += 1
            out.append(text[i:k])
            i = k
            continue
        k = i
        while k < n and cls[k] == "s":
            k += 1
        if k < n and k - i >= 2:  # \s+(?!\S): the run but its last, which goes with what follows
            k -= 1
        out.append(text[i:k])
        i = k
    return out


class _ByteLevel:
    def __init__(self, add_prefix_space: bool, use_regex: bool):
        self.add_prefix_space = add_prefix_space
        self.use_regex = use_regex

    def __call__(self, piece: str) -> List[str]:
        if self.add_prefix_space and not piece.startswith(" "):
            piece = " " + piece
        parts = _split_gpt2(piece) if self.use_regex else [piece]
        return ["".join(_BYTE_CHAR[b] for b in p.encode("utf-8")) for p in parts]


def _pre_tokenizer(spec: Optional[dict], top_prefix_space: bool, top: bool = True) -> list:
    """The pre-tokenizer's steps, each a ``str -> [str]``."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Whitespace":
        return [_split_whitespace]
    if kind == "ByteLevel":
        prefix = top_prefix_space if top else bool(spec.get("add_prefix_space", True))
        return [_ByteLevel(prefix, bool(spec.get("use_regex", True)))]
    if kind == "Sequence":
        steps = []
        for sub in spec.get("pretokenizers", []):
            steps += _pre_tokenizer(sub, top_prefix_space, top=False)
        return steps
    raise ValueError(f"tokenizer.json: the pre-tokenizer {kind!r} is not supported (Whitespace, ByteLevel, Sequence)")


def _token_name(value) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return value


class HFTokenizer:
    """A checkpoint's own vocabulary, from the tokenizer files in ``path``
    (normally the checkpoint directory itself; nothing is downloaded), with
    :class:`ByteTokenizer`'s ``encode``/``decode`` surface and the JAX
    package's ``HFTokenizer``'s ids: ``BOS``, ``EOS``, ``PAD`` (else EOS,
    else 0), ``vocab_size`` (added tokens included). Reads
    ``tokenizer.json``, ``tokenizer_config.json`` and
    ``special_tokens_map.json`` itself (module docstring)."""

    def __init__(self, path: str):
        tj = self._read(path, "tokenizer.json", required=True)
        config = self._read(path, "tokenizer_config.json")
        names = dict(config)
        names.update(self._read(path, "special_tokens_map.json"))
        model = tj.get("model") or {}
        if model.get("type", "BPE") != "BPE" or "merges" not in model:
            raise ValueError(f"tokenizer.json: the model {model.get('type')!r} is not supported (BPE only)")
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix", "byte_fallback", "fuse_unk",
                    "ignore_merges"):
            if model.get(key):
                raise ValueError(f"tokenizer.json: the BPE option {key}={model[key]!r} is not supported")
        if tj.get("normalizer") is not None:
            raise ValueError(f"tokenizer.json: the normalizer {tj['normalizer'].get('type')!r} is not supported")
        decoder = tj.get("decoder")
        if decoder is not None and decoder.get("type") != "ByteLevel":
            raise ValueError(f"tokenizer.json: the decoder {decoder.get('type')!r} is not supported (ByteLevel)")
        self._byte_decoder = decoder is not None
        self._steps = _pre_tokenizer(tj.get("pre_tokenizer"), bool(config.get("add_prefix_space", False)))
        self._clean_up = bool(config.get("clean_up_tokenization_spaces", False))

        self._vocab: Dict[str, int] = dict(model["vocab"])
        self._unk = self._vocab.get(model["unk_token"]) if model.get("unk_token") is not None else None
        self._merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(model["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            new = self._vocab.get(a + b)
            ia, ib = self._vocab.get(a), self._vocab.get(b)
            if new is None or ia is None or ib is None:
                raise ValueError(f"tokenizer.json: the merge {a!r} + {b!r} names a token outside the vocab")
            self._merges.setdefault((ia, ib), (rank, new))

        added = {t["content"]: dict(t) for t in tj.get("added_tokens", [])}
        for tid, t in sorted(config.get("added_tokens_decoder", {}).items(), key=lambda kv: int(kv[0])):
            added.setdefault(t["content"], dict(t, id=int(tid)))
        for c, t in added.items():
            flags = [f for f in ("lstrip", "rstrip", "single_word") if t.get(f)]
            if flags:
                raise ValueError(f"tokenizer.json: the added token {c!r} sets {flags}, which is not supported")
        self._added = added
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        self._id_to_token.update({t["id"]: c for c, t in added.items()})
        special = {c for c, t in added.items() if t.get("special")}
        extra = names.get("additional_special_tokens") or []
        for key in ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token", "mask_token"):
            extra = extra + [names.get(key)]
        for tok in filter(None, map(_token_name, extra)):  # transformers adds each named token
            special.add(tok)
            if tok not in added:
                tid = self._vocab.get(tok, len(self._token_ids()))
                added[tok] = {"id": tid, "content": tok, "special": True, "normalized": False}
                self._id_to_token[tid] = tok
        self._special = special
        self.vocab_size = len(self._token_ids())
        self.BOS = self._lookup(names.get("bos_token"))
        self.EOS = self._lookup(names.get("eos_token"))
        pad = self._lookup(names.get("pad_token"))
        self.PAD = pad if pad is not None else (self.EOS if self.EOS is not None else 0)
        self._cache: Dict[str, List[int]] = {}

    @staticmethod
    def _read(path: str, name: str, required: bool = False) -> dict:
        f = os.path.join(path, name)
        if not os.path.exists(f):
            if required:
                raise ValueError(f"{path}: no {name} (the reader takes a tokenizer.json)")
            return {}
        with open(f, encoding="utf-8") as fh:
            return json.load(fh)

    def _token_ids(self) -> Dict[str, int]:
        ids = dict(self._vocab)
        ids.update({c: t["id"] for c, t in self._added.items()})
        return ids

    def _lookup(self, value) -> Optional[int]:
        tok = _token_name(value)
        if tok is None:
            return None
        tid = self._added[tok]["id"] if tok in self._added else self._vocab.get(tok)
        return tid if tid is not None else self._unk

    # -- encode -------------------------------------------------------------

    def _split_added(self, text: str) -> List[Tuple[str, Optional[int]]]:
        """``text`` cut into (piece, None) and (token, id) for the added
        tokens, non-normalized ones first, then the normalized ones over what
        is left (one pass each, leftmost-longest, non-overlapping)."""
        pieces: List[Tuple[str, Optional[int]]] = [(text, None)]
        for normalized in (False, True):
            toks = sorted((c for c, t in self._added.items() if bool(t.get("normalized", not t.get("special")))
                           == normalized and c), key=len, reverse=True)
            if not toks:
                continue
            out = []
            for piece, tid in pieces:
                out += [(piece, tid)] if tid is not None else self._split_on(piece, toks)
            pieces = out
        return [(p, t) for p, t in pieces if p or t is not None]

    def _split_on(self, text: str, toks: List[str]) -> List[Tuple[str, Optional[int]]]:
        out, start, i, n = [], 0, 0, len(text)
        while i < n:
            tok = next((t for t in toks if text.startswith(t, i)), None)
            if tok is None:
                i += 1
                continue
            out.append((text[start:i], None))
            out.append((tok, self._added[tok]["id"]))
            start = i = i + len(tok)
        out.append((text[start:], None))
        return out

    def _bpe(self, word: str) -> List[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        ids = []
        for ch in word:
            tid = self._vocab.get(ch, self._unk)
            if tid is not None:  # a character outside the vocabulary, with no unk_token, is dropped
                ids.append(tid)
        while len(ids) > 1:  # the lowest-ranked merge first, the leftmost of equals
            best = None
            for j in range(len(ids) - 1):
                m = self._merges.get((ids[j], ids[j + 1]))
                if m is not None and (best is None or m[0] < best[0]):
                    best = (m[0], j, m[1])
            if best is None:
                break
            _, j, new = best
            ids[j : j + 2] = [new]
        if len(self._cache) < 65536:
            self._cache[word] = ids
        return ids

    def _encode_text(self, text: str) -> List[int]:
        pieces = [text]
        for step in self._steps:
            pieces = [q for p in pieces for q in step(p)]
        return [i for p in pieces if p for i in self._bpe(p)]

    def encode(self, text: str, *, bos: bool = True, eos: bool = False) -> List[int]:
        ids: List[int] = []
        for piece, tid in self._split_added(text):
            ids += [tid] if tid is not None else self._encode_text(piece)
        if bos and self.BOS is not None:
            ids = [self.BOS] + ids
        if eos and self.EOS is not None:
            ids = ids + [self.EOS]
        return ids

    # -- decode -------------------------------------------------------------

    def decode(self, ids: List[int]) -> str:
        toks = [t for t in (self._id_to_token.get(int(i)) for i in ids) if t is not None and t not in self._special]
        if self._byte_decoder:
            data = b"".join(
                bytes(_CHAR_BYTE[c] for c in t) if all(c in _CHAR_BYTE for c in t) else t.encode("utf-8")
                for t in toks
            )
            text = data.decode("utf-8", errors="replace")
        else:
            text = " ".join(toks)
        if self._clean_up:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
                         (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
                text = text.replace(a, b)
        return text
