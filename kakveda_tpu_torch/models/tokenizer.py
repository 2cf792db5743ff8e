"""Tokenizers for the in-tree Llama: bytes by default, or a checkpoint's own.

A copy of ``kakveda_tpu/models/tokenizer.py``. :class:`ByteTokenizer`, the
hermetic default: token = byte value + 3, plus BOS/EOS/PAD specials; any
utf-8 string round-trips. :class:`HFTokenizer` loads the tokenizer files of
a local HF checkpoint directory through ``transformers`` (imported when one
is built, so the package does not need it otherwise).
"""

from __future__ import annotations

from typing import List


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


class HFTokenizer:
    """A checkpoint's own vocabulary, from the tokenizer files in ``path``
    (normally the checkpoint directory itself; nothing is downloaded), with
    :class:`ByteTokenizer`'s ``encode``/``decode`` surface. Needs the
    ``transformers`` package."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path)
        self.BOS = self._tok.bos_token_id
        self.EOS = self._tok.eos_token_id
        pad = self._tok.pad_token_id
        self.PAD = pad if pad is not None else (self.EOS if self.EOS is not None else 0)
        self.vocab_size = len(self._tok)

    def encode(self, text: str, *, bos: bool = True, eos: bool = False) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if bos and self.BOS is not None:
            ids = [self.BOS] + ids
        if eos and self.EOS is not None:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)
