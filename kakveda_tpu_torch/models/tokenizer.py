"""Byte-level tokenizer — the hermetic default for the in-tree Llama.

A copy of ``kakveda_tpu/models/tokenizer.py::ByteTokenizer``: token = byte
value + 3, plus BOS/EOS/PAD specials; any utf-8 string round-trips. The HF
tokenizer waits until the HF checkpoint converter is ported.
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
