"""Byte-level tokenizer for text demos (vocab = 256 bytes + specials; a
copy of ``repro.data.tokenizer``, numpy only)."""
from __future__ import annotations

import numpy as np

PAD, BOS, EOS, UNK = 0, 1, 2, 3
N_SPECIALS = 4


class ByteTokenizer:
    """Reversible byte tokenizer; ids are offset past the special tokens so
    it composes with the synthetic corpus (which reserves ids < 4)."""

    vocab_size = 256 + N_SPECIALS

    def encode(self, text: str, *, bos: bool = False,
               eos: bool = False) -> np.ndarray:
        ids = np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(
            np.int32) + N_SPECIALS
        parts = []
        if bos:
            parts.append([BOS])
        parts.append(ids)
        if eos:
            parts.append([EOS])
        return np.concatenate([np.asarray(p, np.int32) for p in parts])

    def decode(self, ids) -> str:
        arr = np.asarray(ids, dtype=np.int64).ravel()
        arr = arr[(arr >= N_SPECIALS) & (arr < self.vocab_size)]
        return (arr - N_SPECIALS).astype(np.uint8).tobytes().decode(
            "utf-8", errors="replace")
