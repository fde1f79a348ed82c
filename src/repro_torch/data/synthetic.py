"""Synthetic multi-language corpus (offline stand-in for BLOOM-style data;
a copy of ``repro.data.synthetic``, numpy only, so the same seed gives
the same bytes in both packages).

The paper's calibration-generation insight (Table 1/8) hinges on a skew
between *corpus* language proportions and *vocabulary* share. We reproduce
that structure synthetically: the vocab is partitioned into `n_languages`
id ranges with roughly equal vocab share, but the training corpus mixes
languages with a heavily skewed distribution (~55/20/10/...). Each language
is a seeded first-order Markov chain (so a tiny LM can actually learn it,
and quantization damage is measurable as PPL).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CorpusMeta:
    vocab_size: int
    n_languages: int
    lang_ranges: list[tuple[int, int]]   # [start, end) token ids per language
    mixture: np.ndarray                  # corpus share per language
    transitions: list[np.ndarray]        # per-language (size, branching) maps

    def top_language_tokens(self, top_k: int = 2) -> np.ndarray:
        """First-token restriction set: ids of the top-k corpus languages
        (the paper's 'language scope restriction', GenData V2)."""
        order = np.argsort(-self.mixture)[:top_k]
        ids = [np.arange(*self.lang_ranges[l]) for l in order]
        return np.concatenate(ids)


def make_corpus(vocab_size: int = 256, n_tokens: int = 200_000,
                n_languages: int = 4, branching: int = 4, seed: int = 0,
                reserved: int = 4):
    """Returns (tokens np.int32 (n_tokens,), CorpusMeta). ids < reserved are
    specials (pad/bos/eos/unk) and never appear in the corpus."""
    rng = np.random.default_rng(seed)
    usable = vocab_size - reserved
    per = usable // n_languages
    ranges = [(reserved + i * per, reserved + (i + 1) * per)
              for i in range(n_languages)]
    mixture = np.array([0.55, 0.20, 0.10, 0.15 / max(n_languages - 3, 1)]
                       [:n_languages], dtype=np.float64)
    if n_languages > 4:
        mixture = np.concatenate(
            [mixture, np.full(n_languages - 4, 0.15 / (n_languages - 3))])
    mixture = mixture / mixture.sum()

    transitions = []
    for lo, hi in ranges:
        size = hi - lo
        trans = rng.integers(0, size, size=(size, branching))
        transitions.append(trans)

    out = np.empty(n_tokens, dtype=np.int32)
    i = 0
    while i < n_tokens:
        lang = rng.choice(n_languages, p=mixture)
        lo, hi = ranges[lang]
        trans = transitions[lang]
        length = int(rng.integers(32, 128))
        tok = int(rng.integers(0, hi - lo))
        for _ in range(min(length, n_tokens - i)):
            out[i] = lo + tok
            i += 1
            tok = int(trans[tok, rng.integers(0, branching)])
    meta = CorpusMeta(vocab_size, n_languages, ranges, mixture, transitions)
    return out, meta


def heldout_split(tokens: np.ndarray, frac: float = 0.05):
    cut = int(len(tokens) * (1.0 - frac))
    return tokens[:cut], tokens[cut:]


def make_eval_sets(meta: CorpusMeta, n_tokens: int = 20_000, seed: int = 1):
    """Per-language held-out corpora — the WikiText2/PTB/C4 analogue for the
    Table 8 cross-dataset generalization ablation."""
    sets = {}
    for l in range(meta.n_languages):
        rng = np.random.default_rng(seed + 100 + l)
        lo, hi = meta.lang_ranges[l]
        trans = meta.transitions[l]
        out = np.empty(n_tokens, dtype=np.int32)
        tok = int(rng.integers(0, hi - lo))
        for i in range(n_tokens):
            out[i] = lo + tok
            tok = int(trans[tok, rng.integers(0, trans.shape[1])])
        sets[f"lang{l}"] = out
    return sets
