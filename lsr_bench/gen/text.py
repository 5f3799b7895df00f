"""Seeded text for the benchmark's train and ingest traffic.

Words are the WordPiece vocabulary's plain lowercase whole-word tokens
(`^[a-z]+$`), drawn with Zipf frequencies over a fixed permutation of
them. Each such word is one wordpiece under BERT-uncased tokenization, so a
text of n words is n + 2 tokens ([CLS] ... [SEP]) up to the 512 cut, and
the harness knows every doc's real token count without tokenizing. Real
passages differ: they split into more wordpieces than words (`##` pieces)
and carry punctuation and case, so per word the tokenizer and collator do
less work here than on real text, and a length in words is a length in
tokens.

Lengths are lognormal, taken at fixed quantiles: every seed gets the same
multiset of lengths, in its own order, so seeds change which texts and not
how much work (a seed that moved the work would move the metrics).
"""

from __future__ import annotations

import os
import re
from typing import List, Sequence

import numpy as np
from scipy.special import ndtri

VOCAB_FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "data", "vocab.txt")


def read_vocab(path: str = VOCAB_FILE) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f]


class Words:
    """The word table and its Zipf weights (exponent `zipf`), fixed for all
    seeds: the popularity of a word never depends on the run."""

    def __init__(self, zipf: float = 1.0, vocab: Sequence[str] = ()):
        vocab = list(vocab) or read_vocab()
        words = np.array([t for t in vocab if re.fullmatch("[a-z]+", t)])
        np.random.default_rng(0x5EED).shuffle(words)
        p = np.arange(1, len(words) + 1, dtype=np.float64) ** -zipf
        self.words = words
        self.cdf = np.cumsum(p / p.sum())

    def draw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        idx = np.searchsorted(self.cdf, rng.random(n), side="right")
        return self.words[np.minimum(idx, len(self.words) - 1)]


def lognormal_lengths(n: int, median: float, sigma: float, lo: int, hi: int,
                      rng: np.random.Generator) -> np.ndarray:
    """n word counts at the (i + 0.5) / n quantiles of a lognormal with this
    median and sigma, clipped to [lo, hi], in an order drawn from `rng`."""
    q = (np.arange(n) + 0.5) / n
    lens = np.clip(np.rint(median * np.exp(sigma * ndtri(q))), lo, hi).astype(np.int64)
    return lens[rng.permutation(n)]


def uniform_lengths(n: int, lo: int, hi: int, rng: np.random.Generator) -> np.ndarray:
    """n word counts spread evenly over [lo, hi], in an order from `rng`."""
    lens = lo + (np.arange(n) * (hi - lo + 1)) // n
    return lens[rng.permutation(n)].astype(np.int64)


def make_texts(words: Words, lengths: np.ndarray, rng: np.random.Generator) -> List[str]:
    """One text per length: that many words drawn from `words`, joined by
    spaces."""
    flat = words.draw(rng, int(lengths.sum()))
    ends = np.cumsum(lengths)
    starts = ends - lengths
    return [" ".join(flat[s:e]) for s, e in zip(starts.tolist(), ends.tolist())]


def token_counts(lengths: np.ndarray, max_length: int) -> np.ndarray:
    """Real (unpadded) tokens of texts of these word counts: the words plus
    [CLS] and [SEP], cut at max_length."""
    return np.minimum(lengths + 2, max_length)
