"""A frozen WordPiece tokenizer (BERT-uncased): the benchmark's own, so the
comparison does not take the tokenization from the program it judges.

Copied from the port's `models/tokenizer.py` (`WordPieceTokenizer`, its
basic tokenizer, greedy longest-match WordPiece, `encode_ids` and the
bucketed padding of `encode_bucketed`). One addition: an ASCII text with no
'[' and no control character takes a regular expression that gives the same
words as the character loop (lowercase, split on whitespace and ASCII
punctuation), which a test checks against the loop.
"""

from __future__ import annotations

import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = (PAD, UNK, CLS, SEP, MASK)
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
_ASCII_WORDS = re.compile(r"[a-z0-9]+|[!-/:-@\[-`{-~]")
_SLOW = re.compile(r"[^\x20-\x7e\t\n\r]|\[")


def _is_whitespace(ch):
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


class WordPiece:
    def __init__(self, vocab_file: str = os.path.join(DATA, "vocab.txt"),
                 max_input_chars_per_word: int = 100):
        with open(vocab_file, encoding="utf-8") as f:
            self.vocab: Dict[str, int] = {line.rstrip("\n"): i for i, line in enumerate(f)}
        self.max_chars = max_input_chars_per_word
        self.pad_id, self.unk_id = self.vocab[PAD], self.vocab[UNK]
        self.cls_id, self.sep_id = self.vocab[CLS], self.vocab[SEP]
        self.special_ids = [self.vocab[t] for t in SPECIAL_TOKENS if t in self.vocab]
        self._pieces: Dict[str, List[int]] = {}

    def basic_tokenize_slow(self, text: str) -> List[str]:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_whitespace(ch):
                out.append(" ")
            elif _is_cjk(cp):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        tokens = []
        for tok in "".join(out).split():
            if tok in SPECIAL_TOKENS:
                tokens.append(tok)
                continue
            tok = unicodedata.normalize("NFD", tok.lower())
            tok = "".join(c for c in tok if unicodedata.category(c) != "Mn")
            cur = []
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    def basic_tokenize(self, text: str) -> List[str]:
        if _SLOW.search(text):
            return self.basic_tokenize_slow(text)
        return _ASCII_WORDS.findall(text.lower())

    def _wordpiece(self, word: str) -> List[int]:
        hit = self._pieces.get(word)
        if hit is not None:
            return hit
        if len(word) > self.max_chars:
            ids = [self.unk_id]
        else:
            ids, start, n = [], 0, len(word)
            while start < n:
                end, piece = n, None
                while start < end:
                    sub = word[start:end] if start == 0 else "##" + word[start:end]
                    if sub in self.vocab:
                        piece = sub
                        break
                    end -= 1
                if piece is None:
                    ids = [self.unk_id]
                    break
                ids.append(self.vocab[piece])
                start = end
        self._pieces[word] = ids
        return ids

    def encode_ids(self, text: str, max_length: int) -> List[int]:
        """[CLS] wordpieces[:max_length - 2] [SEP]."""
        ids = []
        for w in self.basic_tokenize(text):
            ids.extend(self._wordpiece(w) if w not in SPECIAL_TOKENS else [self.vocab[w]])
        return [self.cls_id] + ids[: max_length - 2] + [self.sep_id]

    def batch(self, texts: Sequence[str], max_length: int,
              buckets: Optional[Sequence[int]] = (64, 128, 256, 512)) -> Dict[str, np.ndarray]:
        """ids and mask [B, L] int32, L the smallest bucket that holds the
        longest text (max_length if none does; the longest itself without
        buckets), padded with [PAD]."""
        seqs = [self.encode_ids(t, max_length) for t in texts]
        longest = max((len(s) for s in seqs), default=0)
        L = longest if buckets is None else next(
            (b for b in sorted(buckets) if longest <= b <= max_length), max_length)
        ids = np.full((len(seqs), L), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(seqs), L), dtype=np.int32)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s[:L]
            mask[i, :len(s)] = 1
        return {"input_ids": ids, "attention_mask": mask}
