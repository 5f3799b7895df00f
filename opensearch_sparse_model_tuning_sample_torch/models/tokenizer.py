"""Self-contained WordPiece tokenizer (BERT-uncased semantics).

The reference delegates tokenization to HF AutoTokenizer
(reference sparse_encoders.py:60). This build ships its
own implementation so the framework is fully standalone: BasicTokenizer
(lowercase, NFD accent-strip, punctuation split, CJK spacing) + greedy
longest-match-first WordPiece, with static-shape batch encoding (pad-to-bucket)
for the collators. This is the PyTorch port's copy of the JAX package's
tokenizer; both load the same native/ library.

A native C++ fast path (native/wordpiece.cpp) is used for bulk encoding when
built; this module is the reference implementation and fallback.

Also hosts the text preprocessors (`to_lower`, `blank_prefix`,
`blank_prefix_lower`) mirroring sparse_encoders.py:25-39.
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = (PAD, UNK, CLS, SEP, MASK)


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
    # ASCII non-alphanumeric are treated as punctuation (BERT behavior)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class TextPreProcessors:
    """Text preprocessors applied before tokenization (reference
    sparse_encoders.py:25-39; selected by `preprocess_func` config)."""

    @staticmethod
    def to_lower(texts):
        return [t.lower() for t in texts]

    @staticmethod
    def blank_prefix(texts):
        return [" " + t for t in texts]

    @staticmethod
    def blank_prefix_lower(texts):
        return [" " + t.lower() for t in texts]


class _TokenizerBase:
    """Shared batch/padding machinery for the tokenizer family. Subclasses
    provide `tokenize` / `encode_ids` plus vocab tables; the static-shape
    bucket padding, preprocessors, and native-path hook live here."""

    vocab: Dict[str, int]
    ids_to_tokens: Dict[int, str]
    pad_id: int
    unk_id: int
    vocab_size: int

    def _init_base(self, preprocess_func: Optional[str]):
        self.preprocess = (
            getattr(TextPreProcessors, preprocess_func) if preprocess_func else None
        )
        self._native = None  # set by native.load() when the C++ path is built

    def tokenize(self, text: str) -> List[str]:
        raise NotImplementedError

    def encode_ids(self, text: str, max_length: int) -> List[int]:
        raise NotImplementedError

    def try_attach_native(self) -> bool:
        return False  # only the WordPiece family has a C++ fast path

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    def convert_id_to_token(self, i: int) -> str:
        return self.ids_to_tokens.get(int(i), self.ids_to_tokens[self.unk_id])

    # --------------------------------------------------------- batch path
    def __call__(
        self,
        texts: Sequence[str],
        max_length: int = 512,
        pad_to: Optional[int] = None,
        **_ignored,
    ) -> Dict[str, np.ndarray]:
        """Batch-encode -> {input_ids, attention_mask} int32 ndarrays.

        `pad_to=None` pads to the longest sequence (reference `padding=True`,
        collator.py:32-52); pass a bucket length for bucketed shapes.
        """
        if self.preprocess is not None:
            texts = self.preprocess(list(texts))
        if self._native is not None:
            seqs = self._native.encode_batch(texts, max_length)
        else:
            seqs = [self.encode_ids(t, max_length) for t in texts]
        return self._pad(seqs, pad_to)

    def _pad(self, seqs, pad_to: Optional[int]) -> Dict[str, np.ndarray]:
        if pad_to is not None:
            L = pad_to
        else:
            L = max((len(s) for s in seqs), default=2)
        B = len(seqs)
        input_ids = np.full((B, L), self.pad_id, dtype=np.int32)
        attention_mask = np.zeros((B, L), dtype=np.int32)
        for i, s in enumerate(seqs):
            s = s[:L]
            input_ids[i, : len(s)] = s
            attention_mask[i, : len(s)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}

    def encode_bucketed(
        self, texts: Sequence[str], max_length: int, buckets: Sequence[int]
    ) -> Dict[str, np.ndarray]:
        """Tokenize ONCE and pad to the smallest bucket that fits (bucketed
        shapes without double tokenization)."""
        if self.preprocess is not None:
            texts = self.preprocess(list(texts))
        if self._native is not None:
            seqs = self._native.encode_batch(list(texts), max_length)
        else:
            seqs = [self.encode_ids(t, max_length) for t in texts]
        longest = max((len(s) for s in seqs), default=0)
        L = max_length
        for b in sorted(buckets):
            if longest <= b <= max_length:
                L = b
                break
        return self._pad(seqs, L)


class WordPieceTokenizer(_TokenizerBase):
    def __init__(
        self,
        vocab: Dict[str, int],
        do_lower_case: bool = True,
        max_input_chars_per_word: int = 100,
        preprocess_func: Optional[str] = None,
    ):
        self.vocab = vocab
        self.ids_to_tokens = {v: k for k, v in vocab.items()}
        self.do_lower_case = do_lower_case
        self.max_input_chars_per_word = max_input_chars_per_word
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]
        self.special_token_ids = [vocab[t] for t in SPECIAL_TOKENS if t in vocab]
        self.vocab_size = len(vocab)
        self._init_base(preprocess_func)

    # ------------------------------------------------------------- loading
    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    @classmethod
    def from_idf_asset(cls, path: str, **kw) -> "WordPieceTokenizer":
        """Vocab from the bundled idf asset (token order == id order)."""
        if path.endswith(".npz"):
            blob = np.load(path, allow_pickle=False)
            tokens = [str(t) for t in blob["tokens"]]
        else:  # an idf.json-style {token: weight} map in id order
            tokens = list(json.load(open(path)).keys())
        return cls({t: i for i, t in enumerate(tokens)}, **kw)

    @classmethod
    def from_pretrained(cls, path_or_name: Optional[str], **kw) -> "WordPieceTokenizer":
        """Resolve vocab from a local checkpoint dir (vocab.txt), a vocab/idf
        file path, or fall back to the bundled asset."""
        if path_or_name:
            if os.path.isdir(path_or_name):
                vf = os.path.join(path_or_name, "vocab.txt")
                if os.path.exists(vf):
                    # honor the checkpoint's casing: save_pretrained writes
                    # do_lower_case into tokenizer_config.json, and a cased
                    # vocab loaded as lowercasing would encode every id
                    # wrong with no error (breaks our own round trip)
                    tc = os.path.join(path_or_name, "tokenizer_config.json")
                    if "do_lower_case" not in kw and os.path.exists(tc):
                        try:
                            tcfg = json.load(open(tc))
                        except (json.JSONDecodeError, OSError):
                            tcfg = {}
                        if isinstance(tcfg.get("do_lower_case"), bool):
                            kw["do_lower_case"] = tcfg["do_lower_case"]
                    return cls.from_vocab_file(vf, **kw)
                # an explicit dir without vocab.txt must not silently fall
                # back to the bundled bert-base vocab: a different vocab
                # would put input_ids in the wrong id space with no error
                # (the reference's AutoTokenizer raises here too)
                raise FileNotFoundError(
                    f"{path_or_name} has no vocab.txt — export the tokenizer "
                    "vocab, or pass a vocab/idf file path directly"
                )
            if os.path.exists(path_or_name):
                if path_or_name.endswith((".npz", ".json")):
                    return cls.from_idf_asset(path_or_name, **kw)
                return cls.from_vocab_file(path_or_name, **kw)
            raise FileNotFoundError(f"no tokenizer vocab at {path_or_name}")
        asset = os.path.join(_repo_root(), "assets", "idf.npz")
        return cls.from_idf_asset(asset, **kw)

    def try_attach_native(self) -> bool:
        """Attach the C++ fast path (native/wordpiece.cpp) when built/buildable;
        set OSSMT_NO_NATIVE=1 to force pure Python."""
        if os.environ.get("OSSMT_NO_NATIVE"):
            return False
        if self._native is not None:
            return True
        from .native_tokenizer import attach_native

        return attach_native(self)

    # ----------------------------------------------------------- tokenize
    def _clean(self, text: str) -> str:
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
        return "".join(out)

    def _basic_tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        tokens = []
        for tok in text.split():
            if tok in SPECIAL_TOKENS:  # HF never-splits special tokens
                tokens.append(tok)
                continue
            if self.do_lower_case:
                tok = tok.lower()
                tok = unicodedata.normalize("NFD", tok)
                tok = "".join(c for c in tok if unicodedata.category(c) != "Mn")
            # split on punctuation
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

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [UNK]
        out, start, n = [], 0, len(word)
        while start < n:
            end = n
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK]
            out.append(piece)
            start = end
        return out

    def tokenize(self, text: str) -> List[str]:
        toks = []
        for w in self._basic_tokenize(text):
            toks.extend(self._wordpiece(w))
        return toks

    def encode_ids(self, text: str, max_length: int) -> List[int]:
        """[CLS] tokens[:max_length-2] [SEP] — HF truncation semantics.
        max_length < 2 degenerates to a prefix (a negative slice here would
        silently return nearly the WHOLE sequence)."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if max_length < 2:
            return ([self.cls_id] + ids + [self.sep_id])[:max(max_length, 0)]
        ids = ids[: max_length - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def save_pretrained(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "vocab.txt"), "w", encoding="utf-8") as f:
            for i in range(self.vocab_size):
                f.write(self.ids_to_tokens[i] + "\n")
        with open(os.path.join(output_dir, "tokenizer_config.json"), "w") as f:
            json.dump(
                {
                    "tokenizer_class": "BertTokenizer",
                    "do_lower_case": self.do_lower_case,
                },
                f,
            )


_BPE_SPECIALS = ("<s>", "<pad>", "</s>", "<unk>", "<mask>")


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode table (every byte maps
    to a distinct visible character so BPE can operate on arbitrary UTF-8)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


class ByteLevelBPETokenizer(_TokenizerBase):
    """GPT-2-style byte-level BPE — the tokenizer family RoBERTa-layout
    checkpoints ship (vocab.json + merges.txt). Same interface as
    WordPieceTokenizer so the collators / encoders / index path are
    tokenizer-agnostic. The reference gets this via AutoTokenizer
    (sparse_encoders.py:60); this is the self-contained equivalent."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: List[tuple],
        preprocess_func: Optional[str] = None,
    ):
        import regex

        self.vocab = vocab
        self.ids_to_tokens = {v: k for k, v in vocab.items()}
        self.vocab_size = len(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}
        # GPT-2 pre-tokenization pattern (HF GPT2/RobertaTokenizer)
        self._pat = regex.compile(
            r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
            r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
        )
        self.pad_id = vocab.get("<pad>", 1)
        self.unk_id = vocab.get("<unk>", 3)
        self.bos_id = vocab.get("<s>", 0)
        self.eos_id = vocab.get("</s>", 2)
        self.special_token_ids = [vocab[t] for t in _BPE_SPECIALS if t in vocab]
        self.do_lower_case = False
        self._init_base(preprocess_func)

    # ------------------------------------------------------------- loading
    @classmethod
    def from_files(
        cls, vocab_json: str, merges_txt: str, **kw
    ) -> "ByteLevelBPETokenizer":
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_txt, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                parts = line.split(" ")
                if len(parts) == 2:
                    merges.append((parts[0], parts[1]))
        return cls(vocab, merges, **kw)

    # ------------------------------------------------------------ tokenize
    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 60))
            if best not in self.bpe_ranks:
                break
            a, b = best
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        if len(self._cache) < 500_000:
            self._cache[token] = word
        return word

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self._pat.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            out.extend(self._bpe(mapped))
        return out

    def encode_ids(self, text: str, max_length: int) -> List[int]:
        """<s> tokens[:max_length-2] </s> — HF truncation semantics.
        max_length < 2 degenerates to a prefix (a negative slice here would
        silently return nearly the WHOLE sequence)."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if max_length < 2:
            return ([self.bos_id] + ids + [self.eos_id])[:max(max_length, 0)]
        ids = ids[: max_length - 2]
        return [self.bos_id] + ids + [self.eos_id]

    def save_pretrained(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        with open(
            os.path.join(output_dir, "vocab.json"), "w", encoding="utf-8"
        ) as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        inv = sorted(self.bpe_ranks.items(), key=lambda kv: kv[1])
        with open(
            os.path.join(output_dir, "merges.txt"), "w", encoding="utf-8"
        ) as f:
            f.write("#version: 0.2\n")
            for (a, b), _ in inv:
                f.write(f"{a} {b}\n")
        with open(os.path.join(output_dir, "tokenizer_config.json"), "w") as f:
            json.dump({"tokenizer_class": "RobertaTokenizer"}, f)


def _fast_normalizer_lowercases(norm: Optional[dict]) -> bool:
    """Whether a tokenizers-fast normalizer spec lowercases input."""
    if not norm:
        return False
    t = norm.get("type")
    if t == "BertNormalizer":
        return bool(norm.get("lowercase", True))
    if t == "Lowercase":
        return True
    if t == "Sequence":
        return any(
            _fast_normalizer_lowercases(n) for n in norm.get("normalizers") or []
        )
    return False


def from_tokenizer_json(
    path: str, preprocess_func: Optional[str] = None
) -> _TokenizerBase:
    """Load from a HF fast-tokenizer `tokenizer.json` (the only tokenizer
    file many hub dumps ship). Supports the two families this framework
    hosts natively: WordPiece (BERT/DistilBERT) and byte-level BPE
    (RoBERTa). Anything else raises ValueError so callers can fall back to
    a torch host path (train/teachers.py::build_teacher)."""
    with open(path, encoding="utf-8") as f:
        blob = json.load(f)
    model = blob.get("model") or {}
    mtype = model.get("type")
    if mtype == "WordPiece":
        prefix = model.get("continuing_subword_prefix", "##")
        if prefix != "##":
            raise ValueError(
                f"{path}: WordPiece continuing_subword_prefix {prefix!r} "
                "unsupported (only '##')"
            )
        vocab = model["vocab"]
        missing = [t for t in (PAD, UNK, CLS, SEP) if t not in vocab]
        if missing:
            raise ValueError(f"{path}: WordPiece vocab lacks {missing}")
        return WordPieceTokenizer(
            vocab,
            do_lower_case=_fast_normalizer_lowercases(blob.get("normalizer")),
            preprocess_func=preprocess_func,
        )
    if mtype == "BPE":
        merges = [
            tuple(m) if isinstance(m, (list, tuple)) else tuple(m.split(" "))
            for m in model.get("merges") or []
        ]
        return ByteLevelBPETokenizer(
            model["vocab"], merges, preprocess_func=preprocess_func
        )
    raise ValueError(
        f"{path}: fast-tokenizer model type {mtype!r} not hosted natively "
        "(WordPiece and byte-level BPE are)"
    )


def load_tokenizer(
    path_or_name: Optional[str], preprocess_func: Optional[str] = None
) -> _TokenizerBase:
    """Resolve a tokenizer from a checkpoint dir or file, dispatching on the
    on-disk family: vocab.json + merges.txt -> byte-level BPE (RoBERTa
    layouts), vocab.txt -> WordPiece (BERT / DistilBERT layouts),
    tokenizer.json -> either (fast-format-only dumps). Falls back to the
    bundled WordPiece asset when nothing is given (the reference's
    AutoTokenizer dispatch, sparse_encoders.py:60)."""
    if path_or_name and os.path.isdir(path_or_name):
        vj = os.path.join(path_or_name, "vocab.json")
        mt = os.path.join(path_or_name, "merges.txt")
        if os.path.exists(vj) and os.path.exists(mt):
            return ByteLevelBPETokenizer.from_files(
                vj, mt, preprocess_func=preprocess_func
            )
        tj = os.path.join(path_or_name, "tokenizer.json")
        if not os.path.exists(os.path.join(path_or_name, "vocab.txt")) and (
            os.path.exists(tj)
        ):
            return from_tokenizer_json(tj, preprocess_func=preprocess_func)
    return WordPieceTokenizer.from_pretrained(
        path_or_name, preprocess_func=preprocess_func
    )


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_idf_weights(path: Optional[str], tokenizer: WordPieceTokenizer) -> np.ndarray:
    """[vocab] idf vector from an .npz asset or an idf.json token->weight map
    (reference init: sparse_encoders.py:86-94 — missing tokens default 1.0)."""
    idf = np.ones((tokenizer.vocab_size,), dtype=np.float32)
    if path is None:
        return idf
    if path.endswith(".npz"):
        blob = np.load(path, allow_pickle=False)
        tokens, weights = blob["tokens"], blob["weights"]
        for t, w in zip(tokens, weights):
            i = tokenizer.vocab.get(str(t))
            if i is not None:
                idf[i] = w
    else:
        for t, w in json.load(open(path)).items():
            i = tokenizer.vocab.get(t)
            if i is not None:
                idf[i] = w
    return idf
