"""ctypes bindings for the native C++ WordPiece tokenizer.

ASCII texts run through native/build/libwordpiece.so; any text containing
non-ASCII bytes falls back to the Python implementation (identical Unicode
semantics, see native/wordpiece.cpp header). Auto-builds the library with g++
on first use if the toolchain is available; degrades silently to pure Python
otherwise.
"""

from __future__ import annotations

import ctypes
import logging
import os
import re
import subprocess
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

# texts that must take the Python path even when pure ASCII: '[' can open a
# never-split special token ("[SEP]" stays one token in Python but splits to
# punctuation in C++), and ASCII control chars (other than \t\n\r whitespace)
# are REMOVED mid-word by the Python cleaner while wordpiece.cpp flushes the
# word at them
_NEEDS_PY = re.compile(r"[\[\x00-\x08\x0b\x0c\x0e-\x1f\x7f]")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO, "native", "build", "libwordpiece.so")


def _ensure_built() -> Optional[str]:
    if os.path.exists(_LIB_PATH):
        return _LIB_PATH
    script = os.path.join(_REPO, "native", "build.sh")
    if not os.path.exists(script):
        return None
    try:
        subprocess.run(["bash", script], check=True, capture_output=True, timeout=120)
        return _LIB_PATH if os.path.exists(_LIB_PATH) else None
    except Exception as e:
        logger.warning("native tokenizer build failed (%s); using Python path", e)
        return None


class NativeWordPiece:
    """Holds the C tokenizer handle; encode_batch mirrors the Python
    tokenizer's per-text `encode_ids` output (list of id lists)."""

    def __init__(self, py_tokenizer):
        lib_path = _ensure_built()
        if lib_path is None:
            raise RuntimeError("native tokenizer unavailable")
        self._lib = ctypes.CDLL(lib_path)
        self._lib.wp_create.restype = ctypes.c_void_p
        self._lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        self._lib.wp_destroy.argtypes = [ctypes.c_void_p]
        self._lib.wp_encode_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        vocab_blob = "\n".join(
            py_tokenizer.ids_to_tokens[i] for i in range(py_tokenizer.vocab_size)
        ).encode("utf-8")
        self._handle = self._lib.wp_create(vocab_blob, len(vocab_blob))
        self._py = py_tokenizer

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.wp_destroy(self._handle)
        except Exception:
            pass

    def encode_batch(self, texts: List[str], max_length: int) -> List[List[int]]:
        n = len(texts)
        if n == 0:
            return []
        raw: List[Optional[bytes]] = []
        fallback_idx: List[int] = []
        for i, t in enumerate(texts):
            if _NEEDS_PY.search(t):
                raw.append(None)
                fallback_idx.append(i)
                continue
            try:
                raw.append(t.encode("ascii"))
            except UnicodeEncodeError:
                raw.append(None)
                fallback_idx.append(i)

        out = [None] * n  # type: ignore[var-annotated]
        native_rows = [i for i in range(n) if raw[i] is not None]
        if native_rows:
            m = len(native_rows)
            arr = (ctypes.c_char_p * m)(*[raw[i] for i in native_rows])
            lens = (ctypes.c_int64 * m)(*[len(raw[i]) for i in native_rows])
            out_ids = np.zeros((m, max_length), dtype=np.int32)
            out_lens = np.zeros((m,), dtype=np.int32)
            self._lib.wp_encode_batch(
                self._handle,
                arr,
                lens,
                m,
                max_length,
                out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            for row, i in enumerate(native_rows):
                out[i] = out_ids[row, : out_lens[row]].tolist()
        for i in fallback_idx:
            out[i] = self._py.encode_ids(texts[i], max_length)
        return out  # type: ignore[return-value]


def attach_native(py_tokenizer) -> bool:
    """Try to attach the native fast path to a WordPieceTokenizer; returns
    whether it succeeded."""
    if not getattr(py_tokenizer, "do_lower_case", True):
        # wordpiece.cpp lowercases unconditionally; attaching it to a cased
        # tokenizer would encode ASCII texts in the wrong id space while
        # non-ASCII texts take the (correct) Python path — a silent mixed
        # tokenization within one batch
        logger.info("native tokenizer not attached: cased tokenizer "
                    "(do_lower_case=False); using the Python path")
        return False
    try:
        py_tokenizer._native = NativeWordPiece(py_tokenizer)
        return True
    except Exception as e:
        logger.info("native tokenizer not attached: %s", e)
        return False
