"""Impact-ordered inverted index: token-major postings with sort-merge
scoring (the port of the JAX package's `index/inverted.py`).

Per token, the top `postings_cap` (doc, weight) pairs by weight: the layout
of OpenSearch's `rank_features` index. Query cost scales with query terms x
postings_cap, not with the corpus.

Scoring (torch ops on the index's device):
  1. gather the query terms' posting rows            [B, T, C]
  2. partial scores  q_w * posting_w                 [B, T, C]
  3. flatten, stable sort by doc id per query row    [B, T*C]
  4. run-merge equal doc ids with T-1 masked shifted adds (exact sums over
     the query terms whose top-C postings hold the doc)
  5. exact rescore of the top candidates against the doc-major rows
  6. top-k, and a bound on the score of any doc the search could have missed

Every top-k here breaks ties to the lower index, as `lax.top_k` does: a
stable descending sort (`_topk`), not `torch.topk`, whose tie order is
unspecified. The host side (postings build, merge, split, block maxima) is
numpy and the shared C++ build in `native/postings.cpp`.
"""

from __future__ import annotations

import ctypes
import logging
import os
import queue
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import tracing

logger = logging.getLogger(__name__)

_PAD_ID = np.iinfo(np.int32).max

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO, "native", "build", "libpostings.so")
_native_lib = None
_native_lock = threading.Lock()


def _load_native():
    """native/postings.cpp through ctypes (a counting-bucket build and a
    per-token top-C row merge), built by native/build.sh on first use.
    Lock-guarded: the incremental build's thread and the caller's can race
    the first load. Returns the library, or False (numpy fallback, logged as
    a warning) when it cannot be built or loaded, or OSSMT_NO_NATIVE is set."""
    global _native_lib
    if _native_lib is None:
        with _native_lock:
            if _native_lib is None:
                _native_lib = _load_native_locked()
    return _native_lib


def _load_native_locked():
    if os.environ.get("OSSMT_NO_NATIVE"):
        return False
    script = os.path.join(_REPO, "native", "build.sh")

    def rebuild() -> bool:
        try:
            subprocess.run(["bash", script], check=True, capture_output=True, timeout=120)
            return os.path.exists(_LIB_PATH)
        except Exception as e:  # noqa: BLE001 — reported below
            logger.warning("native postings build failed: %s", e)
            return False

    if not os.path.exists(_LIB_PATH) and not rebuild():
        logger.warning("native postings library unavailable; numpy build")
        return False
    for attempt in (0, 1):
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            i32p, f32p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
            lib.build_postings.restype = ctypes.c_int
            lib.build_postings.argtypes = [
                i32p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                i32p, f32p, ctypes.c_int32,
            ]
            lib.merge_postings.restype = ctypes.c_int
            lib.merge_postings.argtypes = [
                i32p, f32p, i32p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                i32p, f32p, ctypes.c_int32,
            ]
            return lib
        except (OSError, AttributeError) as e:
            if attempt == 0 and rebuild():
                continue
            logger.warning("native postings unavailable (%s); numpy build", e)
            return False
    return False


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_postings(
    toks: np.ndarray,  # [N, L] int32 doc-major token ids (0-padded via w=0)
    ws: np.ndarray,  # [N, L] f32 weights (0 = inactive)
    vocab_size: int,
    postings_cap: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host build: (post_docs [V, C] int32, _PAD_ID padded; post_w [V, C]
    f32), impact-sorted per token. The C++ build when it loads, else the
    numpy one (the same postings where no two weights of a token tie).
    Token ids outside [0, V) raise on both.

    The C++ build runs on one thread: its threads scatter a token's
    entries in the order they win an atomic cursor, so with tied weights
    (common in encoder output) two parallel builds of the same rows order
    the tied docs differently, and keep a different subset where a tie
    straddles the cap. On one thread the build is a function of its rows,
    so an incremental build equals a one-shot build of the same rows."""
    lib = _load_native()
    if lib and toks.size:
        N, L = toks.shape
        t = np.ascontiguousarray(toks, dtype=np.int32)
        w = np.ascontiguousarray(ws, dtype=np.float32)
        # the C++ build indexes counts[tok] unchecked: check here, so an
        # out-of-range id raises as it does on the numpy path
        tmin, tmax = int(t.min()), int(t.max())
        if tmin < 0 or tmax >= vocab_size:
            raise ValueError(f"token ids out of range [0, {vocab_size}): min={tmin} max={tmax}")
        post_docs = np.empty((vocab_size, postings_cap), dtype=np.int32)
        post_w = np.empty((vocab_size, postings_cap), dtype=np.float32)
        rc = lib.build_postings(_ptr(t, ctypes.c_int32), _ptr(w, ctypes.c_float), N, L,
                                vocab_size, postings_cap, _ptr(post_docs, ctypes.c_int32),
                                _ptr(post_w, ctypes.c_float), 1)
        if rc == 0:
            tracing.count("postings.build.native")  # which build ran
            return post_docs, post_w
        logger.warning("native postings build failed (rc=%d); numpy build", rc)
    return _build_postings_np(toks, ws, vocab_size, postings_cap)


def _impact_order(toks: np.ndarray, ws: np.ndarray, doc_dtype):
    """Active (token, weight, doc) entries grouped by token, weight
    descending within a group, stably: one packed-key argsort (weights are
    positive, so their f32 bit patterns are monotonic and their complement
    sorts descending). Returns the three arrays in that order."""
    N, L = toks.shape
    flat_tok = toks.reshape(-1)
    flat_w = ws.reshape(-1).astype(np.float32)
    flat_doc = np.repeat(np.arange(N, dtype=doc_dtype), L)
    keep = flat_w > 0
    flat_tok, flat_w, flat_doc = flat_tok[keep], flat_w[keep], flat_doc[keep]
    w_bits = flat_w.view(np.uint32).astype(np.uint64)
    packed = (flat_tok.astype(np.uint64) << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - w_bits)
    order = np.argsort(packed, kind="stable")
    return flat_tok[order], flat_w[order], flat_doc[order]


def _ranks(flat_tok: np.ndarray, vocab_size: int):
    counts = np.bincount(flat_tok, minlength=vocab_size)
    starts = np.zeros(vocab_size + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return counts, np.arange(flat_tok.shape[0], dtype=np.int64) - starts[flat_tok]


def _build_postings_np(toks, ws, vocab_size, postings_cap):
    tracing.count("postings.build.numpy")
    flat_tok, flat_w, flat_doc = _impact_order(toks, ws, np.int32)
    counts, rank = _ranks(flat_tok, vocab_size)
    keep = rank < postings_cap
    post_docs = np.full((vocab_size, postings_cap), _PAD_ID, dtype=np.int32)
    post_w = np.zeros((vocab_size, postings_cap), dtype=np.float32)
    rows, cols = flat_tok[keep], rank[keep]
    post_docs[rows, cols] = flat_doc[keep]
    post_w[rows, cols] = flat_w[keep]
    truncated = int((counts > postings_cap).sum())
    if truncated:
        logger.info("inverted build: %d/%d tokens truncated at cap %d", truncated,
                    int((counts > 0).sum()), postings_cap)
    return post_docs, post_w


def merge_postings(
    a_docs: np.ndarray, a_w: np.ndarray,  # [V, C]
    b_docs: np.ndarray, b_w: np.ndarray,  # [V, C]
    row_chunk: int = 4096,
    b_doc_offset: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-token top-C of the union of two impact-sorted postings sets
    (`b_doc_offset` is added to b's doc ids: chunk builds emit local ids).
    Any global top-C posting of a token is in its source set's top-C, so
    this reproduces the one-shot build's posting set, except where equal
    weights tie across the cap boundary (each chunk drops an arbitrary
    subset of the tied docs; scores and the certificate bound are the same
    either way). The C++ row merge when the library loads, else numpy over
    vocab row chunks."""
    lib = _load_native()
    if lib:
        a_docs = np.ascontiguousarray(a_docs, dtype=np.int32)
        a_w = np.ascontiguousarray(a_w, dtype=np.float32)
        b_docs = np.ascontiguousarray(b_docs, dtype=np.int32)
        b_w = np.ascontiguousarray(b_w, dtype=np.float32)
        V, C = a_docs.shape
        out_docs = np.empty_like(a_docs)
        out_w = np.empty_like(a_w)
        rc = lib.merge_postings(_ptr(a_docs, ctypes.c_int32), _ptr(a_w, ctypes.c_float),
                                _ptr(b_docs, ctypes.c_int32), _ptr(b_w, ctypes.c_float),
                                V, C, b_doc_offset, _ptr(out_docs, ctypes.c_int32),
                                _ptr(out_w, ctypes.c_float), 0)
        if rc == 0:
            tracing.count("postings.merge.native")
            return out_docs, out_w
        logger.warning("native postings merge failed (rc=%d); numpy merge", rc)
    tracing.count("postings.merge.numpy")
    if b_doc_offset:
        b_docs = np.where(b_docs != _PAD_ID, b_docs + b_doc_offset, b_docs)
    V, C = a_docs.shape
    out_docs = np.empty_like(a_docs)
    out_w = np.empty_like(a_w)
    for s in range(0, V, row_chunk):
        e = min(s + row_chunk, V)
        w = np.concatenate([a_w[s:e], b_w[s:e]], axis=1)  # [v, 2C]
        d = np.concatenate([a_docs[s:e], b_docs[s:e]], axis=1)
        part = np.argpartition(-w, C - 1, axis=1)[:, :C]
        pw = np.take_along_axis(w, part, axis=1)
        sel = np.take_along_axis(part, np.argsort(-pw, axis=1, kind="stable"), axis=1)
        out_w[s:e] = np.take_along_axis(w, sel, axis=1)
        out_docs[s:e] = np.take_along_axis(d, sel, axis=1)
    out_docs[out_w <= 0] = _PAD_ID  # w == 0 is padding wherever it came from
    return out_docs, out_w


class IncrementalPostingsBuilder:
    """Chunked postings build on a background host thread during ingest:
    each fed chunk runs the C++ build (local doc ids) and the C++ top-C
    row merge folds it into the running state, so finalize() pays only the
    chunk in flight. The C++ calls release the GIL (ctypes), so the ingest
    loop keeps the card busy meanwhile. An exception in the thread comes
    back out of feed() and finish(); finish() joins the thread."""

    def __init__(self, vocab_size: int, postings_cap: int, unit: int = 131072,
                 seed: Optional[Tuple[np.ndarray, np.ndarray]] = None):
        self.vocab_size = vocab_size
        self.cap = postings_cap
        self.unit = unit
        # `seed`: resume from merged (docs, w) postings with global doc ids
        # (reopen() seeds the last finalize's postings, so a _bulk ->
        # refresh cycle merges only the new rows)
        self._docs: Optional[np.ndarray] = None
        self._w: Optional[np.ndarray] = None
        if seed is not None:
            self._docs = np.ascontiguousarray(seed[0], dtype=np.int32)
            self._w = np.ascontiguousarray(seed[1], dtype=np.float32)
        self.fed_docs = 0
        self._err: Optional[BaseException] = None
        # bounded: at most 4 chunks in flight, back-pressuring the ingest loop
        self._q: "queue.Queue" = queue.Queue(maxsize=4)
        self._thread = threading.Thread(target=self._run, name="postings-build", daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is not None:
                continue  # drain without work after a failure
            toks, ws, off = item
            try:
                pd, pw = build_postings(toks, ws, self.vocab_size, self.cap)
                if self._docs is None:
                    if off:
                        pd = np.where(pd != _PAD_ID, pd + off, pd)
                    self._docs, self._w = pd, pw
                else:
                    self._docs, self._w = merge_postings(self._docs, self._w, pd, pw,
                                                         b_doc_offset=off)
            except BaseException as e:  # noqa: BLE001 — re-raised by feed/finish
                self._err = e

    def feed(self, toks: np.ndarray, ws: np.ndarray, doc_offset: int):
        """Queue a chunk of rows whose first doc id is `doc_offset`. The
        caller must not reuse the arrays: the thread reads them later."""
        if self._err is not None:
            raise RuntimeError("postings build thread failed") from self._err
        n = toks.shape[0]
        if n == 0:
            return
        self._q.put((np.ascontiguousarray(toks, dtype=np.int32),
                     np.ascontiguousarray(ws, dtype=np.float32), doc_offset))
        self.fed_docs = doc_offset + n

    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        """Join the thread and return the final (docs, w). Single use."""
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise RuntimeError("postings build thread failed") from self._err
        if self._docs is None:
            return (np.full((self.vocab_size, self.cap), _PAD_ID, np.int32),
                    np.zeros((self.vocab_size, self.cap), np.float32))
        return self._docs, self._w


def split_postings(post_docs: np.ndarray, post_w: np.ndarray, base_cap: int):
    """Split a full-depth build [V, C_total] into (base [V, base_cap] docs
    and weights, extension [n_deep + 1, C_total - base_cap] docs and
    weights, deep_map [V]) for tiered read depths: only the tokens whose
    postings reach past base_cap get an extension row; every other token
    maps to the last, all-padding row."""
    V, C_total = post_docs.shape
    if base_cap >= C_total:
        raise ValueError(f"split_postings: base_cap={base_cap} >= C_total={C_total}")
    base_d = np.ascontiguousarray(post_docs[:, :base_cap])
    base_w = np.ascontiguousarray(post_w[:, :base_cap])
    deep = np.flatnonzero(post_w[:, base_cap] > 0)
    Ce = C_total - base_cap
    ext_d = np.full((deep.size + 1, Ce), _PAD_ID, dtype=np.int32)
    ext_w = np.zeros((deep.size + 1, Ce), dtype=np.float32)
    if deep.size:
        ext_d[:-1] = post_docs[deep, base_cap:]
        ext_w[:-1] = post_w[deep, base_cap:]
    deep_map = np.full(V, deep.size, dtype=np.int32)
    deep_map[deep] = np.arange(deep.size, dtype=np.int32)
    return base_d, base_w, ext_d, ext_w, deep_map


def build_tail_blockmax(toks, ws, vocab_size: int, read_cap: int, n_pad: int, block_docs: int):
    """Per-token, per-doc-block maxima over the postings tail (impact rank
    >= read_cap): the block-max WAND bound for the certificate. A missed doc
    carries per term at most its own block's tail maximum, so
    max_b sum_t q_w[t] * min(bm[t, b], w_tail[t]) bounds its score. Returns
    (bm [R + 1, NB] f32, bmap [V] int32): R tokens with tail mass, row R
    all zero for the rest. f32 on purpose: a bf16 cast could round a
    maximum down and make the bound unsound."""
    return build_tail_blockmax_multi(toks, ws, vocab_size, (read_cap,), n_pad, block_docs)[0]


def build_tail_blockmax_multi(toks, ws, vocab_size: int, read_caps, n_pad: int,
                              block_docs: int):
    """build_tail_blockmax at several read depths from one impact sort."""
    NB = -(-max(n_pad, 1) // block_docs)
    flat_tok, flat_w, flat_doc = _impact_order(toks, ws, np.int64)
    _, rank = _ranks(flat_tok, vocab_size)
    out = []
    for read_cap in read_caps:
        tail = rank >= read_cap
        t_tok, t_w, t_doc = flat_tok[tail], flat_w[tail], flat_doc[tail]
        tail_tokens = np.unique(t_tok)
        R = int(tail_tokens.size)
        bmap = np.full(vocab_size, R, dtype=np.int32)
        bmap[tail_tokens] = np.arange(R, dtype=np.int32)
        bm = np.zeros((R + 1, NB), dtype=np.float32)
        if t_tok.size:
            key = bmap[t_tok].astype(np.int64) * NB + t_doc // block_docs
            # weight-descending within a token: the first entry of each
            # (token, block) key is that cell's maximum
            uk, ui = np.unique(key, return_index=True)
            bm.reshape(-1)[uk] = t_w[ui]
        out.append((bm, bmap))
    return out


CERT_MARGIN = 1e-4  # relative fp-reorder tolerance of the certificate


def certified_mask(kth, bound):
    """The certificate: a query is certified when its k-th exact score
    clears the missed-score bound by a relative margin (the bound's cut term
    and the rescore sum the same f32 products in different orders, so they
    can differ by a few ulps near a tie; on the card the reductions reorder
    sums again). One rule for torch tensors (the escalation ladder) and
    numpy arrays (the host check of an index without escalation)."""
    if isinstance(kth, torch.Tensor):
        margin = CERT_MARGIN * torch.maximum(bound.abs(), kth.abs())
        margin = torch.where(torch.isfinite(margin), margin, torch.zeros_like(margin))
        return kth >= bound + margin
    with np.errstate(invalid="ignore"):
        margin = CERT_MARGIN * np.maximum(np.abs(bound), np.abs(kth))
        margin = np.where(np.isfinite(margin), margin, 0.0)
        return kth >= bound + margin


def pack_doc_rows(toks: np.ndarray, ws: np.ndarray) -> np.ndarray:
    """Doc-major rows packed into one int32 array: the bf16 weight bits
    (nearest rounding) in the high half, the token id in the low half. Only
    for bf16-weight engines (the pack is a bf16 truncation) and token ids in
    [0, 2**15). Unpacked by make_search_fn(packed_docs=True)."""
    if toks.max(initial=0) >= 2**15 or toks.min(initial=0) < 0:
        # negatives would wrap through uint32 and clobber the weight half
        raise ValueError("pack_doc_rows needs token ids in [0, 2**15)")
    w = torch.from_numpy(np.ascontiguousarray(ws, dtype=np.float32)).to(torch.bfloat16)
    wb = w.view(torch.int16).numpy().view(np.uint16)
    return ((wb.astype(np.uint32) << np.uint32(16)) | toks.astype(np.uint32)).view(np.int32)


# ------------------------------------------------------------------ search


def _topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along dim 1, descending, ties to
    the lower index: `lax.top_k`'s order. A stable descending sort of the
    whole row (the price of that order)."""
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def _gather_index(tok: torch.Tensor, n: int) -> torch.Tensor:
    """int64 row indices into an [n, ...] array as JAX's gather takes them:
    a negative id counts from the end once, then the index clamps to
    [0, n). (Out of range, torch raises on the CPU and trips a device-side
    assert on the card.)"""
    tok = tok.long()
    return torch.where(tok < 0, tok + n, tok).clamp(0, n - 1)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.index_select(x, 0, idx.reshape(-1)).view(*idx.shape, *x.shape[1:])


def make_search_fn(
    post_docs: torch.Tensor,  # [V, C] int32
    post_w: torch.Tensor,  # [V, C] (weight dtype)
    doc_toks: Optional[torch.Tensor],  # [N_pad, L] (for the exact rescore)
    doc_ws: Optional[torch.Tensor],  # [N_pad, L]
    query_terms: int,  # T: query term slots used for lookup
    k: int,
    rescore: bool = True,
    postings_cols: Optional[int] = None,  # use only the top-C' postings/term
    merge_shifts: Optional[int] = None,  # None = T-1 (exact run sums)
    rescore_expand: int = 4,  # candidate pool = expand * k
    refine_expand: int = 0,  # cut-refinement pool = expand * k
    select_by_impact: bool = False,  # term selection by q_w * max posting w
    phase1_ratio: Optional[float] = None,  # query-side two-phase
    deep_slots: int = 0,  # tiered adaptive depth
    with_bound: bool = False,  # also return the missed-doc score bound
    sort_candidates: bool = False,  # gather rescore rows in doc-id order
    packed_docs: bool = False,  # doc_toks holds pack_doc_rows() output
    token_entry: bool = False,  # q = (q_tok, q_w) slots, no dense query
    match_rescore: bool = False,  # rescore by slot matching
    tail_blockmax: bool = False,  # per-block tail bound
):
    """The inverted search over a query batch: dense q [B, V] fp32 (or with
    `token_entry` the pair (q_tok [B, T] int, q_w [B, T] fp32)) ->
    (scores [B, k], ids [B, k]) and with `with_bound` the missed-score bound
    [B]. Ids are -1 where fewer than k docs matched. Every row is computed
    on its own: a row's answer does not depend on the rest of the batch.

    The options are the JAX function's, with the same meaning:

    * inf-free (default): T term slots, all C postings per term, exact run
      sums. `postings_cols` + `select_by_impact` (full forward): the top-T
      terms by q_w x max posting weight, only the top-C' postings of each;
      the rescore against the full query recovers exact scores.
    * `merge_shifts` < T-1 truncates run sums (rescore only).
    * `deep_slots` (takes `ext` = (ext_docs, ext_w, deep_map) from
      split_postings): the deep_slots terms with the largest q_w x tail also
      read the rest of their base row and their extension row.
    * `phase1_ratio`: term lookup sees only weights >= ratio x the row's
      max; the rescore and the bound see the whole query.
    * `with_bound`: bound = cut + sum_selected q_w w_tail + sum_unselected
      q w_max; -inf when nothing was missed and the k1 cut dropped nothing
      positive (provably exact even with fewer than k matches). With
      merge_shifts < T-1 the bound is +inf. Without rescore it is -inf when
      nothing was truncated and +inf otherwise.
    * `match_rescore` (implied by `token_entry`): the rescore rebuilds each
      candidate token's query weight by comparing it with the T slots
      instead of gathering from the dense query; not valid with
      select_by_impact or phase1_ratio.
    * `tail_blockmax` (takes `bmx` = (bm, bmap)): the tail term becomes the
      block-max bound, min'd with the whole-tail one.
    * `refine_expand` > rescore_expand: rows that fail the certificate at
      the base pool are rescored again from the same run sums at a pool of
      refine_expand x k. JAX compacts those rows under `lax.cond`; here the
      wider pool is computed for every row and spliced into the failing
      ones only (the same answer, no host read).
    * `sort_candidates`, `packed_docs`: rescore locality and packing
      variants (the same scores; on an exact rescore tie the id may differ).
    """
    C = post_docs.shape[1]
    Cq = C if postings_cols is None else min(postings_cols, C)
    TC = query_terms * Cq
    shifts = (query_terms - 1) if merge_shifts is None else min(merge_shifts, query_terms - 1)
    if not rescore and (shifts < query_terms - 1 or Cq < C):
        raise ValueError(
            "approximate candidate generation (merge_shifts/postings_cols) requires "
            "rescore=True — without rescore the returned scores would be truncated")
    if Cq < 1:
        raise ValueError(f"postings_cols={postings_cols} must be >= 1")
    if rescore and rescore_expand < 1:
        raise ValueError(f"rescore_expand={rescore_expand} must be >= 1")
    if phase1_ratio is not None and not rescore:
        raise ValueError("phase1_ratio (query-side two-phase) requires rescore=True — "
                         "phase-1 sums drop the pruned terms' mass")
    if packed_docs and post_w.dtype != torch.bfloat16:
        raise ValueError(
            f"packed_docs requires bfloat16 postings weights (got {post_w.dtype}); the packed "
            "rescore is a bf16 truncation and the exactness bound must be computed from the "
            "same values")
    if TC < k:
        raise ValueError(
            f"k={k} exceeds the candidate pool query_terms*postings_cols={query_terms}*{Cq}="
            f"{TC} — raise query_terms/postings_cap or lower k")
    if token_entry:
        match_rescore = rescore  # no dense query exists to gather from
        if select_by_impact or phase1_ratio is not None or Cq < C:
            raise ValueError(
                "token_entry is the inf-free fast path: incompatible with select_by_impact / "
                "phase1_ratio / postings_cols (those modes need the dense query)")
    if match_rescore and (select_by_impact or phase1_ratio is not None):
        raise ValueError("match_rescore reconstructs the query from the lookup slots — unsound "
                         "when select_by_impact/phase1_ratio exclude query mass from them")
    if tail_blockmax and not with_bound:
        raise ValueError("tail_blockmax only affects the with_bound path")
    deep_slots = min(max(int(deep_slots), 0), query_terms)
    V = post_docs.shape[0]
    inf = float("inf")

    def search(q, post_docs, post_w, doc_toks, doc_ws, ext=None, bmx=None):
        if token_entry:
            q_tok, q_w = q
            q_tok = q_tok.to(torch.int32)
            q_w = torch.clamp(q_w.float(), min=0.0)
            B = q_tok.shape[0]
            if q_tok.shape[1] != query_terms:
                raise ValueError(
                    f"token_entry: q_tok has {q_tok.shape[1]} slots, the search fn was built "
                    f"for query_terms={query_terms} — pad/truncate the slot axis at the caller")
        else:
            B = q.shape[0]
            if phase1_ratio is not None:
                thresh = q.amax(dim=1, keepdim=True) * phase1_ratio
                q_sel = torch.where(q >= thresh, q, 0.0)
            else:
                q_sel = q
            if select_by_impact:
                # impact upper bound per term: q_w x its max posting weight
                # (column 0, postings being impact-sorted)
                ub = q_sel * torch.clamp(post_w[:, 0].float(), min=0.0)[None, :]
                _, q_tok = _topk(ub, query_terms)
                q_w = torch.gather(q_sel, 1, q_tok)
            else:
                q_w, q_tok = _topk(q_sel, query_terms)
        term_valid = q_w > 0
        tok_i = _gather_index(q_tok, V)  # [B, T] in range, as JAX gathers

        docs = _rows(post_docs[:, :Cq] if Cq < C else post_docs, tok_i)  # [B, T, Cq]
        pw = _rows(post_w[:, :Cq] if Cq < C else post_w, tok_i).float()
        part = pw * q_w[:, :, None]
        valid = (docs != _PAD_ID) & term_valid[:, :, None] & (pw > 0)
        ids = torch.where(valid, docs, _PAD_ID).reshape(B, TC)
        part = torch.where(valid, part, 0.0).reshape(B, TC)

        w_tail = pw[:, :, -1]  # [B, T] smallest weight read per term
        if deep_slots:
            ext_docs_a, ext_w_a, deep_map_a = ext
            contrib = torch.where(term_valid, q_w * w_tail, -1.0)
            _, dpos = _topk(contrib, deep_slots)  # [B, S] slot positions
            d_tok = torch.gather(tok_i, 1, dpos)
            d_qw = torch.gather(q_w, 1, dpos)
            extra_ids, extra_part = [ids], [part]
            if Cq < C:
                m_docs = _rows(post_docs[:, Cq:], d_tok)  # [B, S, C - Cq]
                m_w = _rows(post_w[:, Cq:], d_tok).float()
                m_valid = (m_docs != _PAD_ID) & (d_qw > 0)[:, :, None] & (m_w > 0)
                extra_ids.append(torch.where(m_valid, m_docs, _PAD_ID).reshape(B, -1))
                extra_part.append(torch.where(m_valid, m_w * d_qw[:, :, None], 0.0).reshape(B, -1))
            rows = _rows(deep_map_a, d_tok).long()  # the pad row for non-deep tokens
            e_docs = _rows(ext_docs_a, rows)  # [B, S, Ce]
            e_w = _rows(ext_w_a, rows).float()
            e_valid = (e_docs != _PAD_ID) & (d_qw > 0)[:, :, None] & (e_w > 0)
            extra_ids.append(torch.where(e_valid, e_docs, _PAD_ID).reshape(B, -1))
            extra_part.append(torch.where(e_valid, e_w * d_qw[:, :, None], 0.0).reshape(B, -1))
            ids = torch.cat(extra_ids, dim=1)
            part = torch.cat(extra_part, dim=1)
            # deep terms pay the extension's last read weight as their tail
            w_tail = w_tail.scatter(1, dpos, e_w[:, :, -1])

        miss = total_ub = None
        if with_bound:
            sel_max = torch.where(term_valid, q_w * torch.clamp(pw[:, :, 0], min=0.0),
                                  0.0).sum(dim=1)
            if token_entry:
                total_ub = sel_max  # every active term is a slot
                unsel = torch.zeros_like(sel_max)
            else:
                # elementwise fp32 products and an fp32 sum: never a TF32 matmul
                w_max = torch.clamp(post_w[:, 0].float(), min=0.0)
                total_ub = (q * w_max[None, :]).sum(dim=1)
                unsel = torch.clamp(total_ub - sel_max, min=0.0)
            tail = torch.where(term_valid, q_w * w_tail, 0.0).sum(dim=1)
            if tail_blockmax:
                bm_a, bmap_a = bmx
                bmr = _rows(bm_a, _rows(bmap_a, tok_i).long()).float()  # [B, T, NB]
                per = torch.where(term_valid[:, :, None],
                                  q_w[:, :, None] * torch.minimum(bmr, w_tail[:, :, None]), 0.0)
                tail = torch.minimum(tail, per.sum(dim=1).amax(dim=1))
            miss = tail + unsel

        # sort-merge by doc id: one stable sort carries the partial scores
        # (slot order within a run is kept), then T-1 masked shifted adds
        # read at each run's last element sum every run exactly (a doc is in
        # a term's postings at most once, so runs are at most T long)
        sid, order = torch.sort(ids, dim=1, stable=True)
        sp = torch.gather(part, 1, order)
        n = sid.shape[1]
        is_end = torch.ones_like(sid, dtype=torch.bool)
        is_end[:, :-1] = sid[:, 1:] != sid[:, :-1]
        run_sum = sp.clone()
        for j in range(1, min(shifts, n - 1) + 1):
            run_sum[:, j:] += torch.where(sid[:, j:] == sid[:, :-j], sp[:, :-j], 0.0)
        sums = torch.where(is_end & (sid != _PAD_ID), run_sum, -inf)
        rid = sid

        if not rescore:
            s, sel = _topk(sums, k)
            i = torch.where(torch.isfinite(s), torch.gather(rid, 1, sel), _PAD_ID)
            i = torch.where(i == _PAD_ID, -1, i)
            if with_bound:
                bound = torch.where(miss > 1e-4 * torch.clamp(total_ub, min=1e-30), inf, -inf)
                return s, i, bound
            return s, i

        qv = (q_tok, q_w) if match_rescore else q

        def pool_rescore(k1):
            """Exact rescore of the top-k1 run sums: the top-k (scores,
            ids) and the missed-score bound of this pool width."""
            s1, sel = _topk(sums, k1)
            cand = torch.where(torch.isfinite(s1), torch.gather(rid, 1, sel), _PAD_ID)  # [B, k1]
            if sort_candidates:
                cand, _ = torch.sort(cand, dim=1, stable=True)
            safe = cand.long().clamp(0, doc_toks.shape[0] - 1)
            if packed_docs:
                pk = _rows(doc_toks, safe).int()  # [B, k1, L]
                ct = pk & 0xFFFF
                cw = (((pk >> 16) & 0xFFFF) << 16).view(torch.float32)
            else:
                ct = _rows(doc_toks, safe)
                cw = _rows(doc_ws, safe).float()
            if match_rescore:
                # each candidate token's query weight by comparing it with
                # the T slots in turn (a [B, k1, L] tile each, no [.., T]
                # temporary); duplicate slots both count, as a scatter-add
                mt, mw = qv
                ct = ct.int()
                g = torch.zeros(ct.shape, dtype=torch.float32, device=ct.device)
                for t in range(query_terms):
                    hit = (ct == mt[:, t][:, None, None]) & (mw[:, t] > 0)[:, None, None]
                    g = g + torch.where(hit, mw[:, t][:, None, None], 0.0)
            else:
                g = torch.gather(qv, 1, ct.long().reshape(B, -1)).view(B, k1, -1)
            exact = (g * cw).sum(dim=-1)
            exact = torch.where(cand == _PAD_ID, -inf, exact)
            s, sel2 = _topk(exact, k)
            i = torch.gather(cand, 1, sel2)
            i = torch.where(i == _PAD_ID, -1, i)
            if not with_bound:
                return s, i, None
            if shifts < query_terms - 1:
                # truncated run sums: the cut term is unsound, never certify
                return s, i, torch.full((B,), inf, device=s.device)
            if k1 < n:
                # a narrower pool than the sort: dropped candidates are
                # bounded by the k1-th run sum
                last = s1[:, -1]
                cut = torch.where(torch.isfinite(last), torch.clamp(last, min=0.0), 0.0)
            else:
                cut = torch.zeros((B,), device=s.device)
            bound = cut + miss
            # zero-miss certificate: nothing truncated, every active term in
            # a slot, and the cut dropped nothing positive: provably exact
            # even with fewer than k matches
            zero_miss = (cut <= 0.0) & (miss <= 1e-4 * torch.clamp(total_ub, min=1e-30))
            return s, i, torch.where(zero_miss, -inf, bound)

        k1 = min(rescore_expand * k, n)
        s, i, bound = pool_rescore(k1)
        if not with_bound:
            return s, i
        k2 = min(max(int(refine_expand), 0) * k, n)
        if k2 > k1 and shifts >= query_terms - 1:
            # cut refinement: rows the base pool cannot certify take the
            # deeper pool's answer (a superset of the base pool)
            unc = ~certified_mask(s[:, -1], bound)
            s2, i2, b2 = pool_rescore(k2)
            s = torch.where(unc[:, None], s2, s)
            i = torch.where(unc[:, None], i2, i)
            bound = torch.where(unc, b2, bound)
        return s, i, bound

    return search
