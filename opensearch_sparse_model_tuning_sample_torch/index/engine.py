"""On-device sparse retrieval engine (the port of the JAX package's
`index/engine.py`).

  * **sparse engine**: a doc-major forward index — per doc, up to L_max
    (token_id, weight) pairs, impact-sorted. Scoring walks doc blocks,
    gathers the query columns for each block's token ids, contracts them
    with the block's weights, and keeps a running top-k. Memory ∝ nnz;
    exact for any weight distribution.
  * **inverted engine**: impact-ordered token-major postings
    (`index/inverted.py`): gather the query terms' top-C postings,
    sort-merge the partial scores by doc id, rescore the candidates against
    the doc-major rows, and bound the score of any doc it missed. With
    exact escalation the rows that the bound does not certify re-run, first
    through a deep re-lookup of the postings, then through the exact scan.
  * **dense engine**: exact Q @ Dᵀ over the dense [N, V] matrix — the
    correctness oracle for small corpora.
  * **auto**: the sparse scan below `auto_threshold` docs, the inverted
    engine with exact escalation from there on.

All of it is torch ops (the JAX package wrote these as XLA ops, not Pallas
kernels). The serving surface is here too: `search_tokens` (the
`neural_sparse` token->weight query, with the inverted engine's token-entry
fast path), two-phase search, `reopen` for the add -> refresh -> add loop,
and the async handle API the server calls, and `merge_saved` of the shards
a multi-process ingest saved. Saved indexes use the JAX package's format 2,
so an index saved by either package loads in the other.

On a device mesh (`core/mesh.py`, more than one position) the index is
sharded by `cfg.shard_by`:

  * "docs": the padded corpus splits into one contiguous stripe per mesh
    position, on its device, with the stripe's own postings (local doc
    ids). A search runs on every stripe, offsets its ids to global ones and
    merges the stripes' top-k on the mesh's first device (`merged_topk`);
    the inverted engine's missed-score bound is the max of the stripes'.
    Two-phase runs inside each stripe, before the merge.
  * "queries": every position holds the whole index and answers a
    contiguous slice of each query batch.

Rows that the inverted engine's certificate does not cover escalate on the
host, straight to the mesh's own exact scan (no deep tier, no block-max
tail bound on a mesh). The token entry's fast path is single-device. A
mesh of one position is the single-device index.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass, fields
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device, resolve_dtype
from ..core.mesh import Mesh, replicate, shard_rows
from ..parallel.collectives import merged_topk
from ..utils import tracing
from . import inverted

logger = logging.getLogger(__name__)

_MIN_INVERTED_ROWS = 64


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _select(s: torch.Tensor, i: torch.Tensor, k: int):
    """Top-k of scores s [Bq, n] with their ids i: descending, ties to the
    lower column, which is `lax.top_k`'s order. A stable sort, not
    `torch.topk` (whose tie order is unspecified), so a two-phase candidate
    pool holds the same docs as the JAX package's where phase-1 scores tie
    (at 0, mostly)."""
    s, order = torch.sort(s, dim=1, descending=True, stable=True)
    return s[:, :k], torch.gather(i, 1, order[:, :k])


def _load_weights(blob) -> np.ndarray:
    """Weight array from a saved index blob, as float32: bfloat16 indexes
    store their raw bit pattern under "weights_bf16", others a float array
    under "weights"."""
    if "weights_bf16" in blob:
        bits = blob["weights_bf16"].astype(np.uint32) << 16
        return bits.view(np.float32)
    return blob["weights"].astype(np.float32)


def _pack_cols(s, i, b=None, e=None) -> torch.Tensor:
    """Device half of the packed fetch: one int32 matrix holding the scores
    (bit patterns), the ids, and optionally the missed-score bound (bit
    pattern) and a per-row int code, so one copy to the host brings all."""
    cols = [s.float().contiguous().view(torch.int32), i.to(torch.int32)]
    if b is not None:
        cols.append(b.float().reshape(-1, 1).contiguous().view(torch.int32))
    if e is not None:
        assert b is not None, "the code column rides after the bound column"
        cols.append(e.to(torch.int32).reshape(-1, 1))
    return torch.cat(cols, dim=1)


def _split_packed(arr, n_q, k, has_b, has_e):
    """Host half of the packed fetch: an int32 block back into (scores f32,
    ids int32, bounds f32 | None, codes int32 | None)."""
    s_np, i_np = arr[:n_q, :k].view(np.float32), arr[:n_q, k:2 * k]
    if not has_b:
        return s_np, i_np, None, None
    b_np = arr[:n_q, 2 * k:2 * k + 1].view(np.float32)[:, 0]
    if not has_e:
        return s_np, i_np, b_np, None
    return s_np, i_np, b_np, arr[:n_q, 2 * k + 1]


def _fetch_packed(s, i, n_q, b=None, e=None):
    """(scores, ids, bounds | None, codes | None) as numpy with one copy to
    the host."""
    arr = _pack_cols(s, i, b, e).cpu().numpy()
    return _split_packed(arr, n_q, s.shape[1], b is not None, e is not None)


def _densify_tokens(tok: torch.Tensor, w: torch.Tensor, V: int) -> torch.Tensor:
    """[B, V] fp32 query from (token, weight) slots with one accumulating
    scatter, indexed as the JAX package's `.at[].add(mode="drop")`: a
    negative id counts from the end once (-1 is V - 1), an id still outside
    [0, V) is dropped (masked here: out of range, torch raises on the CPU
    and trips a device-side assert on the card). Weights <= 0 add nothing."""
    tok = tok.long()
    tok = torch.where(tok < 0, tok + V, tok)
    keep = (tok >= 0) & (tok < V) & (w > 0)
    q = torch.zeros(tok.shape[0], V, device=tok.device)
    return q.scatter_add_(1, torch.where(keep, tok, 0), torch.where(keep, w.float(), 0.0))


# a query batch is a dense [n, V] tensor or the token entry's (q_tok, q_w)
def _first(q) -> torch.Tensor:
    return q[0] if isinstance(q, tuple) else q


def _n_rows(q) -> int:
    return _first(q).shape[0]


def _take_rows(q, idx: torch.Tensor):
    if isinstance(q, tuple):
        return tuple(torch.index_select(a, 0, idx) for a in q)
    return torch.index_select(q, 0, idx)


class _Stripe(NamedTuple):
    """One mesh position's part of a sharded index, on its device: a doc
    stripe (rows [offset, offset + len(docs)) of the padded corpus, its
    postings holding local doc ids) or, under query sharding, a replica of
    the whole index (offset 0)."""

    device: torch.device
    offset: int
    docs: torch.Tensor
    toks: Optional[torch.Tensor]  # None: the dense oracle
    post_docs: Optional[torch.Tensor] = None
    post_w: Optional[torch.Tensor] = None
    ext: Optional[tuple] = None  # (ext_docs, ext_w, deep_map)


class _InvertedFns(NamedTuple):
    """One (engine, k, two_phase) instantiation of the inverted search,
    bound to the index tensors of the finalize that built it (a handle
    resolved after a reopen still reads its own snapshot)."""

    base: object  # qb -> (scores, ids, bound)
    deep: Optional[object]  # the deep re-lookup tier, or None
    scan: object  # dense qb -> (scores, ids): the exact scan
    escalate: bool
    is_tok: bool
    batch: int  # rows per call of base/deep/scan
    vocab: int


@dataclass
class IndexConfig:
    """The JAX package's IndexConfig, field for field and with its
    defaults, so saved metas and shared configs parse. `shard_by` ("docs"
    or "queries") is the layout on a mesh of more than one position (see
    the module docstring). The inverted knobs:

    * `postings_cap`, `query_terms`: the top-C postings kept per token, and
      the query term slots of one lookup.
    * `inverted_rescore(_expand)`: the exact rescore of a pool of expand x k
      candidates; `refine_expand`: a deeper pool for rows the base pool
      cannot certify (0 = off).
    * `postings_ext_cap`, `deep_slots`: tiered read depths (extension rows
      for tokens whose postings reach past postings_cap, read by the
      deep_slots terms with the largest bound contribution); 0 = off.
    * `tail_block_docs`: the block-max tail bound, docs per block (0 = off).
    * `deep_escalate(_expand)`, `full_deep_query_terms`: the deep re-lookup
      tier of exact escalation.
    * `full_query_terms`, `full_postings_cols`, `full_rescore_expand`,
      `full_merge_shifts`: the full-forward mode for queries wider than
      query_terms; `full_fallback_scan` sends them to the exact scan
      instead; `full_exact_escalate` (None = on exactly when the deep tier
      exists) escalates them.
    * `incremental_postings` (None = on when the index lives on a CUDA
      device), `incremental_unit`: the postings build on a host thread
      during ingest.
    * `exact_escalate` (None = on exactly when "auto" picks the inverted
      engine): rows the certificate does not cover re-run until exact.
    """

    engine: str = "auto"
    auto_threshold: int = 65536
    l_max: int = 256  # max stored (token, weight) pairs per doc
    block_docs: int = 1024  # docs scored per scan step
    query_batch: int = 16  # queries scored together
    weight_dtype: str = "bfloat16"
    two_phase_mode: str = "query"
    two_phase_ratio: float = 0.4
    two_phase_terms: int = 32
    two_phase_expand: int = 8
    postings_cap: int = 2048
    query_terms: int = 16
    inverted_rescore: bool = True
    inverted_rescore_expand: int = 16
    refine_expand: int = 0
    postings_ext_cap: int = 0
    deep_slots: int = 2
    tail_block_docs: int = 0
    deep_escalate: bool = True
    deep_escalate_expand: int = 64
    full_deep_query_terms: int = 128
    full_query_terms: int = 64
    full_postings_cols: int = 256
    full_rescore_expand: int = 16
    full_merge_shifts: Optional[int] = None
    full_fallback_scan: bool = False
    full_exact_escalate: Optional[bool] = None
    shard_by: str = "docs"
    incremental_postings: Optional[bool] = None
    incremental_unit: int = 131072
    exact_escalate: Optional[bool] = None

    def __post_init__(self):
        valid = ("sparse", "inverted", "dense", "auto")
        if self.engine not in valid:
            raise ValueError(f"IndexConfig.engine={self.engine!r} — must be one of {valid}")
        if self.shard_by not in ("docs", "queries"):
            raise ValueError(
                f"IndexConfig.shard_by={self.shard_by!r} — must be 'docs' or 'queries'"
            )
        if self.two_phase_mode not in ("query", "doc"):
            raise ValueError(
                f"IndexConfig.two_phase_mode={self.two_phase_mode!r} — must be 'query' or 'doc'"
            )


class SparseIndex:
    """Host-facing index: accumulate sparse doc reps, finalize to device
    tensors, search.

        idx = SparseIndex(vocab_size, cfg, device=...)   # or mesh=make_mesh(...)
        idx.add_topk(ids, token_idx, weights)   # per encoded batch
        idx.finalize()
        hits = idx.search(q_reps, k=10)         # [{doc_id: score}, ...]

    With a mesh, `device` is the mesh's first device (a `device` that
    disagrees raises): results, the query batch and the merge live there.
    """

    def __init__(self, vocab_size: int, cfg: Optional[IndexConfig] = None,
                 mesh: Optional[Mesh] = None, device: DeviceLike = None):
        self.vocab_size = vocab_size
        self.cfg = cfg or IndexConfig()
        self.mesh = mesh
        if mesh is not None:
            first = resolve_device(mesh.devices[0])
            if device is not None and resolve_device(device) != first:
                raise ValueError(f"device {device!r} disagrees with the mesh {mesh}: the index "
                                 f"lives on the mesh's first device, {first}")
            self.device = first
        else:
            self.device = resolve_device(device)
        self._shard_queries = False  # resolved at finalize()
        self.doc_ids: List[str] = []
        self._tok_chunks: List[np.ndarray] = []
        self._w_chunks: List[np.ndarray] = []
        self._dense_chunks: List[np.ndarray] = []
        self.count_tensor = np.zeros((vocab_size,), dtype=np.int64)
        self._finalized = False
        self._exact_escalate = bool(self.cfg.exact_escalate)  # resolved at finalize()
        self._query_batch = self.cfg.query_batch
        self._ids_arr: Optional[np.ndarray] = None
        self._warned_fallback = False
        self._inc: Optional[inverted.IncrementalPostingsBuilder] = None
        self._inc_fed = 0
        # how the last finalize built its postings: "incremental" (the
        # postings thread), "one-shot", or None (no inverted engine)
        self.postings_source: Optional[str] = None
        # copies of device results to the host made by searches, counted
        # (the escalation ladder reads its row counts there)
        self.host_syncs = 0
        self._clear_device()
        # per-query exactness flags of the last search. The inverted engine
        # sets them: certified (with escalation on, every row: the rest
        # re-ran), escalated (the rows that re-ran) and scan_escalated (the
        # rows that fell through to the exact scan). The scan and dense
        # engines leave them None (exact by construction, except two-phase,
        # which is approximate with no certificate).
        self.last_certified: Optional[np.ndarray] = None
        self.last_escalated: Optional[np.ndarray] = None
        self.last_scan_escalated: Optional[np.ndarray] = None

    def _clear_device(self):
        self._docs_dev: Optional[torch.Tensor] = None
        self._tok_dev: Optional[torch.Tensor] = None
        self._post_docs: Optional[torch.Tensor] = None
        self._post_w: Optional[torch.Tensor] = None
        self._ext_docs = self._ext_w = self._deep_map = None  # tiered depths
        self._bm = self._bmap = self._bm_full = self._bmap_full = None  # block maxima
        # a sharded index's per-position parts (None: the single layout)
        self._stripes: Optional[List[_Stripe]] = None
        self._search_fns: Dict[tuple, _InvertedFns] = {}

    # ------------------------------------------------------------- ingest
    @tracing.spanned("index.add")
    def add(self, doc_ids: Sequence[str], reps: np.ndarray):
        """Add a batch of dense doc representations [B, V] (fp32)."""
        if self._finalized:
            raise RuntimeError("index already finalized")
        if reps.shape[1] != self.vocab_size:
            raise ValueError(f"reps have {reps.shape[1]} columns, index vocab {self.vocab_size}")
        self.doc_ids.extend(map(str, doc_ids))
        self.count_tensor += (reps > 0).sum(axis=0).astype(np.int64)
        if self.cfg.engine == "dense":
            self._dense_chunks.append(reps.astype(np.float32))
            return
        L = self.cfg.l_max
        reps = np.asarray(reps, dtype=np.float32)
        # keep the top-L_max activations per doc, impact-sorted
        if reps.shape[1] > L:
            part = np.argpartition(reps, -L, axis=1)[:, -L:]
        else:
            part = np.broadcast_to(np.arange(reps.shape[1], dtype=np.int64), reps.shape)
        vals = np.take_along_axis(reps, part, axis=1)
        order = np.argsort(-vals, axis=1)
        toks = np.take_along_axis(part, order, axis=1).astype(np.int32)
        ws = np.take_along_axis(vals, order, axis=1)
        inactive = ws <= 0
        toks[inactive] = 0
        ws[inactive] = 0.0
        if toks.shape[1] < L:  # corpus vocab narrower than l_max
            pad = L - toks.shape[1]
            toks = np.pad(toks, ((0, 0), (0, pad)))
            ws = np.pad(ws, ((0, 0), (0, pad)))
        self._tok_chunks.append(toks)
        self._w_chunks.append(ws)
        self._feed_incremental()

    @tracing.spanned("index.add")
    def add_topk(self, doc_ids: Sequence[str], token_idx: np.ndarray, weights: np.ndarray):
        """Add pre-sparsified rows (BatchEncoder.resolve_chunk_sparse):
        token_idx/weights [B, k] already impact-sorted, zero-padded."""
        if self._finalized:
            raise RuntimeError("index already finalized")
        if self.cfg.engine not in ("sparse", "inverted", "auto"):
            raise ValueError("add_topk needs a sparse-format engine")
        self.doc_ids.extend(map(str, doc_ids))
        active = weights > 0
        self.count_tensor += np.bincount(
            token_idx[active].reshape(-1), minlength=self.vocab_size
        ).astype(np.int64)
        L = self.cfg.l_max
        B, k = token_idx.shape
        toks = np.zeros((B, L), dtype=np.int32)
        ws = np.zeros((B, L), dtype=np.float32)
        m = min(k, L)
        toks[:, :m] = token_idx[:, :m]
        ws[:, :m] = np.where(active, weights, 0.0)[:, :m]
        self._tok_chunks.append(toks)
        self._w_chunks.append(ws)
        self._feed_incremental()

    # ------------------------------------------- incremental postings build
    def _incremental_applicable(self) -> bool:
        """The postings thread runs for inverted engines (and "auto" once it
        has auto_threshold docs) when `incremental_postings` says so; None
        means on when the index lives on a CUDA device (ingest keeps the
        card busy and the host idle there)."""
        inc = self.cfg.incremental_postings
        if inc is None:
            inc = self.device.type == "cuda"
        if not inc:
            return False
        if self.mesh is not None and self.mesh.size > 1 and self.cfg.shard_by != "queries":
            return False  # a doc-sharded mesh builds each stripe's postings at finalize
        if self.cfg.engine == "inverted":
            return True
        return self.cfg.engine == "auto" and self.n_docs >= self.cfg.auto_threshold

    def _slice_rows(self, start: int, count: int):
        """Rows [start, start + count) of the accumulated chunks, as fresh
        arrays (the postings thread reads them later)."""
        toks_parts, w_parts = [], []
        lo, hi, pos = start, start + count, 0
        for t, w in zip(self._tok_chunks, self._w_chunks):
            n = t.shape[0]
            if pos + n > lo and pos < hi:
                s, e = max(lo - pos, 0), min(hi - pos, n)
                toks_parts.append(t[s:e])
                w_parts.append(w[s:e])
            pos += n
            if pos >= hi:
                break
        return np.concatenate(toks_parts, axis=0), np.concatenate(w_parts, axis=0)

    def _feed_incremental(self, flush: bool = False):
        """Stream the accumulated rows to the postings thread in incremental_unit
        chunks (flush=True sends the tail too). Starts the thread lazily:
        an "inverted" index from its first add, "auto" once it crosses
        auto_threshold (feeding every row so far)."""
        if self._inc is None:
            if not self._incremental_applicable():
                return
            self._inc = inverted.IncrementalPostingsBuilder(
                self.vocab_size, self._build_cap, unit=max(self.cfg.incremental_unit, 1))
            self._inc_fed = 0
        unit = self._inc.unit
        while True:
            unfed = self.n_docs - self._inc_fed
            if unfed <= 0 or (unfed < unit and not flush):
                return
            take = min(unfed, unit)
            toks, ws = self._slice_rows(self._inc_fed, take)
            self._inc.feed(toks, ws, self._inc_fed)
            self._inc_fed += take

    def _discard_incremental(self):
        """Join and drop the postings thread (its error, if any, goes with it)."""
        if self._inc is not None:
            try:
                self._inc.finish()
            except Exception:  # noqa: BLE001 — the build is being discarded
                pass
            self._inc = None
        self._inc_fed = 0

    @property
    def n_docs(self) -> int:
        return len(self.doc_ids)

    @property
    def _build_cap(self) -> int:
        """Postings depth of the host build: the base cap plus the tiered
        extension depth (split apart at finalize)."""
        return self.cfg.postings_cap + max(int(self.cfg.postings_ext_cap), 0)

    @property
    def avg_doc_activation(self) -> np.ndarray:
        """Average per-token activation count (the `{index}.corpus.bin`
        statistic, reference ingest.py:108-117)."""
        return self.count_tensor.astype(np.float64) / max(self.n_docs, 1)

    # ----------------------------------------------------------- finalize
    @tracing.spanned("index.finalize")
    def finalize(self):
        if self._finalized:
            return
        self._engine = self.cfg.engine
        if self._engine == "auto":
            self._engine = "sparse" if self.n_docs < self.cfg.auto_threshold else "inverted"
        # None resolves here: an auto-picked inverted engine escalates (auto
        # keeps the scan's exact contract); explicit engines default off
        self._exact_escalate = (
            self.cfg.engine == "auto" and self._engine == "inverted"
            if self.cfg.exact_escalate is None else bool(self.cfg.exact_escalate)
        )
        n_shards = self.mesh.size if self.mesh is not None else 1
        # query sharding replicates the index: every position holds all the
        # rows and answers its slice of each query batch
        self._shard_queries = n_shards > 1 and self.cfg.shard_by == "queries"
        # the rounded batch lives on the index: written back into cfg it
        # would change the caller's (shared, saved) config
        self._query_batch = self.cfg.query_batch
        if self._shard_queries and self._query_batch % n_shards:
            self._query_batch = _round_up(self._query_batch, n_shards)
            logger.info("shard_by=queries: query_batch rounded up to %d (a multiple of %d "
                        "mesh positions)", self._query_batch, n_shards)
        stripes = 1 if self._shard_queries else n_shards
        blk = self.cfg.block_docs
        n = self.n_docs
        n_pad = _round_up(max(n, 1), blk * stripes)
        wdt = resolve_dtype(self.cfg.weight_dtype)
        self._clear_device()
        self.postings_source = None
        if self._engine == "dense":
            D = (np.concatenate(self._dense_chunks, axis=0) if self._dense_chunks
                 else np.zeros((0, self.vocab_size), np.float32))
            D = np.concatenate([D, np.zeros((n_pad - n, self.vocab_size), np.float32)])
            if stripes > 1:
                self._finalize_stripes(D, None, wdt)
            else:
                self._docs_dev = torch.from_numpy(D).to(self.device, wdt)
        else:
            L = self.cfg.l_max
            toks = (np.concatenate(self._tok_chunks, axis=0) if self._tok_chunks
                    else np.zeros((0, L), np.int32))
            ws = (np.concatenate(self._w_chunks, axis=0) if self._w_chunks
                  else np.zeros((0, L), np.float32))
            toks = np.concatenate([toks, np.zeros((n_pad - n, L), np.int32)])
            ws = np.concatenate([ws, np.zeros((n_pad - n, L), np.float32)])
            if stripes > 1:
                self._finalize_stripes(ws, toks, wdt)
            else:
                self._tok_dev = torch.from_numpy(toks.astype(self._tok_dtype)).to(self.device)
                self._docs_dev = torch.from_numpy(ws).to(self.device, wdt)
                if self._engine == "inverted":
                    self._finalize_postings(toks, ws, n, n_pad, wdt)
        if self._shard_queries:
            self._replicate()
        self._n_pad = n_pad
        self._tok_chunks, self._w_chunks, self._dense_chunks = [], [], []
        self._finalized = True
        logger.info("index finalized: %d docs (padded %d) engine=%s device=%s postings=%s "
                    "shards=%d%s", n, n_pad, self._engine, self.device, self.postings_source,
                    n_shards, " (by queries)" if self._shard_queries else "")

    @property
    def _tok_dtype(self):
        # token ids < 32768 fit int16 — halves the dominant index array
        return np.int16 if self.vocab_size < 2**15 else np.int32

    def _finalize_stripes(self, ws, toks, wdt):
        """The doc-sharded layout: stripe s (rows [s, s + 1) x n_pad / n of
        the padded corpus) on mesh position s's device, and for the
        inverted engine its own postings over its rows (local doc ids; each
        stripe's build on one thread, a function of its rows, the stripes
        built side by side). The extension rows are padded to the largest
        stripe's deep-row count; every stripe keeps its own deep map. No
        block-max tail bound on a mesh."""
        mesh = self.mesh
        docs = shard_rows(mesh, torch.from_numpy(ws).to(wdt))
        tks = (shard_rows(mesh, toks.astype(self._tok_dtype)) if toks is not None
               else [None] * mesh.size)
        shard_n = ws.shape[0] // mesh.size
        posts = [(None, None, None)] * mesh.size
        if self._engine == "inverted":
            posts = self._stripe_postings(toks, ws, shard_n, wdt)
            self.postings_source = "per-stripe"
        self._stripes = [_Stripe(dev, s * shard_n, docs[s], tks[s], *posts[s])
                         for s, dev in enumerate(mesh.devices)]

    def _stripe_postings(self, toks, ws, shard_n, wdt):
        """[(post_docs, post_w, ext | None)] per stripe, on its device."""
        cfg, mesh = self.cfg, self.mesh

        def build(s):
            sl = slice(s * shard_n, (s + 1) * shard_n)
            pd, pw = inverted.build_postings(toks[sl], ws[sl], self.vocab_size, self._build_cap)
            if cfg.postings_ext_cap <= 0:
                return pd, pw, None
            bd, bw, ed, ew, dm = inverted.split_postings(pd, pw, cfg.postings_cap)
            return bd, bw, (ed, ew, dm)

        with ThreadPoolExecutor(max_workers=min(mesh.size, os.cpu_count() or 1)) as pool:
            built = list(pool.map(build, range(mesh.size)))
        rows = max((ext[0].shape[0] for *_, ext in built if ext is not None), default=0)
        out = []
        for dev, (pd, pw, ext) in zip(mesh.devices, built):
            if ext is not None:
                ed, ew, dm = ext
                pad = ((0, rows - ed.shape[0]), (0, 0))  # all-padding rows: no token maps there
                ext = (torch.from_numpy(np.pad(ed, pad, constant_values=inverted._PAD_ID)).to(dev),
                       torch.from_numpy(np.pad(ew, pad)).to(dev, wdt),
                       torch.from_numpy(dm).to(dev))
            out.append((torch.from_numpy(pd).to(dev), torch.from_numpy(pw).to(dev, wdt), ext))
        return out

    def _replicate(self):
        """The query-sharded layout: the single layout's tensors (built on
        the first device) copied to every mesh position's device."""
        parts = [self._docs_dev, self._tok_dev, self._post_docs, self._post_w]
        reps = [replicate(self.mesh, t) if t is not None else [None] * self.mesh.size
                for t in parts]
        ext = None
        if self._ext_docs is not None:
            ext = list(zip(*(replicate(self.mesh, t)
                             for t in (self._ext_docs, self._ext_w, self._deep_map))))
        self._stripes = [_Stripe(dev, 0, reps[0][s], reps[1][s], reps[2][s], reps[3][s],
                                 ext[s] if ext is not None else None)
                         for s, dev in enumerate(self.mesh.devices)]

    def _finalize_postings(self, toks, ws, n, n_pad, wdt):
        """The inverted engine's device tensors: postings (finishing the
        incremental build, or one build), the tiered extension split, and
        the block maxima at both read depths."""
        cfg = self.cfg
        if self._inc is not None:
            # the thread took chunks during ingest: feed the tail, join
            self._feed_incremental(flush=True)
            inc, self._inc, self._inc_fed = self._inc, None, 0
            pd, pw = inc.finish()
            self.postings_source = "incremental"
        else:
            pd, pw = inverted.build_postings(toks[:n] if n else toks, ws[:n] if n else ws,
                                             self.vocab_size, self._build_cap)
            self.postings_source = "one-shot"
        if cfg.postings_ext_cap > 0:
            pd, pw, ed, ew, dm = inverted.split_postings(pd, pw, cfg.postings_cap)
            self._ext_docs = torch.from_numpy(ed).to(self.device)
            self._ext_w = torch.from_numpy(ew).to(self.device, wdt)
            self._deep_map = torch.from_numpy(dm).to(self.device)
        self._post_docs = torch.from_numpy(np.ascontiguousarray(pd)).to(self.device)
        self._post_w = torch.from_numpy(np.ascontiguousarray(pw)).to(self.device, wdt)
        if cfg.tail_block_docs > 0 and not self._shard_queries:
            # (one device only, as in JAX) one per entry mode's shallowest
            # read: postings_cap for the inf-free and token paths,
            # full_postings_cols for full forward
            (bm, bmap), (bmf, bmapf) = inverted.build_tail_blockmax_multi(
                toks[:n] if n else toks, ws[:n] if n else ws, self.vocab_size,
                (cfg.postings_cap, min(cfg.full_postings_cols, cfg.postings_cap)),
                n_pad, cfg.tail_block_docs)
            self._bm, self._bmap = (torch.from_numpy(a).to(self.device) for a in (bm, bmap))
            self._bm_full, self._bmap_full = (torch.from_numpy(a).to(self.device)
                                              for a in (bmf, bmapf))

    def reopen(self):
        """Back to ingest mode after finalize(): recover the host-side rows of
        the first n_docs docs from the device tensors (int16 ids to int32,
        weights through their stored dtype to fp32, the precision search
        uses), drop the device state, and let add()/add_topk() append. This
        is the serving surface's _bulk -> _refresh -> search -> _bulk loop.
        doc_ids stays append-only. An inverted index of a single layout (one
        device, or query-sharded) seeds the next postings build with its
        merged postings (weights through fp32 as stored), so the next
        finalize merges only the new rows; doc stripes are gathered back in
        order and rebuilt."""
        if not self._finalized:
            return
        seed = None
        if (self._engine == "inverted" and self._post_docs is not None
                and not self.cfg.postings_ext_cap and self._incremental_applicable()):
            seed = (self._post_docs.cpu().numpy(), self._post_w.float().cpu().numpy())
        self._discard_incremental()
        n = self.n_docs
        if n:
            docs, toks = self._stored_rows()
            w = docs[:n].float().cpu().numpy()
            if toks is not None:
                self._tok_chunks = [toks[:n].cpu().numpy().astype(np.int32)]
                self._w_chunks = [w]
            else:  # dense engine: the padded [n_pad, V] matrix
                self._dense_chunks = [w]
        self._clear_device()
        self._finalized = False
        if seed is not None:
            self._inc = inverted.IncrementalPostingsBuilder(
                self.vocab_size, self.cfg.postings_cap,
                unit=max(self.cfg.incremental_unit, 1), seed=seed)
            self._inc_fed = n

    def _stored_rows(self):
        """(weights, token ids | None) of the whole padded corpus as stored:
        the single layout's tensors (a query-sharded index's first replica),
        or the doc stripes gathered to the host in order."""
        if self._stripes is not None and not self._shard_queries:
            docs = torch.cat([st.docs.cpu() for st in self._stripes])
            if self._stripes[0].toks is None:
                return docs, None
            return docs, torch.cat([st.toks.cpu() for st in self._stripes])
        return self._docs_dev, self._tok_dev

    def delete(self):
        """Release all index state (the analog of OpenSearch
        `indices.delete`). The object returns to the empty-ingest state."""
        self._clear_device()
        self._finalized = False
        self.doc_ids = []
        self._tok_chunks, self._w_chunks, self._dense_chunks = [], [], []
        self.count_tensor = np.zeros((self.vocab_size,), dtype=np.int64)
        self._discard_incremental()

    # ------------------------------------------------------------- search
    def _topk_batch(self, q: torch.Tensor, k: int, two_phase: Optional[str] = None,
                    rows=None, offset: int = 0):
        """Top-k of one query batch q [Bq, V] fp32 over every doc block,
        merged into a running top-k (engine.py make_scan_topk: the sparse
        scan and the dense oracle). Returns (scores, doc idx). `rows` =
        (docs, toks) to scan, the index's own by default; toks None is the
        dense oracle. `offset` is the global id of rows[0] (a doc stripe's
        first row): the returned ids are global.

        `two_phase` ("query" or "doc", sparse engine only; the dense oracle
        ignores it) makes phase 1 approximate: "query" scores only the query
        terms with weight >= two_phase_ratio * the row's max, "doc" only each
        doc's first min(two_phase_terms, l_max) terms (rows are
        impact-sorted). Phase 1 keeps a pool of k1 = max(min(two_phase_expand
        * k, block_docs), k) candidates, which phase 2 rescores exactly with
        the full query and all l_max terms."""
        Bq = q.shape[0]
        cfg = self.cfg
        blk = cfg.block_docs
        docs, toks = rows if rows is not None else (self._docs_dev, self._tok_dev)
        if toks is None:
            two_phase = None  # the dense oracle is already one exact matmul
        k1 = max(min(cfg.two_phase_expand * k, blk), k) if two_phase else k
        q1 = q
        if two_phase == "query":  # phase 1 sees the high-weight terms only
            q1 = torch.where(q >= q.amax(dim=1, keepdim=True) * cfg.two_phase_ratio, q, 0.0)
        n_terms = min(cfg.two_phase_terms, cfg.l_max) if two_phase == "doc" else None
        best_s = torch.full((Bq, k1), float("-inf"), device=q.device)
        best_i = torch.full((Bq, k1), -1, dtype=torch.long, device=q.device)
        if toks is None:  # the dense oracle scores the query at the weight dtype
            qc = q.to(docs.dtype).float()
        for b0 in range(0, docs.shape[0], blk):
            if toks is None:  # dense oracle: one exact matmul per block
                s = torch.matmul(qc, docs[b0:b0 + blk].float().t())
            else:
                # gather the query columns of this block's token ids, then
                # contract with the block's weights: [Bq, blk, L] -> [Bq, blk]
                tok = toks[b0:b0 + blk, :n_terms].to(torch.int64)
                g = torch.index_select(q1, 1, tok.reshape(-1)).view(Bq, *tok.shape)
                s = (g * docs[b0:b0 + blk, :n_terms].float()).sum(dim=-1)
            gidx = torch.arange(offset + b0, offset + b0 + s.shape[1],
                                device=q.device).expand(Bq, -1)
            best_s, best_i = _select(torch.cat([best_s, s], dim=1),
                                     torch.cat([best_i, gidx], dim=1), k1)
        if not two_phase:
            return best_s, best_i
        # phase 2: the pool rescored exactly; empty slots (id -1) score -inf
        cand = (best_i - offset).clamp(0, docs.shape[0] - 1)
        g = torch.gather(q, 1, toks[cand].to(torch.int64).view(Bq, -1)).view(Bq, k1, -1)
        s2 = (g * docs[cand].float()).sum(dim=-1)
        return _select(torch.where(best_i >= 0, s2, float("-inf")), best_i, k)

    def _scan(self, q: torch.Tensor, k: int, two_phase: Optional[str] = None, stripes=None):
        """`_topk_batch` of one query batch q [Bq, V] (on self.device) in
        the index's layout: the single layout's rows; each doc stripe on its
        device with its ids offset, the stripes' top-k merged on self.device;
        or, query-sharded, a slice of q's rows on each replica. `stripes`
        (default: the index's own) pins the parts of one finalize."""
        stripes = self._stripes if stripes is None else stripes
        if stripes is None:
            return self._topk_batch(q, k, two_phase)
        if self._shard_queries:  # (the layout of every finalize of this index)
            return self._on_slices(q, stripes, lambda s, qs: self._topk_batch(
                qs, k, two_phase, rows=(stripes[s].docs, stripes[s].toks)))
        parts = [self._topk_batch(q.to(st.device), k, two_phase, rows=(st.docs, st.toks),
                                  offset=st.offset) for st in stripes]
        return merged_topk([p[0] for p in parts], [p[1] for p in parts], k)

    def _on_slices(self, q, stripes, fn):
        """fn(s, rows) over q's rows split into one contiguous slice per mesh
        position s (the query-sharded layout), each slice on position s's
        device; the outputs concatenated in order on self.device.
        Every row is computed on its own, so the split changes no answer."""
        n = _n_rows(q)
        per = -(-n // len(stripes))
        outs = []
        for s, st in enumerate(stripes):
            if s * per >= n:
                break
            sl = slice(s * per, (s + 1) * per)
            rows = (tuple(a[sl].to(st.device) for a in q) if isinstance(q, tuple)
                    else q[sl].to(st.device))
            outs.append(fn(s, rows))
        return tuple(torch.cat([o[j].to(self.device) for o in outs]) for j in range(len(outs[0])))

    def _escalate_for(self, engine: Optional[str], two_phase: bool = False) -> bool:
        """Whether a search path escalates: full-forward lookups follow
        `full_exact_escalate` (None = on exactly when the deep tier exists),
        the other inverted paths the finalize-resolved flag. Query-mode
        two-phase never escalates: it is the approximate speed knob (its
        certificates are still computed and exposed)."""
        if two_phase and self.cfg.two_phase_mode == "query":
            return False
        if engine == "inverted_full":
            if self.cfg.full_exact_escalate is None:
                return bool(self.cfg.postings_ext_cap and self.cfg.deep_escalate)
            return bool(self.cfg.full_exact_escalate)
        return self._exact_escalate

    def _inverted_fns(self, k: int, two_phase: bool, engine: str) -> _InvertedFns:
        """The inverted search of one (engine, k, two_phase), built once per
        finalize. "inverted" takes a dense [B, V] query batch, inf-free
        width; "inverted_full" the full-forward mode; "inverted_tokens" the
        (q_tok, q_w) slot pair of the serving fast path."""
        esc = self._escalate_for(engine, two_phase)
        key = (k, two_phase, engine, esc)
        fns = self._search_fns.get(key)
        if fns is not None:
            return fns
        cfg = self.cfg
        is_tok = engine == "inverted_tokens"
        if engine == "inverted_full":
            inv_kw = dict(query_terms=cfg.full_query_terms, k=k, rescore=True,
                          postings_cols=cfg.full_postings_cols,
                          merge_shifts=cfg.full_merge_shifts,
                          rescore_expand=cfg.full_rescore_expand,
                          refine_expand=cfg.refine_expand, select_by_impact=True,
                          with_bound=True)
        else:
            inv_kw = dict(query_terms=cfg.query_terms, k=k, rescore=cfg.inverted_rescore,
                          rescore_expand=cfg.inverted_rescore_expand,
                          refine_expand=cfg.refine_expand, with_bound=True,
                          token_entry=is_tok)
        ext = None
        if self._ext_docs is not None:
            ext = (self._ext_docs, self._ext_w, self._deep_map)
        if ext is not None or (self._stripes is not None and self._stripes[0].ext is not None):
            inv_kw["deep_slots"] = cfg.deep_slots
        if two_phase and cfg.two_phase_mode == "query" and inv_kw["rescore"] and not is_tok:
            # the reference's two-phase: lookup sees only the high-weight
            # terms; the rescore and the bound see the whole query
            inv_kw["phase1_ratio"] = cfg.two_phase_ratio
        bmx = None
        if self._bm is not None:
            inv_kw["tail_blockmax"] = True
            bmx = ((self._bm_full, self._bmap_full) if engine == "inverted_full"
                   else (self._bm, self._bmap))
        if engine == "inverted" and inv_kw["rescore"] and "phase1_ratio" not in inv_kw:
            # the width routing guarantees every active term wins a slot:
            # the rescore rebuilds the query from the slots
            inv_kw["match_rescore"] = True
        # rows per call: query_batch, but at least _MIN_INVERTED_ROWS: every
        # row is computed on its own, and each call is a few hundred small
        # device operations whose launches the host pays for
        batch = max(self._query_batch, _MIN_INVERTED_ROWS)
        if self._stripes is not None:
            if self._shard_queries:
                batch = _round_up(batch, len(self._stripes))
            fns = _InvertedFns(self._mesh_base(k, inv_kw), None,
                               self._mesh_scan(k), esc, is_tok, batch, self.vocab_size)
            self._search_fns[key] = fns
            return fns
        tensors = (self._post_docs, self._post_w, self._tok_dev, self._docs_dev)
        raw = inverted.make_search_fn(*tensors, **inv_kw)
        deep_raw = None
        if esc and ext is not None and cfg.deep_escalate:
            # the deep re-lookup tier: every query term reads its whole
            # base + extension postings, over a wider pool
            deep_kw = dict(inv_kw)
            if engine == "inverted_full":
                deep_kw["query_terms"] = max(cfg.full_deep_query_terms, inv_kw["query_terms"])
            deep_kw["deep_slots"] = deep_kw["query_terms"]
            deep_kw["rescore_expand"] = max(cfg.deep_escalate_expand,
                                            deep_kw.get("rescore_expand", 4))
            deep_raw = inverted.make_search_fn(*tensors, **deep_kw)
        rows = (self._docs_dev, self._tok_dev)

        def base(qb):
            return raw(qb, *tensors, ext, bmx)

        def deep(qb):
            return deep_raw(qb, *tensors, ext, bmx)

        def scan(qd):
            return self._topk_batch(qd, k, None, rows=rows)

        fns = _InvertedFns(base, deep if deep_raw is not None else None, scan, esc, is_tok,
                           batch, self.vocab_size)
        self._search_fns[key] = fns
        return fns

    def _mesh_base(self, k: int, inv_kw: dict):
        """The inverted base pass on a mesh: qb [Bq, V] -> (scores, global
        ids, bound) on self.device. Doc-sharded: every stripe searches its
        own postings and rows, its local ids offset to global ones (-1
        stays -1), the stripes' top-k merged, and the bound is the max of
        the stripes' bounds (a missed doc lives in exactly one stripe).
        Query-sharded: each replica answers its slice of the batch."""
        stripes = self._stripes
        raws = [inverted.make_search_fn(st.post_docs, st.post_w, st.toks, st.docs, **inv_kw)
                for st in stripes]

        def run(s, qb):
            st = stripes[s]
            return raws[s](qb, st.post_docs, st.post_w, st.toks, st.docs, st.ext, None)

        if self._shard_queries:
            return lambda qb: self._on_slices(qb, stripes, run)

        def base(qb):
            outs = [run(s, qb.to(st.device)) for s, st in enumerate(stripes)]
            ids = [torch.where(i >= 0, i + st.offset, -1) for (_, i, _), st in zip(outs, stripes)]
            s, i = merged_topk([o[0] for o in outs], ids, k)
            return s, i, torch.stack([o[2].to(self.device) for o in outs]).amax(dim=0)

        return base

    def _mesh_scan(self, k: int):
        """The mesh's exact scan (the escalation target), sharded as the
        index is, over the parts of this finalize."""
        stripes = self._stripes
        return lambda qd: self._scan(qd, k, None, stripes)

    @staticmethod
    def _in_batches(fn, q, batch: int):
        """fn over q's rows, `batch` rows a call, outputs concatenated. Every
        row is computed on its own, so the batching changes no answer."""
        outs = [fn(tuple(a[s:s + batch] for a in q) if isinstance(q, tuple) else q[s:s + batch])
                for s in range(0, _n_rows(q), batch)]
        return tuple(torch.cat([o[j] for o in outs]) for j in range(len(outs[0])))

    def _dispatch_inverted(self, q, k_eff: int, two_phase: bool, engine: str) -> dict:
        """Queue one inverted search of every row of q (a dense [n, V]
        matrix, or for "inverted_tokens" the slot pair) without waiting:
        the handle holds the device results. With escalation on, a fourth
        column marks the rows to escalate: certified by neither the bound
        nor being all zero (padding rows are exact: nothing to find)."""
        fns = self._inverted_fns(k_eff, two_phase, engine)
        s, i, b = self._in_batches(fns.base, q, fns.batch)
        parts = (s, i, b)
        if fns.escalate:
            active = (q[1] > 0) if isinstance(q, tuple) else (q > 0)
            cert = inverted.certified_mask(s[:, -1], b) | (active.sum(dim=1) == 0)
            parts += (~cert,)
        return {"parts": parts, "n_q": _n_rows(q), "q": q, "fns": fns}

    def _escalate_rows(self, fns: _InvertedFns, q_rows, k_eff: int):
        """The escalation ladder over the rows that need it (q_rows, already
        compacted): the deep re-lookup first, whose certified rows keep its
        answer (stage 1); the rest through the exact scan (stage 2). Reads
        the deep tier's certificate on the host: one copy, and one more for
        the scan when any row reaches it. Returns numpy (scores, ids,
        stage)."""
        n = _n_rows(q_rows)
        s = np.empty((n, k_eff), np.float32)
        i = np.empty((n, k_eff), np.int32)
        stage = np.full(n, 2, np.int32)
        todo = np.arange(n)
        if fns.deep is not None:
            ds, di, db = self._in_batches(fns.deep, q_rows, fns.batch)
            dcert = inverted.certified_mask(ds[:, -1], db)
            ds_np, di_np, _, dc_np = _fetch_packed(ds, di, n, db, dcert)
            self.host_syncs += 1
            ok = dc_np != 0
            s[ok], i[ok], stage[ok] = ds_np[ok], di_np[ok], 1
            todo = np.flatnonzero(~ok)
        if todo.size:
            rest = _take_rows(q_rows, torch.from_numpy(todo).to(_first(q_rows).device))
            qd = _densify_tokens(*rest, fns.vocab) if fns.is_tok else rest
            es, ei = self._in_batches(fns.scan, qd, fns.batch)
            es_np, ei_np, _, _ = _fetch_packed(es, ei, todo.size)
            self.host_syncs += 1
            s[todo], i[todo] = es_np, ei_np
        return s, i, stage

    def _resolve_inverted(self, handles: Sequence[dict]):
        """(scores, ids, bounds, stage codes | None) as numpy for handles of
        one packed width, with one copy to the host for all of them; then
        one escalation ladder over every row of theirs that needs it, per
        search function."""
        packs = [_pack_cols(*h["parts"]) for h in handles]
        arr = (torch.cat(packs) if len(packs) > 1 else packs[0]).cpu().numpy()
        self.host_syncs += 1
        out, row, ladders = [], 0, {}
        for h, pk in zip(handles, packs):
            block = arr[row:row + pk.shape[0]]
            row += pk.shape[0]
            s_np, i_np, b_np, e_np = _split_packed(block, h["n_q"], h["parts"][0].shape[1],
                                                   True, len(h["parts"]) > 3)
            stage = None
            if e_np is not None:
                stage = np.zeros(h["n_q"], np.int32)
                esc = np.flatnonzero(e_np)
                if esc.size:
                    ladders.setdefault(id(h["fns"]), []).append((len(out), esc))
            out.append([s_np, i_np, b_np, stage])
        for jobs in ladders.values():
            h0 = handles[jobs[0][0]]
            parts = [_take_rows(handles[j]["q"], torch.from_numpy(esc).to(
                _first(handles[j]["q"]).device)) for j, esc in jobs]
            q_rows = (tuple(torch.cat(c) for c in zip(*parts)) if isinstance(parts[0], tuple)
                      else torch.cat(parts))
            s, i, stage = self._escalate_rows(h0["fns"], q_rows, h0["parts"][0].shape[1])
            off = 0
            for j, esc in jobs:
                o = out[j]
                o[0][esc], o[1][esc], o[3][esc] = (x[off:off + esc.size] for x in (s, i, stage))
                off += esc.size
        return out

    @staticmethod
    def _flags(s_np, b_np, stage, n_active):
        """(certified, escalated, scan_escalated) of one resolved search:
        with escalation, every row is certified and the stage codes say
        which re-ran; without, the bound's certificate (all-zero rows count
        as certified where their activity is known)."""
        if stage is not None:
            return np.ones(stage.shape[0], dtype=bool), stage != 0, stage >= 2
        kth = s_np[:, -1] if s_np.shape[1] else np.full(s_np.shape[0], -np.inf, np.float32)
        cert = inverted.certified_mask(kth, b_np)
        if n_active is not None:
            cert = cert | (n_active == 0)
        return cert, None, None

    @torch.inference_mode()
    def search(
        self,
        q_reps,  # [B, V] fp32 sparse query reps (numpy or a tensor)
        k: int = 10,
        query_prune: float = 0.0,
        exclude_self: Optional[Sequence[str]] = None,
        two_phase: bool = False,
        full_forward: Optional[bool] = None,
    ) -> List[Dict[str, float]]:
        """Top-k search; returns per-query {doc_id: score} maps.

        `query_prune`: drop query tokens with weight <= prune * max weight
        (reference sparse_embedding_to_query, sparse_encoders.py:184-194).
        `exclude_self`: per-query id whose hit is dropped (search.py:78-80).
        `two_phase`: approximate phase 1 + exact rescore of a candidate pool
        (reference use_two_phase, search.py:27-42) in `cfg.two_phase_mode`:
        on the scan see _topk_batch; on the inverted engine "query" mode
        looks up only the high-weight terms (certified, never escalated).
        `full_forward` routes the inverted engine: queries wider than
        `cfg.query_terms` active terms take the full-forward mode (or the
        exact scan with `cfg.full_fallback_scan`). None decides from the
        batch (one copy of the active counts to the host); False asserts
        every row is within query_terms wide. The exact engines score every
        query term whatever its width."""
        if not self._finalized:
            raise RuntimeError("call finalize() first")
        self.last_certified = self.last_escalated = self.last_scan_escalated = None
        if self.n_docs == 0:
            return [dict() for _ in range(q_reps.shape[0])]
        if q_reps.shape[0] == 0:
            return []
        q = (q_reps if isinstance(q_reps, torch.Tensor)
             else torch.from_numpy(np.asarray(q_reps, dtype=np.float32)))
        q = q.to(self.device, torch.float32)
        if query_prune > 0:
            thresh = q.amax(dim=1, keepdim=True) * query_prune
            q = torch.where(q > thresh, q, 0.0)
        k_eff = min(k + (1 if exclude_self is not None else 0), self.n_docs)
        n_q = q.shape[0]
        engine = None
        if self._engine == "inverted":
            if full_forward is None:
                active = (q > 0).sum(dim=1).max().item()
                self.host_syncs += 1
                full_forward = active > self.cfg.query_terms
            engine = "inverted"
            if full_forward:
                engine = "inverted_full"
                if self.cfg.full_fallback_scan:
                    engine = None  # the exact doc-major scan, corpus-linear
                    if not self._warned_fallback:
                        self._warned_fallback = True
                        logger.warning("inverted engine: full_fallback_scan set; wide "
                                       "queries use the exact doc-major scan")
        if engine is not None:
            handle = self._dispatch_inverted(q, k_eff, two_phase, engine)
            s_np, i_np, b_np, stage = self._resolve_inverted([handle])[0]
            self.last_certified, self.last_escalated, self.last_scan_escalated = self._flags(
                s_np, b_np, stage, None)
            if stage is not None and stage.any():
                logger.debug("exact_escalate: %d/%d queries re-ran (%d on the exact scan)",
                             int((stage > 0).sum()), n_q, int((stage >= 2).sum()))
            return self._collect_results(s_np, i_np, n_q, k, exclude_self)
        Bq = self._query_batch
        mode = self.cfg.two_phase_mode if two_phase else None
        parts = [self._scan(q[i:i + Bq], k_eff, mode) for i in range(0, n_q, Bq)]
        s_np, i_np, _, _ = _fetch_packed(torch.cat([p[0] for p in parts]),
                                         torch.cat([p[1] for p in parts]), n_q)
        self.host_syncs += 1
        return self._collect_results(s_np, i_np, n_q, k, exclude_self)

    def _collect_results(self, s_np, i_np, n_q: int, k: int,
                         exclude_self: Optional[Sequence[str]]) -> List[Dict[str, float]]:
        """Score/id arrays -> per-query {doc_id: score} maps (drops pad ids,
        non-positive scores, and the per-query self hit)."""
        if self._ids_arr is None or len(self._ids_arr) != len(self.doc_ids):
            # doc_ids is append-only across reopen(); rebuild on growth
            self._ids_arr = np.asarray(self.doc_ids, dtype=object)
        valid = (i_np[:n_q] >= 0) & (i_np[:n_q] < self.n_docs) & (s_np[:n_q] > 0)
        ends = np.cumsum(valid.sum(axis=1)).tolist()
        flat_ids = self._ids_arr[i_np[:n_q][valid]].tolist()
        flat_scores = s_np[:n_q][valid].tolist()
        results: List[Dict[str, float]] = []
        start = 0
        for qi in range(n_q):
            end = ends[qi]
            pairs = zip(flat_ids[start:end], flat_scores[start:end])
            if exclude_self is not None:
                self_id = str(exclude_self[qi])
                pairs = (p for p in pairs if p[0] != self_id)
            results.append(dict(itertools.islice(pairs, k)))
            start = end
        return results

    @torch.inference_mode()
    def search_tokens(
        self,
        q_tokens: np.ndarray,  # [B, q_len] int32 token ids (0-padded)
        q_weights: np.ndarray,  # [B, q_len] f32 weights (0 = inactive)
        k: int = 10,
        **kw,
    ) -> List[Dict[str, float]]:
        """Search from (token, weight) pairs: the serving path's entry, the
        analog of the reference's `neural_sparse` query body of token->weight
        maps (sparse_encoders.py:184-194). An inverted index takes slot lists
        of at most `query_terms` as they are (the token-entry fast path: no
        [B, V] query at all); everywhere else the dense [B, V] query is built
        on the device (`_token_query`), so only the (B, q_len) pairs cross
        from the host. `kw` as search()."""
        q_tokens = np.ascontiguousarray(q_tokens, dtype=np.int32)
        q_weights = np.ascontiguousarray(q_weights, dtype=np.float32)
        if self._tokens_fast_eligible(q_tokens, q_weights, kw):
            return self.resolve_hits(self._search_tokens_dispatch(
                q_tokens, q_weights, k, kw.get("query_prune", 0.0), kw.get("exclude_self")))
        if "full_forward" not in kw and q_tokens.shape[1] <= self.cfg.query_terms:
            # at most q_len active terms, within the lookup budget
            kw["full_forward"] = False
        return self.search(self._token_query(q_tokens, q_weights), k=k, **kw)

    def _token_query(self, q_tokens: np.ndarray, q_weights: np.ndarray) -> torch.Tensor:
        """[B, V] fp32 query on the device from (token, weight) slots
        (`_densify_tokens`: duplicates sum, out-of-range ids drop)."""
        return _densify_tokens(torch.from_numpy(q_tokens).to(self.device),
                               torch.from_numpy(q_weights).to(self.device), self.vocab_size)

    def _tokens_fast_eligible(self, q_tokens: np.ndarray, q_weights: np.ndarray,
                              kw: dict) -> bool:
        """The token-entry fast path's routing predicate: a finalized
        single-device inverted index, slot width within `query_terms`, no two-phase, no
        unknown kwargs, and no duplicate active token id in a row (there
        query_prune would threshold per slot here and per merged weight on
        the dense path). The exact engines never qualify."""
        if not (
            self._finalized
            and self._engine == "inverted"
            and (self.mesh is None or self.mesh.size == 1)
            and q_tokens.shape[1] <= self.cfg.query_terms
            and not kw.get("two_phase", False)
            and kw.get("full_forward", None) in (None, False)
            and not set(kw) - {"query_prune", "exclude_self", "two_phase", "full_forward"}
            and self.n_docs > 0
            and q_tokens.shape[0] > 0
        ):
            return False
        srt = np.sort(np.where(q_weights > 0, q_tokens, -1), axis=1)
        return not bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any())

    @torch.inference_mode()
    def _search_tokens_dispatch(self, q_tok, q_w, k, query_prune, exclude_self) -> dict:
        """Token-entry search, queued on the device without waiting: the
        slots (pruned, padded to query_terms) go straight into the postings
        lookup. Token ids index as JAX gathers them (a negative id counts
        from the end, then clamps into [0, V)); the rescore matches the
        slots' own ids, so an out-of-range id scores nothing."""
        T = self.cfg.query_terms
        n_q, S = q_tok.shape
        if query_prune > 0:
            thresh = q_w.max(axis=1, keepdims=True) * query_prune
            q_w = np.where(q_w > thresh, q_w, 0.0).astype(np.float32)
        if S < T:  # pad the slot axis to the search's width
            q_tok = np.pad(q_tok, ((0, 0), (0, T - S)))
            q_w = np.pad(q_w, ((0, 0), (0, T - S)))
        dev = (torch.tensor(q_tok, dtype=torch.int32, device=self.device),
               torch.tensor(q_w, dtype=torch.float32, device=self.device))
        k_eff = min(k + (1 if exclude_self is not None else 0), self.n_docs)
        handle = self._dispatch_inverted(dev, k_eff, False, "inverted_tokens")
        handle.update(k=k, exclude_self=exclude_self, n_active=(q_w > 0).sum(axis=1))
        return handle

    def search_tokens_async(self, q_tokens: np.ndarray, q_weights: np.ndarray,
                            k: int = 10, **kw) -> dict:
        """search_tokens as a handle for resolve_hits(). The inverted
        engine's fast path queues its device work and returns at once;
        everywhere else the call degrades to a synchronous search whose
        results and flags ride the handle, so callers need one code path."""
        q_tokens = np.ascontiguousarray(q_tokens, dtype=np.int32)
        q_weights = np.ascontiguousarray(q_weights, dtype=np.float32)
        if self._tokens_fast_eligible(q_tokens, q_weights, kw):
            return self._search_tokens_dispatch(
                q_tokens, q_weights, k, kw.get("query_prune", 0.0), kw.get("exclude_self"))
        results = self.search_tokens(q_tokens, q_weights, k=k, **kw)
        return {
            "sync_results": results,
            "flags": (self.last_certified, self.last_escalated, self.last_scan_escalated),
        }

    def _finish_resolve(self, arrays, handle):
        """(results, certified, escalated, scan_escalated) of a resolved
        token handle, without touching the last_* attributes."""
        s_np, i_np, b_np, stage = arrays
        flags = self._flags(s_np, b_np, stage, handle["n_active"])
        return (self._collect_results(s_np, i_np, handle["n_q"], handle["k"],
                                      handle["exclude_self"]),) + flags

    @torch.inference_mode()
    def resolve_hits(self, handle: dict) -> List[Dict[str, float]]:
        """The results of a search_tokens_async handle (the copy to the host,
        then the escalation ladder where rows need it); sets the last_*
        flags as the synchronous call does."""
        if "sync_results" in handle:
            (self.last_certified, self.last_escalated,
             self.last_scan_escalated) = handle["flags"]
            return handle["sync_results"]
        results, *flags = self._finish_resolve(self._resolve_inverted([handle])[0], handle)
        self.last_certified, self.last_escalated, self.last_scan_escalated = flags
        return results

    @torch.inference_mode()
    def resolve_hits_many(self, handles: Sequence[dict]) -> List[List[Dict[str, float]]]:
        """resolve_hits over a window of handles, in order, with one copy to
        the host for all dispatched handles of one packed width (and one
        escalation ladder for all their rows that need it). The last_*
        flags become the row-wise concatenation of the handles' flags (None
        if any handle lacks them)."""
        out: List[Optional[List[Dict[str, float]]]] = [None] * len(handles)
        flags: List[tuple] = [(None, None, None)] * len(handles)
        groups: Dict[tuple, List[int]] = {}
        for j, h in enumerate(handles):
            if "sync_results" in h:
                out[j], flags[j] = h["sync_results"], h["flags"]
            else:
                p = h["parts"]
                groups.setdefault((p[0].shape[1], len(p)), []).append(j)
        for idxs in groups.values():
            arrays = self._resolve_inverted([handles[j] for j in idxs])
            for j, a in zip(idxs, arrays):
                out[j], *f = self._finish_resolve(a, handles[j])
                flags[j] = tuple(f)

        def _cat(col):
            vals = [f[col] for f in flags]
            if not vals or any(v is None for v in vals):
                return None
            return np.concatenate(vals)

        self.last_certified, self.last_escalated, self.last_scan_escalated = (
            _cat(0), _cat(1), _cat(2))
        return out

    # -------------------------------------------------------- persistence
    def save(self, path: str):
        """Format 2, as the JAX package writes it: the doc-major rows and
        the whole config (the postings are rebuilt from the rows at load)."""
        if not self._finalized:
            raise RuntimeError("call finalize() first")
        os.makedirs(path, exist_ok=True)
        arrs = {"count_tensor": self.count_tensor}
        docs, toks = self._stored_rows()  # global rows, whatever the layout
        w = docs.cpu()
        if w.dtype == torch.bfloat16:  # lossless: the raw bit pattern
            arrs["weights_bf16"] = w.view(torch.int16).numpy().view(np.uint16)
        else:
            arrs["weights"] = w.numpy()
        if toks is not None:
            arrs["tokens"] = toks.cpu().numpy()
        np.savez_compressed(os.path.join(path, "index.npz"), **arrs)
        meta = {
            "format": 2,
            "vocab_size": self.vocab_size,
            "n_docs": self.n_docs,
            "engine": self._engine,
            "l_max": self.cfg.l_max,
            "block_docs": self.cfg.block_docs,
            "postings_cap": self.cfg.postings_cap,
            "query_terms": self.cfg.query_terms,
            "full_query_terms": self.cfg.full_query_terms,
            "full_postings_cols": self.cfg.full_postings_cols,
            "full_rescore_expand": self.cfg.full_rescore_expand,
            "exact_escalate": self._exact_escalate,
            "cfg": asdict(self.cfg),
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(path, "doc_ids.json"), "w") as f:
            json.dump(self.doc_ids, f)

    @classmethod
    def merge_saved(cls, paths: Sequence[str], mesh=None, cfg: Optional[IndexConfig] = None,
                    device: DeviceLike = None) -> "SparseIndex":
        """Concatenate per-rank shard indexes (multi-process ingest, where each
        rank saved its corpus stripe) into one index, finalized on `device`.
        Doc ids are the global string ids, so concatenation is the merge:
        the analog of every rank bulk-writing into one OpenSearch index
        (ingest.py:88-106). Without `cfg` the shards' build config is kept;
        an "auto" engine picks again by the merged size, and exact
        escalation stays on if any shard had it."""
        metas = []
        for p in paths:
            with open(os.path.join(p, "meta.json")) as f:
                metas.append(json.load(f))
        v = metas[0]["vocab_size"]
        if any(m["vocab_size"] != v for m in metas):
            raise ValueError("merge_saved: the shards' vocab sizes differ")
        if cfg is None:
            cfg = cls._cfg_from_meta(metas[0])
            escalate = any(cls._cfg_from_meta(m).exact_escalate for m in metas)
            if metas[0].get("cfg", {}).get("engine") == "auto":
                # a shard resolved "auto" by its own size; the merge resolves
                # it again by the whole corpus's (escalation with it)
                cfg.engine = "auto"
                cfg.exact_escalate = True if escalate else metas[0]["cfg"].get("exact_escalate")
            else:
                cfg.exact_escalate = escalate
        idx = cls(v, cfg, mesh, device)
        L = cfg.l_max
        for p in paths:
            blob = np.load(os.path.join(p, "index.npz"))
            if "tokens" not in blob:
                raise ValueError(f"merge_saved needs sparse-format shards: {p} is dense")
            with open(os.path.join(p, "doc_ids.json")) as f:
                ids = json.load(f)
            n = len(ids)
            idx.doc_ids.extend(ids)
            idx.count_tensor = idx.count_tensor + blob["count_tensor"]
            toks = blob["tokens"][:n].astype(np.int32)
            ws = _load_weights(blob)[:n]
            if toks.shape[1] != L:  # re-cap shards built with another l_max
                if toks.shape[1] > L:
                    toks, ws = toks[:, :L], ws[:, :L]
                else:
                    pad = L - toks.shape[1]
                    toks = np.pad(toks, ((0, 0), (0, pad)))
                    ws = np.pad(ws, ((0, 0), (0, pad)))
            idx._tok_chunks.append(toks)
            idx._w_chunks.append(ws)
        idx.finalize()
        return idx

    @staticmethod
    def _cfg_from_meta(meta: dict) -> IndexConfig:
        """The build-time IndexConfig from saved metadata: the full
        dataclass under "cfg" (unknown keys dropped, the resolved engine
        wins over "auto", the resolved exact_escalate over None), else the
        legacy flat keys."""
        if "cfg" in meta:
            known = {f.name for f in fields(IndexConfig)}
            kw = {k: v for k, v in meta["cfg"].items() if k in known}
            kw["engine"] = meta["engine"]
            if "exact_escalate" in meta:
                kw["exact_escalate"] = meta["exact_escalate"]
            return IndexConfig(**kw)
        return IndexConfig(
            engine=meta["engine"], l_max=meta["l_max"],
            block_docs=meta["block_docs"],
            postings_cap=meta.get("postings_cap", 2048),
            query_terms=meta.get("query_terms", 16),
            full_query_terms=meta.get("full_query_terms", 64),
            full_postings_cols=meta.get("full_postings_cols", 256),
            full_rescore_expand=meta.get("full_rescore_expand", 16),
            exact_escalate=meta.get("exact_escalate", False),
        )

    @classmethod
    def load(cls, path: str, mesh=None, device: DeviceLike = None) -> "SparseIndex":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        blob = np.load(os.path.join(path, "index.npz"))
        idx = cls(meta["vocab_size"], cls._cfg_from_meta(meta), mesh, device)
        with open(os.path.join(path, "doc_ids.json")) as f:
            idx.doc_ids = json.load(f)
        idx.count_tensor = blob["count_tensor"]
        n = len(idx.doc_ids)
        w = _load_weights(blob)[:n]
        if "tokens" in blob:
            idx._tok_chunks = [blob["tokens"][:n].astype(np.int32)]
            idx._w_chunks = [w]
        else:
            idx._dense_chunks = [w]
        idx.finalize()
        return idx
