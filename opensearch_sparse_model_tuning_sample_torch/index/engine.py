"""On-device exact sparse retrieval engine (the port of the JAX package's
`index/engine.py`, exact engines only).

  * **sparse engine**: a doc-major forward index — per doc, up to L_max
    (token_id, weight) pairs, impact-sorted. Scoring walks doc blocks,
    gathers the query columns for each block's token ids, contracts them
    with the block's weights, and keeps a running top-k. Memory ∝ nnz;
    exact for any weight distribution.
  * **dense engine**: exact Q @ Dᵀ over the dense [N, V] matrix — the
    correctness oracle for small corpora.

Both are plain torch ops (the JAX package wrote them as `lax` loops, not
Pallas kernels). The serving surface is here too: `search_tokens` (the
`neural_sparse` token->weight query), two-phase search on the scan, `reopen`
for the add -> refresh -> add loop, and the async handle API the server
calls (on the exact engines it resolves synchronously). Not ported yet, each
raising NotImplementedError that names its ROADMAP item: the inverted engine
(and "auto" above `auto_threshold`, which resolves to it, with its token
fast path and packed fetches) and a device mesh. Saved indexes use the JAX
package's format 2, so an index saved by either package loads in the other.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
from dataclasses import asdict, dataclass, fields
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device, resolve_dtype

logger = logging.getLogger(__name__)

_TODO_INVERTED = "the inverted engine is not ported yet (ROADMAP: port queue, inverted engine)"


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


@dataclass
class IndexConfig:
    """The JAX package's IndexConfig, field for field, so saved metas and
    shared configs parse. The port runs "sparse", "dense", and "auto" up to
    `auto_threshold` docs; the inverted-engine knobs are carried, unused."""

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

        idx = SparseIndex(vocab_size, cfg, device=...)
        idx.add_topk(ids, token_idx, weights)   # per encoded batch
        idx.finalize()
        hits = idx.search(q_reps, k=10)         # [{doc_id: score}, ...]
    """

    def __init__(self, vocab_size: int, cfg: Optional[IndexConfig] = None,
                 mesh=None, device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet (ROADMAP: port queue, distribution)"
            )
        self.vocab_size = vocab_size
        self.cfg = cfg or IndexConfig()
        if self.cfg.engine == "inverted":
            raise NotImplementedError(_TODO_INVERTED)
        self.device = resolve_device(device)
        self.doc_ids: List[str] = []
        self._tok_chunks: List[np.ndarray] = []
        self._w_chunks: List[np.ndarray] = []
        self._dense_chunks: List[np.ndarray] = []
        self.count_tensor = np.zeros((vocab_size,), dtype=np.int64)
        self._finalized = False
        self._exact_escalate = bool(self.cfg.exact_escalate)
        self._ids_arr: Optional[np.ndarray] = None
        self._docs_dev: Optional[torch.Tensor] = None
        self._tok_dev: Optional[torch.Tensor] = None
        # per-query exactness flags of the last search, as the JAX package
        # keeps them. Only its inverted engine sets them; the scan and dense
        # engines leave them None (exact by construction, except two-phase,
        # which is approximate with no certificate), so a server built on
        # them puts no exactness `ext` in its responses.
        self.last_certified: Optional[np.ndarray] = None
        self.last_escalated: Optional[np.ndarray] = None
        self.last_scan_escalated: Optional[np.ndarray] = None

    # ------------------------------------------------------------- ingest
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

    def add_topk(self, doc_ids: Sequence[str], token_idx: np.ndarray, weights: np.ndarray):
        """Add pre-sparsified rows (BatchEncoder.encode_batch_sparse):
        token_idx/weights [B, k] already impact-sorted, zero-padded."""
        if self._finalized:
            raise RuntimeError("index already finalized")
        if self.cfg.engine not in ("sparse", "auto"):
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

    @property
    def n_docs(self) -> int:
        return len(self.doc_ids)

    # ----------------------------------------------------------- finalize
    def finalize(self):
        if self._finalized:
            return
        self._engine = self.cfg.engine
        if self._engine == "auto":
            if self.n_docs >= self.cfg.auto_threshold:
                raise NotImplementedError(
                    f"engine='auto' resolves to the inverted engine at {self.n_docs} "
                    f">= auto_threshold={self.cfg.auto_threshold} docs; {_TODO_INVERTED}"
                )
            self._engine = "sparse"
        self._exact_escalate = (
            False if self.cfg.exact_escalate is None else bool(self.cfg.exact_escalate)
        )
        blk = self.cfg.block_docs
        n = self.n_docs
        n_pad = _round_up(max(n, 1), blk)
        wdt = resolve_dtype(self.cfg.weight_dtype)
        if self._engine == "dense":
            D = (np.concatenate(self._dense_chunks, axis=0) if self._dense_chunks
                 else np.zeros((0, self.vocab_size), np.float32))
            D = np.concatenate([D, np.zeros((n_pad - n, self.vocab_size), np.float32)])
            self._docs_dev = torch.from_numpy(D).to(self.device, wdt)
            self._tok_dev = None
        else:
            L = self.cfg.l_max
            toks = (np.concatenate(self._tok_chunks, axis=0) if self._tok_chunks
                    else np.zeros((0, L), np.int32))
            ws = (np.concatenate(self._w_chunks, axis=0) if self._w_chunks
                  else np.zeros((0, L), np.float32))
            toks = np.concatenate([toks, np.zeros((n_pad - n, L), np.int32)])
            ws = np.concatenate([ws, np.zeros((n_pad - n, L), np.float32)])
            # token ids < 32768 fit int16 — halves the dominant index array
            tok_dtype = np.int16 if self.vocab_size < 2**15 else np.int32
            self._tok_dev = torch.from_numpy(toks.astype(tok_dtype)).to(self.device)
            self._docs_dev = torch.from_numpy(ws).to(self.device, wdt)
        self._n_pad = n_pad
        self._tok_chunks, self._w_chunks, self._dense_chunks = [], [], []
        self._finalized = True
        logger.info("index finalized: %d docs (padded %d) engine=%s device=%s",
                    n, n_pad, self._engine, self.device)

    def reopen(self):
        """Back to ingest mode after finalize(): recover the host-side rows of
        the first n_docs docs from the device tensors (int16 ids to int32,
        weights through their stored dtype to fp32, the precision search
        uses), drop the device state, and let add()/add_topk() append. This
        is the serving surface's _bulk -> _refresh -> search -> _bulk loop.
        doc_ids stays append-only."""
        if not self._finalized:
            return
        n = self.n_docs
        if n:
            w = self._docs_dev[:n].float().cpu().numpy()
            if self._tok_dev is not None:
                self._tok_chunks = [self._tok_dev[:n].cpu().numpy().astype(np.int32)]
                self._w_chunks = [w]
            else:  # dense engine: the padded [n_pad, V] matrix
                self._dense_chunks = [w]
        self._docs_dev = None
        self._tok_dev = None
        self._finalized = False

    def delete(self):
        """Release all index state (the analog of OpenSearch
        `indices.delete`). The object returns to the empty-ingest state."""
        self._docs_dev = None
        self._tok_dev = None
        self._finalized = False
        self.doc_ids = []
        self._tok_chunks, self._w_chunks, self._dense_chunks = [], [], []
        self.count_tensor = np.zeros((self.vocab_size,), dtype=np.int64)

    # ------------------------------------------------------------- search
    def _topk_batch(self, q: torch.Tensor, k: int, two_phase: Optional[str] = None):
        """Top-k of one query batch q [Bq, V] fp32 over every doc block,
        merged into a running top-k (engine.py make_scan_topk: the sparse
        scan and the dense oracle). Returns (scores, doc idx).

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
        docs, toks = self._docs_dev, self._tok_dev
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
            gidx = torch.arange(b0, b0 + s.shape[1], device=q.device).expand(Bq, -1)
            best_s, best_i = _select(torch.cat([best_s, s], dim=1),
                                     torch.cat([best_i, gidx], dim=1), k1)
        if not two_phase:
            return best_s, best_i
        # phase 2: the pool rescored exactly; empty slots (id -1) score -inf
        cand = best_i.clamp(0, docs.shape[0] - 1)
        g = torch.gather(q, 1, toks[cand].to(torch.int64).view(Bq, -1)).view(Bq, k1, -1)
        s2 = (g * docs[cand].float()).sum(dim=-1)
        return _select(torch.where(best_i >= 0, s2, float("-inf")), best_i, k)

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
        (reference use_two_phase, search.py:27-42) in `cfg.two_phase_mode`
        (see _topk_batch); the dense engine ignores it.
        `full_forward` only routes queries on the inverted engine; the exact
        engines score every query term whatever its width."""
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
        Bq = self.cfg.query_batch
        mode = self.cfg.two_phase_mode if two_phase else None
        parts = [self._topk_batch(q[i:i + Bq], k_eff, mode) for i in range(0, q.shape[0], Bq)]
        s_np = torch.cat([p[0] for p in parts]).cpu().numpy()
        i_np = torch.cat([p[1] for p in parts]).cpu().numpy()
        return self._collect_results(s_np, i_np, q.shape[0], k, exclude_self)

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
        maps (sparse_encoders.py:184-194). The dense [B, V] query is built on
        the device (`_token_query`), so only the (B, q_len) pairs cross from
        the host. `kw` as search()."""
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
        """[B, V] fp32 query on the device from (token, weight) slots with
        one accumulating scatter, so duplicate ids in a row sum. Ids index as
        the JAX package's `.at[].add(mode="drop")` does: a negative id counts
        from the end (-1 is V - 1), and an id still outside [0, V) is
        dropped, here by masking it before the scatter (an out-of-range index
        would raise on the CPU and trip a device-side assert on the card).
        Weights <= 0 add nothing."""
        V = self.vocab_size
        tok = torch.from_numpy(q_tokens).to(self.device, torch.int64)
        w = torch.from_numpy(q_weights).to(self.device)
        tok = torch.where(tok < 0, tok + V, tok)
        keep = (tok >= 0) & (tok < V) & (w > 0)
        q = torch.zeros(tok.shape[0], V, device=self.device)
        return q.scatter_add_(1, torch.where(keep, tok, 0), torch.where(keep, w, 0.0))

    def _tokens_fast_eligible(self, q_tokens: np.ndarray, q_weights: np.ndarray,
                              kw: dict) -> bool:
        """The JAX package's routing predicate for the inverted engine's
        token-entry fast path: a finalized inverted index, slot width within
        `query_terms`, no two-phase, no unknown kwargs, and no duplicate
        active token id in a row. The exact engines never qualify."""
        if not (
            self._finalized
            and self._engine == "inverted"
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

    def _search_tokens_dispatch(self, q_tok, q_w, k, query_prune, exclude_self) -> dict:
        raise NotImplementedError(f"the token fast path: {_TODO_INVERTED}")

    def search_tokens_async(self, q_tokens: np.ndarray, q_weights: np.ndarray,
                            k: int = 10, **kw) -> dict:
        """search_tokens as a handle for resolve_hits(). Only the inverted
        engine's fast path dispatches without waiting; everywhere else
        (every exact engine) the call degrades to a synchronous search whose
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

    def resolve_hits(self, handle: dict) -> List[Dict[str, float]]:
        """The results of a search_tokens_async handle; sets the last_* flags
        as the synchronous call did."""
        if "sync_results" not in handle:
            raise NotImplementedError(f"packed fetches: {_TODO_INVERTED}")
        (self.last_certified, self.last_escalated,
         self.last_scan_escalated) = handle["flags"]
        return handle["sync_results"]

    def resolve_hits_many(self, handles: Sequence[dict]) -> List[List[Dict[str, float]]]:
        """resolve_hits over a window of handles, in order. The last_* flags
        become the row-wise concatenation of the handles' flags (None if any
        handle lacks them)."""
        out = [self.resolve_hits(h) for h in handles]

        def _cat(col):
            vals = [h["flags"][col] for h in handles]
            if not vals or any(v is None for v in vals):
                return None
            return np.concatenate(vals)

        self.last_certified, self.last_escalated, self.last_scan_escalated = (
            _cat(0), _cat(1), _cat(2))
        return out

    # -------------------------------------------------------- persistence
    def save(self, path: str):
        if not self._finalized:
            raise RuntimeError("call finalize() first")
        os.makedirs(path, exist_ok=True)
        arrs = {"count_tensor": self.count_tensor}
        w = self._docs_dev.cpu()
        if w.dtype == torch.bfloat16:  # lossless: the raw bit pattern
            arrs["weights_bf16"] = w.view(torch.int16).numpy().view(np.uint16)
        else:
            arrs["weights"] = w.numpy()
        if self._tok_dev is not None:
            arrs["tokens"] = self._tok_dev.cpu().numpy()
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

    @staticmethod
    def _cfg_from_meta(meta: dict) -> IndexConfig:
        """The build-time IndexConfig from saved metadata: the full
        dataclass under "cfg" (unknown keys dropped, the resolved engine
        wins over "auto"), else the legacy flat keys."""
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
