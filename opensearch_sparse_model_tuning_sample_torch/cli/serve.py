"""HTTP serving endpoint for saved indexes, the port of the JAX package's
`cli/serve.py`: the live-query surface the reference delegates to its
OpenSearch node (README.md:10-15; queries go to `POST /{index}/_search` with
a `neural_sparse` body, utils.py:104-136).

A client written against the reference's OpenSearch usage can point here
instead: the search endpoint accepts the same `neural_sparse` query DSL
(token->weight map, or raw text encoded server-side inference-free/full) and
answers with an OpenSearch-shaped hits envelope.

    python -m opensearch_sparse_model_tuning_sample_torch.cli.serve \
        --index synth=out/idx_dir [--model ckpt] [--port 9201] [--arch mini] \
        [--device cpu]

It runs on the CUDA card unless `--device cpu`, and raises without a card.

Endpoints:
    GET  /                      cluster-info stub
    GET  /_health               {"status": "green"}
    GET  /_stats                the micro-batcher's counters
    PUT  /{index}               create index (settings.index may carry
                                l_max/engine/block_docs/postings_cap/
                                query_batch overrides; the reference's
                                shards/replicas are accepted and ignored)
    DELETE /{index}             delete index
    POST /_bulk                 NDJSON: {"index": {"_index", "_id"}} action
                                lines + doc lines {"text_sparse": {tok: w}}
                                or {"text": "..."} (encoded server-side) —
                                the reference's ingest wire format
                                (ingest.py:88-106)
    POST /{index}/_refresh      make buffered docs searchable (finalize)
    PUT  /_search/pipeline/{p}  ack the two-phase pipeline install
                                (reference search.py:27-42); searches sent
                                with ?search_pipeline={p} run two-phase
    POST /{index}/_search       {"query": {"neural_sparse": {"text_sparse":
                                  {"query_tokens": {tok: w}} |
                                  {"query_text": "...", "inf_free": bool}}},
                                 "size": k, "query_prune": p,
                                 "two_phase": bool}
    POST /_encode               {"texts": [...], "inf_free": bool}

Implementation notes: stdlib-only HTTP (ThreadingHTTPServer). Concurrent
searches are micro-batched: requests queue to a dispatch thread that drains
everything waiting (plus an optional coalescing window, --batch-window-ms)
and rides compatible queries through one engine call, and a resolve thread
completes them. Writes (_bulk / create / refresh) take the process-wide state
lock, which the dispatch and resolve stages hold while they touch an index or
the encoder. `torch.inference_mode` is per thread, so each thread's entry
here enters it. The encoder's forward (dispatch thread) and the search
(resolve thread) run on the card's default stream, so they stay in order
without a synchronization.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List

import numpy as np
import torch

from ..utils.shapes import next_pow2

logger = logging.getLogger(__name__)


class _SearchRequest:
    __slots__ = ("index_name", "kind", "payload", "k", "prune", "two_phase",
                 "event", "result", "error", "certified", "escalated")

    def __init__(self, index_name, kind, payload, k, prune, two_phase):
        self.index_name = index_name
        self.kind = kind          # "tokens" -> [(id, w), ...] | "text" -> (text, inf_free)
        self.payload = payload
        self.k = k
        self.prune = prune
        self.two_phase = two_phase
        self.event = threading.Event()
        self.result = None        # {doc_id: score}
        self.error = None
        # exactness-certificate flags for THIS query (None when the engine
        # doesn't produce them: the scan and dense engines never do)
        self.certified = None
        self.escalated = False

    def group_key(self):
        extra = self.payload[1] if self.kind == "text" else None  # inf_free
        return (self.index_name, self.kind, self.k, self.prune,
                self.two_phase, extra)


class MicroBatcher:
    """Coalesce concurrent search requests into batched engine calls, and
    pipeline those calls against the device.

    Two stages, bounded by `pipeline_depth` engine calls in flight:

      * the DISPATCH thread drains the queue: whatever is waiting when it
        loops (bounded by max_batch) forms the next batch, so batching
        emerges under load without adding latency when idle; window_ms > 0
        additionally holds the first request open to let near-simultaneous
        arrivals join. Token-kind groups go through the index's async token
        path where it has one (the inverted engine's); text-kind groups
        launch their encoder forward here.
      * the RESOLVE thread completes the calls in FIFO order, and resolves a
        backlog of async token handles on one index through one
        `resolve_hits_many`.

    Exactness flags (`index.last_*`) are only ever written by resolve/sync
    search calls, all of which run on the resolve thread, so reading them
    right after each resolve is race-free.
    """

    def __init__(self, state: "ServingState", window_ms: float = 0.0,
                 max_batch: int = 128, pipeline_depth: int = 4):
        self.state = state
        self.window_s = max(window_ms, 0.0) / 1e3
        self.max_batch = max(max_batch, 1)
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._inflight: queue.Queue = queue.Queue(maxsize=max(int(pipeline_depth), 1))
        self.stats = {"requests": 0, "engine_calls": 0, "batches": 0,
                      "max_batch_seen": 0}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-microbatch")
        self._thread.start()
        self._resolver = threading.Thread(target=self._resolve_loop, daemon=True,
                                          name="serve-resolve")
        self._resolver.start()

    def submit(self, req: _SearchRequest) -> Dict[str, float]:
        with self._cv:
            self._q.append(req)
            self.stats["requests"] += 1
            self._cv.notify()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    @torch.inference_mode()
    def _run(self):
        while True:
            with self._cv:
                while not self._q:
                    self._cv.wait()
                if self.window_s > 0:
                    deadline = time.monotonic() + self.window_s
                    while len(self._q) < self.max_batch:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._cv.wait(left)
                batch = [self._q.popleft() for _ in range(min(len(self._q), self.max_batch))]
            self.stats["batches"] += 1
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], len(batch))
            groups: Dict[tuple, List[_SearchRequest]] = {}
            for r in batch:
                groups.setdefault(r.group_key(), []).append(r)
            for reqs in groups.values():
                try:
                    self.stats["engine_calls"] += 1
                    produce = self._dispatch(reqs)
                except Exception as e:  # noqa: BLE001 — serving surface
                    logger.exception("search dispatch failed")
                    for r in reqs:
                        r.error = e
                        r.event.set()
                    continue
                # bounded: back-pressures the drain (and thus the HTTP
                # clients) when the device falls behind
                self._inflight.put((reqs, produce))

    @torch.inference_mode()
    def _resolve_loop(self):
        while True:
            items = [self._inflight.get()]
            # drain the whole backlog, so every pending token handle on one
            # index resolves through one resolve_hits_many
            while True:
                try:
                    items.append(self._inflight.get_nowait())
                except queue.Empty:
                    break
            by_index: Dict[int, list] = {}
            for it in items:
                p = it[1]
                if getattr(p, "handle", None) is not None:
                    by_index.setdefault(id(p.index), []).append(it)
            done = set()
            for grp in by_index.values():
                if len(grp) < 2:
                    continue
                index = grp[0][1].index
                try:
                    outs = index.resolve_hits_many([it[1].handle for it in grp])
                except Exception as e:  # noqa: BLE001 — serving surface
                    logger.exception("search resolve failed")
                    for reqs, p in grp:
                        done.add(id(p))
                        for r in reqs:
                            r.error = e
                            r.event.set()
                    continue
                cert, esc = index.last_certified, index.last_escalated
                off = 0
                for (reqs, p), hits in zip(grp, outs):
                    n_q = p.handle["n_q"]
                    c = cert[off:off + n_q] if cert is not None else None
                    e = esc[off:off + n_q] if esc is not None else None
                    off += n_q
                    done.add(id(p))
                    try:
                        p.finish(hits, c, e)
                    except Exception as err:  # noqa: BLE001
                        logger.exception("search resolve failed")
                        for r in reqs:
                            r.error = err
                    for r in reqs:
                        r.event.set()
            for reqs, produce in items:
                if id(produce) in done:
                    continue
                try:
                    produce()
                except Exception as e:  # noqa: BLE001 — serving surface
                    logger.exception("search failed")
                    for r in reqs:
                        r.error = e
                for r in reqs:
                    r.event.set()

    @staticmethod
    def _assign(reqs, hits, cert, esc):
        """Attach results + per-query exactness flags (resolve thread)."""
        for b, (r, h) in enumerate(zip(reqs, hits)):
            r.result = h
            if cert is not None:
                r.certified = bool(cert[b])
                r.escalated = bool(esc[b]) if esc is not None else False

    @torch.inference_mode()
    def _execute(self, reqs: List[_SearchRequest]):
        """Dispatch + resolve one group synchronously on the caller's thread
        (for tests and direct callers)."""
        self._dispatch(reqs)()

    def _dispatch(self, reqs: List[_SearchRequest]):
        """Dispatch one compatible group; returns the produce() closure the
        resolve thread runs to complete it."""
        state = self.state
        r0 = reqs[0]
        # pad the batch to a power-of-two bucket, so the encoder forward (and
        # its head kernel) sees a few batch shapes, not one per concurrency
        # level. Zero-padded queries score nothing and are sliced off.
        B = len(reqs)
        Bp = next_pow2(B)
        with state.lock:
            index = state.indexes[r0.index_name]
            if not index._finalized:
                # near-real-time semantics: search refreshes. Inside the
                # lock: finalize concatenates + clears the ingest buffers
                # and must not race a concurrent _bulk's reopen()/add_topk()
                index.finalize()
            if r0.kind == "tokens":
                # the slot width buckets to powers of two as well
                L = next_pow2(max(max(len(r.payload) for r in reqs), 1))
                q_tok = np.zeros((Bp, L), np.int32)
                q_w = np.zeros((Bp, L), np.float32)
                for b, r in enumerate(reqs):
                    for j, (i, w) in enumerate(r.payload):
                        q_tok[b, j], q_w[b, j] = i, w
                kw = dict(query_prune=r0.prune, two_phase=r0.two_phase)
                if index._tokens_fast_eligible(q_tok, q_w, kw):
                    # async: the device work starts now; the resolve thread
                    # waits for it while the drain moves on
                    handle = index._search_tokens_dispatch(q_tok, q_w, r0.k, r0.prune, None)

                    def produce(index=index, handle=handle):
                        hits = index.resolve_hits(handle)
                        self._assign(reqs, hits[:B], index.last_certified,
                                     index.last_escalated)

                    def finish(hits, cert, esc, reqs=reqs, B=B):
                        self._assign(reqs, hits[:B], cert, esc)

                    # batched-resolve hooks (see _resolve_loop)
                    produce.handle = handle
                    produce.index = index
                    produce.finish = finish
                    return produce

                def produce(index=index, q_tok=q_tok, q_w=q_w, kw=kw):
                    with state.lock:
                        hits = index.search_tokens(q_tok, q_w, k=r0.k, **kw)
                        self._assign(reqs, hits[:B], index.last_certified,
                                     index.last_escalated)

                return produce

            texts = [r.payload[0] for r in reqs] + [""] * (Bp - B)
            inf_free = r0.payload[1]
            # the encoder forward is queued on the card here and overlaps
            # earlier groups' resolution
            reps = state.encoder.encode_batch_device(texts, inf_free=inf_free)
            if not inf_free and Bp > B:
                # "" pads encode to nonzero full-forward reps (CLS/SEP still
                # produce MLM logits): hand the engine only the real rows.
                # (Inference-free "" rows tokenize to nothing and are zero.)
                reps = reps[:B]

        def produce(index=index, reps=reps, inf_free=inf_free):
            # full_forward: True for full-forward queries; None for inf-free
            with state.lock:
                hits = index.search(
                    reps, k=r0.k, query_prune=r0.prune, two_phase=r0.two_phase,
                    full_forward=True if not inf_free else None,
                )
                self._assign(reqs, hits[:B], index.last_certified, index.last_escalated)

        return produce


class ServingState:
    """Model + named indexes + the device lock."""

    def __init__(self, model, indexes: Dict[str, object], max_length: int = 512,
                 index_cfg=None, batch_window_ms: float = 0.0,
                 max_batch: int = 128, pipeline_depth: int = 4):
        from ..index.engine import IndexConfig
        from ..models.sparse_encoder import BatchEncoder

        self.model = model
        self.indexes = indexes
        self.encoder = BatchEncoder(model, max_length=max_length, do_count=False)
        self.lock = threading.Lock()
        self.index_cfg = index_cfg or IndexConfig()
        self.pipelines: Dict[str, dict] = {}
        self.batcher = MicroBatcher(self, window_ms=batch_window_ms, max_batch=max_batch,
                                    pipeline_depth=pipeline_depth)

    @torch.inference_mode()
    def encode(self, texts, inf_free: bool = True):
        with self.lock:
            return self.encoder.encode(texts, inf_free=inf_free)

    # ------------------------------------------------------- write path
    def create_index(self, name: str, body: dict):
        """PUT /{index}: reference ingest.py:66-82 creates a rank_features
        index; settings.index here may override l_max/engine/block_docs. The
        index lives on the model's device."""
        import dataclasses

        from ..index.engine import SparseIndex

        settings = (body or {}).get("settings", {}).get("index", {})
        overrides = {k: settings[k]
                     for k in ("l_max", "engine", "block_docs", "postings_cap", "query_batch")
                     if k in settings}
        cfg = dataclasses.replace(self.index_cfg, **overrides)
        with self.lock:
            if name in self.indexes:
                raise KeyError(f"index {name} already exists")
            self.indexes[name] = SparseIndex(self.model.vocab_size, cfg,
                                             device=self.model.device)

    def delete_index(self, name: str) -> bool:
        with self.lock:
            return self.indexes.pop(name, None) is not None

    @torch.inference_mode()
    def bulk(self, raw: bytes) -> dict:
        """POST /_bulk (NDJSON): action line + source line per doc, with
        `text_sparse` token->weight maps (the reference's encode-client-side
        path) or raw `text` encoded here (the encoder's forward, head kernel
        included). Docs land in the in-memory buffer; a _refresh (or the next
        search) makes them visible."""
        t0 = time.time()
        lines = [json.loads(ln) for ln in raw.splitlines() if ln.strip()]
        if len(lines) % 2:
            raise ValueError("bulk body must be action/source line pairs")
        per_index: Dict[str, list] = {}
        items = []
        for action, source in zip(lines[::2], lines[1::2]):
            op = next(iter(action))
            if op != "index":
                raise ValueError(f"unsupported bulk op {op!r}")
            idx_name = action[op]["_index"]
            doc_id = str(action[op].get("_id", ""))
            per_index.setdefault(idx_name, []).append((doc_id, source))
            items.append({"index": {"_index": idx_name, "_id": doc_id,
                                    "status": 201, "result": "created"}})
        vocab = self.model.tokenizer.vocab
        with self.lock:
            # validate the WHOLE request before mutating any index: failing
            # mid-loop would leave earlier indexes' docs ingested behind a
            # 400, and a client retry would double-ingest them (add_topk
            # appends; there is no overwrite-by-_id like OpenSearch bulk)
            missing = [n for n in per_index if n not in self.indexes]
            if missing:
                raise KeyError(f"no index {missing[0]}")
            for idx_name, docs in per_index.items():
                index = self.indexes[idx_name]
                index.reopen()
                # a batch may mix pre-encoded text_sparse docs and raw text
                # docs: split per doc, not per batch
                enc_docs = [(d, s) for d, s in docs if s.get("text_sparse") is None]
                sp_docs = [(d, s["text_sparse"]) for d, s in docs
                           if s.get("text_sparse") is not None]
                if sp_docs:
                    L = max(max((len(tw) for _, tw in sp_docs), default=1), 1)
                    toks = np.zeros((len(sp_docs), L), np.int32)
                    ws = np.zeros((len(sp_docs), L), np.float32)
                    for r, (_, tw) in enumerate(sp_docs):
                        pairs = sorted(((vocab[t], float(w)) for t, w in tw.items() if t in vocab),
                                       key=lambda p: -p[1])
                        for c, (i, w) in enumerate(pairs):
                            toks[r, c], ws[r, c] = i, w
                    index.add_topk([d for d, _ in sp_docs], toks, ws)
                if enc_docs:
                    # in batches of max_batch rows: memory bounded by one batch
                    texts = [s.get("text", "") for _, s in enc_docs]
                    handle, n = self.encoder.encode_chunk_sparse_async(
                        texts, l_max=index.cfg.l_max, rows=self.batcher.max_batch)
                    toks, ws = self.encoder.resolve_chunk_sparse(handle, n)
                    index.add_topk([d for d, _ in enc_docs], toks, ws)
        return {"took": int((time.time() - t0) * 1000), "errors": False, "items": items}

    @torch.inference_mode()
    def refresh(self, name: str):
        with self.lock:
            self.indexes[name].finalize()

    # -------------------------------------------------------- read path
    def search(self, index_name: str, body: dict, two_phase_param: bool = False) -> dict:
        k = int(body.get("size", 10))
        prune = float(body.get("query_prune", 0.0))
        two_phase = bool(body.get("two_phase", False)) or two_phase_param
        ns = body["query"]["neural_sparse"]
        field = next(iter(ns))
        spec = ns[field]
        if index_name not in self.indexes:
            raise KeyError(f"no index {index_name}")
        t0 = time.time()
        if "query_tokens" in spec:
            vocab = self.model.tokenizer.vocab
            pairs = [(vocab[t], float(w)) for t, w in spec["query_tokens"].items() if t in vocab]
            req = _SearchRequest(index_name, "tokens", pairs, k, prune, two_phase)
        else:
            payload = (spec["query_text"], bool(spec.get("inf_free", True)))
            req = _SearchRequest(index_name, "text", payload, k, prune, two_phase)
        hit = self.batcher.submit(req)
        took_ms = int((time.time() - t0) * 1000)
        ranked = sorted(hit.items(), key=lambda kv: -kv[1])
        out = {
            "took": took_ms,
            "timed_out": False,
            "hits": {
                "total": {"value": len(ranked), "relation": "eq"},
                "max_score": ranked[0][1] if ranked else None,
                "hits": [{"_index": index_name, "_id": did, "_score": score}
                         for did, score in ranked],
            },
        }
        if req.certified is not None:
            # exactness certificate (the inverted engine's): whether THIS
            # query's top-k is provably the true top-k, and whether it came
            # from escalating to the exact scan. Rides the OpenSearch
            # response extension slot so standard clients ignore it.
            out["ext"] = {"exactness": {"certified": req.certified,
                                        "escalated": req.escalated}}
        return out


def make_handler(state: ServingState):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            blob = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def log_message(self, fmt, *args):  # route to logging, not stderr
            logger.debug("%s " + fmt, self.client_address[0], *args)

        def do_GET(self):
            if self.path in ("/", ""):
                self._send(200, {
                    "name": "opensearch-sparse-model-tuning-sample-torch",
                    "version": {"distribution": "torch-cuda", "number": "2"},
                    "indexes": {n: i.n_docs for n, i in state.indexes.items()},
                })
            elif self.path == "/_health":
                self._send(200, {"status": "green"})
            elif self.path == "/_stats":
                self._send(200, {"search_microbatch": dict(state.batcher.stats)})
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def _split(self):
            from urllib.parse import parse_qs, urlparse

            u = urlparse(self.path)
            return [p for p in u.path.split("/") if p], parse_qs(u.query)

        def do_POST(self):
            try:
                parts, params = self._split()
                if parts == ["_encode"]:
                    body = self._body()
                    out = state.encode(body["texts"], inf_free=body.get("inf_free", True))
                    self._send(200, {"embeddings": out})
                elif parts == ["_bulk"]:
                    n = int(self.headers.get("Content-Length", 0))
                    self._send(200, state.bulk(self.rfile.read(n)))
                elif len(parts) == 2 and parts[1] == "_refresh":
                    if parts[0] not in state.indexes:
                        self._send(404, {"error": f"no index {parts[0]}"})
                        return
                    state.refresh(parts[0])
                    self._send(200, {"_shards": {"successful": 1, "failed": 0}})
                elif len(parts) == 2 and parts[1] == "_search":
                    if parts[0] not in state.indexes:
                        self._send(404, {"error": f"no index {parts[0]}"})
                        return
                    two_phase = False
                    if "search_pipeline" in params:
                        # OpenSearch 400s on an unknown pipeline name; a
                        # typo must not silently change search semantics
                        pname = params["search_pipeline"][0]
                        if pname not in state.pipelines:
                            self._send(400, {"error": f"no search pipeline {pname}"})
                            return
                        two_phase = True
                    self._send(200, state.search(parts[0], self._body(),
                                                 two_phase_param=two_phase))
                else:
                    self._send(404, {"error": f"no route {self.path}"})
            except Exception as e:  # noqa: BLE001 — serving surface
                logger.exception("request failed")
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def do_PUT(self):
            try:
                parts, _ = self._split()
                if len(parts) == 3 and parts[:2] == ["_search", "pipeline"]:
                    state.pipelines[parts[2]] = self._body()
                    self._send(200, {"acknowledged": True})
                elif len(parts) == 1:
                    state.create_index(parts[0], self._body())
                    self._send(200, {"acknowledged": True, "index": parts[0]})
                else:
                    self._send(404, {"error": f"no route {self.path}"})
            except KeyError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — serving surface
                logger.exception("request failed")
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def do_DELETE(self):
            parts, _ = self._split()
            if len(parts) == 1:
                if state.delete_index(parts[0]):
                    self._send(200, {"acknowledged": True})
                else:
                    self._send(404, {"error": f"no index {parts[0]}"})
            else:
                self._send(404, {"error": f"no route {self.path}"})

    return Handler


class _Server(ThreadingHTTPServer):
    # socketserver's default accept backlog is 5: a burst of clients that
    # connect in the same instant overflows it and gets connection resets
    # before a handler runs. The micro-batcher is built for such bursts, so
    # the listener's backlog matches them.
    request_queue_size = 256


def serve(state: ServingState, host: str = "127.0.0.1", port: int = 9201):
    httpd = _Server((host, port), make_handler(state))
    logger.info("serving %d index(es) on http://%s:%d", len(state.indexes), host,
                httpd.server_address[1])
    return httpd


def main(argv=None):
    from ..core.device import resolve_device
    from ..index.engine import SparseIndex
    from ..models import sparse_encoder as se

    p = argparse.ArgumentParser()
    p.add_argument("--index", action="append", required=True,
                   help="name=path of a SparseIndex.save() dir (repeatable)")
    p.add_argument("--model", default=None, help="checkpoint dir")
    p.add_argument("--arch", default="mini")
    p.add_argument("--idf", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9201)
    p.add_argument("--max-length", type=int, default=512)
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="coalescing window for concurrent searches (0 = "
                        "drain-available batching only; 0 suits a single "
                        "latency-sensitive client)")
    p.add_argument("--max-batch", type=int, default=128,
                   help="max concurrent searches per engine dispatch")
    p.add_argument("--pipeline-depth", type=int, default=4,
                   help="engine calls in flight between the dispatch and "
                        "resolve stages (1 = sequential)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    model = se.build_model(
        model_name_or_path=args.model, arch=args.arch,
        idf_path=args.idf or os.path.join(repo, "assets", "idf.npz"), device=device,
    )
    indexes = {}
    for spec in args.index:
        name, path = spec.split("=", 1)
        indexes[name] = SparseIndex.load(path, device=device)
    state = ServingState(
        model, indexes, max_length=args.max_length,
        batch_window_ms=args.batch_window_ms, max_batch=args.max_batch,
        pipeline_depth=args.pipeline_depth,
    )
    serve(state, args.host, args.port).serve_forever()


if __name__ == "__main__":
    main()
