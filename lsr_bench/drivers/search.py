"""Search traffic: one closed-loop caller of the port's
`SparseIndex.search_tokens`, inference-free queries of `n_terms` idf-weighted
tokens in `slots` slots, `queries_per_call` a call, top `k`.

Set-up makes the configuration's corpus on the card (bench.py's
distribution, `gen/corpus.py`, from the deployment's own `corpus_seed`: one
index for every run, as a deployment serves one), builds the index the
configuration states, makes the traffic's query pool and puts it in an
order drawn from the run's seed (every run does the same work, in its own
order), and warms up with calls from another pool. A unit is one call (the
range `lsr.search`), timed from its submission to its resolved hits; every
query of the call waited that long. Of each call the window keeps the
answer of one query, drawn from the seed before the window.

The output check draws `sample_queries` of the kept answers from the seed
and holds each query's hits (ids and scores) to an exact dense-blockwise
scoring of the whole corpus, with the doc weights rounded to the stored
precision the configuration states.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..gen import corpus as gen
from .common import Base, free


class Driver(Base):
    def setup(self):
        from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex

        c, t = self.cell.config, self.t
        self.V = int(c["vocab_size"])
        dep = c["deployment"]
        self.n_docs = n = int(c["corpus_docs"])
        toks, ws = gen.make_corpus(n, self.V, dep["avg_terms"], dep["corpus_seed"], dep["l_max"],
                                   self.dev)
        toks, ws = toks.cpu().numpy(), ws.cpu().numpy()
        free(self.dev)
        self.index = SparseIndex(self.V, IndexConfig(**dep["index"]), device=self.dev)
        self.index.add_topk([str(i) for i in range(n)], toks, ws)
        del toks, ws
        self.index.finalize()
        if self.fault is not None:
            _plant(self.fault, self.index)
        self.queries()
        self.pick_rows()
        q = self.q
        wt, ww = gen.make_queries(int(t["warmup_calls"]) * q, self.V, int(t["n_terms"]),
                                  int(t["query_seed"]) + 1, int(t["slots"]))
        for s in range(0, len(wt), q):
            self.index.search_tokens(wt[s:s + q], ww[s:s + q], k=int(t["k"]))
        self.answers = []

    def queries(self):
        t = self.t
        self.q = int(t["queries_per_call"])
        qt, qw = gen.make_queries(int(t["query_pool"]), self.V, int(t["n_terms"]),
                                  t["query_seed"], int(t["slots"]))
        order = np.random.default_rng(self.cell.seed & (2**63 - 1)).permutation(len(qt))
        self.qt, self.qw = qt[order], qw[order]

    def pick_rows(self):
        """The query of each call whose answer the window keeps (call j
        keeps row `pick[j % len(pick)]`)."""
        rng = np.random.default_rng((self.cell.seed + 13) & (2**63 - 1))
        self.pick = rng.integers(0, self.q, size=4096).tolist()

    def setup_for_control(self, units: int):
        """What the control needs of a run: the corpus's size and the
        queries of `units` calls, without the program."""
        self.V = int(self.cell.config["vocab_size"])
        self.n_docs = int(self.cell.config["corpus_docs"])
        self.queries()
        self.pick_rows()
        self.answers = [((j * self.q) % len(self.qt) + self.pick[j % len(self.pick)], {})
                        for j in range(units)]

    def unit(self) -> dict:
        j = len(self.answers)
        s = (j * self.q) % len(self.qt)
        t0 = time.perf_counter()
        with self.ranges("search"):
            res = self.index.search_tokens(self.qt[s:s + self.q], self.qw[s:s + self.q],
                                           k=int(self.t["k"]))
        lat = time.perf_counter() - t0
        esc = self.index.last_escalated
        r = self.pick[j % len(self.pick)]
        self.answers.append((s + r, res[r]))
        return {"calls": 1, "queries": self.q, "latency_s": lat,
                "escalated": 0 if esc is None else int(np.asarray(esc).sum())}

    def end_to_end(self, w) -> dict:
        lat = np.repeat([u["latency_s"] for u in w.units], [u["queries"] for u in w.units])
        return {"search_qps": w.total("queries") / w.seconds,
                "search_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    def attempted(self, w) -> int:
        return int(w.total("queries"))

    # ------------------------------------------------------------ check
    def sampled(self):
        """(query rows, hit ids [S, k] (-1 where none), hit scores [S, k])
        of the drawn queries of the window."""
        k = int(self.t["k"])
        flat = self.answers
        rng = np.random.default_rng(self.cell.seed + 11)
        pick = rng.choice(len(flat), size=min(int(self.t["sample_queries"]), len(flat)),
                          replace=False)
        rows = np.array([flat[i][0] for i in pick])
        ids = np.full((len(pick), k), -1, np.int64)
        scores = np.zeros((len(pick), k), np.float64)
        for a, i in enumerate(pick):
            hits = list(flat[i][1].items())[:k]
            ids[a, :len(hits)] = [int(d) for d, _ in hits]
            scores[a, :len(hits)] = [v for _, v in hits]
        return rows, ids, scores

    def release(self):
        self.index = self.answers = None
        free(self.dev)

    def corpus(self, precision: str):
        """The corpus again, the weights rounded as stored
        (bfloat16), or to float8 e4m3 (one scale) for the control."""
        dep = self.cell.config["deployment"]
        toks, ws = gen.make_corpus(self.n_docs, self.V, dep["avg_terms"], dep["corpus_seed"],
                                   dep["l_max"], self.dev)
        if precision == "fp8":
            scale = ws.abs().amax() / 448.0
            ws = (ws / scale).to(torch.float8_e4m3fn).float() * scale
        else:
            ws = ws.to(getattr(torch, dep["index"]["weight_dtype"])).float()
        return toks.long(), ws.double()

    def exact(self, toks, ws, rows, block: int = 8192):
        """Top-k scores [S, k] (descending) and ids of the drawn queries over
        the whole corpus, in float64, block by block of dense doc rows."""
        k = int(self.t["k"])
        Q = torch.zeros((len(rows), self.V), dtype=torch.float64, device=self.dev)
        Q.scatter_add_(1, torch.from_numpy(self.qt[rows]).long().to(self.dev),
                       torch.from_numpy(self.qw[rows]).double().to(self.dev))
        best_s = torch.full((len(rows), k), -1.0, dtype=torch.float64, device=self.dev)
        best_i = torch.full((len(rows), k), -1, dtype=torch.int64, device=self.dev)
        D = torch.zeros((block, self.V), dtype=torch.float64, device=self.dev)
        for b in range(0, self.n_docs, block):
            n = min(block, self.n_docs - b)
            D.zero_()
            D[:n].scatter_add_(1, toks[b:b + n], ws[b:b + n])
            sc = Q @ D[:n].t()  # [S, n]
            s, i = torch.topk(sc, min(k, n), dim=1)
            cat_s, cat_i = torch.cat([best_s, s], 1), torch.cat([best_i, i + b], 1)
            top = torch.topk(cat_s, k, dim=1).indices
            best_s, best_i = torch.gather(cat_s, 1, top), torch.gather(cat_i, 1, top)
        return Q, best_s, best_i

    @staticmethod
    def doc_scores(Q, toks, ws, ids):
        """Each returned id's exact score (0 where there is no hit)."""
        safe = ids.clamp_min(0)
        t, w = toks[safe], ws[safe]  # [S, k, l_max]
        s = (torch.gather(Q, 1, t.flatten(1)).view_as(w) * w).sum(-1)
        return torch.where(ids >= 0, s, 0.0)

    def compare(self, ids, scores, Q, toks, ws, ref_s) -> dict:
        """score_gap: over the drawn queries and ranks, the widest of
        |returned score - the exact k-th best at that rank| and |returned
        score - that doc's exact score|, over the query's best exact score."""
        ids_t = torch.from_numpy(ids).to(self.dev)
        sc = torch.from_numpy(scores).to(self.dev)
        own = self.doc_scores(Q, toks, ws, ids_t)
        gap = torch.maximum((sc - ref_s).abs(), (sc - own).abs()).amax(1)
        return {"score_gap": float((gap / ref_s[:, 0].clamp_min(1e-30)).max())}

    def readings(self) -> dict:
        rows, ids, scores = self.sampled()
        self.release()
        toks, ws = self.corpus("stored")
        Q, ref_s, _ = self.exact(toks, ws, rows)
        return self.compare(ids, scores, Q, toks, ws, ref_s)

    def control(self) -> dict:
        """The search recomputed with float8 doc weights in the program's
        place, against the exact reference."""
        rows, _, _ = self.sampled()
        self.release()
        toks, w8 = self.corpus("fp8")
        _, s8, i8 = self.exact(toks, w8, rows)
        toks, ws = self.corpus("stored")
        Q, ref_s, _ = self.exact(toks, ws, rows)
        return self.compare(i8.cpu().numpy(), s8.cpu().numpy(), Q, toks, ws, ref_s)


def _plant(fault, index):
    """Faults planted in the program for the output check's own tests."""
    if fault != "answer":
        raise ValueError(f"unknown fault {fault!r}")
    inner = index.search_tokens

    def altered(*a, **k):  # each query's best hit's score altered where it is returned
        res = inner(*a, **k)
        return [{d: (v * 1.01 if j == 0 else v) for j, (d, v) in enumerate(r.items())}
                for r in res]

    index.search_tokens = altered
