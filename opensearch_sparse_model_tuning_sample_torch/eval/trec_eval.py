"""TREC-style retrieval metrics (pytrec_eval-compatible conventions).

Replaces the reference's `beir.retrieval.evaluation.EvaluateRetrieval`
(used at reference evaluate_beir.py:187-190) — same metric definitions
as trec_eval so numbers are comparable:

  * NDCG@k: linear-gain DCG, rel / log2(rank+1)  (trec_eval `ndcg_cut`)
  * MAP@k, Recall@k (graded rel > 0 counts as relevant), P@k

`evaluate(qrels, run, k_values)` returns the same four-dict structure BEIR's
EvaluateRetrieval.evaluate does: ({NDCG@k}, {MAP@k}, {Recall@k}, {P@k}).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

Qrels = Dict[str, Dict[str, int]]
Run = Dict[str, Dict[str, float]]


def _ranked(doc_scores: Dict[str, float]) -> List[str]:
    # trec_eval/pytrec_eval break score ties by DESCENDING doc id; ascending
    # would diverge from the reference numbers exactly when scores tie
    # (common once weights round-trip through bf16)
    docs = sorted(doc_scores, reverse=True)  # doc id desc
    docs.sort(key=doc_scores.__getitem__, reverse=True)  # stable: score desc
    return docs


def ndcg_at_k(qrels_q: Dict[str, int], ranked: List[str], k: int) -> float:
    dcg = 0.0
    for i, d in enumerate(ranked[:k]):
        rel = qrels_q.get(d, 0)
        if rel > 0:
            dcg += rel / math.log2(i + 2)
    ideal = sorted((r for r in qrels_q.values() if r > 0), reverse=True)[:k]
    idcg = sum(r / math.log2(i + 2) for i, r in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def average_precision_at_k(qrels_q: Dict[str, int], ranked: List[str], k: int) -> float:
    """trec_eval `map_cut.k`: sum of precision at each relevant rank within
    the top k, divided by the TOTAL number of relevant docs (n_rel, not
    min(n_rel, k) — dividing by the min inflates MAP@k when k < n_rel)."""
    n_rel = sum(1 for r in qrels_q.values() if r > 0)
    if n_rel == 0:
        return 0.0
    hits, ap = 0, 0.0
    for i, d in enumerate(ranked[:k]):
        if qrels_q.get(d, 0) > 0:
            hits += 1
            ap += hits / (i + 1)
    return ap / n_rel


def recall_at_k(qrels_q: Dict[str, int], ranked: List[str], k: int) -> float:
    rel_docs = {d for d, r in qrels_q.items() if r > 0}
    if not rel_docs:
        return 0.0
    got = sum(1 for d in ranked[:k] if d in rel_docs)
    return got / len(rel_docs)


def precision_at_k(qrels_q: Dict[str, int], ranked: List[str], k: int) -> float:
    got = sum(1 for d in ranked[:k] if qrels_q.get(d, 0) > 0)
    return got / k


def evaluate(
    qrels: Qrels, run: Run, k_values: Sequence[int] = (1, 10)
) -> Tuple[Dict[str, float], Dict[str, float], Dict[str, float], Dict[str, float]]:
    """BEIR EvaluateRetrieval.evaluate-compatible: averages over queries
    that appear in BOTH qrels (with a positive judgment) and the run —
    pytrec_eval scores only run-present queries and BEIR divides by that
    count, so a run covering 90 of 100 judged queries must not be dragged
    down by 10 implicit zeros here when the reference pipeline would not."""
    ndcg = {f"NDCG@{k}": 0.0 for k in k_values}
    _map = {f"MAP@{k}": 0.0 for k in k_values}
    recall = {f"Recall@{k}": 0.0 for k in k_values}
    precision = {f"P@{k}": 0.0 for k in k_values}

    qids = [q for q in qrels
            if q in run and any(r > 0 for r in qrels[q].values())]
    n = len(qids)
    if n == 0:
        return ndcg, _map, recall, precision

    for qid in qids:
        ranked = _ranked(run.get(qid, {}))
        for k in k_values:
            ndcg[f"NDCG@{k}"] += ndcg_at_k(qrels[qid], ranked, k)
            _map[f"MAP@{k}"] += average_precision_at_k(qrels[qid], ranked, k)
            recall[f"Recall@{k}"] += recall_at_k(qrels[qid], ranked, k)
            precision[f"P@{k}"] += precision_at_k(qrels[qid], ranked, k)

    for d in (ndcg, _map, recall, precision):
        for key in d:
            d[key] = round(d[key] / n, 5)
    return ndcg, _map, recall, precision
