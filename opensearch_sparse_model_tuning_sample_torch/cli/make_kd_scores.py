"""Teacher scores for a mined posnegs dataset -> a kd dataset:

    python -m opensearch_sparse_model_tuning_sample_torch.cli.make_kd_scores \\
        --posnegs data/synthetic-rich_train \\
        --teacher output/infonce_synthetic/checkpoint-2000 \\
        --out data/synthetic-rich_kd3 --docs-per-query 16 --random-negs 8 [--device cpu]

The port's counterpart of `tools/make_kd_scores.py`, with its flags and its
rows: the reference's kd recipes read {query, docs, scores} rows whose
scores were computed offline (msmarco-hard-negatives, reference
dataset.py:151-217); here a local sparse teacher checkpoint scores each
(query, doc) pair, the full-forward doc rep against the inference-free (or
full) query rep, and the rows go to an HF `save_to_disk` dataset. The same
`--seed` draws the same random negatives, in the same order, as the tool.
The teacher's reps come from `BatchEncoder.encode_batch` (the ingest kernel
on the card). Runs on the CUDA card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np

from ..models import sparse_encoder as se


def build_rows(src, docs_per_query: int, random_negs: int, seed: int):
    """(rows [{query, docs}], the flat query and doc lists, each row's
    (start, n) span of the docs): the positive and the first hard negatives
    of each row, and `random_negs` docs drawn uniformly from the other
    rows' docs, skipping any already in the row."""
    rng = np.random.default_rng(seed)
    pool: List[str] = []
    if random_negs:
        for r in src:
            pool.append(r["pos"])
            pool.extend(r["negs"])
    rows, flat_q, flat_docs, spans = [], [], [], []
    for r in src:
        n_hard = docs_per_query - 1 - random_negs
        docs = [r["pos"]] + list(r["negs"])[: max(n_hard, 0)]
        if pool:
            own = set(docs)
            need, attempts = random_negs, 0
            while need and attempts < 50 * random_negs:  # a tiny corpus may run dry
                attempts += 1
                cand = pool[int(rng.integers(0, len(pool)))]
                if cand in own:
                    continue
                docs.append(cand)
                own.add(cand)
                need -= 1
        if len(docs) < 2:
            continue
        spans.append((len(flat_docs), len(docs)))
        flat_q.append(r["query"])
        flat_docs.extend(docs)
        rows.append({"query": r["query"], "docs": docs})
    return rows, flat_q, flat_docs, spans


def encode_all(enc: se.BatchEncoder, texts: List[str], batch_size: int,
               inf_free: bool = False) -> np.ndarray:
    return np.concatenate([enc.encode_batch(texts[s: s + batch_size], inf_free=inf_free)
                           for s in range(0, len(texts), batch_size)], axis=0)


def score_rows(rows, spans, q_reps: np.ndarray, d_reps: np.ndarray):
    """Each row's docs rank-ordered by teacher score (KnowledgeDistillDataset's
    strided grouping assumes rank-ordered rows, as real score sets are),
    with the scores beside them."""
    for i, (start, n) in enumerate(spans):
        scores = d_reps[start: start + n] @ q_reps[i]
        order = np.argsort(-scores)
        rows[i]["docs"] = [rows[i]["docs"][j] for j in order]
        rows[i]["scores"] = [float(scores[j]) for j in order]
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--posnegs", required=True, help="mined posnegs dataset dir")
    p.add_argument("--teacher", required=True, help="teacher checkpoint dir")
    p.add_argument("--out", required=True)
    p.add_argument("--docs-per-query", type=int, default=8,
                   help="pos + (n-1) negs kept per row")
    p.add_argument("--random-negs", type=int, default=0,
                   help="of the docs-per-query-1 negatives, draw this many uniformly "
                        "from OTHER queries' docs instead of the row's mined hard "
                        "negatives, so the pool spans easy docs too, as real KD score "
                        "sets do")
    p.add_argument("--max-length", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--query-inf-free", action=argparse.BooleanOptionalAction, default=True,
                   help="score teacher queries inference-free (idf-weighted bag); "
                        "--no-query-inf-free uses the full forward")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import datasets as hfds

    model = se.build_model(model_name_or_path=args.teacher, device=args.device)
    enc = se.BatchEncoder(model, max_length=args.max_length, do_count=False)
    src = hfds.Dataset.load_from_disk(args.posnegs)
    rows, flat_q, flat_docs, spans = build_rows(src, args.docs_per_query, args.random_negs,
                                                args.seed)
    q_reps = encode_all(enc, flat_q, args.batch_size, inf_free=args.query_inf_free)
    d_reps = encode_all(enc, flat_docs, args.batch_size)
    rows = score_rows(rows, spans, q_reps, d_reps)
    hfds.Dataset.from_list(rows).save_to_disk(args.out)
    print(f"wrote {len(rows)} kd rows -> {args.out}")
    return rows


if __name__ == "__main__":
    main()
