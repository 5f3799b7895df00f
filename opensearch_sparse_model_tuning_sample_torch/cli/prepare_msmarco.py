"""Prepare the MS MARCO KD training set from local data:

    python -m opensearch_sparse_model_tuning_sample_torch.cli.prepare_msmarco \
        --hard-negatives <dir> --msmarco-dir <dir> [--out data/msmarco_ft]

Reference: prepare_msmarco_hard_negatives.py. Joins an id-based hard-negative
set (an HF `save_to_disk` dir of rows {query: qid, docs: [doc ids],
scores?, first_rank?, ...}) with the text of a BEIR-format msmarco dir
(corpus.jsonl + queries.jsonl), repairing latin1-decoded utf-8 text, and
saves the rows for `data_type: kd` training. Host only: no model, no card.
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger(__name__)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--hard-negatives", required=True,
                   help="HF save_to_disk dir: rows {query: qid, docs: [ids], scores?}")
    p.add_argument("--msmarco-dir", required=True,
                   help="BEIR-format msmarco dir (corpus.jsonl + queries.jsonl)")
    p.add_argument("--out", default="data/msmarco_ft")
    args = p.parse_args(argv)

    import datasets as hfds

    from ..eval.beir import load_beir_dir
    from ..mine.hard_negatives import prepare_msmarco_kd

    logging.basicConfig(level=logging.INFO)
    corpus, queries, _ = load_beir_dir(args.msmarco_dir, split="train")
    corpus_texts = {k: v["text"] for k, v in corpus.items()}
    hn = hfds.Dataset.load_from_disk(args.hard_negatives)
    rows = prepare_msmarco_kd(hn, corpus_texts, queries, args.out)
    logger.info("wrote %d rows to %s", len(rows), args.out)
    return rows


if __name__ == "__main__":
    main()
