"""Hard-negative mining: retrieve with the current model, drop positives,
emit a {query, pos, negs} training dataset.

The port of the JAX package's `mine/hard_negatives.py` for one process
(reference demo_train_data.py:43-91: mine with the current model via
ingest + search, remove qrel positives from the hits, one training row per
positive). Mine -> train -> evaluate closes on the card without any
external search engine. Multi-process mining and `prepare_msmarco_kd` are
not ported yet.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

from ..data.datasets import BEIRCorpusDataset
from ..eval.beir import ingest, search
from ..index.engine import IndexConfig
from ..models.sparse_encoder import SparseEncoderModel

logger = logging.getLogger(__name__)


def mine_hard_negatives(
    corpus: Dict[str, Dict[str, str]],
    queries: Dict[str, str],
    qrels: Dict[str, Dict[str, int]],
    model: SparseEncoderModel,
    out_dir: str,
    index_name: str,
    save_path: Optional[str] = None,
    max_length: int = 512,
    batch_size: int = 50,
    result_size: int = 50,
    inf_free: bool = True,
    index_cfg: Optional[IndexConfig] = None,
    doc_inf_free: bool = False,
    world_size: int = 1,
):
    """Returns the list of {query, pos, negs} rows; saves an HF dataset when
    `save_path` is given (the reference writes data/{ds}_train).

    `doc_inf_free=True` mines against the idf-weighted lexical index: the
    offline bootstrap when no pretrained encoder is available (the reference
    mines with a pretrained doc-v2 model, demo_train_data.py)."""
    if world_size > 1:
        raise NotImplementedError(
            "multi-process mining is not ported to the PyTorch package yet "
            "(ROADMAP Queue 1: distribution)")
    index = ingest(BEIRCorpusDataset(corpus), model, out_dir, index_name,
                   max_length=max_length, batch_size=batch_size, index_cfg=index_cfg,
                   doc_inf_free=doc_inf_free)
    res = search(queries, model, index, out_dir, index_name, max_length=max_length,
                 batch_size=batch_size, result_size=result_size, inf_free=inf_free)
    run_res = res["run_res"]

    def doc_text(did):
        d = corpus[did]
        return (d.get("title", "") + " " + d.get("text", "")).strip()

    rows = []
    for qid, docs in run_res.items():
        if qid not in qrels:
            continue
        for did in qrels[qid]:
            docs.pop(did, None)  # drop positives from the negatives pool
        for positive in qrels[qid]:
            if positive not in corpus:
                continue
            rows.append({
                "query": queries[qid],
                "pos": doc_text(positive),
                "negs": [doc_text(n) for n in docs if n in corpus],
            })
    logger.info("mined %d training rows from %d queries", len(rows), len(queries))

    if save_path:
        import datasets as hfds

        hfds.Dataset.from_list(rows).save_to_disk(save_path)
        logger.info("saved mined dataset to %s", save_path)
    return rows
