"""Hard-negative mining: retrieve with the current model, drop positives,
emit a {query, pos, negs} training dataset.

The port of the JAX package's `mine/hard_negatives.py` (reference
demo_train_data.py:43-91: mine with the current model via ingest + search,
remove qrel positives from the hits, one training row per positive; and
prepare_msmarco_hard_negatives.py: join an id-based hard-negative set with
corpus and query text). Mine -> train -> evaluate closes on the card
without any external search engine.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

from ..data.datasets import BEIRCorpusDataset, MsMarcoKDDataset
from ..eval.beir import ingest, save_and_merge_shards, search
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
    mesh=None,
    doc_inf_free: bool = False,
    rank: int = 0,
    world_size: int = 1,
):
    """Returns the list of {query, pos, negs} rows; saves an HF dataset when
    `save_path` is given (the reference writes data/{ds}_train).

    `doc_inf_free=True` mines against the idf-weighted lexical index: the
    offline bootstrap when no pretrained encoder is available (the reference
    mines with a pretrained doc-v2 model, demo_train_data.py).

    `mesh`: shard the mining index over a device mesh (`core/mesh.py`).

    Multi-process (reference: all ranks ingest, rank 0 searches and writes,
    demo_train_data.py:43-66): every rank encodes its corpus stripe and
    saves a shard index; rank 0 merges, searches and writes the dataset.
    Other ranks return []."""
    index_dir = os.path.join(out_dir, f"{index_name}.index")
    if world_size > 1:
        # clear this rank's stale marker before the ingest barrier (the
        # protocol of eval/beir.evaluate_datasets)
        try:
            os.remove(os.path.join(f"{index_dir}.shard{rank}of{world_size}", ".done"))
        except FileNotFoundError:
            pass
    index = ingest(BEIRCorpusDataset(corpus), model, out_dir, index_name,
                   max_length=max_length, batch_size=batch_size, index_cfg=index_cfg,
                   mesh=mesh, doc_inf_free=doc_inf_free, rank=rank, world_size=world_size)
    if world_size > 1:
        index = save_and_merge_shards(index, index_dir, rank, world_size, model.device, mesh)
        if index is None:
            return []
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


def prepare_msmarco_kd(
    hard_negatives_rows,  # rows {query: qid, docs: [doc_ids], scores?, ...}
    corpus_texts: Dict[str, str],
    query_texts: Dict[str, str],
    save_path: str,
):
    """Join id-based hard negatives with text (reference
    prepare_msmarco_hard_negatives.py:1-42, with the latin1 -> utf-8
    repair) and save the rows as an HF dataset at `save_path`. Every other
    source column is carried over (the reference's Dataset.map keeps them),
    first_rank among them, which the KD dataset's first_rank_thresh filter
    reads (dataset.py:174-179)."""
    import datasets as hfds

    fix = MsMarcoKDDataset.transform_str
    rows = []
    for r in hard_negatives_rows:
        out = {k: v for k, v in r.items() if k not in ("query", "docs")}
        out["query"] = query_texts[r["query"]]
        out["docs"] = [fix(corpus_texts[d]) for d in r["docs"]]
        rows.append(out)
    hfds.Dataset.from_list(rows).save_to_disk(save_path)
    return rows
