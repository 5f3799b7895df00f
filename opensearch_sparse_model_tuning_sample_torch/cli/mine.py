"""Hard-negative mining entry point of the PyTorch port (reference
demo_train_data.py):

    python -m opensearch_sparse_model_tuning_sample_torch.cli.mine cfg.yaml [--device cpu]

Mines top-k hard negatives for the train split of the configured BEIR
dataset with the current model and saves `data/{ds}_train` (relative to the
working directory) for the training recipes. With `mine_doc_inf_free` the
mining index is the idf-weighted lexical one (the bootstrap when no trained
encoder exists). Runs on the CUDA card unless `--device cpu`.

Multi-process (torchrun, or RANK/WORLD_SIZE with `--device cuda:0` for
ranks that share a card): every rank ingests its corpus stripe and saves a
shard index; rank 0 merges the shards, searches and writes the dataset.
In one process the mining index is sharded over `make_mesh(dp_size)` as in
`cli.evaluate_beir` (one card: the single-device index; `--device cpu`: one
CPU).
"""

from __future__ import annotations

import json
import logging
import os

from ..core import distributed
from ..core.config import parse_config
from ..core.device import resolve_device
from ..core.mesh import process_mesh
from ..eval.beir import resolve_dataset
from ..mine.hard_negatives import mine_hard_negatives
from ..models import sparse_encoder as se
from ..ops import maxpool
from ..utils.logging_utils import set_logging

logger = logging.getLogger(__name__)


def main(config_source=None):
    model_args, data_args, training_args, mining_args = parse_config(
        config_source, with_mining=True)
    device = resolve_device(distributed.process_device(training_args.device))
    distributed.maybe_init_distributed(device)  # every rank ingests, rank 0 searches
    try:
        rows = _mine(model_args, data_args, training_args, mining_args, device)
        logger.info("rank %d launch counts: %s", distributed.rank(),
                    json.dumps(maxpool.launch_counts()))
        return rows
    finally:
        distributed.destroy()


def _mine(model_args, data_args, training_args, mining_args, device):
    rank, world_size = distributed.rank(), distributed.world_size()
    set_logging(training_args.output_dir, "mine.log" if rank == 0 else None,
                training_args.log_level)
    # MiningArguments (reference args.py:76-79): mine_datasets wins when set;
    # `source` points the mining encoder (weights and vocab) at a checkpoint
    if mining_args.source:
        model_args.model_name_or_path = mining_args.source
        model_args.tokenizer_name = mining_args.source
    names = (mining_args.mine_datasets or data_args.beir_datasets).split(",")
    if len(names) != 1:
        raise ValueError("can only accept one beir dataset")
    name = names[0]

    model = se.from_model_args(model_args, seed=training_args.seed, device=device)
    corpus, queries, qrels = resolve_dataset(name, data_args.beir_dir, split="train")

    save_path = os.path.join("data", f"{name}_train")
    rows = mine_hard_negatives(
        corpus, queries, qrels, model,
        out_dir=os.path.join(training_args.output_dir, "tmp"),
        index_name=name.lower(),
        save_path=save_path,
        max_length=data_args.max_seq_length,
        batch_size=training_args.per_device_eval_batch_size,
        result_size=50,
        inf_free=model_args.inf_free,
        mesh=process_mesh(device, training_args.dp_size, world_size),
        doc_inf_free=data_args.mine_doc_inf_free,
        rank=rank, world_size=world_size,
    )
    if rank == 0:
        logger.info("mined %d rows -> %s", len(rows), save_path)
    return rows


if __name__ == "__main__":
    main()
