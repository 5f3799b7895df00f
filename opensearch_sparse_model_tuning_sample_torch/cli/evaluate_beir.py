"""BEIR evaluation entry point of the PyTorch port:

    python -m opensearch_sparse_model_tuning_sample_torch.cli.evaluate_beir cfg.yaml [--device cpu]

Reference: evaluate_beir.py:331-378 — evaluates the final checkpoint on the
configured BEIR datasets, then every `checkpoint-*` dir on NanoBEIR-style
small sets. Data comes from local BEIR-format dirs under `beir_dir`
(zero-egress); `beir_datasets: synthetic` (or `synthetic-rich`) runs a
built-in synthetic task. Runs on the CUDA card unless `--device cpu`.

Multi-process: under torchrun each process joins the launch's group and
runs on `cuda:LOCAL_RANK`; without a rendezvous the ranks come from
RANK/WORLD_SIZE, and `--device cuda:0` puts them on one card (the ingest
needs no collective). Every rank ingests its corpus stripe and saves a
shard index; rank 0 merges the shards, searches, and writes the metrics:

    RANK=0 WORLD_SIZE=2 python -m ...cli.evaluate_beir cfg.yaml --device cuda:0 &
    RANK=1 WORLD_SIZE=2 python -m ...cli.evaluate_beir cfg.yaml --device cuda:0

In one process the eval index is sharded over `make_mesh(dp_size)`: every
visible card from the run's device on (`index_shard_by` picks docs or
queries; one card is the single-device index), or one CPU with `--device
cpu`. Under a launch of more ranks each rank's mesh is its own card.
"""

from __future__ import annotations

import json
import logging
import os
import sys

from ..core import distributed
from ..core.config import parse_config, snapshot_config
from ..core.device import resolve_device
from ..core.mesh import process_mesh
from ..eval.beir import eval_suffix, evaluate_datasets, resolve_dataset
from ..models import bert
from ..models import sparse_encoder as se
from ..ops import maxpool
from ..utils.logging_utils import set_logging

logger = logging.getLogger(__name__)


def prepare_model_args(model_args, output_dir: str, step) -> None:
    """Point eval at checkpoint-{max_steps} (evaluate_beir.py:33-38)."""
    ckpt = os.path.join(output_dir, f"checkpoint-{step}")
    if os.path.isdir(ckpt):
        model_args.model_name_or_path = ckpt
        model_args.tokenizer_name = ckpt
        if model_args.idf_requires_grad:
            idf = os.path.join(ckpt, "idf.json")
            if os.path.exists(idf):
                model_args.idf_path = idf
    else:
        logger.warning("no trained checkpoint at %s — evaluating %s as configured",
                       ckpt, model_args.model_name_or_path)


def _loader(data_args):
    def load(name: str):
        return resolve_dataset(name, data_args.beir_dir, split="test")

    return load


def resolve_eval_model(model_args, training_args, config_source, argv) -> None:
    """Point eval at the trained checkpoint-{max_steps}, as the reference
    does for yaml-driven runs (evaluate_beir.py:337-340). Only an explicit
    --model_name_or_path flag, or a programmatic dict that sets it, selects
    the eval model directly."""
    if config_source is None:
        explicit_model = any(
            a == "--model_name_or_path" or a.startswith("--model_name_or_path=")
            for a in argv
        )
    elif isinstance(config_source, str):  # programmatic yaml path == CLI yaml
        explicit_model = False
    else:  # programmatic dict: the caller's model choice is authoritative
        explicit_model = model_args.model_name_or_path is not None
    if not explicit_model:
        prepare_model_args(model_args, training_args.output_dir, training_args.max_steps)


def main(config_source=None):
    model_args, data_args, training_args = parse_config(config_source)
    resolve_eval_model(model_args, training_args, config_source, sys.argv[1:])

    device = resolve_device(distributed.process_device(training_args.device))
    distributed.maybe_init_distributed(device)  # every rank ingests, rank 0 searches
    try:
        avg = _evaluate(model_args, data_args, training_args, device)
        logger.info("rank %d launch counts: %s", distributed.rank(),
                    json.dumps({**maxpool.launch_counts(), "attention": bert.attention_counts()}))
        return avg
    finally:
        distributed.destroy()


def _evaluate(model_args, data_args, training_args, device):
    suffix = eval_suffix(model_args, data_args)
    main_rank = distributed.is_main()
    if main_rank:
        snapshot_config(
            model_args, data_args, training_args,
            os.path.join(training_args.output_dir, f"beir_eval_config{suffix}.yaml"),
        )
    set_logging(training_args.output_dir, "eval_beir.log" if main_rank else None,
                training_args.log_level)
    model = se.from_model_args(model_args, seed=training_args.seed, device=device)
    mesh = process_mesh(device, training_args.dp_size, distributed.world_size())

    eval_dir = os.path.join(training_args.output_dir, f"beir_eval{suffix}")
    avg = evaluate_datasets(
        data_args.beir_datasets.split(","), _loader(data_args),
        model, model_args, data_args, training_args,
        eval_dir, mesh=mesh, metrics_index="beir_eval",
    )
    logger.info("BEIR avg: %s", avg)

    # NanoBEIR-style sweep over every checkpoint (evaluate_beir.py:365-378)
    nano_cfg = data_args.nano_beir_datasets or os.environ.get("NANO_BEIR_DATASETS", "")
    nano_names = [n for n in nano_cfg.split(",") if n]
    if nano_names:
        for file in sorted(os.listdir(training_args.output_dir)):
            if not file.startswith("checkpoint-"):
                continue
            step = file.split("-")[-1]
            model_args.model_name_or_path = os.path.join(training_args.output_dir, file)
            model_args.tokenizer_name = model_args.model_name_or_path
            if model_args.idf_requires_grad:
                # each checkpoint carries its own learned idf vector
                idf = os.path.join(model_args.model_name_or_path, "idf.json")
                if os.path.exists(idf):
                    model_args.idf_path = idf
            ckpt_model = se.from_model_args(model_args, seed=training_args.seed,
                                            device=device)
            evaluate_datasets(
                nano_names, _loader(data_args), ckpt_model, model_args, data_args,
                training_args,
                os.path.join(training_args.output_dir, f"nano_beir_eval{suffix}"),
                mesh=mesh, metrics_index="nano_beir_eval", step=step,
            )
    return avg


if __name__ == "__main__":
    main()
