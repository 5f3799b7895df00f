"""Training entry point of the PyTorch port:

    python -m opensearch_sparse_model_tuning_sample_torch.cli.train_ir cfg.yaml [--device cpu]
    torchrun --nproc_per_node N -m opensearch_sparse_model_tuning_sample_torch.cli.train_ir cfg.yaml

Reference: train_ir.py:30-150, the same single-YAML interface as the JAX
package's `cli.train_ir`. Runs on the CUDA card unless `--device cpu`.
In one process it trains over `make_mesh(dp_size)` of the visible cards
from the run's device on (`core/mesh.py::process_mesh`; -1: all of them, a
`dp_size` beyond them raises), as the JAX package does: the loader batch is
the global batch of `per_device_train_batch_size` x mesh size x
`gradient_accumulation_steps` rows an optimizer step (the JAX package's
batch semantics; one host thread drives every position, and the step is
measured slower than one card at the same batch). Under torchrun (or
the JAX package's `tools/launch_dist.py`) each process joins the launch's
process group (NCCL on the card, gloo on the CPU) and trains data-parallel
on `cuda:LOCAL_RANK`, its mesh its own card: the global batch is
`per_device_train_batch_size` x world size x `gradient_accumulation_steps`
rows, each rank's loader yields its slice, and `dp_size` must be -1 or the
world size. `kd_ensemble_teacher_kwargs` builds a teacher
ensemble that scores each batch inside the step (with an embedding store
under `store_root` when a teacher is `remote`). Rank 0 writes the log file,
the config snapshot, the checkpoints and `run_summary.json` (the process
group, the log history, and the launch counts of the head's kernels and the
collectives).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys

from ..core import distributed
from ..core.config import parse_config, snapshot_config
from ..core.device import resolve_device
from ..core.mesh import process_mesh
from ..data.collator import build_collator
from ..data.datasets import HostShardDataset, load_dataset, load_datasets
from ..data.loader import DataLoader, epochs
from ..models import sparse_encoder as se
from ..ops import maxpool
from ..ops.losses import build_loss_specs
from ..parallel import collectives
from ..train.trainer import Trainer
from ..utils.logging_utils import set_logging

logger = logging.getLogger(__name__)


def main(config_source=None):
    model_args, data_args, training_args = parse_config(config_source)
    # the process group first: rank 0 alone writes the log file and snapshot
    device = resolve_device(distributed.process_device(training_args.device))
    distributed.maybe_init_distributed(device)
    try:
        world = distributed.world_size()
        if world > 1:
            distributed.check_dp_size(training_args.dp_size, world)
        try:
            mesh = process_mesh(device, training_args.dp_size, world)
        except ValueError as e:
            raise ValueError(f"dp_size={training_args.dp_size}: {e}") from e
        main_rank = distributed.is_main()
        set_logging(training_args.output_dir, "train.log" if main_rank else None,
                    training_args.log_level)
        if main_rank:
            _snapshot(config_source, model_args, data_args, training_args)

        # precomputed-embedding store for "remote" teachers (reference
        # train_ir.py:50-57); its prefetch pool is shut down when the run ends
        embedding_store = None
        kd_kwargs = data_args.kd_ensemble_teacher_kwargs
        if kd_kwargs and "remote" in kd_kwargs.get("types", []):
            from ..train.embedding_store import EmbeddingStore, LocalVectorStore

            store_root = kd_kwargs.get("store_root", "data/embedding_store")
            embedding_store = EmbeddingStore(LocalVectorStore(store_root))
            logger.info("embedding store ready at %s", store_root)
        try:
            trainer = _train(model_args, data_args, training_args, kd_kwargs,
                             embedding_store, device, mesh)
        finally:
            if embedding_store is not None:
                embedding_store.shutdown()
        if main_rank:
            _write_summary(trainer, training_args.output_dir)
        return trainer
    finally:
        distributed.destroy()


def _snapshot(config_source, model_args, data_args, training_args):
    """The config snapshot for reproducibility (reference train_ir.py:33-44)."""
    argv_yaml = (config_source is None and len(sys.argv) == 2
                 and sys.argv[1].endswith((".yaml", ".yml")))
    if isinstance(config_source, str) or argv_yaml:
        shutil.copy(config_source or sys.argv[1],
                    os.path.join(training_args.output_dir, "train_config.yaml"))
    else:
        snapshot_config(model_args, data_args, training_args,
                        os.path.join(training_args.output_dir, "config.yaml"))


def _write_summary(trainer, output_dir):
    """`run_summary.json`: the process group, the steps and log history, and
    this process's launch counts of the head's kernels, their plain versions
    and the collectives (the process group's and the mesh's)."""
    summary = {"backend": distributed.backend(), "world_size": distributed.world_size(),
               "device": str(trainer.device),
               "mesh": [str(d) for d in trainer.mesh.devices], "steps": trainer.step,
               "log_history": trainer.log_history, **maxpool.launch_counts(),
               "collectives": collectives.counts(),
               "mesh_collectives": collectives.mesh_counts()}
    with open(os.path.join(output_dir, "run_summary.json"), "w") as f:
        json.dump(summary, f)


def _train(model_args, data_args, training_args, kd_kwargs, embedding_store, device, mesh):
    rank, world = distributed.rank(), distributed.world_size()
    logger.info("mesh: %d device(s) (%s)%s", mesh.size, device.type,
                f" process {rank}/{world}" if world > 1 else "")
    if mesh.size > 1:
        logger.info("the mesh trains on the JAX package's global batch, driven from one "
                    "host thread: measured slower than one card at the same batch; for "
                    "throughput launch one process per card with torchrun")
    model = se.from_model_args(model_args, seed=training_args.seed, device=device)
    logger.info("model: %s hidden=%d layers=%d vocab=%d on %s",
                model_args.model_name_or_path or model_args.arch, model.cfg.hidden_size,
                model.cfg.num_hidden_layers, model.cfg.vocab_size, device)

    # the ensemble before the collator: the collator takes its per-teacher
    # feature specs (native tokenizer, host texts, remote ids) from it
    teacher_ensemble = None
    if kd_kwargs:
        from ..train.teachers import build_ensemble

        teacher_ensemble = build_ensemble(kd_kwargs, data_args.use_in_batch_negatives,
                                          max_length=data_args.max_seq_length, device=device)
        logger.info("kd-ensemble teachers: %s", kd_kwargs.get("types"))

    collator = build_collator(data_args.data_type, model.tokenizer, data_args.max_seq_length,
                              teacher_tokenizer_ids=kd_kwargs.get("teacher_tokenizer_ids", []),
                              seq_buckets=data_args.seq_buckets,
                              embedding_store=embedding_store,
                              teacher_ensemble=teacher_ensemble)
    loss_specs = build_loss_specs(data_args)
    logger.info("losses: %s", loss_specs)

    # one loader batch per optimizer step: with gradient accumulation the
    # trainer splits it into A microbatches (HF effective batch semantics:
    # per_device x mesh size x world x A rows an update). The loader yields
    # this rank's slice; the trainer gathers the global batch's reps.
    batch_size = training_args.per_device_train_batch_size * mesh.size * max(
        1, training_args.gradient_accumulation_steps)
    logger.info("global batch %d rows an update over %d process(es), %d mesh position(s) "
                "each", batch_size * world, world, mesh.size)
    ds_kwargs = dict(
        swap_times=data_args.swap_times,
        sample_num_one_query=data_args.sample_num_one_query,
        first_rank_thresh=data_args.first_rank_thresh,
        score_scale=data_args.score_scale,
        shuffle_seed=training_args.seed,
    )
    if data_args.train_file is not None:
        dataset = load_dataset(data_args.train_file, data_args.data_type, **ds_kwargs)
        if world > 1:
            # equal shards, so the ranks agree on batch counts (unequal counts
            # hang a collective; reference DDPDatasetWithRank)
            dataset = HostShardDataset(dataset, rank, world, drop=True)
    elif data_args.train_file_dir is not None:
        dataset = load_datasets(data_args.train_file_dir, data_args.data_type,
                                rank=rank, world_size=world, **ds_kwargs)
    else:
        raise ValueError("train_file or train_file_dir must be specified")

    loader = DataLoader(
        dataset, batch_size=batch_size, collate_fn=collator,
        drop_last=training_args.dataloader_drop_last, seed=training_args.seed,
        prefetch=training_args.dataloader_prefetch_factor or 0,
    )
    trainer = Trainer(model, model_args, data_args, training_args, loss_specs=loss_specs,
                      teacher_ensemble=teacher_ensemble, mesh=mesh)
    if training_args.resume:
        state_dir = os.path.join(os.path.abspath(training_args.output_dir), "train_state")
        if os.path.isdir(state_dir):
            trainer.restore_train_state(state_dir)
            logger.info("resumed from %s at step %d", state_dir, trainer.step)
        else:
            logger.info("resume requested but no train_state at %s; fresh run", state_dir)

    def batches():
        # exact resume: the data stream fast-forwards to the restored step;
        # remote teachers' embeddings are fetched before the batch moves
        for batch in epochs(loader, training_args.max_steps, start=trainer.step):
            yield collator.resolve_pending(batch)

    trainer.train(batches())
    trainer.save_train_state()
    logger.info("training complete at step %d", trainer.step)
    return trainer


if __name__ == "__main__":
    main()
