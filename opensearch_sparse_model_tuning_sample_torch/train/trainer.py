"""Training: the train step and the host loop, on one card, data-parallel
over the device mesh of one process, or over a process group (one process
per card).

The port of the JAX package's `train/trainer.py` (which replaces the
reference's HF-Trainer subclass, trainer.py:52-218). A step runs the
student forwards (docs through the BERT-MLM and the max-pool head's
autograd Function, queries inference-free or through the encoder), the
FLOPS/L0 regulariser with its quadratic lambda ramp, the ranking losses,
the backward and one AdamW update:

  * AdamW (betas 0.9/0.999, eps 1e-8) with weight decay on every BERT
    parameter, biases and LayerNorm included (the reference builds AdamW
    over model.parameters(), train_ir.py:86-90);
  * the learnable IDF vector in its own group: frozen (outside the
    optimizer and the clip norm), at `idf_lr`, or at the base rate;
  * linear warm-up then linear decay, where the first update uses lr(0),
    as optax evaluates the schedule at the count before the update;
  * global-norm clipping (`clip_grad_norm_`: optax's `clip_by_global_norm`
    up to a 1e-6 in the norm);
  * gradient accumulation over A microbatches: gradients averaged, one
    update, metrics averaged except `nonzero_max` (a max);
  * knowledge distillation: a teacher ensemble (train/teachers.py) scores
    each microbatch inside the step, under no_grad and before the student
    forward; host teachers run on their raw texts before the step. The
    teachers belong to the ensemble, not to the model, so they stay out of
    the optimizer, the clip norm, the train state and the checkpoints.

A step over a mesh (`core/mesh.py`) is JAX's jitted step over its `data`
axis: the loader batch is the global batch, each microbatch is split by
rows over the positions, and each position encodes its rows with its own
replica of the model on its device (position 0's is the model itself).
The reps are gathered to the first device, where the losses, the
regulariser and the metrics are taken once on the global microbatch; one
backward sends each replica its rows' gradient, the replicas' gradients
are summed onto the model's, and after the one AdamW step the parameters
are copied back out to the replicas. The encode and the loss are separate
functions (`encode_rows`, `loss_from_rows`), so the process group's gather
(`all_gather_batch`) and the mesh's (`mesh_gather`) share the loss code.

Metrics and the loss moving average stay on the device; the loop reads
them only at `logging_steps`, so other steps never wait for the card.

A step's stages are the spans `train.encode`, `train.loss` and
`train.backward` (each microbatch), `train.grad_sum`, `train.optimizer`
and `train.broadcast` (`utils/tracing.py`): the `profile_dir` window's
trace shows them.
"""

from __future__ import annotations

import copy
import logging
import os
import time
from typing import Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

from ..core import distributed
from ..core.mesh import Mesh, process_mesh, shard_batch, split_rows
from ..models import hf_import, sparse_encoder as se
from ..models.modernbert import ModernBertConfig
from ..models.kimi_linear import KimiLinearConfig
from ..models.moonlight import MoonlightConfig
from ..ops import flops as flops_ops
from ..ops.losses import LossSpec, build_loss_specs
from ..parallel.collectives import (all_gather_batch, all_reduce_grads, mesh_broadcast,
                                    mesh_gather, mesh_grad_sum)
from ..utils import tracing

logger = logging.getLogger(__name__)


def linear_warmup_linear_decay(warmup_steps: int, total_steps: int):
    """The multiplier of the base rate at optimizer step `step` (HF
    get_linear_schedule_with_warmup, reference train_ir.py:103-107)."""

    def factor(step: int) -> float:
        if step < warmup_steps:
            return step / max(warmup_steps, 1)
        return max(0.0, (total_steps - step) / max(total_steps - warmup_steps, 1))

    return factor


def make_optimizer(model: se.SparseEncoderModel, model_args, data_args, training_args):
    """(AdamW, LambdaLR) over the BERT parameters and, when it trains, the
    IDF vector in its own group. A frozen IDF is not in the optimizer: no
    update, no weight decay, and nothing in the clip norm."""
    groups = [{"params": list(model.bert.parameters()), "lr": training_args.learning_rate}]
    if model_args.idf_requires_grad:
        idf_lr = data_args.idf_lr if data_args.idf_lr is not None else training_args.learning_rate
        groups.append({"params": [model.idf_vector], "lr": idf_lr})
    opt = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=training_args.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, linear_warmup_linear_decay(training_args.warmup_steps, training_args.max_steps))
    return opt, sched


def encode_rows(model: se.SparseEncoderModel, batch, model_args, dropout_key=None,
                teacher_ensemble=None) -> dict:
    """The student's reps of a batch's rows, with `model` on the batch's
    device, and what the loss takes beside them: the teachers' reps of the
    same rows (no gradient), or else the dataset's scores. One position's
    (or one rank's) part of a microbatch; `dropout_key` (None: dropout off)
    seeds the dropout masks."""
    rows = {}
    if teacher_ensemble is not None:
        rows["teacher_q"] = teacher_ensemble.reps(batch["teacher_q"])
        rows["teacher_d"] = teacher_ensemble.reps(batch["teacher_d"])
    elif batch.get("scores") is not None:
        rows["scores"] = batch["scores"]
    key_d = None if dropout_key is None else (*dropout_key, 0)
    key_q = None if dropout_key is None else (*dropout_key, 1)
    rows["d"] = se.encode_doc(model, batch["d_input_ids"], batch["d_attention_mask"],
                              dropout_key=key_d)
    if model_args.inf_free:
        rows["q"] = se.encode_query_inf_free(model, batch["q_input_ids"])
    else:
        rows["q"] = se.encode_doc(model, batch["q_input_ids"], batch["q_attention_mask"],
                                  dropout_key=key_q)
    return rows


def loss_from_rows(rows: dict, step: int, loss_specs: List[LossSpec], model_args, data_args,
                   teacher_ensemble=None):
    """One microbatch's loss and metrics (tensors on the device) from the
    whole microbatch's `encode_rows`. `step` is the optimizer's step count
    before this update, which the lambda ramp reads. With a
    `teacher_ensemble` its scores of the teachers' reps take the place of
    the dataset's `scores`."""
    needs_scores = any(s.kind in ("kldiv", "marginmse") for s in loss_specs)
    teacher_scores = rows.get("scores")
    if teacher_ensemble is not None:
        teacher_scores = teacher_ensemble.scores_from_reps(rows["teacher_q"], rows["teacher_d"])
    if needs_scores and teacher_scores is None:
        raise ValueError("kldiv/marginmse losses need teacher scores")
    d_rep, q_rep = rows["d"], rows["q"]

    group_num = d_rep.shape[0] // q_rep.shape[0]
    d_flops = flops_ops.flops_value(d_rep, group_num, flops_threshold=data_args.flops_threshold)
    flops_loss = d_flops * flops_ops.get_lambda(step, data_args.flops_d_lambda,
                                                data_args.flops_d_T)
    if not model_args.inf_free and data_args.flops_q_lambda:
        flops_loss = flops_loss + flops_ops.flops_value(q_rep) * flops_ops.get_lambda(
            step, data_args.flops_q_lambda, data_args.flops_q_T)

    ranking_loss = sum(spec(q_rep, d_rep, teacher_scores) for spec in loss_specs)
    loss = ranking_loss + flops_loss
    with torch.no_grad():
        nonzero = d_rep > 0
        nnz = nonzero.sum()
        metrics = {
            "loss": loss.detach(),
            "ranking_loss": ranking_loss.detach(),
            "d_flops": d_flops.detach(),
            "flops_loss": flops_loss.detach(),
            "avg_doc_length": nnz / d_rep.shape[0],
            "nonzero_mean": torch.where(nonzero, d_rep, 0.0).sum() / nnz.clamp_min(1),
            "nonzero_max": d_rep.max(),
        }
    return loss, metrics


def train_loss(model: se.SparseEncoderModel, batch: Dict[str, torch.Tensor], step: int,
               loss_specs: List[LossSpec], model_args, data_args, dropout_key=None,
               teacher_ensemble=None):
    """One whole microbatch's loss and metrics on one device: `encode_rows`,
    then `loss_from_rows`."""
    return loss_from_rows(encode_rows(model, batch, model_args, dropout_key, teacher_ensemble),
                          step, loss_specs, model_args, data_args, teacher_ensemble)


def _replica(model: se.SparseEncoderModel, device: torch.device) -> se.SparseEncoderModel:
    """A copy of the model on `device` that shares its tokenizer."""
    return copy.deepcopy(model, {id(model.tokenizer): model.tokenizer}).to(device)


class Trainer:
    """Host loop: batches to the card, step, log, checkpoint.

    Mirrors the observable behaviour of the reference SparseModelTrainer
    (moving-average ranking loss with 0.99 decay and periodic health stats,
    trainer.py:57,120-137; `checkpoint-{step}` saves, :145-156). The model's
    parameters are updated in place.

    `mesh` (default `process_mesh(model.device, dp_size, world)`, as JAX's
    default is `make_mesh(dp_size)`): each loader batch is the global batch
    of `per_device x mesh.size x A` rows, and the step runs over the mesh's
    positions. Position 0 is the model itself (the mesh's first device must
    be the model's); every other position keeps a replica of its own, made
    once and refreshed after each step, also where devices repeat. The
    AdamW state lives only with the model. While a process group is up the
    step is data-parallel over the ranks too (at world size 1 as well), and
    each loader batch is this rank's slice of the global batch."""

    def __init__(self, model: se.SparseEncoderModel, model_args, data_args, training_args,
                 loss_specs: Optional[List[LossSpec]] = None, teacher_ensemble=None,
                 mesh: Optional[Mesh] = None):
        if isinstance(model.cfg, ModernBertConfig):
            raise NotImplementedError(
                "training a ModernBERT backbone is not supported: the port runs it for "
                "encoding (ingest, evaluation, serving) only")
        if isinstance(model.cfg, MoonlightConfig):
            raise NotImplementedError(
                "training a Moonlight backbone is not supported: the port runs it for "
                "encoding (ingest, evaluation, serving) only")
        if isinstance(model.cfg, KimiLinearConfig):
            raise NotImplementedError(
                "training a Kimi Linear backbone is not supported: the port runs it for "
                "encoding (ingest, evaluation, serving) only")
        self.model = model
        self.teacher_ensemble = teacher_ensemble
        self.model_args = model_args
        self.data_args = data_args
        self.args = training_args
        self.loss_specs = loss_specs or build_loss_specs(data_args)
        self.device = model.device
        model.idf_vector.requires_grad_(bool(model_args.idf_requires_grad))
        self.optimizer, self.scheduler = make_optimizer(model, model_args, data_args,
                                                        training_args)
        self.params = [p for g in self.optimizer.param_groups for p in g["params"]]
        self.step = 0
        self.loss_ma = torch.zeros((), dtype=torch.float32, device=self.device)
        self.accum_steps = max(1, int(getattr(training_args, "gradient_accumulation_steps", 1)))
        self.log_history: List[Dict[str, float]] = []
        self.distributed = torch.distributed.is_initialized()
        self.rank = distributed.rank() if self.distributed else 0
        self.mesh = mesh if mesh is not None else process_mesh(
            self.device, training_args.dp_size, distributed.world_size())
        if self.mesh.devices[0] != self.device:
            raise ValueError(f"the mesh's first device {self.mesh.devices[0]} is not the "
                             f"model's ({self.device})")
        self.replicas = [_replica(model, d) for d in self.mesh.devices[1:]]
        names = {id(p): n for n, p in model.named_parameters()}
        self._replica_params = [[dict(r.named_parameters())[names[id(p)]] for p in self.params]
                                for r in self.replicas]

    # ------------------------------------------------------------------
    def _microbatch_loss(self, mb, i: int):
        """Microbatch i's loss and metrics: each position encodes its rows
        with its replica on its device, the rows are gathered to the first
        device (and over the ranks under a process group), and the loss is
        taken once on the global microbatch. Position p takes the rank's
        place in the dropout key, so the positions draw the masks that as
        many ranks would."""
        models = [self.model, *self.replicas]
        ens = self.teacher_ensemble
        with tracing.span("train.encode"):
            parts = [encode_rows(m, part, self.model_args,
                                 (self.args.seed, self.step, i, self.rank * self.mesh.size + p),
                                 None if ens is None else ens.on(m.device))
                     for p, (m, part) in enumerate(zip(models, shard_batch(self.mesh, mb)))]
            if len(parts) > 1:  # leaf by leaf, in position order
                parts = [pytree.tree_map(lambda *xs: mesh_gather(xs, self.device), *parts)]
            rows = pytree.tree_map(all_gather_batch, parts[0]) if self.distributed else parts[0]
        with tracing.span("train.loss"):
            return loss_from_rows(rows, self.step, self.loss_specs, self.model_args,
                                  self.data_args, ens)

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One optimizer step on a loader batch (numpy or tensors). With
        gradient accumulation the batch's leading dim is split into A
        microbatches, and each microbatch over the mesh's positions (JAX
        shards axis 1 of [A, rows]). Host teachers encode their texts first,
        on the whole batch."""
        if self.teacher_ensemble is not None:
            batch = self.teacher_ensemble.host_precompute(batch)
        A = self.accum_steps
        self.optimizer.zero_grad(set_to_none=True)
        per_mb = []
        for i, mb in enumerate(split_rows(batch, A, "the batch")):
            loss, m = self._microbatch_loss(mb, i)
            with tracing.span("train.backward"):
                loss.backward()  # gradients add up in .grad over the microbatches
            per_mb.append(m)
        if self.replicas:
            with tracing.span("train.grad_sum"):
                mesh_grad_sum(self.params, self._replica_params)
        if A > 1:
            for p in self.params:
                if p.grad is not None:
                    p.grad.mul_(1.0 / A)
            metrics = {k: (torch.stack([m[k] for m in per_mb]).max() if k == "nonzero_max"
                           else torch.stack([m[k] for m in per_mb]).mean())
                       for k in per_mb[0]}
        else:
            metrics = per_mb[0]
        if self.distributed:
            with tracing.span("train.grad_sum"):
                all_reduce_grads(self.params)  # a sum: each rank holds its slice's part
        with tracing.span("train.optimizer"):
            if self.args.max_grad_norm:
                torch.nn.utils.clip_grad_norm_(self.params, self.args.max_grad_norm)
            self.optimizer.step()
            self.scheduler.step()
        if self.replicas:
            with tracing.span("train.broadcast"):
                mesh_broadcast(self.params, self._replica_params)
        self.step += 1
        self.loss_ma = 0.99 * self.loss_ma + 0.01 * metrics["ranking_loss"]
        metrics["ranking_loss_ma"] = self.loss_ma
        return metrics

    def train(self, batch_iter, max_steps: Optional[int] = None):
        max_steps = max_steps or self.args.max_steps
        t0 = time.time()
        start_step = self.step
        last_saved = -1
        prof = None
        for batch in batch_iter:
            if self.step >= max_steps:
                break
            # torch.profiler trace of steps [2, 7) when profile_dir is set
            if (self.args.profile_dir and self.step == 2 and prof is None
                    and self.rank == 0):
                prof = _start_profiler(self.device)
            metrics = self.train_step(batch)
            if prof is not None and self.step >= 7:
                prof = _stop_profiler(prof, self.args.profile_dir)
            step = self.step
            if step % self.args.logging_steps == 0 or step == 1:
                m = {k: float(v) for k, v in metrics.items()}
                self.log_history.append({"step": step, **m})
                logger.info(
                    "Step %d. ranking loss moving avg:%.5f, d_flops: %.4f, "
                    "flops_loss: %.5f avg doc length: %.1f nonzero mean/max: "
                    "%.4f/%.4f (%.2f steps/s)",
                    step, m["ranking_loss_ma"], m["d_flops"], m["flops_loss"],
                    m["avg_doc_length"], m["nonzero_mean"], m["nonzero_max"],
                    (step - start_step) / max(time.time() - t0, 1e-9),
                )
            if (self.args.save_strategy == "steps" and self.args.save_steps
                    and step % self.args.save_steps == 0):
                self.save_checkpoint(step)
                last_saved = step
        if prof is not None:  # the run ended inside the trace window
            _stop_profiler(prof, self.args.profile_dir)
        if self.args.save_strategy != "no" and last_saved != self.step:
            self.save_checkpoint(self.step)
        return self

    # ------------------------------------------------------------------
    def save_checkpoint(self, step: int):
        if self.rank != 0:
            return  # the main process saves (reference trainer.py:145-147)
        out = os.path.join(self.args.output_dir, f"checkpoint-{step}")
        hf_import.save_checkpoint(self.model, out)
        logger.info("Saving model checkpoint to %s", out)

    def _state_path(self, path: Optional[str]) -> str:
        return path or os.path.join(os.path.abspath(self.args.output_dir), "train_state")

    def save_train_state(self, path: Optional[str] = None):
        """Everything an exact resume needs (model, optimizer, schedule, step,
        loss moving average) as `train_state/state.pt`; of a mesh's
        positions only the model itself, which the replicas copy. The
        port's own format: a JAX package's train_state does not load here. Rank 0
        writes it; every rank calls this and leaves behind a barrier, so
        the file is whole before any rank can restore from it."""
        path = self._state_path(path)
        if self.rank != 0:
            distributed.barrier()
            return
        os.makedirs(path, exist_ok=True)
        torch.save({
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": self.step,
            "loss_ma": self.loss_ma,
        }, os.path.join(path, "state.pt"))
        distributed.barrier()

    def restore_train_state(self, path: Optional[str] = None):
        # on the CPU first: AdamW keeps its step counts there, and
        # load_state_dict moves the moments to their parameters' device
        state = torch.load(os.path.join(self._state_path(path), "state.pt"),
                           map_location="cpu", weights_only=True)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])
        self.loss_ma = state["loss_ma"].to(self.device)
        if self.replicas:
            mesh_broadcast(self.params, self._replica_params)


def _start_profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, profile_dir: str):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
    return None
