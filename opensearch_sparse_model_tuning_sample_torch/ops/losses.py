"""Ranking losses as plain functions of batch representations (the port of
the JAX package's `ops/losses.py`).

Reps arrive as [B, V] queries and [B*G, V] docs, G = docs per query with the
positive first in each group (the collator's layout). On one card the batch
is the whole batch, so in-batch negatives need no gather. Scores are fp32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


def _scores_grouped(q_rep: torch.Tensor, d_rep: torch.Tensor) -> torch.Tensor:
    """Per-group scores [B, G]: each query against its own doc group."""
    B = q_rep.shape[0]
    d = d_rep.reshape(B, d_rep.shape[0] // B, d_rep.shape[-1])
    return torch.einsum("bgv,bv->bg", d.float(), q_rep.float())


def _scores_in_batch(q_rep: torch.Tensor, d_rep: torch.Tensor) -> torch.Tensor:
    """Full cross-score matrix [B, B*G] (in-batch negatives)."""
    return torch.matmul(q_rep.float(), d_rep.float().t())


def infonce_loss(q_rep, d_rep, use_in_batch_negatives: bool = False, **_) -> torch.Tensor:
    """Cross-entropy over [positive | negatives] scores; positives sit at
    stride G = d_rep.shape[0] // B (reference loss.py:89-91)."""
    B = q_rep.shape[0]
    G = d_rep.shape[0] // B
    if use_in_batch_negatives:
        scores_all = _scores_in_batch(q_rep, d_rep)  # [B, N]
        docs = torch.arange(B * G, device=q_rep.device).view(B, G)
        scores_pos = scores_all.gather(1, docs[:, :1])
        # negatives: every doc that is not a positive (any query's positive
        # is excluded for all rows, the reference mask, loss.py:94-98), in
        # doc order; index tensors, not a boolean mask, so nothing waits
        scores_neg = scores_all[:, docs[:, 1:].reshape(-1)]  # [B, N-B]
    else:
        grouped = _scores_grouped(q_rep, d_rep)  # [B, G]
        scores_pos, scores_neg = grouped[:, :1], grouped[:, 1:]
    scores = torch.cat([scores_pos, scores_neg], dim=1)
    return torch.mean(-F.log_softmax(scores, dim=1)[:, 0])


def pair_scores(q_rep, d_rep, use_in_batch_negatives: bool) -> torch.Tensor:
    """fp32 query-doc scores: [B, B*G] with in-batch negatives, else [B, G]."""
    if use_in_batch_negatives:
        return _scores_in_batch(q_rep, d_rep)
    return _scores_grouped(q_rep, d_rep)


def kldiv_loss(q_rep, d_rep, teacher_scores, use_in_batch_negatives: bool = False,
               temperature: float = 1.0, **_) -> torch.Tensor:
    """Temperature-scaled KL(teacher || student) as the reference computes it
    (loss.py:18-43): sum(q * (log q - log p)) over docs, mean over queries,
    with 0 * log(0) taken as 0."""
    student = pair_scores(q_rep, d_rep, use_in_batch_negatives)
    log_p = F.log_softmax(student / temperature, dim=1)
    q = F.softmax(teacher_scores.float() / temperature, dim=1)
    logq = torch.where(q > 0, torch.log(torch.clamp(q, min=1e-30)), 0.0)
    return torch.mean(torch.sum(q * (logq - log_p), dim=1))


def margin_mse_loss(q_rep, d_rep, teacher_scores, use_in_batch_negatives: bool = False,
                    temperature: float = 1.0, **_) -> torch.Tensor:
    """MSE between student and teacher margins to doc 0 (loss.py:46-77)."""
    student = pair_scores(q_rep, d_rep, use_in_batch_negatives) / temperature
    teacher = teacher_scores.float() / temperature

    def margins(x):
        return x[:, :1] - x[:, 1:]

    return torch.mean((margins(student) - margins(teacher)) ** 2)


@dataclass(frozen=True)
class LossSpec:
    """One configured ranking loss (reference SparseTrainingLoss + weight)."""

    kind: str
    weight: float = 1.0
    temperature: float = 1.0
    use_in_batch_negatives: bool = False

    def __call__(self, q_rep, d_rep, teacher_scores=None) -> torch.Tensor:
        fn = LOSS_FN_MAP[self.kind]
        return self.weight * fn(
            q_rep, d_rep,
            teacher_scores=teacher_scores,
            use_in_batch_negatives=self.use_in_batch_negatives,
            temperature=self.temperature,
        )


def _infonce_adapter(q_rep, d_rep, teacher_scores=None, **kw):
    return infonce_loss(q_rep, d_rep, **kw)


LOSS_FN_MAP = {
    "infonce": _infonce_adapter,
    "kldiv": kldiv_loss,
    "marginmse": margin_mse_loss,
}


def build_loss_specs(data_args) -> list[LossSpec]:
    """From config (reference train_ir.py:72-82)."""
    return [
        LossSpec(
            kind=t,
            weight=data_args.ranking_loss_weight,
            temperature=data_args.temperature,
            use_in_batch_negatives=data_args.use_in_batch_negatives,
        )
        for t in data_args.loss_types
    ]
