"""Sparse-representation activation math as plain tensor functions (the
port of the JAX package's `ops/activations.py`).

Reference semantics (sparse_encoders.py):
  * masked max-pool over sequence + log1p(relu)        (:107-112)
  * L0-paper double log1p                              (:113-114)
  * relative-threshold pruning `prune_ratio`           (:115-119)
  * inference-free query encoding: binary bag of input
    tokens x relu(idf), special tokens zeroed          (:121-127)
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _log_prune(values: torch.Tensor, use_l0: bool,
               prune_ratio: Optional[float]) -> torch.Tensor:
    values = torch.log1p(torch.relu(values))
    if use_l0:
        values = torch.log1p(values)
    if prune_ratio is not None:
        thresh = values.amax(dim=-1, keepdim=True) * prune_ratio
        values = values * (values > thresh)
    return values


def sparse_activation(
    logits: torch.Tensor,  # [B, L, V] fp32 MLM logits
    attention_mask: torch.Tensor,  # [B, L]
    use_l0: bool = False,
    prune_ratio: Optional[float] = None,
) -> torch.Tensor:
    """Masked max-pool over the sequence axis followed by saturating logs.
    Masked positions are multiplied by 0 (not -inf) before the max."""
    masked = logits * attention_mask[:, :, None].to(logits.dtype)
    return _log_prune(masked.amax(dim=1), use_l0, prune_ratio)


def pooled_activation(
    pooled: torch.Tensor,  # [B, V] masked max-pooled logits (fp32)
    use_l0: bool = False,
    prune_ratio: Optional[float] = None,
) -> torch.Tensor:
    """The log/prune chain applied to already-pooled logits (the fused
    max-pool head path, BertForMaskedLM.mlm_maxpool)."""
    return _log_prune(pooled, use_l0, prune_ratio)


def inf_free_activation(
    input_ids: torch.Tensor,  # [B, L] int
    idf_vector: torch.Tensor,  # [V]
    special_token_mask: torch.Tensor,  # [V] bool, True at special-token ids
    vocab_size: int,
) -> torch.Tensor:
    """Inference-free query rep: binary bag-of-input-tokens x relu(idf).
    Ids outside [0, vocab_size) are dropped."""
    B = input_ids.shape[0]
    ids = input_ids.long()
    out = torch.zeros((B, vocab_size), dtype=torch.float32, device=ids.device)
    valid = (ids >= 0) & (ids < vocab_size)
    rows = torch.arange(B, device=ids.device)[:, None].expand_as(ids)
    out[rows[valid], ids[valid]] = 1.0
    out = torch.where(special_token_mask[None, :], 0.0, out)
    return out * torch.relu(idf_vector.float())[None, :]


def special_token_mask(special_token_ids: Sequence[int], vocab_size: int,
                       device: Optional[torch.device] = None) -> torch.Tensor:
    mask = torch.zeros((vocab_size,), dtype=torch.bool, device=device)
    if len(special_token_ids):
        mask[torch.as_tensor(list(special_token_ids), dtype=torch.long,
                             device=device)] = True
    return mask


def activation_count(reps: torch.Tensor) -> torch.Tensor:
    """Per-token activation counts for the FLOPS statistic
    (reference SparseEncoder count_tensor, sparse_encoders.py:178-179)."""
    return (reps > 0).sum(dim=0).to(torch.int32)
