"""FLOPS / L0 activation regularisers and their quadratic lambda warm-up (the
port of the JAX package's `ops/flops.py`; reference trainer.py:61-79).

  * flops_value: sum_j (mean_i |w_ij|)^2, with the reps reshaped to
    [N, group, V] so the mean runs over the queries of one group slot;
  * with `flops_threshold`: only docs whose L0 length exceeds it pay;
  * get_lambda: lambda * ((step + 1) / T)^2 until step >= T.
"""

from __future__ import annotations

from typing import Optional

import torch


def flops_value(
    representation: torch.Tensor,  # [N_total, V]
    group_num: int = 1,
    flops_threshold: Optional[int] = None,
) -> torch.Tensor:
    rep = torch.abs(representation.reshape(-1, group_num, representation.shape[-1]))
    if flops_threshold is None:
        return torch.sum(torch.mean(rep, dim=0) ** 2)
    doc_length = torch.sum((rep > 0).float(), dim=2)  # [N, G] (L0 norm)
    mask = (doc_length > flops_threshold).float()[:, :, None]
    return torch.sum(torch.mean(mask * rep, dim=0) ** 2)


def get_lambda(step: int, lambda_value: Optional[float],
               lambda_T: Optional[float]) -> float:
    """Quadratic ramp lambda * ((step + 1) / T)^2, capped at lambda from step
    T on. `step` is the optimizer's step count before the update; a plain
    number, so the host computes it without touching the device."""
    if lambda_value is None or lambda_value == 0:
        return 0.0
    if lambda_T is None or lambda_T <= 0:
        return float(lambda_value)
    if step >= lambda_T:
        return float(lambda_value)
    return float(lambda_value) * ((float(step) + 1.0) / float(lambda_T)) ** 2
