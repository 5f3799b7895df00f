"""The plain reference of one recipe step: InfoNCE with in-batch negatives
plus the FLOPS regulariser on the docs, the gradient by autograd in
float32, global-norm clipping when the recipe sets it, and AdamW with the
linear warm-up schedule, written out by hand.

The loss is the reference recipe's (opensearch-sparse-model-tuning-sample
`loss.py` InfoNCE, `trainer.py` FLOPS with lambda * ((step + 1) / T)^2):
each query's positive against every hard negative of the batch, docs laid
out group-major [q0_pos, q0_neg1, q0_neg2, q1_pos, ...]. AdamW is torch's
(Loshchilov & Hutter): decay p *= 1 - lr * wd, then the bias-corrected
moments; the first update runs at lr(0).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F


def lr_factor(step: int, warmup: int, total: int) -> float:
    if step < warmup:
        return step / max(warmup, 1)
    return max(0.0, (total - step) / max(total - warmup, 1))


def flops_lambda(step: int, lam: float, T: float) -> float:
    if not lam:
        return 0.0
    if T <= 0 or step >= T:
        return float(lam)
    return float(lam) * ((step + 1.0) / T) ** 2


def recipe_loss(q: torch.Tensor, d: torch.Tensor, step: int, recipe: dict) -> torch.Tensor:
    """q [B, V] inference-free queries, d [B * G, V] docs."""
    B = q.shape[0]
    G = d.shape[0] // B
    scores = q @ d.t()  # [B, B * G]
    docs = torch.arange(B * G, device=q.device).view(B, G)
    pos = scores.gather(1, docs[:, :1])
    neg = scores[:, docs[:, 1:].reshape(-1)]
    nll = -F.log_softmax(torch.cat([pos, neg], dim=1), dim=1)[:, 0]
    ranking = nll.mean() * float(recipe.get("ranking_loss_weight", 1.0))
    flops = (d.abs().reshape(-1, G, d.shape[-1]).mean(dim=0) ** 2).sum()
    return ranking + flops * flops_lambda(step, recipe["flops_d_lambda"], recipe["flops_d_T"])


class AdamW:
    """`state`: the step count and the two moments to start from (None: a
    fresh optimizer)."""

    def __init__(self, params: Dict[str, torch.Tensor], recipe: dict, state=None):
        self.p = params
        self.lr = float(recipe["learning_rate"])
        self.wd = float(recipe["weight_decay"])
        self.warmup, self.total = int(recipe["warmup_steps"]), int(recipe["max_steps"])
        self.clip = recipe.get("max_grad_norm")
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        if state is None:
            state = {"step": 0, "m": {}, "v": {}}
        self.m = {k: state["m"].get(k, torch.zeros_like(v)).to(v.device).clone()
                  for k, v in params.items()}
        self.v = {k: state["v"].get(k, torch.zeros_like(v)).to(v.device).clone()
                  for k, v in params.items()}
        self.t = int(state["step"])

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        if self.clip:
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
            scale = min(1.0, float(self.clip) / (float(norm) + 1e-6))
            grads = {k: g * scale for k, g in grads.items()}
        lr = self.lr * lr_factor(self.t, self.warmup, self.total)
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.p.items():
            g = grads[k]
            p.mul_(1 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(self.m[k] / c1, (self.v[k] / c2).sqrt_().add_(self.eps), value=-lr)


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: Sequence[str]) -> List[float]:
    """Per leaf |‖prog‖ - ‖ref‖| over max(‖ref leaf‖, median ‖ref leaf‖)."""
    rn = {k: float(ref[k].double().norm()) for k in names}
    med = float(torch.tensor(sorted(rn.values())).median())
    return [abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med, 1e-30)
            for k in names]
