"""Collectives of the data-parallel train step (the port of the JAX
package's `parallel/collectives.py::all_gather_batch`).

The reference's whole custom comm surface is `gather_rep`: an all-gather
along the batch dim whose backward keeps only this rank's slice of the
gradient (scripts/utils.py:16-23), plus a loss rescale for DDP's mean. Here
the gather is an autograd Function with exactly that backward, and the
gradients are summed (not averaged) over ranks in one flattened bucket, so
the update is the gradient of the global-batch loss, as JAX's jitted global
step computes it. Each function counts its calls (`.calls`), so a run can
show that its step went through them.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


class _AllGatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        world = dist.get_world_size()
        ctx.rank, ctx.n = dist.get_rank(), x.shape[0]
        x = x.contiguous()
        out = x.new_empty((world * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
        return out

    @staticmethod
    def backward(ctx, grad):
        # this rank's rows of the incoming gradient: each rank's loss is the
        # same global loss, so the ranks' slices together are its gradient
        return grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n]


def all_gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's `x` along dim 0, in rank order (JAX's
    process-major device order, so in-batch labels name the same global
    rows). Differentiable: the backward is this rank's slice of the
    gradient. Under no_grad it gathers teacher scores or reps."""
    all_gather_batch.calls += 1
    return _AllGatherBatch.apply(x)


all_gather_batch.calls = 0


def all_reduce_grads(params: List[torch.Tensor]) -> None:
    """Sum every parameter's gradient over the ranks, in one flattened
    bucket (a parameter without a gradient contributes zeros, so the
    buckets line up on every rank)."""
    all_reduce_grads.calls += 1
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    for g, reduced in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(reduced)


all_reduce_grads.calls = 0


def counts() -> dict:
    return {"all_gather_batch": all_gather_batch.calls,
            "all_reduce_grads": all_reduce_grads.calls}


def reset_counts() -> None:
    all_gather_batch.calls = 0
    all_reduce_grads.calls = 0
