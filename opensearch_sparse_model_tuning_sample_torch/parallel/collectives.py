"""Collectives: those of the data-parallel train step and those of the
device mesh inside one process (the port of the JAX package's
`parallel/collectives.py`).

The reference's whole custom comm surface is `gather_rep`: an all-gather
along the batch dim whose backward keeps only this rank's slice of the
gradient (scripts/utils.py:16-23), plus a loss rescale for DDP's mean. Here
the gather is an autograd Function with exactly that backward, and the
gradients are summed (not averaged) over ranks in one flattened bucket, so
the update is the gradient of the global-batch loss, as JAX's jitted global
step computes it. Each function counts its calls (the counter
`collectives.<name>` of `utils/tracing.py`), so a run can show that its
step went through them.

Over the mesh of one process (`core/mesh.py`) a collective is a copy to the
mesh's first device: `merged_topk` merges the shards' top-k lists there
(the sharded index's merge), and `global_batch_fn` runs a function on the
gathered global batch on every device. The trainer's step over the mesh
gathers the positions' reps with `mesh_gather` (autograd carries each
position's slice of the gradient back through the copy), adds the
replicas' gradients onto the lead's with `mesh_grad_sum`, and copies the
updated parameters back out with `mesh_broadcast`: the in-process
counterparts of `all_gather_batch` and `all_reduce_grads`.
"""

from __future__ import annotations

import inspect
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..core.mesh import shard_rows
from ..utils import tracing


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
    tracing.count("collectives.all_gather_batch")
    return _AllGatherBatch.apply(x)



def all_reduce_grads(params: List[torch.Tensor]) -> None:
    """Sum every parameter's gradient over the ranks, in one flattened
    bucket (a parameter without a gradient contributes zeros, so the
    buckets line up on every rank)."""
    tracing.count("collectives.all_reduce_grads")
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    for g, reduced in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(reduced)



def mesh_gather(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The positions' tensors concatenated along dim 0 on `device` (the
    mesh's first), in position order. Differentiable: the copy and the
    concatenation send each position its rows of the gradient."""
    tracing.count("collectives.mesh_gather")
    return torch.cat([p.to(device) for p in parts])



def _flat_grads(params: Sequence[torch.Tensor]) -> torch.Tensor:
    return _flatten_dense_tensors([p.grad if p.grad is not None else torch.zeros_like(p)
                                   for p in params])


def mesh_grad_sum(lead: List[torch.Tensor], replicas: Sequence[Sequence[torch.Tensor]]) -> None:
    """Add each replica's gradients onto the lead's (the parameters of
    position 0), in position order, in one flattened bucket a replica; the
    replicas' gradients are then dropped. `replicas[r][i]` is the
    parameter `lead[i]` of position r + 1. A parameter that no position
    gave a gradient keeps none, as on one device."""
    tracing.count("collectives.mesh_grad_sum")
    on = [i for i, p in enumerate(lead)
          if p.grad is not None or any(r[i].grad is not None for r in replicas)]
    flat = _flat_grads([lead[i] for i in on])
    for params in replicas:
        flat += _flat_grads([params[i] for i in on]).to(flat.device)
        for p in params:
            p.grad = None
    for i, g in zip(on, _unflatten_dense_tensors(flat, [lead[i] for i in on])):
        lead[i].grad = g



@torch.no_grad()
def mesh_broadcast(lead: List[torch.Tensor], replicas: Sequence[Sequence[torch.Tensor]]) -> None:
    """Copy the lead's parameters onto every replica's, bit for bit (one
    flattened bucket, one copy to each replica's device)."""
    tracing.count("collectives.mesh_broadcast")
    flat = _flatten_dense_tensors([p.detach() for p in lead])
    for params in replicas:
        on_dev = flat.to(params[0].device)
        torch._foreach_copy_(list(params), list(_unflatten_dense_tensors(on_dev, params)))



def merged_topk(scores: Sequence[torch.Tensor], indices: Sequence[torch.Tensor], k: int):
    """The global top-k of per-shard [B, k] top-k lists (scores and global
    ids): the shards' lists concatenated in shard order on the first
    shard's device (the all-gather's counterpart), then a stable top-k, so
    that ties go to the lower shard (the lower global doc id), as
    `lax.top_k` over JAX's concatenation keeps them. Counts its calls
    (`collectives.merged_topk`)."""
    from ..index.engine import _select

    tracing.count("collectives.merged_topk")
    dev = scores[0].device
    cat_s = torch.cat([s.to(dev) for s in scores], dim=1)
    cat_i = torch.cat([i.to(dev) for i in indices], dim=1)
    return _select(cat_s, cat_i, k)



def _cat_outputs(outs, dev):
    """Per-device outputs (tensors, or tuples of them) concatenated on dim
    0 on `dev`, leaf by leaf."""
    if isinstance(outs[0], (tuple, list)):
        return type(outs[0])(_cat_outputs([o[j] for o in outs], dev) for j in range(len(outs[0])))
    return torch.cat([o.to(dev) for o in outs])


def global_batch_fn(fn, mesh, *, replicated_out: bool = True, n_args: Optional[int] = None):
    """Wrap `fn(global arrays...) -> out` so that every device of the mesh
    runs it on the gathered global batch: each argument's rows are sharded
    over the mesh and gathered back on every device. With `replicated_out`
    the call returns the first device's output (every device computed the
    same); otherwise the devices' outputs concatenated on dim 0 on the
    first device, as JAX's out spec P("data") assembles them. Pass `n_args`
    for callables whose positional arity `inspect.signature` cannot see."""
    if n_args is None:
        params = inspect.signature(fn).parameters.values()
        if any(p.kind == p.VAR_POSITIONAL for p in params):
            raise TypeError("global_batch_fn needs an explicit n_args for *args callables")
        n_args = sum(p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD) for p in params)

    def wrapped(*args):
        if len(args) != n_args:
            raise TypeError(f"global_batch_fn: {len(args)} arguments for n_args={n_args}")
        shards = [shard_rows(mesh, a) for a in args]
        # with a replicated output every device computes the same value:
        # the first one's is the result
        devices = mesh.devices[:1] if replicated_out else mesh.devices
        outs = [fn(*[torch.cat([s.to(dev) for s in sh]) for sh in shards]) for dev in devices]
        return outs[0] if replicated_out else _cat_outputs(outs, mesh.devices[0])

    return wrapped


_GROUP_TRAIN = ("all_gather_batch", "all_reduce_grads")
_MESH_TRAIN = ("mesh_gather", "mesh_grad_sum", "mesh_broadcast")


def _calls(names) -> dict:
    c = tracing.counters()
    return {n: c.get("collectives." + n, 0) for n in names}


def counts() -> dict:
    """The calls of the process group's two train-step collectives."""
    return _calls(_GROUP_TRAIN)


def mesh_counts() -> dict:
    """The calls of the in-process mesh's three train-step collectives."""
    return _calls(_MESH_TRAIN)


def reset_counts() -> None:
    """Set counts() and mesh_counts() back to 0."""
    tracing.reset("collectives." + n for n in _GROUP_TRAIN + _MESH_TRAIN)
