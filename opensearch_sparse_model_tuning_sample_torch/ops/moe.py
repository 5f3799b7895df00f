"""A DeepSeekMoE expert layer's routing, permutation, expert products and
combine: the routed experts of `models/moonlight.py`.

    s = sigmoid(u · W_gᵀ)                        (fp32)
    chosen = top-k of s + b                      (b: `e_score_correction_bias`)
    w = s[chosen] / (Σ s[chosen] + 1e-20) · scale
    y = Σ_{e ∈ chosen} w_e · down_e(silu(gate_e · u) ⊙ up_e · u)

`route` gives each token its k experts and weights (plain torch ops in
fp32). `permute` sorts the token-expert rows by expert (a stable sort, so
the order inside a group is the rows' own) and finds each group's offsets
on the card with `searchsorted`, so nothing is read back to the host.
`expert_gate_up` and `expert_down` are the grouped GEMMs of `csrc/moe.cu`
on a CUDA tensor (one launch each for all the experts, the groups' offsets
read on the card; the trace names them `moe_gate_up_kernel` and
`moe_down_kernel`) and a loop over the experts on the CPU. `combine` adds
each token's k rows, weighted, in slot order, and the shared expert's
output into the fp32 residual stream (`moe_combine_kernel` on a card): no
atomics, so it is the same on every run. Nothing in a layer waits for the
card.

Spans: `encoder.moe.route` (router, top-k, weights), `encoder.moe.permute`
(the sort, the gather of the rows, the combine), `encoder.moe.experts` (the
two grouped GEMMs). Counters: `encoder.moe.rows` (token-expert rows,
counted on the host from the shapes), `moe.launches.<kernel>` and
`moe.plain_calls.<plain>`. The kernels replace no TPU kernel: the JAX
package has no expert layer.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils import tracing
from .kernel_build import library

_LAUNCH = "moe.launches."
_PLAIN = "moe.plain_calls."


def route(u: torch.Tensor, w_gate: torch.Tensor, bias: torch.Tensor, top_k: int,
          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """u [T, D] (fp32), w_gate [E, D], bias [E] -> (experts [T, k] int64, in
    the order top-k gives them, weights [T, k] fp32). The bias enters the
    choice and not the weights."""
    with tracing.span("encoder.moe.route"):
        s = torch.sigmoid(torch.matmul(u.float(), w_gate.float().t()))
        chosen = torch.topk(s + bias.float(), top_k, dim=-1).indices
        w = s.gather(1, chosen)
        return chosen, w / (w.sum(-1, keepdim=True) + 1e-20) * scale


def permute(chosen: torch.Tensor, n_experts: int):
    """chosen [T, k] -> (token of each sorted row [R] int64, offsets [E + 1]
    int32, pos [T, k] int64: the sorted row of each (token, slot)), R = T·k,
    rows sorted by expert and, inside a group, by (token, slot)."""
    flat = chosen.reshape(-1)
    order = torch.argsort(flat, stable=True)
    edges = torch.arange(n_experts + 1, device=flat.device, dtype=flat.dtype)
    offsets = torch.searchsorted(flat[order], edges).to(torch.int32)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=order.device)
    return order // chosen.shape[1], offsets, pos.view(chosen.shape)


def _groups(offsets: torch.Tensor):
    bounds = offsets.tolist()
    return [(e, bounds[e], bounds[e + 1]) for e in range(len(bounds) - 1)]


def expert_gate_up_reference(x, gate, up, offsets):
    """Plain version: per expert, silu(x·gateᵀ) ⊙ (x·upᵀ) from exact products
    of x's dtype summed in fp32, rounded to x's dtype once."""
    tracing.count(_PLAIN + "expert_gate_up_reference")
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    out = torch.empty((x.shape[0], gate.shape[1]), dtype=x.dtype, device=x.device)
    for e, a, b in _groups(offsets):
        xs = x[a:b].to(acc)
        out[a:b] = (F.silu(xs @ gate[e].to(acc).t()) * (xs @ up[e].to(acc).t())).to(x.dtype)
    return out


def expert_down_reference(h, down, offsets):
    """Plain version: per expert, h·downᵀ summed in fp32, in h's dtype."""
    tracing.count(_PLAIN + "expert_down_reference")
    acc = torch.float64 if h.dtype == torch.float64 else torch.float32
    out = torch.empty((h.shape[0], down.shape[1]), dtype=h.dtype, device=h.device)
    for e, a, b in _groups(offsets):
        out[a:b] = (h[a:b].to(acc) @ down[e].to(acc).t()).to(h.dtype)
    return out


def combine_reference(x, y, shared, pos, w):
    """Plain version: x += Σ_s w[:, s]·y[pos[:, s]] (slot order) + shared,
    in x's dtype (fp32 or float64)."""
    tracing.count(_PLAIN + "combine_reference")
    acc = torch.zeros_like(x)
    for s in range(pos.shape[1]):
        acc += w[:, s, None].to(x.dtype) * y[pos[:, s]].to(x.dtype)
    x += acc + shared.to(x.dtype)
    return x


def _lib():
    lib = library("moe")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_gate_up_bf16.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.moe_gate_up_bf16.restype = i
        lib.moe_down_bf16.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.moe_down_bf16.restype = i
        lib.moe_combine.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.moe_combine.restype = i
        lib._argtypes_set = True
    return lib


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    tracing.count(_LAUNCH + name)


def _bf16_contiguous(*ts):
    for t in ts:
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise TypeError(f"the expert kernels take contiguous bf16 tensors, got {t.dtype}")


def expert_gate_up(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """x [R, D] sorted by expert, gate and up [E, I, D], offsets [E + 1]
    int32 -> h [R, I] = silu(x·gate_eᵀ) ⊙ (x·up_eᵀ) row by row."""
    if x.device.type == "cpu":
        return expert_gate_up_reference(x, gate, up, offsets)
    _bf16_contiguous(x, gate, up)
    R, D = x.shape
    E, I, _ = gate.shape
    h = torch.empty((R, I), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().moe_gate_up_bf16(x.data_ptr(), gate.data_ptr(), up.data_ptr(),
                                     offsets.data_ptr(), h.data_ptr(), R, D, I, E, _stream(x))
    _check("moe_gate_up_kernel", rc)
    return h


def expert_down(h: torch.Tensor, down: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """h [R, I] sorted by expert, down [E, D, I] -> y [R, D] = h·down_eᵀ."""
    if h.device.type == "cpu":
        return expert_down_reference(h, down, offsets)
    _bf16_contiguous(h, down)
    R, I = h.shape
    E, D, _ = down.shape
    y = torch.empty((R, D), dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):
        rc = _lib().moe_down_bf16(h.data_ptr(), down.data_ptr(), offsets.data_ptr(),
                                  y.data_ptr(), R, I, D, E, _stream(h))
    _check("moe_down_kernel", rc)
    return y


def combine(x: torch.Tensor, y: torch.Tensor, shared: torch.Tensor, pos: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """x [T, D] fp32 += Σ_s w[:, s]·y[pos[:, s]] + shared, in place; returns x."""
    if x.device.type == "cpu":
        return combine_reference(x, y, shared, pos, w)
    _bf16_contiguous(y, shared)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("the combine adds into a contiguous fp32 residual stream")
    T, D = x.shape
    pos, w = pos.contiguous(), w.float().contiguous()
    with torch.cuda.device(x.device):
        rc = _lib().moe_combine(x.data_ptr(), y.data_ptr(), shared.data_ptr(), pos.data_ptr(),
                                w.data_ptr(), T, D, pos.shape[1], _stream(x))
    _check("moe_combine_kernel", rc)
    return x


def experts(u: torch.Tensor, x: torch.Tensor, chosen: torch.Tensor, w: torch.Tensor,
            gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
            shared: torch.Tensor) -> torch.Tensor:
    """The routed experts of the tokens u [T, D] (compute dtype) and their
    combine into the residual stream x [T, D] fp32 (in place), with the
    shared expert's output `shared` [T, D]; chosen, w from `route`."""
    T, k = chosen.shape
    tracing.count("encoder.moe.rows", T * k)
    with tracing.span("encoder.moe.permute"):
        token, offsets, pos = permute(chosen, gate.shape[0])
        rows = u.index_select(0, token)
    with tracing.span("encoder.moe.experts"):
        y = expert_down(expert_gate_up(rows, gate, up, offsets), down, offsets)
    with tracing.span("encoder.moe.permute"):
        return combine(x, y, shared, pos, w)
