"""A DeepSeekMoE expert layer's routing, permutation, expert products and
combine: the routed experts of `models/moonlight.py` (every expert held) and
of `models/kimi_linear.py` (one card's share of an expert-parallel layer).

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
read on the card, the gate-up reading each row's token in place, so no row
is gathered; the trace names them `moe_gate_up_kernel` and
`moe_down_kernel`) and a loop over the experts on the CPU. `combine` adds
each token's k rows, weighted, in slot order, and the shared expert's
output into the fp32 residual stream (`moe_combine_kernel` on a card): no
atomics, so it is the same on every run. Nothing in a layer waits for the
card.

A layer holds experts first .. first + E_held - 1 of the router's experts,
stacked [E_held, ...] (Moonlight all of them, Kimi Linear one card's share
of an expert-parallel layer). The router scores all of them and takes its
top k; `permute` sorts the rows of experts not held past the held groups
(offsets[E_held] is the count of held rows, on the card) and marks their
(token, slot) -1, so no row of an absent expert is read or computed, and
the combine adds the held rows alone. What the absent experts would add is
left out, as on a card of an expert-parallel deployment before its
exchange.

Spans: `encoder.moe.route` (router, top-k, weights), `encoder.moe.permute`
(the sort, the combine), `encoder.moe.experts` (the two grouped GEMMs).
Counters: `encoder.moe.rows` (token-expert rows routed, held or not,
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


def permute(chosen: torch.Tensor, n_experts: int, first: int = 0):
    """chosen [T, k] -> (token of each sorted row [R] int64, offsets [E + 1]
    int32, pos [T, k] int64: the sorted row of each (token, slot)), R = T·k,
    rows sorted by expert and, inside a group, by (token, slot). The E =
    n_experts groups are experts first .. first + E - 1; the rows of any
    other expert sort after them (offsets[E] counts the held rows) and their
    pos is -1."""
    flat = chosen.reshape(-1) - first
    flat = torch.where((flat >= 0) & (flat < n_experts), flat, n_experts)
    order = torch.argsort(flat, stable=True)
    edges = torch.arange(n_experts + 1, device=flat.device, dtype=flat.dtype)
    offsets = torch.searchsorted(flat[order], edges).to(torch.int32)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=order.device)
    pos = torch.where(flat == n_experts, -1, pos)
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
    """Plain version: x += Σ_s w[:, s]·y[pos[:, s]] (slot order, the slots
    whose pos is -1 left out) + shared, in x's dtype (fp32 or float64)."""
    tracing.count(_PLAIN + "combine_reference")
    acc = torch.zeros_like(x)
    for s in range(pos.shape[1]):
        p = pos[:, s]
        term = w[:, s, None].to(x.dtype) * y[p.clamp_min(0)].to(x.dtype)
        acc += torch.where(p[:, None] >= 0, term, 0.0)
    x += acc + shared.to(x.dtype)
    return x


def _lib():
    lib = library("moe")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_gate_up_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
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


def expert_gate_up(u: torch.Tensor, token: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """u [T, D] the tokens, token [R] the token of each row sorted by
    expert, gate and up [E, I, D], offsets [E + 1] int32 -> h [R, I] =
    silu(u[token[r]]·gate_eᵀ) ⊙ (u[token[r]]·up_eᵀ) row by row, each row's
    token read in place; rows past offsets[E] not written."""
    if u.device.type == "cpu":
        return expert_gate_up_reference(u.index_select(0, token), gate, up, offsets)
    _bf16_contiguous(u, gate, up)
    R, (E, I, D) = token.shape[0], gate.shape
    token = token.contiguous()
    h = torch.empty((R, I), dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        rc = _lib().moe_gate_up_bf16(u.data_ptr(), token.data_ptr(), gate.data_ptr(),
                                     up.data_ptr(), offsets.data_ptr(), h.data_ptr(), R, D, I, E,
                                     _stream(u))
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
            shared: torch.Tensor, first: int = 0) -> torch.Tensor:
    """The routed experts of the tokens u [T, D] (compute dtype) and their
    combine into the residual stream x [T, D] fp32 (in place), with the
    shared expert's output `shared` [T, D]; chosen, w from `route`. gate,
    up and down stack the experts held, first .. first + E - 1 of the
    router's."""
    T, k = chosen.shape
    E = gate.shape[0]
    tracing.count("encoder.moe.rows", T * k)
    with tracing.span("encoder.moe.permute"):
        token, offsets, pos = permute(chosen, E, first)
    with tracing.span("encoder.moe.experts"):
        y = expert_down(expert_gate_up(u, token, gate, up, offsets), down, offsets)
    with tracing.span("encoder.moe.permute"):
        return combine(x, y, shared, pos, w)
