"""The plain reference Moonlight-16B-A3B encoder (HF `deepseek_v3`): the
decoder's forward in float32 and the sparse head (the LM head's logits, the
max over the doc's positions, log1p(relu)), in plain torch ops.

It follows the published model (DeepSeek-V3, arXiv:2412.19437; HF's
`modeling_deepseek_v3.py` at Moonlight's config.json): token embeddings;
27 pre-norm layers, RMSNorm (eps 1e-5) before attention and before the
feed-forward; MLA with no q compression: q = a W_qᵀ split per head into
q_nope (128) and q_rope (64); [c, k_r] = a W_kv_aᵀ; [k_nope, v] =
RMSNorm(c) W_kv_bᵀ per head; RoPE (θ 50 000, no scaling) on q_rope and on
the one k_r that all heads share, in DeepSeek's pair layout (HF's
`apply_rotary_pos_emb_interleave`: the dims de-interleaved, then rotated
half against half); softmax(q kᵀ / √192) v over the keys at or before the
query; layer 0's SwiGLU of 11 264; layers 1-26's DeepSeekMoE: s =
sigmoid(u W_gᵀ) in float32, the top 6 of s + b, weights s over the chosen,
over their sum (+ 1e-20), times 2.446, each chosen expert's SwiGLU of 1 408
weighted, plus the shared experts' SwiGLU of 2 816; the final RMSNorm; the
untied head with no bias. Nothing here comes from the program.

Departures from the published model: each doc runs alone at its own length
(its positions 0..n-1; the program's padding is after the last live token
and causal attention never reaches it); attention is dense with an explicit
causal mask, a few heads at a time; every expert is computed for the tokens
routed to it, in a plain loop over the experts, and the weighted outputs
are summed in expert order (HF sums in the same way); the head is computed
a doc at a time with a max over its positions (HF has no max-pool: this is
the sparse encoder's head). The weights are drawn again one layer at a
time (`weights_moonlight.draw`: the same values the program holds, in
float32), so that the reference fits on the card beside nothing else.

`precision="fp8"` is the control: every matrix product's operands are
rounded to float8 e4m3 with one scale a tensor (`reference/bert.py`'s
rounding), the router's too. TF32 is off.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from .bert import _F8MatMul, set_precision


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [H, n, d]: DeepSeek's pair layout (de-interleave, rotate-half),
    positions 0..n-1."""
    H, n, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.int64, device=x.device).float() / d))
    freqs = torch.outer(torch.arange(n, device=x.device, dtype=torch.float32), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    x = x.view(H, n, d // 2, 2).transpose(-1, -2).reshape(H, n, d)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * emb.cos() + rot * emb.sin()


class Encoder:
    """m: `weights_moonlight.model_keys`; weights(names) -> {name: float32
    tensor} for a list of (name, shape)."""

    def __init__(self, m: dict, weights: Callable, layer_shapes: Callable, outer_shapes: Callable,
                 precision: str = "fp32", heads_at_once: int = 4):
        set_precision()
        self.m = m
        self.weights = weights
        self.layer_shapes, self.outer_shapes = layer_shapes, outer_shapes
        self.fp8 = precision == "fp8"
        self.heads_at_once = heads_at_once

    def mm(self, a, b):
        return _F8MatMul.apply(a, b) if self.fp8 else torch.matmul(a, b)

    def lin(self, x, w):
        return self.mm(x, w.t())

    def swiglu(self, u, gate, up, down):
        return self.lin(F.silu(self.lin(u, gate)) * self.lin(u, up), down)

    def attend(self, a: torch.Tensor, w: Dict[str, torch.Tensor], p: str) -> torch.Tensor:
        """One doc's attention block: a [n, D] (normed) -> [n, D]."""
        m = self.m
        n = a.shape[0]
        H, nope, rd, vd = (m["num_attention_heads"], m["qk_nope_head_dim"],
                           m["qk_rope_head_dim"], m["v_head_dim"])
        q = self.lin(a, w[p + "self_attn.q_proj"]).view(n, H, nope + rd).transpose(0, 1)
        ckv = self.lin(a, w[p + "self_attn.kv_a_proj_with_mqa"])
        c, k_r = ckv[:, : m["kv_lora_rank"]], ckv[:, m["kv_lora_rank"]:]
        kv = self.lin(rms(c, w[p + "self_attn.kv_a_layernorm"], m["rms_norm_eps"]),
                      w[p + "self_attn.kv_b_proj"]).view(n, H, nope + vd).transpose(0, 1)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], m["rope_theta"])], dim=-1)
        k_r = rope(k_r.view(1, n, rd), m["rope_theta"]).expand(H, n, rd)
        k = torch.cat([kv[..., :nope], k_r], dim=-1)
        v = kv[..., nope:]
        causal = torch.ones((n, n), dtype=torch.bool, device=a.device).tril()
        bias = torch.where(causal, 0.0, torch.finfo(torch.float32).min)
        out = torch.empty((H, n, vd), device=a.device)
        for h0 in range(0, H, self.heads_at_once):
            hs = slice(h0, h0 + self.heads_at_once)
            logits = self.mm(q[hs], k[hs].transpose(-1, -2)) / math.sqrt(nope + rd)
            out[hs] = self.mm(torch.softmax(logits + bias, dim=-1), v[hs])
        return self.lin(out.transpose(0, 1).reshape(n, H * vd), w[p + "self_attn.o_proj"])

    def route(self, u: torch.Tensor, w: Dict[str, torch.Tensor], p: str):
        """u [N, D] -> (chosen [N, k], weights [N, k]): sigmoid scores, the
        top k of scores + b, the chosen scores normalised and scaled."""
        m = self.m
        s = torch.sigmoid(self.lin(u, w[p + "mlp.gate.weight"]))
        chosen = torch.topk(s + w[p + "mlp.gate.e_score_correction_bias"],
                            m["num_experts_per_tok"], dim=-1).indices
        wt = s.gather(1, chosen)
        return chosen, wt / (wt.sum(-1, keepdim=True) + 1e-20) * m["routed_scaling_factor"]

    def moe(self, u: torch.Tensor, w: Dict[str, torch.Tensor], p: str):
        """u [N, D] -> (the layer's output [N, D], chosen [N, k])."""
        chosen, wt = self.route(u, w, p)
        out = self.swiglu(u, w[p + "mlp.shared_experts.gate_proj"],
                          w[p + "mlp.shared_experts.up_proj"],
                          w[p + "mlp.shared_experts.down_proj"])
        gate, up, down = (w[p + "mlp.experts." + k] for k in ("gate_proj", "up_proj", "down_proj"))
        for e in range(self.m["n_routed_experts"]):
            tok, slot = torch.nonzero(chosen == e, as_tuple=True)
            if tok.numel():
                y = self.swiglu(u[tok], gate[e], up[e], down[e])
                out.index_add_(0, tok, wt[tok, slot, None] * y)
        return out, chosen

    def layer(self, i: int, x: torch.Tensor, bounds: List[int], w: Dict[str, torch.Tensor]):
        """Layer i over x [N, D] (the docs' tokens in order, doc j at
        bounds[j]:bounds[j + 1]) with its weights w -> (its output, the
        chosen experts [N, k], or None for a dense layer)."""
        m, p = self.m, f"layers.{i}."
        eps = m["rms_norm_eps"]
        a = rms(x, w[p + "input_layernorm"], eps)
        x = x + torch.cat([self.attend(a[s:e], w, p) for s, e in zip(bounds, bounds[1:])])
        u = rms(x, w[p + "post_attention_layernorm"], eps)
        if i < m["first_k_dense_replace"]:
            return x + self.swiglu(u, w[p + "mlp.gate_proj"], w[p + "mlp.up_proj"],
                                   w[p + "mlp.down_proj"]), None
        out, chosen = self.moe(u, w, p)
        return x + out, chosen

    def layer_weights(self, i: int) -> Dict[str, torch.Tensor]:
        return self.weights(self.layer_shapes(self.m, i))

    def head_reps(self, x: torch.Tensor, bounds: List[int], outer=None) -> torch.Tensor:
        """The final norm and the head over x [N, D] (the last layer's
        output) -> reps [n_docs, V]: the max over each doc's positions of
        the logits, through log1p(relu)."""
        outer = outer or self.weights([s for s in self.outer_shapes(self.m)
                                       if s[0] != "embed_tokens"])
        h = rms(x, outer["norm"], self.m["rms_norm_eps"])
        head = outer["lm_head"]
        reps = torch.stack([self.mm(h[s:e], head.t()).amax(0) for s, e in zip(bounds, bounds[1:])])
        return torch.log1p(torch.relu(reps))

    def run(self, docs: List[torch.Tensor]) -> Tuple[torch.Tensor, List[torch.Tensor], list]:
        """docs: each doc's live token ids [n_i] -> (reps [n_docs, V], the
        chosen experts of every expert layer ([N, k] over the docs' tokens
        in order), each layer's input and the last one's output [N, D])."""
        bounds = [0]
        for d in docs:
            bounds.append(bounds[-1] + int(d.numel()))
        outer = self.weights(self.outer_shapes(self.m))
        x = outer.pop("embed_tokens")[torch.cat(docs).long()]
        routes, xs = [], [x]
        for i in range(self.m["num_hidden_layers"]):
            x, chosen = self.layer(i, x, bounds, self.layer_weights(i))
            xs.append(x)
            if chosen is not None:
                routes.append(chosen)
        return self.head_reps(x, bounds, outer), routes, xs
