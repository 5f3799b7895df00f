"""The plain reference Kimi-Linear-48B-A3B encoder (HF `kimi_linear`): the
hybrid decoder's forward in float32 and the sparse head (the LM head's
logits, the max over the doc's positions, log1p(relu)), in plain torch ops.

It follows the published model (Kimi Linear, arXiv:2510.26692; the
config.json of moonshotai/Kimi-Linear-48B-A3B-Instruct; the KDA layer as
flash-linear-attention's `fla/layers/kda.py` writes it): token embeddings;
27 pre-norm layers, RMSNorm (eps 1e-5) before the mixer and before the
feed-forward. A KDA layer (the 20 of `linear_attn_config.kda_layers`,
numbered from 1), per head of dk = dv = 128, on u = RMSNorm(x): q, k, v =
SiLU(causal depthwise conv of width 4 (u W_q|k|vᵀ)), q and k divided by
sqrt(‖·‖² + 1e-6), q times dk^-1/2; g = −exp(A_log[h]) softplus(u W_faᵀ
W_fbᵀ + dt_bias); β = sigmoid(u W_bᵀ); S_t = (I − β_t k_t k_tᵀ) Diag(exp
g_t) S_{t−1} + β_t k_t v_tᵀ from S = 0, o_t = S_tᵀ q_t; x += (RMSNorm(o)
w_norm sigmoid(u W_gaᵀ W_gbᵀ)) W_oᵀ. An MLA layer (the other 7): q = a W_qᵀ
per head [q_nope 128, q_pe 64]; [c, k_pe] = a W_kv_aᵀ; [k_nope, v] =
RMSNorm(c) W_kv_bᵀ; no rotation (`mla_use_nope`); k = [k_nope, k_pe], the
one k_pe shared by all heads; softmax(q kᵀ / √192) v over the keys at or
before the query. Layer 0's SwiGLU of 9 216; layers 1-26's experts: s =
sigmoid(u W_gᵀ), the top 8 of s + b, weights s over the chosen, over their
sum (+ 1e-20), times 2.446, each chosen expert's SwiGLU of 1 024 weighted,
plus the shared expert's SwiGLU; the final RMSNorm; the untied head.
Nothing here comes from the program.

KDA is written twice: `kda_recurrent`, token by token (the definition),
and `kda_chunked`, the exact restatement by chunks of 64 (inside a chunk,
with Γ the running sum of g: A_ij = Σ_c k_ic k_jc exp(Γ_ic − Γ_jc) for i >
j, T = (I + Diag(β) A)⁻¹, W = T Diag(β)(v − exp(Γ) k S), o = exp(Γ) q S +
P W with P_ij = Σ_c q_ic k_jc exp(Γ_ic − Γ_jc) for i ≥ j, and the state
carried to the chunk's end), looped over chunks and vectorised over docs
and heads, which is what runs on the card.

Departures from the published model, each noted: the docs run together
padded on the right (their positions 0..n−1; padding after a doc never
reaches it, as every mixer is causal); MLA is dense with an explicit causal
mask, a few heads and a block of queries at a time, so 32k positions fit;
the experts are computed for the tokens routed to them in a plain loop, for
the experts held (`held` = (first, count)), the router's choice and weights
over all of them: what the other experts would add is left out, as the
program leaves it out (the deployment's other card adds it); with held =
(0, all) it is the uncut layer; the head is a max over each doc's positions
(the sparse encoder's head). The weights are drawn again one layer at a
time (`weights_kimi_linear.draw`: the values the program holds, in
float32).

`precision="fp8"` is the control: every matrix product's operands are
rounded to float8 e4m3 with one scale a tensor (`reference/bert.py`'s
rounding), the router's and KDA's chunk products (W, o, the state) too.
TF32 is off.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .bert import _F8MatMul, set_precision


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def kda_recurrent(q, k, v, g, beta, scale):
    """The definition, one token at a time: q, k, g [B, L, H, dk], v [B, L,
    H, dv], beta [B, L, H] -> o [B, L, H, dv] (the inputs' float type)."""
    B, L, H, dk = q.shape
    S = q.new_zeros((B, H, dk, v.shape[-1]))
    out = q.new_empty((B, L, H, v.shape[-1]))
    for t in range(L):
        kt, bt = k[:, t], beta[:, t, :, None, None]
        S = g[:, t].exp()[..., None] * S
        S = S - bt * kt[..., None] * (kt[..., None, :] @ S)
        S = S + bt * kt[..., None] * v[:, t, :, None, :]
        out[:, t] = (S.transpose(-1, -2) @ (q[:, t] * scale)[..., None])[..., 0]
    return out


def kda_chunked(q, k, v, g, beta, scale, chunk: int = 64, mm: Callable = torch.matmul):
    """The same by chunks (module docstring), vectorised over docs and
    heads; `mm` takes the chunk's matrix products (W, o and the state's)."""
    B, L, H, dk = q.shape
    dv = v.shape[-1]
    pad = (-L) % chunk

    def heads(t):
        t = t.transpose(1, 2)
        return F.pad(t, (0, 0, 0, pad)) if pad else t

    qh, kh, vh, gh = heads(q * scale), heads(k), heads(v), heads(g)
    bh = heads(beta[..., None])[..., 0]
    S = q.new_zeros((B, H, dk, dv))
    out = q.new_empty((B, H, L + pad, dv))
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    eye = torch.eye(chunk, dtype=q.dtype, device=q.device)
    for s in range(0, L + pad, chunk):
        c = slice(s, s + chunk)
        qc, kc, vc, bc = qh[:, :, c], kh[:, :, c], vh[:, :, c], bh[:, :, c]
        G = gh[:, :, c].cumsum(2)
        e = torch.where(causal[..., None], G[:, :, :, None] - G[:, :, None], -math.inf).exp()
        A = torch.einsum("bhic,bhjc,bhijc->bhij", kc, kc, e).tril(-1)
        P = torch.einsum("bhic,bhjc,bhijc->bhij", qc, kc, e)
        T = torch.linalg.solve_triangular(eye + bc[..., None] * A, eye.expand_as(A), upper=False,
                                          unitriangular=True)
        W = mm(T * bc[..., None, :], vc - mm(G.exp() * kc, S))
        out[:, :, c] = mm(G.exp() * qc, S) + mm(P, W)
        S = G[:, :, -1, :, None].exp() * S + mm(((G[:, :, -1:] - G).exp() * kc).transpose(-1, -2),
                                                W)
    return out[:, :, :L].transpose(1, 2)


class Encoder:
    """m: `weights_kimi_linear.model_keys`; weights(names) -> {name: float32
    tensor} for a list of (name, shape). `held` = (first, count): the
    experts computed (the program's share by default)."""

    def __init__(self, m: dict, weights: Callable, layer_shapes: Callable, outer_shapes: Callable,
                 precision: str = "fp32", heads_at_once: int = 8, query_block: int = 1024,
                 held: Optional[Tuple[int, int]] = None):
        set_precision()
        self.m = m
        self.weights = weights
        self.layer_shapes, self.outer_shapes = layer_shapes, outer_shapes
        self.fp8 = precision == "fp8"
        self.heads_at_once, self.query_block = heads_at_once, query_block
        self.held = held or (m["experts_first"], m["num_experts"])

    def mm(self, a, b):
        return _F8MatMul.apply(a, b) if self.fp8 else torch.matmul(a, b)

    def lin(self, x, w):
        return self.mm(x, w.t())

    def swiglu(self, u, gate, up, down):
        return self.lin(F.silu(self.lin(u, gate)) * self.lin(u, up), down)

    def kda(self, a: torch.Tensor, bounds: List[int], w: Dict[str, torch.Tensor], p: str):
        """The KDA block over the docs' tokens a [N, D] (normed) -> [N, D]:
        the docs padded on the right into one batch."""
        m, p = self.m, p + "self_attn."
        H, d, K = m["kda_num_heads"], m["kda_head_dim"], m["short_conv_kernel_size"]
        lens = [e - s for s, e in zip(bounds, bounds[1:])]
        n = max(lens)
        batch = a.new_zeros((len(lens), n, a.shape[-1]))
        for i, (s, e) in enumerate(zip(bounds, bounds[1:])):
            batch[i, : e - s] = a[s:e]
        live = torch.arange(n, device=a.device)[None] < torch.tensor(lens, device=a.device)[:, None]

        def conv(x, wc):  # causal depthwise, zeros before position 0
            xp = F.pad(x.transpose(1, 2), (K - 1, 0))
            return F.conv1d(xp, wc[:, None, :], groups=wc.shape[0]).transpose(1, 2)

        def heads(x):
            return x.reshape(len(lens), n, H, d)

        q = heads(F.silu(conv(self.lin(batch, w[p + "q_proj"]), w[p + "q_conv1d"])))
        k = heads(F.silu(conv(self.lin(batch, w[p + "k_proj"]), w[p + "k_conv1d"])))
        v = heads(F.silu(conv(self.lin(batch, w[p + "v_proj"]), w[p + "v_conv1d"])))
        q = q / torch.sqrt(q.pow(2).sum(-1, keepdim=True) + 1e-6)
        k = k / torch.sqrt(k.pow(2).sum(-1, keepdim=True) + 1e-6)
        f = self.lin(self.lin(batch, w[p + "f_a_proj"]), w[p + "f_b_proj"]) + w[p + "dt_bias"]
        g = heads(-torch.exp(w[p + "A_log"]).repeat_interleave(d) * F.softplus(f))
        beta = torch.sigmoid(self.lin(batch, w[p + "b_proj"]))
        o = kda_chunked(q, k, v, g, beta, d ** -0.5, mm=self.mm)
        gate = heads(self.lin(self.lin(batch, w[p + "g_a_proj"]), w[p + "g_b_proj"]))
        o = rms(o, w[p + "o_norm"], m["rms_norm_eps"]) * torch.sigmoid(gate)
        out = self.lin(o.reshape(len(lens), n, H * d), w[p + "o_proj"])
        return out[live]

    def mla(self, a: torch.Tensor, w: Dict[str, torch.Tensor], p: str) -> torch.Tensor:
        """One doc's MLA block: a [n, D] (normed) -> [n, D]."""
        m, p = self.m, p + "self_attn."
        n = a.shape[0]
        H, nope, rd, vd = (m["num_attention_heads"], m["qk_nope_head_dim"],
                           m["qk_rope_head_dim"], m["v_head_dim"])
        q = self.lin(a, w[p + "q_proj"]).view(n, H, nope + rd).transpose(0, 1)
        ckv = self.lin(a, w[p + "kv_a_proj_with_mqa"])
        c, k_pe = ckv[:, : m["kv_lora_rank"]], ckv[:, m["kv_lora_rank"]:]
        kv = self.lin(rms(c, w[p + "kv_a_layernorm"], m["rms_norm_eps"]),
                      w[p + "kv_b_proj"]).view(n, H, nope + vd).transpose(0, 1)
        k = torch.cat([kv[..., :nope], k_pe.view(1, n, rd).expand(H, n, rd)], dim=-1)
        v = kv[..., nope:]
        out = torch.empty((H, n, vd), device=a.device)
        pos = torch.arange(n, device=a.device)
        for q0 in range(0, n, self.query_block):
            q1 = min(q0 + self.query_block, n)
            bias = torch.where(pos[None, :q1] <= pos[q0:q1, None], 0.0,
                               torch.finfo(torch.float32).min)
            for h0 in range(0, H, self.heads_at_once):
                hs = slice(h0, h0 + self.heads_at_once)
                logits = self.mm(q[hs, q0:q1], k[hs, :q1].transpose(-1, -2)) / math.sqrt(nope + rd)
                out[hs, q0:q1] = self.mm(torch.softmax(logits + bias, dim=-1), v[hs, :q1])
        return self.lin(out.transpose(0, 1).reshape(n, H * vd), w[p + "o_proj"])

    def route(self, u: torch.Tensor, w: Dict[str, torch.Tensor], p: str):
        """u [N, D] -> (chosen [N, k] over all the router's experts, weights
        [N, k])."""
        m = self.m
        s = torch.sigmoid(self.lin(u, w[p + "mlp.gate.weight"]))
        chosen = torch.topk(s + w[p + "mlp.gate.e_score_correction_bias"],
                            m["num_experts_per_token"], dim=-1).indices
        wt = s.gather(1, chosen)
        return chosen, wt / (wt.sum(-1, keepdim=True) + 1e-20) * m["routed_scaling_factor"]

    def moe(self, u: torch.Tensor, w: Dict[str, torch.Tensor], p: str):
        """u [N, D] -> (the held experts' and the shared expert's output [N,
        D], chosen [N, k]). The stacked expert weights hold experts
        m["experts_first"] on; `held` picks which of them are computed."""
        chosen, wt = self.route(u, w, p)
        out = self.swiglu(u, w[p + "mlp.shared_experts.gate_proj"],
                          w[p + "mlp.shared_experts.up_proj"],
                          w[p + "mlp.shared_experts.down_proj"])
        gate, up, down = (w[p + "mlp.experts." + k] for k in ("gate_proj", "up_proj", "down_proj"))
        first, count = self.held
        for e in range(first, first + count):
            tok, slot = torch.nonzero(chosen == e, as_tuple=True)
            if tok.numel():
                i = e - self.m["experts_first"]
                y = self.swiglu(u[tok], gate[i], up[i], down[i])
                out.index_add_(0, tok, wt[tok, slot, None] * y)
        return out, chosen

    def layer(self, i: int, x: torch.Tensor, bounds: List[int], w: Dict[str, torch.Tensor]):
        """Layer i over x [N, D] (the docs' tokens in order, doc j at
        bounds[j]:bounds[j + 1]) -> (its output, the chosen experts [N, k]
        or None for the dense layer)."""
        m, p = self.m, f"layers.{i}."
        eps = m["rms_norm_eps"]
        a = rms(x, w[p + "input_layernorm"], eps)
        if i + 1 in m["kda_layers"]:
            x = x + self.kda(a, bounds, w, p)
        else:
            x = x + torch.cat([self.mla(a[s:e], w, p) for s, e in zip(bounds, bounds[1:])])
        u = rms(x, w[p + "post_attention_layernorm"], eps)
        if i < m["first_k_dense_replace"]:
            return x + self.swiglu(u, w[p + "mlp.gate_proj"], w[p + "mlp.up_proj"],
                                   w[p + "mlp.down_proj"]), None
        out, chosen = self.moe(u, w, p)
        return x + out, chosen

    def layer_weights(self, i: int) -> Dict[str, torch.Tensor]:
        return self.weights(self.layer_shapes(self.m, i))

    def head_reps(self, x: torch.Tensor, bounds: List[int], outer=None) -> torch.Tensor:
        """The final norm and the head over x [N, D] -> reps [n_docs, V]."""
        outer = outer or self.weights([s for s in self.outer_shapes(self.m)
                                       if s[0] != "embed_tokens"])
        h = rms(x, outer["norm"], self.m["rms_norm_eps"])
        head = outer["lm_head"]
        reps = torch.stack([self.mm(h[s:e], head.t()).amax(0) for s, e in zip(bounds, bounds[1:])])
        return torch.log1p(torch.relu(reps))

    def run(self, docs: List[torch.Tensor]):
        """docs: each doc's live token ids [n_i] -> (reps [n_docs, V], the
        chosen experts of every expert layer, each layer's input and the
        last one's output [N, D])."""
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
