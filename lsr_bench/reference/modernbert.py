"""The plain reference ModernBERT encoder: the masked-LM forward in float32
and the sparse head (the full logits, the masked max over the positions,
log1p(relu)), in plain torch ops.

It follows the published model (Warner et al. 2024, arXiv:2412.13663; HF's
`modeling_modernbert.py`): embeddings LN(tok_emb[ids]); pre-norm layers
with no biases, the first without its attention norm; q, k, v from one
Wqkv; rotary positions (rotate-half, inverse frequencies θ^(-2i/hd)) with
θ = global_rope_theta on every `global_attn_every_n_layers`-th layer from
layer 0 and local_rope_theta on the others; softmax(q kᵀ / sqrt(hd) + M) v,
M masking the padding keys and, on the local layers, the keys with
|i - j| > local_attention / 2; a GeGLU feed-forward (gelu(u) ⊙ g); a final
norm; the head LN(gelu(x W_denseᵀ)) with the token embeddings as decoder
plus a bias. Every LayerNorm has a scale and no bias. The weights are a
dict under the port's names (HF's without `model.`), from the benchmark's
generator. Nothing here comes from the program.

Departures from the published model: dropout is left out (every published
config sets it to 0); attention is computed densely with explicit masks
(HF unpads the rows and runs a windowed flash kernel for the local layers:
the same function), one doc and a few heads at a time so that it fits;
the head is computed over blocks of positions, with a running max; a
masked position pools to 0 (HF has no max-pool: this is the sparse
encoder's head).

`precision="fp8"` is the control: every matrix product's operands are
rounded to float8 e4m3 with one scale a tensor (`reference/bert.py`'s
rounding). TF32 is off.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .bert import _F8MatMul, set_precision


class Encoder:
    """cfg: hidden_size, num_hidden_layers, num_attention_heads,
    intermediate_size, vocab_size, global_attn_every_n_layers,
    local_attention, global_rope_theta, local_rope_theta, norm_eps."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], precision: str = "fp32",
                 heads_at_once: int = 4, positions_at_once: int = 1024):
        set_precision()
        self.cfg = cfg
        self.w = weights
        self.fp8 = precision == "fp8"
        self.V = int(cfg["vocab_size"])
        self.heads_at_once = heads_at_once
        self.positions_at_once = positions_at_once

    def mm(self, a, b):
        return _F8MatMul.apply(a, b) if self.fp8 else torch.matmul(a, b)

    def lin(self, x, name):
        return self.mm(x, self.w[name].t())

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[name], None, float(self.cfg["norm_eps"]))

    def is_global(self, i: int) -> bool:
        return i % int(self.cfg["global_attn_every_n_layers"]) == 0

    @staticmethod
    def rope(L: int, hd: int, theta: float, device):
        inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.int64, device=device).float()
                               / hd))
        freqs = torch.outer(torch.arange(L, device=device, dtype=torch.float32), inv)
        emb = torch.cat([freqs, freqs], dim=-1)
        return emb.cos(), emb.sin()

    @staticmethod
    def rotate(x, cos, sin):
        """x [B, H, L, hd]."""
        half = x.shape[-1] // 2
        return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin

    def attend(self, q, k, v, mask, window: int):
        """q, k, v [B, H, L, hd]; dense logits with the padding keys (and,
        for window > 0, |i - j| > window) masked; a doc and a few heads at
        a time."""
        B, H, L, hd = q.shape
        pos = torch.arange(L, device=q.device)
        out = torch.empty_like(q)
        for b in range(B):
            ok = mask[b].bool()[None, :].expand(L, L)
            if window > 0:
                ok = ok & ((pos[:, None] - pos[None, :]).abs() <= window)
            bias = torch.where(ok, 0.0, torch.finfo(torch.float32).min)
            for h0 in range(0, H, self.heads_at_once):
                hs = slice(h0, h0 + self.heads_at_once)
                logits = self.mm(q[b, hs], k[b, hs].transpose(-1, -2)) / math.sqrt(hd)
                out[b, hs] = self.mm(torch.softmax(logits + bias, dim=-1), v[b, hs])
        return out

    def hidden(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg, w = self.cfg, self.w
        B, L = ids.shape
        D, H = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
        hd = D // H
        x = self.ln(w["embeddings.tok_embeddings.weight"][ids.long()], "embeddings.norm.weight")
        ropes = {t: self.rope(L, hd, float(cfg[t]), x.device)
                 for t in ("global_rope_theta", "local_rope_theta")}
        for i in range(int(cfg["num_hidden_layers"])):
            pre = f"layers.{i}."
            glob = self.is_global(i)
            a = x if i == 0 else self.ln(x, pre + "attn_norm.weight")
            qkv = self.lin(a, pre + "attn.Wqkv.weight").view(B, L, 3, H, hd).permute(2, 0, 3, 1, 4)
            cos, sin = ropes["global_rope_theta" if glob else "local_rope_theta"]
            q, k = self.rotate(qkv[0], cos, sin), self.rotate(qkv[1], cos, sin)
            window = 0 if glob else int(cfg["local_attention"]) // 2
            ctx = self.attend(q, k, qkv[2], mask, window).transpose(1, 2).reshape(B, L, D)
            x = x + self.lin(ctx, pre + "attn.Wo.weight")
            u, g = self.lin(self.ln(x, pre + "mlp_norm.weight"), pre + "mlp.Wi.weight").chunk(2, -1)
            x = x + self.lin(F.gelu(u) * g, pre + "mlp.Wo.weight")
        return self.ln(x, "final_norm.weight")

    def pooled(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """max_l mask * MLM logits -> [B, V] (a masked position gives 0)."""
        h = self.ln(F.gelu(self.lin(x, "head.dense.weight")), "head.norm.weight")
        dec = self.w["embeddings.tok_embeddings.weight"][: self.V]
        bias = self.w["decoder.bias"][: self.V]
        out = None
        m = mask.to(h.dtype)
        for l0 in range(0, h.shape[1], self.positions_at_once):
            sl = slice(l0, l0 + self.positions_at_once)
            logits = (self.mm(h[:, sl], dec.t()) + bias) * m[:, sl, None]
            part = logits.amax(dim=1)
            out = part if out is None else torch.maximum(out, part)
        return out

    def rep(self, ids, mask) -> torch.Tensor:
        """The doc's sparse rep [B, V]: log1p(relu(pooled))."""
        return torch.log1p(torch.relu(self.pooled(self.hidden(ids, mask), mask)))
