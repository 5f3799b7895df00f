"""The plain reference encoder: a BERT (or DistilBERT) masked-LM forward and
its gradient in float32, then the sparse head (masked max-pool of the MLM
logits over the positions, log1p(relu)), in plain torch ops.

It follows the published models (BERT: Devlin et al. 2019; DistilBERT:
Sanh et al. 2019, no token types) with the HF layout: post-LayerNorm
layers, exact GELU, additive attention mask, an MLM head of dense + GELU +
LayerNorm + the word embeddings as decoder plus a bias. The weights are a
dict under the names the benchmark generates them with. Nothing here comes
from the program: the dropout masks are drawn through a frozen copy of the
key derivation the port documents (`dropout_generator`), so the reference
draws the masks the program should draw.

`precision="fp8"` is the control: every matrix product (forward and
backward) takes its operands rounded to float8 e4m3 with one scale per
tensor, the nearest precision below the bfloat16 that the configurations
state. TF32 is off for both.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

F8_MAX = 448.0


def set_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dropout_generator(key: Sequence[int], stream: int, device) -> torch.Generator:
    """Frozen copy of the port's key derivation: stream 0 the embeddings,
    i + 1 layer i, for a step's key (seed, step, microbatch, position, side)."""
    state = np.random.SeedSequence([int(k) for k in key] + [stream]).generate_state(2)
    seed = (int(state[0]) << 31) ^ int(state[1])
    return torch.Generator(device=device).manual_seed(seed)


def _f8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _F8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(_f8(a), _f8(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = _f8(g)
        ga = torch.matmul(g8, _f8(b).transpose(-1, -2))
        gb = torch.matmul(_f8(a).transpose(-1, -2), g8)
        while gb.dim() > b.dim():  # a batched a against a shared b
            gb = gb.sum(0)
        return ga, gb


class Encoder:
    """cfg: the configuration file's model keys (hidden_size,
    num_hidden_layers, num_attention_heads, intermediate_size, vocab_size,
    layer_norm_eps, hidden_dropout_prob, attention_probs_dropout_prob,
    model_type)."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], precision: str = "fp32"):
        self.cfg = cfg
        self.w = weights
        self.fp8 = precision == "fp8"
        self.V = int(cfg["vocab_size"])
        self.token_types = cfg.get("model_type", "bert") != "distilbert"

    def mm(self, a, b):
        return _F8MatMul.apply(a, b) if self.fp8 else torch.matmul(a, b)

    def dense(self, x, name):
        return self.mm(x, self.w[name + ".weight"].t()) + self.w[name + ".bias"]

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"], self.w[name + ".bias"],
                            float(self.cfg["layer_norm_eps"]))

    @staticmethod
    def dropout(x, rate, gen):
        if gen is None or rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), 0.0)

    def hidden(self, ids: torch.Tensor, mask: torch.Tensor,
               dropout_key: Optional[Sequence[int]] = None) -> torch.Tensor:
        cfg, w = self.cfg, self.w
        B, L = ids.shape
        D, H = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
        hd = D // H
        p_h, p_a = float(cfg["hidden_dropout_prob"]), float(cfg["attention_probs_dropout_prob"])
        x = w["embeddings.word_embeddings"][ids.long()] + w["embeddings.position_embeddings"][:L][None]
        if self.token_types:
            x = x + w["embeddings.token_type_embeddings"][0]
        x = self.ln(x, "embeddings.layer_norm")
        if dropout_key is not None:
            x = self.dropout(x, p_h, dropout_generator(dropout_key, 0, x.device))
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, torch.finfo(torch.float32).min)
        for i in range(int(cfg["num_hidden_layers"])):
            gen = None if dropout_key is None else dropout_generator(dropout_key, i + 1, x.device)
            pre = f"layers.{i}."

            def heads(name):
                return self.dense(x, pre + name).view(B, L, H, hd).transpose(1, 2)

            q, k, v = heads("attention.query"), heads("attention.key"), heads("attention.value")
            probs = torch.softmax(self.mm(q, k.transpose(-1, -2)) / math.sqrt(hd) + bias, dim=-1)
            probs = self.dropout(probs, p_a, gen)
            ctx = self.mm(probs, v).transpose(1, 2).reshape(B, L, D)
            out = self.dropout(self.dense(ctx, pre + "attention.output"), p_h, gen)
            x = self.ln(x + out, pre + "attention.layer_norm")
            hmid = F.gelu(self.dense(x, pre + "ffn.intermediate"))
            out = self.dropout(self.dense(hmid, pre + "ffn.output"), p_h, gen)
            x = self.ln(x + out, pre + "ffn.layer_norm")
        return x

    def pooled(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """max_l mask * MLM logits -> [B, V] (a masked position gives 0)."""
        h = self.ln(F.gelu(self.dense(x, "mlm_head.transform")), "mlm_head.layer_norm")
        dec = self.w["embeddings.word_embeddings"][: self.V]
        logits = self.mm(h, dec.t()) + self.w["mlm_head.bias"][: self.V]
        return (logits * mask[:, :, None].to(logits.dtype)).amax(dim=1)

    def rep(self, ids, mask, dropout_key=None) -> torch.Tensor:
        """The doc's sparse rep [B, V]: log1p(relu(pooled))."""
        return torch.log1p(torch.relu(self.pooled(self.hidden(ids, mask, dropout_key), mask)))


def inf_free_rep(ids: torch.Tensor, idf: torch.Tensor, special_ids: Sequence[int]) -> torch.Tensor:
    """An inference-free query: its bag of input tokens times relu(idf),
    special tokens left out."""
    B, V = ids.shape[0], idf.shape[0]
    bag = torch.zeros((B, V), dtype=torch.float32, device=ids.device)
    bag.scatter_(1, ids.long(), 1.0)
    bag[:, list(special_ids)] = 0.0
    return bag * torch.relu(idf)[None, :]
