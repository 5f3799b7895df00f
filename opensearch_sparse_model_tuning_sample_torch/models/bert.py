"""BERT-for-Masked-LM backbone as a PyTorch module.

The port of the JAX package's `models/bert.py`, kept to its precision policy
so both packages compute the same function from the same weights:

  * embedding gathers and adds run in the compute dtype;
  * LayerNorm runs in fp32 and casts back;
  * a dense layer accumulates its product in fp32, casts it to the compute
    dtype, then adds the bias in the compute dtype;
  * GELU is the exact (erf) form, in the compute dtype;
  * attention logits and softmax are fp32, the probabilities are cast to
    the compute dtype; the additive mask is finfo(float32).min, not -inf;
  * the MLM head's logits are fp32 with an fp32 bias.

The vocab axis is padded up to `vocab_pad_multiple`; padded rows of the word
embeddings are zero. `mlm_maxpool` is the sparse encoder's head: it calls the
fused max-pool kernel (ops/maxpool.py), so the [B, L, V] logits never exist.
This slice is inference only (no dropout) and hosts the BERT layout
(absolute positions, token-type embeddings).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.maxpool import maxpool_head


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    hidden_act: str = "gelu"  # "gelu" (exact) | "gelu_new" (tanh) | "relu"
    pad_token_id: int = 0
    # None = follow hidden_act (BERT); RoBERTa's head pins gelu
    head_act: Optional[str] = None
    vocab_pad_multiple: int = 128
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def padded_vocab_size(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


PRESETS = {
    "tiny": dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=512),
    "mini": dict(hidden_size=256, num_hidden_layers=4, num_attention_heads=4,
                 intermediate_size=1024),
    "small": dict(hidden_size=512, num_hidden_layers=4, num_attention_heads=8,
                  intermediate_size=2048),
    "distill": dict(hidden_size=768, num_hidden_layers=6, num_attention_heads=12,
                    intermediate_size=3072),
    "base": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072),
    "large": dict(hidden_size=1024, num_hidden_layers=24,
                  num_attention_heads=16, intermediate_size=4096),
}


def config_from_preset(name: str, **overrides) -> BertConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown arch preset {name!r}; have {sorted(PRESETS)}")
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return BertConfig(**kw)


def _act_by_name(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x)
    if name in ("gelu_new", "gelu_pytorch_tanh", "gelu_approx"):
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"unsupported hidden_act {name!r}")


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 and cast back to the input dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class Dense(nn.Module):
    """x @ Wᵀ accumulated in fp32 and emitted in the compute dtype, then the
    bias added in the compute dtype (torch autocast semantics). Weight is
    [out, in], as in nn.Linear."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def forward(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        y = torch.matmul(x.to(cd), self.weight.to(cd).t())
        return y + self.bias.to(cd)


class Attention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.query, self.key, self.value, self.output = (Dense(d, d) for _ in range(4))
        self.layer_norm = LayerNorm(d, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        cfg, cd = self.cfg, self.cfg.compute_dtype
        B, L, D = x.shape
        H, hd = cfg.num_attention_heads, cfg.head_dim

        def heads(p: Dense) -> torch.Tensor:  # [B, H, L, hd]
            return p(x, cd).view(B, L, H, hd).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        # fp32 logits from exact products of the compute-dtype values
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(logits + mask_bias, dim=-1).to(cd)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, D)
        return self.layer_norm(x + self.output(ctx, cd))


class FeedForward(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.cfg.compute_dtype
        h = _act_by_name(self.intermediate(x, cd), self.cfg.hidden_act)
        return self.layer_norm(x + self.output(h, cd))


class Layer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = Attention(cfg)
        self.ffn = FeedForward(cfg)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        return self.ffn(self.attention(x, mask_bias))


class Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.word_embeddings = nn.Parameter(torch.empty(cfg.padded_vocab_size, d))
        self.position_embeddings = nn.Parameter(torch.empty(cfg.max_position_embeddings, d))
        self.token_type_embeddings = nn.Parameter(torch.empty(cfg.type_vocab_size, d))
        self.layer_norm = LayerNorm(d, cfg.layer_norm_eps)


class MLMHead(nn.Module):
    def __init__(self, cfg: BertConfig, tied: bool = True):
        super().__init__()
        d = cfg.hidden_size
        self.transform = Dense(d, d)
        self.layer_norm = LayerNorm(d, cfg.layer_norm_eps)
        self.bias = nn.Parameter(torch.empty(cfg.padded_vocab_size))
        # an untied checkpoint keeps its own [padded_V, D] decoder
        self.decoder = None if tied else nn.Parameter(
            torch.empty(cfg.padded_vocab_size, d)
        )


class BertForMaskedLM(nn.Module):
    def __init__(self, cfg: BertConfig, tied: bool = True):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.layers = nn.ModuleList(Layer(cfg) for _ in range(cfg.num_hidden_layers))
        self.mlm_head = MLMHead(cfg, tied)

    def encode_hidden(
        self,
        input_ids: torch.Tensor,  # [B, L] int
        attention_mask: torch.Tensor,  # [B, L] int/bool
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Transformer stack -> final hidden states [B, L, D] (compute dtype)."""
        cfg, cd = self.cfg, self.cfg.compute_dtype
        emb = self.embeddings
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = (F.embedding(input_ids, emb.word_embeddings).to(cd)
             + F.embedding(pos_ids, emb.position_embeddings).to(cd)
             + F.embedding(token_type_ids.long(), emb.token_type_embeddings).to(cd))
        x = emb.layer_norm(x)
        # additive attention bias: 0 where attended, large-negative where masked
        mask_bias = torch.where(
            attention_mask[:, None, None, :] > 0, 0.0, torch.finfo(torch.float32).min
        ).to(torch.float32)
        for layer in self.layers:
            x = layer(x, mask_bias)
        return x

    def decoder_weight(self) -> torch.Tensor:
        """[padded_V, D] decoder: the word embeddings when tied (the
        default), or the checkpoint's own decoder for untied imports."""
        dec = self.mlm_head.decoder
        return dec if dec is not None else self.embeddings.word_embeddings

    def head_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        """MLM-head transform + activation + LayerNorm, in the compute dtype."""
        cfg, p = self.cfg, self.mlm_head
        h = _act_by_name(p.transform(hidden, cfg.compute_dtype),
                         cfg.head_act or cfg.hidden_act)
        return p.layer_norm(h)

    def mlm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """MLM head -> [B, L, padded_V] fp32 (the full logits; the sparse
        encoder uses mlm_maxpool instead)."""
        cd = self.cfg.compute_dtype
        h = self.head_hidden(hidden).to(cd).float()
        w = self.decoder_weight().to(cd).float()
        return torch.matmul(h, w.t()) + self.mlm_head.bias.float()

    def mlm_maxpool(self, hidden: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
        """max_l mask[b,l] * logits[b,l,v] -> [B, padded_V] fp32, through the
        fused kernel without ever forming the logits."""
        cd = self.cfg.compute_dtype
        return maxpool_head(
            self.head_hidden(hidden).to(cd).contiguous(),
            attention_mask.to(torch.int32).contiguous(),
            self.decoder_weight().to(cd).contiguous(),
            self.mlm_head.bias.float().contiguous(),
        )


def init_state_dict(cfg: BertConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded random init (HF-style: N(0, 0.02) weights, zero biases, unit
    LayerNorm scales; padded vocab rows zero), drawn on the CPU from one
    torch.Generator so it does not depend on the device."""
    gen = torch.Generator().manual_seed(seed)
    shapes = {k: v.shape for k, v in BertForMaskedLM(cfg).state_dict().items()}
    sd = {}
    for name, shape in shapes.items():
        if name.endswith("layer_norm.weight"):
            sd[name] = torch.ones(shape)
        elif name.endswith("bias"):
            sd[name] = torch.zeros(shape)
        else:
            sd[name] = torch.randn(shape, generator=gen) * 0.02
    sd["embeddings.word_embeddings"][cfg.vocab_size:] = 0.0
    return sd


def from_state_dict(cfg: BertConfig, sd: Dict[str, torch.Tensor],
                    device: torch.device) -> BertForMaskedLM:
    """A module in eval mode on `device`, with the weights of `sd` in
    cfg.param_dtype; untied when `sd` carries a decoder."""
    model = BertForMaskedLM(cfg, tied="mlm_head.decoder" not in sd)
    model.load_state_dict(sd)
    return model.to(device=device, dtype=cfg.param_dtype).eval()
