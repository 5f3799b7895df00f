"""ModernBERT-for-Masked-LM backbone as a PyTorch module (Warner et al.
2024, arXiv:2412.13663; the HF layout of `answerdotai/ModernBERT-*`).

A pre-norm encoder with no biases, rotary positions, a GeGLU feed-forward
and two kinds of attention layer:

  * embeddings: x = LN(tok_emb[ids]) (no positions, no token types);
  * layer i: a = LN_attn(x) (the identity for layer 0); q, k, v =
    split(a · Wqkvᵀ) in heads; RoPE (rotate-half) on q and k with θ =
    `global_rope_theta` when i % `global_attn_every_n_layers` == 0 (a
    global layer) and `local_rope_theta` otherwise (a local layer, which
    attends |i - j| <= `local_attention` / 2); x = x + attn(q, k, v) · Woᵀ;
    u, g = split(LN_mlp(x) · Wiᵀ); x = x + (gelu(u) ⊙ g) · Woᵀ;
  * after the last layer x = LN_final(x);
  * head: h = LN_head(gelu(x · W_denseᵀ)); logits = h · tok_embᵀ + b.

Every LayerNorm has a scale and no bias. The sparse encoder's interface is
`models/bert.py`'s (`encode_hidden`, `head_hidden`, `decoder_weight`,
`mlm_maxpool`), so `SparseEncoderModel`, `BatchEncoder` and the ingest,
eval and serving paths run it unchanged.

Precision, the port's policy: float32 parameters; matrix products take
compute-dtype operands and accumulate in fp32; LayerNorm runs in fp32; the
residual stream stays in fp32 (28 pre-norm additions in bf16 would each
round it); RoPE is applied in fp32 to the compute-dtype q and k and cast
back; attention is `ops/attention.py` (fp32 logits and softmax, compute-
dtype probabilities, no `[L, L]` tensor on the card); GELU runs in the
compute dtype; the head goes through `models/bert.py`'s `maxpool_head`
(the fused kernel, looked up on that module at each call).

Not hosted: dropout (every published ModernBERT config sets 0), biases,
activations other than exact GELU, an untied decoder, and training;
`Trainer` refuses this backbone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from . import bert as bert_mod
from .bert import round_up


@dataclass(frozen=True)
class ModernBertConfig:
    vocab_size: int = 50368
    hidden_size: int = 1024
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    intermediate_size: int = 2624
    max_position_embeddings: int = 8192
    global_attn_every_n_layers: int = 3
    local_attention: int = 128  # the window's width: a local layer attends |i - j| <= 64
    global_rope_theta: float = 160000.0
    local_rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    model_type: str = "modernbert"
    vocab_pad_multiple: int = 128
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def padded_vocab_size(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def is_global(self, layer: int) -> bool:
        return layer % self.global_attn_every_n_layers == 0

    def window(self, layer: int) -> int:
        """The half-width of layer `layer`'s window, 0 for a global layer."""
        return 0 if self.is_global(layer) else self.local_attention // 2

    def rope_theta(self, layer: int) -> float:
        return self.global_rope_theta if self.is_global(layer) else self.local_rope_theta


PRESETS = {
    # answerdotai/ModernBERT-large's config.json
    "modernbert-large": dict(),
    # the published structure (globals at 0 and 3) at test widths
    "modernbert-tiny": dict(vocab_size=512, hidden_size=64, num_hidden_layers=6,
                            num_attention_heads=4, intermediate_size=96,
                            max_position_embeddings=512, local_attention=16),
}


def config_from_preset(name: str, **overrides) -> ModernBertConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown ModernBERT preset {name!r}; have {sorted(PRESETS)}")
    return ModernBertConfig(**{**PRESETS[name], **overrides})


class Norm(nn.Module):
    """LayerNorm with a scale and no bias, computed in fp32 (returns fp32)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), None, self.eps)


class Linear(nn.Module):
    """A bias-free [out, in] weight: x · Wᵀ from compute-dtype operands,
    accumulated in fp32, emitted in the compute dtype."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))

    def forward(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        return torch.matmul(x.to(cd), self.weight.to(cd).t())


def rope_tables(n: int, dim: int, theta: float, device) -> tuple:
    """(cos, sin) [n, dim] fp32 of positions 0..n-1 (HF's rotary embedding:
    inverse frequencies theta^(-2i/dim), each repeated over both halves)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.int64, device=device).float()
                           / dim))
    freqs = torch.outer(torch.arange(n, device=device, dtype=torch.float32), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, L, H, hd] rotated (rotate-half) by cos, sin [L, hd], in fp32,
    returned in x's dtype."""
    xf = x.float()
    half = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[None, :, None] + rot * sin[None, :, None]).to(x.dtype)


class Attn(nn.Module):
    def __init__(self, cfg: ModernBertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.Wqkv = Linear(d, 3 * d)
        self.Wo = Linear(d, d)


class Mlp(nn.Module):
    def __init__(self, cfg: ModernBertConfig):
        super().__init__()
        self.Wi = Linear(cfg.hidden_size, 2 * cfg.intermediate_size)
        self.Wo = Linear(cfg.intermediate_size, cfg.hidden_size)


class Layer(nn.Module):
    def __init__(self, cfg: ModernBertConfig, index: int):
        super().__init__()
        self.cfg, self.index = cfg, index
        # layer 0 takes the embeddings' norm as it is (HF: nn.Identity)
        self.attn_norm = None if index == 0 else Norm(cfg.hidden_size, cfg.norm_eps)
        self.attn = Attn(cfg)
        self.mlp_norm = Norm(cfg.hidden_size, cfg.norm_eps)
        self.mlp = Mlp(cfg)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, rope: tuple) -> torch.Tensor:
        """x [B, L, D] fp32 (the residual stream) -> the same."""
        cfg, cd = self.cfg, self.cfg.compute_dtype
        B, L, D = x.shape
        H, hd = cfg.num_attention_heads, cfg.head_dim
        a = x if self.attn_norm is None else self.attn_norm(x)
        qkv = self.attn.Wqkv(a, cd).view(B, L, 3, H, hd)
        cos, sin = rope
        q = apply_rope(qkv[:, :, 0], cos, sin)
        k = apply_rope(qkv[:, :, 1], cos, sin)
        ctx = attention(q, k, qkv[:, :, 2], mask, cfg.window(self.index))
        x = x + self.attn.Wo(ctx.reshape(B, L, D), cd).float()
        u, g = self.mlp.Wi(self.mlp_norm(x), cd).chunk(2, dim=-1)
        return x + self.mlp.Wo(F.gelu(u) * g, cd).float()


class Embeddings(nn.Module):
    def __init__(self, cfg: ModernBertConfig):
        super().__init__()
        self.tok_embeddings = nn.Module()
        self.tok_embeddings.weight = nn.Parameter(torch.empty(cfg.padded_vocab_size,
                                                              cfg.hidden_size))
        self.norm = Norm(cfg.hidden_size, cfg.norm_eps)


class Head(nn.Module):
    def __init__(self, cfg: ModernBertConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)
        self.norm = Norm(cfg.hidden_size, cfg.norm_eps)


class ModernBertForMaskedLM(nn.Module):
    def __init__(self, cfg: ModernBertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.layers = nn.ModuleList(Layer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.final_norm = Norm(cfg.hidden_size, cfg.norm_eps)
        self.head = Head(cfg)
        # the decoder is the token embeddings (tied, as published) plus its bias
        self.decoder = nn.Module()
        self.decoder.bias = nn.Parameter(torch.empty(cfg.padded_vocab_size))
        self._rope: Dict[tuple, tuple] = {}

    def _rope_for(self, L: int, theta: float, device) -> tuple:
        """(cos, sin) [L, hd] for positions 0..L-1, sliced from a table of
        max(L, max_position_embeddings) rows made once per θ and device."""
        key = (theta, str(device))
        table = self._rope.get(key)
        if table is None or table[0].shape[0] < L:
            n = max(L, self.cfg.max_position_embeddings)
            table = self._rope[key] = rope_tables(n, self.cfg.head_dim, theta, device)
        return table[0][:L], table[1][:L]

    def encode_hidden(
        self,
        input_ids: torch.Tensor,  # [B, L] int
        attention_mask: torch.Tensor,  # [B, L] int/bool
        token_type_ids: Optional[torch.Tensor] = None,
        dropout_key: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """The stack and the final norm -> hidden states [B, L, D] in the
        compute dtype. Takes no token types and no dropout."""
        if dropout_key is not None:
            raise NotImplementedError("ModernBERT runs without dropout here: it does not train")
        cfg = self.cfg
        emb = self.embeddings
        x = emb.norm(F.embedding(input_ids.long(), emb.tok_embeddings.weight))
        L = input_ids.shape[1]
        ropes = {t: self._rope_for(L, t, x.device)
                 for t in (cfg.global_rope_theta, cfg.local_rope_theta)}
        for i, layer in enumerate(self.layers):
            x = layer(x, attention_mask, ropes[cfg.rope_theta(i)])
        return self.final_norm(x).to(cfg.compute_dtype)

    def decoder_weight(self) -> torch.Tensor:
        """[padded_V, D] decoder: the token embeddings."""
        return self.embeddings.tok_embeddings.weight

    def head_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        """The prediction head's dense + GELU + norm, in the compute dtype."""
        cd = self.cfg.compute_dtype
        return self.head.norm(F.gelu(self.head.dense(hidden, cd))).to(cd)

    def mlm_maxpool(self, hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """max_l mask[b,l] * logits[b,l,v] -> [B, padded_V] fp32, through the
        fused head kernel (`models/bert.py`'s `maxpool_head`)."""
        cd = self.cfg.compute_dtype
        args = (
            self.head_hidden(hidden).contiguous(),
            attention_mask.to(torch.int32).contiguous(),
            self.decoder_weight().to(cd).contiguous(),
            self.decoder.bias.float().contiguous(),
        )
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            return bert_mod.maxpool_head_train(*args)
        return bert_mod.maxpool_head(*args)


def state_dict_names(cfg: ModernBertConfig) -> Dict[str, tuple]:
    """The module's parameter names and shapes."""
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in ModernBertForMaskedLM(cfg).state_dict().items()}


def init_state_dict(cfg: ModernBertConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded random init (N(0, 0.02) matrices and embeddings, unit norm
    scales, zero decoder bias; padded vocab rows zero), drawn on the CPU
    from one torch.Generator so it does not depend on the device."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, shape in state_dict_names(cfg).items():
        if name.endswith("norm.weight"):
            sd[name] = torch.ones(shape)
        elif name.endswith("bias"):
            sd[name] = torch.zeros(shape)
        else:
            sd[name] = torch.randn(shape, generator=gen) * 0.02
    sd["embeddings.tok_embeddings.weight"][cfg.vocab_size:] = 0.0
    return sd


def from_state_dict(cfg: ModernBertConfig, sd: Dict[str, torch.Tensor],
                    device: torch.device) -> ModernBertForMaskedLM:
    """A module in eval mode on `device` holding `sd` in cfg.param_dtype
    (made on the device, no init)."""
    with torch.device(device):
        model = ModernBertForMaskedLM(cfg)
    model.load_state_dict(sd)
    return model.to(dtype=cfg.param_dtype).eval()
