"""Moonlight-16B-A3B (`moonshotai/Moonlight-16B-A3B`, HF `deepseek_v3`) as a
sparse document encoder: a decoder LLM whose LM-head logits are max-pooled
over the doc's positions, as SPLADE pools an MLM head's.

The published shape: 27 pre-norm layers at D 2 048; layer 0 dense (SwiGLU
of 11 264), layers 1-26 DeepSeekMoE (64 routed experts of 1 408, 6 a token,
and 2 shared that act as one SwiGLU of 2 816); MLA attention with no q
compression; RMSNorm; an untied head of 163 840 rows. For layer i, x fp32:

  * a = RMSNorm(x); q = a·W_qᵀ split per head into q_nope (128) and q_rope
    (64); [c, k_r] = a·W_kv_aᵀ (c 512 wide, k_r 64); [k_nope, v] =
    RMSNorm_kv(c)·W_kv_bᵀ per head (128 + 128); RoPE (θ 50 000) on q_rope
    and on k_r, one k_r for all 16 heads; q = [q_nope, q_rope], k =
    [k_nope, k_r]; causal attention with key padding, scaled by 1/√192;
    x += ctx·W_oᵀ;
  * layer 0: x += SwiGLU_11264(RMSNorm(x));
  * layers 1-26, u = RMSNorm(x): s = sigmoid(u·W_gᵀ) (fp32); the chosen
    experts are the top 6 of s + b (`e_score_correction_bias`); w = s over
    the chosen, over its sum, times 2.446; x += Σ_e w_e·E_e(u) + S(u), E_e
    = down(silu(gate·u) ⊙ up·u) of width 1 408, S the shared SwiGLU;
  * after the last layer x = RMSNorm(x); the head W_lm (no bias).

RoPE takes DeepSeek's pair layout, as HF's `deepseek_v3` applies it: the 64
dims are de-interleaved (pairs (2i, 2i + 1) to (i, i + 32)) and then
rotated half against half, inverse frequencies θ^(-2i/64); q and k take the
same permutation, so q·k is that of rotating each pair (2i, 2i + 1).

The interface is `models/modernbert.py`'s (`encode_hidden`, `head_hidden`,
`decoder_weight`, `mlm_maxpool`), so `SparseEncoderModel`, `BatchEncoder`
and the ingest, eval and serving paths run it unchanged; the sparse rep is
the max over live positions of log1p(relu(logits)).

Precision: matrices are held in the compute dtype (bf16, as the checkpoint
publishes them: 31.92 GB; the port's fp32-parameter policy would take 63.8
GB and a cast of every weight each batch); norm scales, W_g and b in fp32.
Products take compute-dtype operands and accumulate in fp32; RMSNorm, the
router and the residual stream are fp32. Attention is `ops/attention.py`'s
causal kernel (q·k dim 192, v 128), the experts `ops/moe.py`'s grouped
GEMMs and combine, the head `models/bert.py`'s `maxpool_head` with a zero
bias; the dense layer, the shared experts and the projections are cuBLAS.

Not hosted: training (`Trainer` refuses this backbone), dropout, YaRN or
other RoPE scaling, the grouped top-k of configs with n_group > 1, and a
HF checkpoint's layout (the expert weights are stacked here, one [E, I, D]
tensor each for gate, up and down).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import moe
from ..ops.attention import attention
from . import bert as bert_mod


@dataclass(frozen=True)
class MoonlightConfig:
    vocab_size: int = 163840
    hidden_size: int = 2048
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    routed_scaling_factor: float = 2.446
    max_position_embeddings: int = 8192
    model_type: str = "deepseek_v3"
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def shared_intermediate_size(self) -> int:
        return self.n_shared_experts * self.moe_intermediate_size

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace


PRESETS = {
    # moonshotai/Moonlight-16B-A3B's config.json
    "moonlight-16b-a3b": dict(),
    # the same structure at test widths (a dense layer 0, then expert layers)
    "moonlight-tiny": dict(vocab_size=512, hidden_size=64, num_hidden_layers=4,
                           num_attention_heads=4, intermediate_size=96,
                           moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2,
                           n_shared_experts=1, kv_lora_rank=32, qk_nope_head_dim=16,
                           qk_rope_head_dim=16, v_head_dim=16, max_position_embeddings=512),
}


def config_from_preset(name: str, **overrides) -> MoonlightConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown Moonlight preset {name!r}; have {sorted(PRESETS)}")
    return MoonlightConfig(**{**PRESETS[name], **overrides})


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32 (returns fp32)."""
    xf = x.float()
    return xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * weight


def rope_tables(n: int, dim: int, theta: float, device) -> tuple:
    """(cos, sin) [n, dim] fp32 of positions 0..n-1: inverse frequencies
    theta^(-2i/dim), each repeated over both halves."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.int64, device=device).float()
                           / dim))
    freqs = torch.outer(torch.arange(n, device=device, dtype=torch.float32), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, L, H, d] in DeepSeek's pair layout: de-interleaved (pairs (2i,
    2i + 1) to (i, i + d/2)), then rotate-half by cos, sin [L, d], in fp32;
    returned in x's dtype."""
    B, L, H, d = x.shape
    xf = x.float().view(B, L, H, d // 2, 2).transpose(-1, -2).reshape(B, L, H, d)
    rot = torch.cat([-xf[..., d // 2:], xf[..., : d // 2]], dim=-1)
    return (xf * cos[None, :, None] + rot * sin[None, :, None]).to(x.dtype)


def _matrix(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape), requires_grad=False)


class Attn(nn.Module):
    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        D, H = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = _matrix(H * cfg.qk_head_dim, D)
        self.kv_a_proj_with_mqa = _matrix(cfg.kv_lora_rank + cfg.qk_rope_head_dim, D)
        self.kv_a_layernorm = _matrix(cfg.kv_lora_rank)
        self.kv_b_proj = _matrix(H * (cfg.qk_nope_head_dim + cfg.v_head_dim), cfg.kv_lora_rank)
        self.o_proj = _matrix(D, H * cfg.v_head_dim)


def mla(cfg, at: Attn, a: torch.Tensor, mask: torch.Tensor,
        rope: Optional[tuple]) -> torch.Tensor:
    """MLA with no q compression, then W_o, for a [B, L, D] (the normed
    input, compute dtype) -> [B, L, D] in the compute dtype. `rope` (cos,
    sin) rotates q_rope and the shared k_r; None leaves them as they are
    (Kimi Linear's `mla_use_nope`)."""
    B, L, _ = a.shape
    cd = a.dtype
    H, nope, rd = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = torch.matmul(a, at.q_proj.t()).view(B, L, H, nope + rd)
    ckv = torch.matmul(a, at.kv_a_proj_with_mqa.t())
    c, k_r = ckv.split([cfg.kv_lora_rank, rd], dim=-1)
    kv = torch.matmul(rms_norm(c, at.kv_a_layernorm, cfg.rms_norm_eps).to(cd),
                      at.kv_b_proj.t()).view(B, L, H, nope + cfg.v_head_dim)
    if rope is None:
        k_r = k_r.view(B, L, 1, rd).expand(B, L, H, rd)
    else:
        cos, sin = rope
        q_r = apply_rope(q[..., nope:], cos, sin)
        k_r = apply_rope(k_r.view(B, L, 1, rd), cos, sin).expand(B, L, H, rd)
        q = torch.cat([q[..., :nope], q_r], dim=-1)
    k = torch.cat([kv[..., :nope], k_r], dim=-1)
    ctx = attention(q, k, kv[..., nope:], mask, causal=True)
    return torch.matmul(ctx.reshape(B, L, H * cfg.v_head_dim), at.o_proj.t())


class SwiGLU(nn.Module):
    def __init__(self, D: int, width: int):
        super().__init__()
        self.gate_proj = _matrix(width, D)
        self.up_proj = _matrix(width, D)
        self.down_proj = _matrix(D, width)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        """u [..., D] in the compute dtype -> down(silu(gate·u) ⊙ up·u), in
        the compute dtype."""
        g = torch.matmul(u, self.gate_proj.t())
        return torch.matmul(F.silu(g) * torch.matmul(u, self.up_proj.t()), self.down_proj.t())


class Experts(nn.Module):
    """The routed experts, stacked: gate and up [E, I, D], down [E, D, I]."""

    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        E, D, I = cfg.n_routed_experts, cfg.hidden_size, cfg.moe_intermediate_size
        self.gate_proj = _matrix(E, I, D)
        self.up_proj = _matrix(E, I, D)
        self.down_proj = _matrix(E, D, I)


class Router(nn.Module):
    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        self.cfg = cfg
        self.weight = _matrix(cfg.n_routed_experts, cfg.hidden_size)
        self.e_score_correction_bias = _matrix(cfg.n_routed_experts)

    def forward(self, u: torch.Tensor):
        """u [T, D] fp32 -> (experts [T, k], weights [T, k] fp32)."""
        return moe.route(u, self.weight, self.e_score_correction_bias,
                         self.cfg.num_experts_per_tok, self.cfg.routed_scaling_factor)


class MoE(nn.Module):
    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        self.gate = Router(cfg)
        self.experts = Experts(cfg)
        self.shared_experts = SwiGLU(cfg.hidden_size, cfg.shared_intermediate_size)

    def forward(self, x: torch.Tensor, u: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        """x [T, D] fp32 (the residual stream) += the layer's output for
        u [T, D] fp32 (RMSNorm(x)), in place."""
        chosen, w = self.gate(u)
        uc = u.to(cd)
        ex = self.experts
        return moe.experts(uc, x, chosen, w, ex.gate_proj, ex.up_proj, ex.down_proj,
                           self.shared_experts(uc))


class Layer(nn.Module):
    def __init__(self, cfg: MoonlightConfig, index: int):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.input_layernorm = _matrix(D)
        self.self_attn = Attn(cfg)
        self.post_attention_layernorm = _matrix(D)
        self.mlp = MoE(cfg) if cfg.is_moe(index) else SwiGLU(D, cfg.intermediate_size)

    def attend(self, x: torch.Tensor, mask: torch.Tensor, rope: tuple) -> torch.Tensor:
        """The attention block's output for x [B, L, D] fp32, in the compute
        dtype: MLA, then W_o."""
        a = rms_norm(x, self.input_layernorm, self.cfg.rms_norm_eps).to(self.cfg.compute_dtype)
        return mla(self.cfg, self.self_attn, a, mask, rope)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, rope: tuple) -> torch.Tensor:
        """x [B, L, D] fp32 (the residual stream) -> the same."""
        cfg, cd = self.cfg, self.cfg.compute_dtype
        x = x + self.attend(x, mask, rope).float()
        u = rms_norm(x, self.post_attention_layernorm, cfg.rms_norm_eps)
        if isinstance(self.mlp, MoE):
            B, L, D = x.shape
            return self.mlp(x.reshape(B * L, D), u.reshape(B * L, D), cd).view(B, L, D)
        return x + self.mlp(u.to(cd)).float()


class MoonlightForCausalLM(nn.Module):
    def __init__(self, cfg: MoonlightConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = _matrix(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(Layer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = _matrix(cfg.hidden_size)
        self.lm_head = _matrix(cfg.vocab_size, cfg.hidden_size)
        self._rope: Dict[str, tuple] = {}
        self._zero_bias: Dict[str, torch.Tensor] = {}

    def _rope_for(self, L: int, device) -> tuple:
        """(cos, sin) [L, rope dim] for positions 0..L-1, sliced from a table
        of max(L, max_position_embeddings) rows made once per device."""
        key = str(device)
        table = self._rope.get(key)
        if table is None or table[0].shape[0] < L:
            n = max(L, self.cfg.max_position_embeddings)
            table = self._rope[key] = rope_tables(n, self.cfg.qk_rope_head_dim,
                                                  self.cfg.rope_theta, device)
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
            raise NotImplementedError("Moonlight runs without dropout here: it does not train")
        cfg = self.cfg
        x = F.embedding(input_ids.long(), self.embed_tokens).float()
        rope = self._rope_for(input_ids.shape[1], x.device)
        for layer in self.layers:
            x = layer(x, attention_mask, rope)
        return rms_norm(x, self.norm, cfg.rms_norm_eps).to(cfg.compute_dtype)

    def decoder_weight(self) -> torch.Tensor:
        """[V, D] decoder: the untied LM head."""
        return self.lm_head

    def head_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        """The head takes the final norm's output as it is."""
        return hidden

    def mlm_maxpool(self, hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """max_l mask[b,l] * logits[b,l,v] -> [B, V] fp32, through the fused
        head kernel (`models/bert.py`'s `maxpool_head`), with a zero bias."""
        dev = str(hidden.device)
        bias = self._zero_bias.get(dev)
        if bias is None:
            bias = self._zero_bias[dev] = torch.zeros(self.cfg.vocab_size, device=hidden.device)
        cd = self.cfg.compute_dtype
        return bert_mod.maxpool_head(hidden.to(cd).contiguous(),
                                     attention_mask.to(torch.int32).contiguous(),
                                     self.lm_head.to(cd).contiguous(), bias)


def _fp32(name: str) -> bool:
    """The parameters held in fp32: norm scales, the router and its bias."""
    return name.endswith(("layernorm", "norm", "gate.weight", "e_score_correction_bias"))


def state_dict_names(cfg: MoonlightConfig) -> Dict[str, tuple]:
    """The module's parameter names and shapes."""
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in MoonlightForCausalLM(cfg).state_dict().items()}


def param_dtype(cfg: MoonlightConfig, name: str) -> torch.dtype:
    return torch.float32 if _fp32(name) else cfg.compute_dtype


def _seed_of(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def init_state_dict(cfg: MoonlightConfig, seed: int = 0,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """Seeded random weights on `device`, each tensor drawn from a generator
    seeded with (seed, its name), so one tensor at a time is made (the
    large preset's 32 GB never exists twice): N(0, 0.02) matrices and
    correction bias, unit norm scales; in each parameter's dtype."""
    sd = {}
    for name, shape in state_dict_names(cfg).items():
        if _fp32(name) and not name.endswith(("gate.weight", "e_score_correction_bias")):
            sd[name] = torch.ones(shape, device=device)
            continue
        gen = torch.Generator(device=device).manual_seed(_seed_of(seed, name))
        t = torch.randn(shape, generator=gen, device=device)
        sd[name] = t.mul_(0.02).to(param_dtype(cfg, name))
    return sd


def from_state_dict(cfg: MoonlightConfig, sd: Dict[str, torch.Tensor],
                    device) -> MoonlightForCausalLM:
    """A module in eval mode on `device` holding `sd`, each tensor in its
    parameter dtype; a tensor already on the device in that dtype is taken
    as it is (no copy), so the large preset is held once."""
    with torch.device("meta"):
        model = MoonlightForCausalLM(cfg)
    held = {k: v.to(device=device, dtype=param_dtype(cfg, k)) for k, v in sd.items()}
    model.load_state_dict(held, assign=True)
    for p in model.parameters():
        p.requires_grad_(False)
    return model.eval()

