"""Kimi-Linear-48B-A3B (`moonshotai/Kimi-Linear-48B-A3B-Instruct`, HF
`kimi_linear`; Kimi Linear, arXiv:2510.26692) as a sparse document encoder:
a hybrid decoder LLM whose LM-head logits are max-pooled over the doc's
positions, as `models/moonlight.py` pools Moonlight's.

The published shape: 27 pre-norm layers at D 2 304. Twenty are Kimi Delta
Attention (KDA, `linear_attn_config.kda_layers`, numbered from 1), seven
are MLA (0-based layers 3, 7, 11, 15, 19, 23 and 26: 32 heads of q·k 128 +
64 and v 128, kv rank 512, no q compression, and `mla_use_nope`, so no
rotation anywhere). Layer 0's feed-forward is a dense SwiGLU of 9 216;
layers 1-26 hold 256 routed SwiGLU experts of 1 024 (8 a token: sigmoid
scores, the correction bias in the choice only, renormalised, x 2.446) and
one shared expert. An untied head of 163 840 rows. For layer i, x fp32,
u = RMSNorm(x):

  * a KDA layer, per head (32 of dk = dv = 128): q, k, v =
    SiLU(causal depthwise conv4(u·W_q|k|v)); q and k L2-normalised, q
    scaled by dk^-1/2; g = −exp(A_log[h])·softplus(u·W_fa·W_fb + dt_bias)
    per channel (the decay α = exp(g)); β = sigmoid(u·W_b); the state
    recurrence of `ops/kda.py`; x += (RMSNorm_head(o) ⊙ w_norm ⊙
    sigmoid(u·W_ga·W_gb))·W_o;
  * an MLA layer: `models/moonlight.py`'s `mla` with q and k unrotated;
  * then, u = RMSNorm(x): layer 0 x += SwiGLU(u); layers 1-26 x += the
    routed experts held here and the shared expert (`ops/moe.py`).

The expert share (`experts_held`, `experts_first`): one card of a
deployment that divides each expert layer's experts over cards (expert
parallel) holds `experts_held` of them, stacked; the router keeps its 256
outputs and its top 8, the layer computes its own experts' rows alone and
adds them and the shared expert. What the other cards' experts would add
is left out (on a card of the deployment it would come back in the
exchange, which a one-card run does not make). `kimi-linear-48b-a3b-ep2`
holds experts 0-127 of 256: the card of two that share each layer.

Reused by import from `models/moonlight.py`: `Attn` (the MLA weights),
`mla`, `SwiGLU`, `Router`, `rms_norm`, and the head
(`MoonlightForCausalLM.mlm_maxpool` through the fused head kernel); the
interface is Moonlight's, so `SparseEncoderModel`, `BatchEncoder` and the
ingest path run it unchanged.

Precision: matrices in the compute dtype (bf16) but the gates'; fp32 for
the residual stream, RMSNorm, the router and its bias, the gates' low-rank
matrices and their products (W_fa, W_fb, W_ga, W_gb, W_b: u in fp32 times
fp32 copies), β, A_log, dt_bias, the convolution and the KDA state. The
span `encoder.attn.linear` holds each KDA layer's mixer, from the
projections' outputs to the gated norm's output before W_o; the counter
`encoder.attn.tokens.linear` adds its positions, padding included, and
`encoder.moe.experts_held` the experts each expert layer holds, once at
build.

Not hosted: training (`Trainer` refuses this backbone), a decode path with
KDA's recurrent state, the tokenizer and a checkpoint's layout.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import moe
from ..ops.kda import conv_silu, decay, gated_norm, kda
from ..utils import tracing
from . import moonlight
from .moonlight import Attn, Router, SwiGLU, mla, rms_norm

KDA_LAYERS = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26)


@dataclass(frozen=True)
class KimiLinearConfig:
    vocab_size: int = 163840
    hidden_size: int = 2304
    num_hidden_layers: int = 27
    num_attention_heads: int = 32
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_experts: int = 256
    num_experts_per_token: int = 8
    num_shared_experts: int = 1
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    routed_scaling_factor: float = 2.446
    kda_layers: Tuple[int, ...] = KDA_LAYERS  # numbered from 1, as published
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    short_conv_kernel_size: int = 4
    mla_use_nope: bool = True
    model_max_length: int = 1048576
    # the experts this card holds: experts_first .. experts_first + experts_held - 1
    experts_first: int = 0
    experts_held: int = 256
    model_type: str = "kimi_linear"
    compute_dtype: torch.dtype = torch.bfloat16

    # the names `models/moonlight.py`'s modules read
    @property
    def n_routed_experts(self) -> int:
        return self.num_experts

    @property
    def num_experts_per_tok(self) -> int:
        return self.num_experts_per_token

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def shared_intermediate_size(self) -> int:
        return self.num_shared_experts * self.moe_intermediate_size

    def is_kda(self, layer: int) -> bool:
        return layer + 1 in self.kda_layers

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace


PRESETS = {
    # the published config.json, one card of two sharing each expert layer
    "kimi-linear-48b-a3b-ep2": dict(experts_held=128),
    # the same structure at test widths: KDA, KDA, KDA, MLA; a dense layer 0
    "kimi-linear-tiny": dict(vocab_size=512, hidden_size=64, num_hidden_layers=4,
                             num_attention_heads=4, intermediate_size=96,
                             moe_intermediate_size=32, num_experts=16, num_experts_per_token=4,
                             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
                             v_head_dim=16, kda_layers=(1, 2, 3), kda_num_heads=2,
                             kda_head_dim=16, experts_held=16),
}


def config_from_preset(name: str, **overrides) -> KimiLinearConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown Kimi Linear preset {name!r}; have {sorted(PRESETS)}")
    return KimiLinearConfig(**{**PRESETS[name], **overrides})


def _matrix(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape), requires_grad=False)


class KDA(nn.Module):
    """Kimi Delta Attention's weights and its block (flash-linear-attention's
    `KimiDeltaAttention` names)."""

    def __init__(self, cfg: KimiLinearConfig):
        super().__init__()
        self.cfg = cfg
        D, H, d, K = (cfg.hidden_size, cfg.kda_num_heads, cfg.kda_head_dim,
                      cfg.short_conv_kernel_size)
        self.q_proj, self.k_proj, self.v_proj = (_matrix(H * d, D) for _ in range(3))
        self.q_conv1d, self.k_conv1d, self.v_conv1d = (_matrix(H * d, K) for _ in range(3))
        self.f_a_proj = _matrix(d, D)
        self.f_b_proj = _matrix(H * d, d)
        self.b_proj = _matrix(H, D)
        self.A_log = _matrix(H)
        self.dt_bias = _matrix(H * d)
        self.g_a_proj = _matrix(d, D)
        self.g_b_proj = _matrix(H * d, d)
        self.o_norm = _matrix(d)
        self.o_proj = _matrix(D, H * d)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        """u [B, L, D] fp32 (RMSNorm(x)) -> the block's output [B, L, D] in
        the compute dtype."""
        cfg, cd = self.cfg, self.cfg.compute_dtype
        B, L, _ = u.shape
        H, d = cfg.kda_num_heads, cfg.kda_head_dim
        a = u.to(cd)
        q, k, v = (torch.matmul(a, w.t()) for w in (self.q_proj, self.k_proj, self.v_proj))
        f = torch.matmul(torch.matmul(u, self.f_a_proj.t()), self.f_b_proj.t())
        b = torch.matmul(u, self.b_proj.t())
        gate = torch.matmul(torch.matmul(u, self.g_a_proj.t()), self.g_b_proj.t())
        with tracing.span("encoder.attn.linear"):
            tracing.count("encoder.attn.tokens.linear", B * L)
            q = conv_silu(q, self.q_conv1d, d, norm=True)
            k = conv_silu(k, self.k_conv1d, d, norm=True)
            v = conv_silu(v, self.v_conv1d, d, norm=False)
            g = decay(f, self.A_log, self.dt_bias, d)
            o = kda(q, k, v, g, torch.sigmoid(b), 1.0 / math.sqrt(d))
            o = gated_norm(o, self.o_norm, gate, cfg.rms_norm_eps, cd)
        return torch.matmul(o.reshape(B, L, H * d), self.o_proj.t())


class Experts(nn.Module):
    """The routed experts held here, stacked: gate and up [E_held, I, D],
    down [E_held, D, I]."""

    def __init__(self, cfg: KimiLinearConfig):
        super().__init__()
        E, D, I = cfg.experts_held, cfg.hidden_size, cfg.moe_intermediate_size
        self.gate_proj = _matrix(E, I, D)
        self.up_proj = _matrix(E, I, D)
        self.down_proj = _matrix(E, D, I)


class MoE(nn.Module):
    def __init__(self, cfg: KimiLinearConfig):
        super().__init__()
        self.cfg = cfg
        self.gate = Router(cfg)
        self.experts = Experts(cfg)
        self.shared_experts = SwiGLU(cfg.hidden_size, cfg.shared_intermediate_size)

    def forward(self, x: torch.Tensor, u: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        """x [T, D] fp32 (the residual stream) += the held experts' and the
        shared expert's output for u [T, D] fp32 (RMSNorm(x)), in place."""
        chosen, w = self.gate(u)
        uc = u.to(cd)
        ex, cfg = self.experts, self.cfg
        return moe.experts(uc, x, chosen, w, ex.gate_proj, ex.up_proj, ex.down_proj,
                           self.shared_experts(uc), cfg.experts_first)


class Layer(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, index: int):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.input_layernorm = _matrix(D)
        self.self_attn = KDA(cfg) if cfg.is_kda(index) else Attn(cfg)
        self.post_attention_layernorm = _matrix(D)
        self.mlp = MoE(cfg) if cfg.is_moe(index) else SwiGLU(D, cfg.intermediate_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B, L, D] fp32 (the residual stream) -> the same."""
        cfg, cd = self.cfg, self.cfg.compute_dtype
        u = rms_norm(x, self.input_layernorm, cfg.rms_norm_eps)
        if isinstance(self.self_attn, KDA):
            x = x + self.self_attn(u).float()
        else:
            x = x + mla(cfg, self.self_attn, u.to(cd), mask, None).float()
        u = rms_norm(x, self.post_attention_layernorm, cfg.rms_norm_eps)
        if isinstance(self.mlp, MoE):
            B, L, D = x.shape
            return self.mlp(x.reshape(B * L, D), u.reshape(B * L, D), cd).view(B, L, D)
        return x + self.mlp(u.to(cd)).float()


class KimiLinearForCausalLM(nn.Module):
    def __init__(self, cfg: KimiLinearConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = _matrix(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(Layer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = _matrix(cfg.hidden_size)
        self.lm_head = _matrix(cfg.vocab_size, cfg.hidden_size)
        self._zero_bias: Dict[str, torch.Tensor] = {}

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
            raise NotImplementedError("Kimi Linear runs without dropout here: it does not train")
        cfg = self.cfg
        x = F.embedding(input_ids.long(), self.embed_tokens).float()
        for layer in self.layers:
            x = layer(x, attention_mask)
        return rms_norm(x, self.norm, cfg.rms_norm_eps).to(cfg.compute_dtype)

    decoder_weight = moonlight.MoonlightForCausalLM.decoder_weight
    head_hidden = moonlight.MoonlightForCausalLM.head_hidden
    mlm_maxpool = moonlight.MoonlightForCausalLM.mlm_maxpool


_FP32 = ("layernorm", "norm", "gate.weight", "e_score_correction_bias", "conv1d", ".f_a_proj",
         ".f_b_proj", ".b_proj", ".g_a_proj", ".g_b_proj", "A_log", "dt_bias")


def _fp32(name: str) -> bool:
    """The parameters held in fp32: norm scales, the router and its bias,
    the KDA gates' matrices, A_log, dt_bias and the convolutions."""
    return name.endswith(_FP32)


def state_dict_names(cfg: KimiLinearConfig) -> Dict[str, tuple]:
    """The module's parameter names and shapes."""
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in KimiLinearForCausalLM(cfg).state_dict().items()}


def param_dtype(cfg: KimiLinearConfig, name: str) -> torch.dtype:
    return torch.float32 if _fp32(name) else cfg.compute_dtype


def _seed_of(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def _draw(name: str, shape: tuple, seed: int, device) -> torch.Tensor:
    """One tensor in fp32 from a generator seeded with (seed, name): unit
    norm scales; A = exp(A_log) uniform on [1, 16] and dt = softplus(dt_bias)
    log-uniform on [1e-3, 1e-1] (Mamba's ranges, as flash-linear-attention
    draws them); the convolutions uniform on ±1/2 (±1/√K, a conv's default
    range at K 4); every other tensor N(0, 0.02)."""
    if name.endswith("norm"):
        return torch.ones(shape, device=device)
    gen = torch.Generator(device=device).manual_seed(_seed_of(seed, name))
    if name.endswith(("A_log", "dt_bias", "conv1d")):
        r = torch.rand(shape, generator=gen, device=device)
        if name.endswith("A_log"):
            return torch.log(1.0 + 15.0 * r)
        if name.endswith("conv1d"):
            return r - 0.5
        dt = torch.exp(math.log(1e-3) + r * (math.log(1e-1) - math.log(1e-3)))
        return dt + torch.log(-torch.expm1(-dt))
    return torch.randn(shape, generator=gen, device=device).mul_(0.02)


def init_state_dict(cfg: KimiLinearConfig, seed: int = 0,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """Seeded random weights on `device`, one tensor at a time, in each
    parameter's dtype; each held expert's matrices are drawn from (seed,
    the stack's name and the expert's number among all the router's), so
    any share holds the same experts' values as the whole layer."""
    sd = {}
    for name, shape in state_dict_names(cfg).items():
        dt = param_dtype(cfg, name)
        if ".mlp.experts." in name:
            sd[name] = torch.stack([_draw(f"{name}.{cfg.experts_first + e}", shape[1:], seed,
                                          device).to(dt) for e in range(shape[0])])
        else:
            sd[name] = _draw(name, shape, seed, device).to(dt)
    return sd


def from_state_dict(cfg: KimiLinearConfig, sd: Dict[str, torch.Tensor],
                    device) -> KimiLinearForCausalLM:
    """A module in eval mode on `device` holding `sd`, each tensor in its
    parameter dtype (a tensor already there in that dtype is taken as it
    is); adds the experts an expert layer holds to `encoder.moe.experts_held`
    once."""
    with torch.device("meta"):
        model = KimiLinearForCausalLM(cfg)
    held = {k: v.to(device=device, dtype=param_dtype(cfg, k)) for k, v in sd.items()}
    model.load_state_dict(held, assign=True)
    for p in model.parameters():
        p.requires_grad_(False)
    tracing.count("encoder.moe.experts_held", cfg.experts_held)
    return model.eval()
