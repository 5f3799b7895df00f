"""Kimi Linear configurations' model keys and their random weights.

A Kimi Linear configuration file holds the published config.json's keys
(`hidden_size`, `num_experts`, `linear_attn_config`, ...) and its
deployment: `num_experts` is the count of experts held on this card (the
cut, in `reduced`), `deployment.num_experts_published` the router's width
and `deployment.experts_first` the first expert held. `model_keys` reads
them. Each tensor is drawn on the device from a generator seeded with (the
run's seed, the tensor's name), and each routed expert's matrices from (the
seed, the stack's name and the expert's number among the router's), so
any share of the experts holds the values the uncut layer holds: the
program takes the whole model at once (51 GB in bfloat16 at the published
widths with 128 experts a layer, made one tensor at a time), the reference
one layer at a time. Matrices, token embeddings, the head, the router's
weight and its correction bias are N(0, 0.02); norm scales 1; A = exp(A_log)
uniform on [1, 16] and dt = softplus(dt_bias) log-uniform on [1e-3, 1e-1]
(Mamba's ranges); the short convolutions uniform on ±1/2. Names are the
port's state dict's (`models/kimi_linear.py`). Matrices are rounded to the
program's compute dtype (bfloat16); the router, its bias, the KDA gates'
matrices, A_log, dt_bias, the convolutions and the norm scales stay in
float32. The reference gets the same values in float32.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterable, List, Tuple

import torch

_KEYS = {"hidden_size": int, "num_hidden_layers": int, "num_attention_heads": int,
         "intermediate_size": int, "moe_intermediate_size": int, "num_experts": int,
         "num_experts_per_token": int, "num_shared_experts": int, "first_k_dense_replace": int,
         "kv_lora_rank": int, "qk_nope_head_dim": int, "qk_rope_head_dim": int,
         "v_head_dim": int, "rms_norm_eps": float, "routed_scaling_factor": float,
         "vocab_size": int}


def model_keys(cfg: dict) -> dict:
    """The model's sizes, from a Kimi Linear (kimi_linear) config; raises on
    what the port does not host (q compression, grouped top-k over more than
    one group, a scoring other than sigmoid, rotary MLA)."""
    if (cfg.get("q_lora_rank") is not None or cfg.get("num_expert_group", 1) != 1
            or cfg.get("moe_router_activation_func", "sigmoid") != "sigmoid"
            or not cfg.get("moe_renormalize", True) or not cfg.get("mla_use_nope", False)):
        raise ValueError("the port hosts kimi_linear with q_lora_rank null, one expert group, "
                         "sigmoid scores, renormalised top-k weights and mla_use_nope")
    m = {k: t(cfg[k]) for k, t in _KEYS.items()}
    la = cfg["linear_attn_config"]
    dep = cfg.get("deployment", {})
    m.update(kda_layers=tuple(int(i) for i in la["kda_layers"]), kda_num_heads=int(la["num_heads"]),
             kda_head_dim=int(la["head_dim"]),
             short_conv_kernel_size=int(la["short_conv_kernel_size"]),
             n_routed=int(dep.get("num_experts_published", m["num_experts"])),
             experts_first=int(dep.get("experts_first", 0)))
    return m


def is_kda(m: dict, i: int) -> bool:
    return i + 1 in m["kda_layers"]


def layer_shapes(m: dict, i: int) -> List[Tuple[str, tuple]]:
    D, p = m["hidden_size"], f"layers.{i}."
    out = [(p + "input_layernorm", (D,)), (p + "post_attention_layernorm", (D,))]
    a = p + "self_attn."
    if is_kda(m, i):
        H, d, K = m["kda_num_heads"], m["kda_head_dim"], m["short_conv_kernel_size"]
        out += [(a + "q_proj", (H * d, D)), (a + "k_proj", (H * d, D)), (a + "v_proj", (H * d, D)),
                (a + "q_conv1d", (H * d, K)), (a + "k_conv1d", (H * d, K)),
                (a + "v_conv1d", (H * d, K)), (a + "f_a_proj", (d, D)),
                (a + "f_b_proj", (H * d, d)),
                (a + "b_proj", (H, D)), (a + "A_log", (H,)), (a + "dt_bias", (H * d,)),
                (a + "g_a_proj", (d, D)), (a + "g_b_proj", (H * d, d)), (a + "o_norm", (d,)),
                (a + "o_proj", (D, H * d))]
    else:
        H, nope, rope, vd, r = (m["num_attention_heads"], m["qk_nope_head_dim"],
                                m["qk_rope_head_dim"], m["v_head_dim"], m["kv_lora_rank"])
        out += [(a + "q_proj", (H * (nope + rope), D)), (a + "kv_a_proj_with_mqa", (r + rope, D)),
                (a + "kv_a_layernorm", (r,)), (a + "kv_b_proj", (H * (nope + vd), r)),
                (a + "o_proj", (D, H * vd))]
    if i < m["first_k_dense_replace"]:
        F = m["intermediate_size"]
        return out + [(p + "mlp.gate_proj", (F, D)), (p + "mlp.up_proj", (F, D)),
                      (p + "mlp.down_proj", (D, F))]
    E, En, I = m["num_experts"], m["n_routed"], m["moe_intermediate_size"]
    S = m["num_shared_experts"] * I
    return out + [(p + "mlp.gate.weight", (En, D)), (p + "mlp.gate.e_score_correction_bias", (En,)),
                  (p + "mlp.experts.gate_proj", (E, I, D)), (p + "mlp.experts.up_proj", (E, I, D)),
                  (p + "mlp.experts.down_proj", (E, D, I)),
                  (p + "mlp.shared_experts.gate_proj", (S, D)),
                  (p + "mlp.shared_experts.up_proj", (S, D)),
                  (p + "mlp.shared_experts.down_proj", (D, S))]


def outer_shapes(m: dict) -> List[Tuple[str, tuple]]:
    V, D = m["vocab_size"], m["hidden_size"]
    return [("embed_tokens", (V, D)), ("norm", (D,)), ("lm_head", (V, D))]


def shapes(m: dict) -> List[Tuple[str, tuple]]:
    out = outer_shapes(m)
    for i in range(m["num_hidden_layers"]):
        out += layer_shapes(m, i)
    return out


_FLOAT32 = ("norm", "gate.weight", "e_score_correction_bias", "conv1d", ".f_a_proj", ".f_b_proj",
            ".b_proj", ".g_a_proj", ".g_b_proj", "A_log", "dt_bias")


def _seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed) & (2**63 - 1)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def _one(name: str, shape: tuple, seed: int, device) -> torch.Tensor:
    if name.endswith("norm"):
        return torch.ones(shape, device=device)
    gen = torch.Generator(device=device).manual_seed(_seed(seed, name))
    if name.endswith(("A_log", "dt_bias", "conv1d")):
        r = torch.rand(shape, generator=gen, device=device)
        if name.endswith("A_log"):
            return torch.log(1.0 + 15.0 * r)
        if name.endswith("conv1d"):
            return r - 0.5
        dt = torch.exp(math.log(1e-3) + r * (math.log(1e-1) - math.log(1e-3)))
        return dt + torch.log(-torch.expm1(-dt))
    return torch.randn(shape, generator=gen, device=device).mul_(0.02)


def draw(name: str, shape: tuple, seed: int, device, compute=torch.bfloat16,
         first: int = 0) -> torch.Tensor:
    """One tensor, in the dtype the program holds it in; a stack of routed
    experts [E, ...] holds experts first .. first + E - 1."""
    dtype = torch.float32 if name.endswith(_FLOAT32) else compute
    if ".mlp.experts." in name:
        return torch.stack([_one(f"{name}.{first + e}", shape[1:], seed, device).to(dtype)
                            for e in range(shape[0])])
    return _one(name, shape, seed, device).to(dtype)


def make_weights(m: dict, seed: int, device, compute=torch.bfloat16,
                 names: Iterable[Tuple[str, tuple]] = None) -> Dict[str, torch.Tensor]:
    """The tensors `names` ((name, shape) pairs; every tensor by default),
    each in the dtype the program holds it in, the experts held here."""
    return {n: draw(n, s, seed, device, compute, m["experts_first"])
            for n, s in (names or shapes(m))}


def n_params(m: dict) -> int:
    return sum(torch.Size(s).numel() for _, s in shapes(m))
