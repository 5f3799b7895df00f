"""Moonlight configurations' model keys and their random weights.

A Moonlight configuration file holds the published config.json's keys
(`hidden_size`, `n_routed_experts`, `kv_lora_rank`, ...). `model_keys` reads
them. Each tensor is drawn on the device from a generator seeded with (the
run's seed, the tensor's name), so any one tensor can be drawn again alone:
the program takes the whole model at once (32 GB in bfloat16 at the
published widths, made one tensor at a time), the reference one layer at a
time. Matrices, token embeddings and the head are N(0, 0.02), the router's
weight and its correction bias b too (so that b moves the choice and the
weights differ from the scores), norm scales 1. Names are the port's state
dict's (`models/moonlight.py`: HF's without `model.` and `.weight`, the
routed experts stacked [E, I, D] per projection). Matrices are rounded to
the program's compute dtype (bfloat16, as the checkpoint publishes them);
the router, b and the norm scales stay in float32. The reference gets the
same values in float32.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Tuple

import torch

_KEYS = {"hidden_size": int, "num_hidden_layers": int, "num_attention_heads": int,
         "intermediate_size": int, "moe_intermediate_size": int, "n_routed_experts": int,
         "num_experts_per_tok": int, "n_shared_experts": int, "first_k_dense_replace": int,
         "kv_lora_rank": int, "qk_nope_head_dim": int, "qk_rope_head_dim": int,
         "v_head_dim": int, "rope_theta": float, "rms_norm_eps": float,
         "routed_scaling_factor": float, "vocab_size": int, "max_position_embeddings": int}


def model_keys(cfg: dict) -> dict:
    """The model's sizes, from a Moonlight (deepseek_v3) config; raises on
    what the port does not host (q compression, grouped top-k, a scoring
    other than sigmoid)."""
    if (cfg.get("q_lora_rank") is not None or cfg.get("n_group", 1) != 1
            or cfg.get("scoring_func", "sigmoid") != "sigmoid"
            or not cfg.get("norm_topk_prob", True)):
        raise ValueError("the port hosts deepseek_v3 with q_lora_rank null, n_group 1, sigmoid "
                         "scores and normalised top-k weights")
    return {k: t(cfg[k]) for k, t in _KEYS.items()}


def layer_shapes(m: dict, i: int) -> List[Tuple[str, tuple]]:
    D, H = m["hidden_size"], m["num_attention_heads"]
    nope, rope, vd, r = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"], \
        m["kv_lora_rank"]
    p = f"layers.{i}."
    out = [(p + "input_layernorm", (D,)), (p + "post_attention_layernorm", (D,)),
           (p + "self_attn.q_proj", (H * (nope + rope), D)),
           (p + "self_attn.kv_a_proj_with_mqa", (r + rope, D)),
           (p + "self_attn.kv_a_layernorm", (r,)),
           (p + "self_attn.kv_b_proj", (H * (nope + vd), r)),
           (p + "self_attn.o_proj", (D, H * vd))]
    if i < m["first_k_dense_replace"]:
        F = m["intermediate_size"]
        return out + [(p + "mlp.gate_proj", (F, D)), (p + "mlp.up_proj", (F, D)),
                      (p + "mlp.down_proj", (D, F))]
    E, I = m["n_routed_experts"], m["moe_intermediate_size"]
    S = m["n_shared_experts"] * I
    return out + [(p + "mlp.gate.weight", (E, D)), (p + "mlp.gate.e_score_correction_bias", (E,)),
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


def _float32(name: str) -> bool:
    return name.endswith(("norm", "gate.weight", "e_score_correction_bias"))


def _seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed) & (2**63 - 1)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def draw(name: str, shape: tuple, seed: int, device, compute=torch.bfloat16) -> torch.Tensor:
    """One tensor: norm scales 1 (float32); the router and b N(0, 0.02) in
    float32; every other tensor N(0, 0.02) rounded to `compute`."""
    if name.endswith("norm"):
        return torch.ones(shape, device=device)
    gen = torch.Generator(device=device).manual_seed(_seed(seed, name))
    t = torch.randn(shape, generator=gen, device=device).mul_(0.02)
    return t if _float32(name) else t.to(compute)


def make_weights(m: dict, seed: int, device, compute=torch.bfloat16,
                 names: Iterable[Tuple[str, tuple]] = None) -> Dict[str, torch.Tensor]:
    """The tensors `names` ((name, shape) pairs; every tensor by default),
    each in the dtype the program holds it in."""
    return {n: draw(n, s, seed, device, compute) for n, s in (names or shapes(m))}


def n_params(m: dict) -> int:
    return sum(torch.Size(s).numel() for _, s in shapes(m))
