"""ModernBERT configurations' model keys and their random weights.

A ModernBERT configuration file holds the published config.json's keys
(`hidden_size`, `global_attn_every_n_layers`, `local_attention`, ...).
`model_keys` reads them. `make_weights` draws the weights on the device from
the seed in one call, as `weights.py` does for BERT (N(0, 0.02) matrices and
token embeddings, unit LayerNorm scales, a zero decoder bias), under the
port's state-dict names (HF's without `model.`), the token embeddings and
the decoder bias padded to a multiple of 128 rows with zeros. The program
and the reference each get the same values.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .weights import padded_vocab

_KEYS = {"hidden_size": int, "num_hidden_layers": int, "num_attention_heads": int,
         "intermediate_size": int, "vocab_size": int, "max_position_embeddings": int,
         "global_attn_every_n_layers": int, "local_attention": int,
         "global_rope_theta": float, "local_rope_theta": float, "norm_eps": float}


def model_keys(cfg: dict) -> dict:
    """The model's sizes, from a ModernBERT config."""
    return {k: t(cfg[k]) for k, t in _KEYS.items()}


def shapes(m: dict) -> List[Tuple[str, tuple]]:
    D, Fd, V = m["hidden_size"], m["intermediate_size"], padded_vocab(m["vocab_size"])
    out = [("embeddings.tok_embeddings.weight", (V, D)), ("embeddings.norm.weight", (D,))]
    for i in range(m["num_hidden_layers"]):
        p = f"layers.{i}."
        if i > 0:
            out.append((p + "attn_norm.weight", (D,)))
        out += [(p + "attn.Wqkv.weight", (3 * D, D)), (p + "attn.Wo.weight", (D, D)),
                (p + "mlp_norm.weight", (D,)), (p + "mlp.Wi.weight", (2 * Fd, D)),
                (p + "mlp.Wo.weight", (D, Fd))]
    out += [("final_norm.weight", (D,)), ("head.dense.weight", (D, D)),
            ("head.norm.weight", (D,)), ("decoder.bias", (V,))]
    return out


def make_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights on `device`, the random ones from one N(0, 1) draw of a
    generator seeded with `seed`."""
    sh = shapes(m)
    total = sum(s[0] * s[1] for _, s in sh if len(s) == 2)
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    flat = torch.randn(total, generator=gen, device=device).mul_(0.02)
    out, off = {}, 0
    for n, s in sh:
        if len(s) == 2:
            out[n] = flat[off: off + s[0] * s[1]].view(s)
            off += s[0] * s[1]
        elif n.endswith("norm.weight"):
            out[n] = torch.ones(s, device=device)
        else:
            out[n] = torch.zeros(s, device=device)
    out["embeddings.tok_embeddings.weight"][m["vocab_size"]:] = 0.0
    return out


def n_params(m: dict) -> int:
    return sum(torch.Size(s).numel() for _, s in shapes(m))
