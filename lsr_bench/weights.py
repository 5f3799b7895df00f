"""The configurations' model keys and their random weights.

A configuration file holds the published config.json's keys (BERT's
`hidden_size`, ..., or DistilBERT's `dim`, `n_layers`, ...). `model_keys`
reads either into one set of names. `make_weights` draws the weights on the
device from the seed in one call, as the HF initialisation does (N(0, 0.02)
matrices and embeddings, zero biases, unit LayerNorm scales), under the
port's state-dict names, the word embeddings padded to a multiple of 128
rows with zeros. The program and the reference each get the same values.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

PAD_MULTIPLE = 128


def model_keys(cfg: dict) -> dict:
    """The model's sizes under BERT's names, from either layout's config."""
    if cfg.get("model_type") == "distilbert" or "dim" in cfg:
        return {
            "model_type": "distilbert",
            "hidden_size": int(cfg["dim"]),
            "num_hidden_layers": int(cfg["n_layers"]),
            "num_attention_heads": int(cfg["n_heads"]),
            "intermediate_size": int(cfg["hidden_dim"]),
            "vocab_size": int(cfg["vocab_size"]),
            "max_position_embeddings": int(cfg["max_position_embeddings"]),
            "type_vocab_size": 2,
            "layer_norm_eps": float(cfg.get("layer_norm_eps", 1e-12)),
            "hidden_dropout_prob": float(cfg["dropout"]),
            "attention_probs_dropout_prob": float(cfg["attention_dropout"]),
            "hidden_act": cfg["activation"],
        }
    return {
        "model_type": "bert",
        "hidden_size": int(cfg["hidden_size"]),
        "num_hidden_layers": int(cfg["num_hidden_layers"]),
        "num_attention_heads": int(cfg["num_attention_heads"]),
        "intermediate_size": int(cfg["intermediate_size"]),
        "vocab_size": int(cfg["vocab_size"]),
        "max_position_embeddings": int(cfg["max_position_embeddings"]),
        "type_vocab_size": int(cfg.get("type_vocab_size", 2)),
        "layer_norm_eps": float(cfg.get("layer_norm_eps", 1e-12)),
        "hidden_dropout_prob": float(cfg["hidden_dropout_prob"]),
        "attention_probs_dropout_prob": float(cfg["attention_probs_dropout_prob"]),
        "hidden_act": cfg["hidden_act"],
    }


def padded_vocab(V: int) -> int:
    return -(-V // PAD_MULTIPLE) * PAD_MULTIPLE


def shapes(m: dict) -> List[Tuple[str, tuple]]:
    D, Fd = m["hidden_size"], m["intermediate_size"]
    out = [("embeddings.word_embeddings", (padded_vocab(m["vocab_size"]), D)),
           ("embeddings.position_embeddings", (m["max_position_embeddings"], D)),
           ("embeddings.token_type_embeddings", (m["type_vocab_size"], D)),
           ("embeddings.layer_norm.weight", (D,)), ("embeddings.layer_norm.bias", (D,))]
    for i in range(m["num_hidden_layers"]):
        p = f"layers.{i}."
        for name in ("query", "key", "value", "output"):
            out += [(p + f"attention.{name}.weight", (D, D)), (p + f"attention.{name}.bias", (D,))]
        out += [(p + "attention.layer_norm.weight", (D,)), (p + "attention.layer_norm.bias", (D,)),
                (p + "ffn.intermediate.weight", (Fd, D)), (p + "ffn.intermediate.bias", (Fd,)),
                (p + "ffn.output.weight", (D, Fd)), (p + "ffn.output.bias", (D,)),
                (p + "ffn.layer_norm.weight", (D,)), (p + "ffn.layer_norm.bias", (D,))]
    out += [("mlm_head.transform.weight", (D, D)), ("mlm_head.transform.bias", (D,)),
            ("mlm_head.layer_norm.weight", (D,)), ("mlm_head.layer_norm.bias", (D,)),
            ("mlm_head.bias", (padded_vocab(m["vocab_size"]),))]
    return out


def make_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights on `device`, the random ones from one N(0, 1) draw of a
    generator seeded with `seed`."""
    sh = shapes(m)
    rand = [(n, s) for n, s in sh if len(s) == 2]
    total = sum(s[0] * s[1] for _, s in rand)
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    flat = torch.randn(total, generator=gen, device=device).mul_(0.02)
    out, off = {}, 0
    for n, s in sh:
        if len(s) == 2:
            out[n] = flat[off: off + s[0] * s[1]].view(s)
            off += s[0] * s[1]
        elif n.endswith("layer_norm.weight"):
            out[n] = torch.ones(s, device=device)
        else:
            out[n] = torch.zeros(s, device=device)
    out["embeddings.word_embeddings"][m["vocab_size"]:] = 0.0
    return out


def n_params(m: dict) -> int:
    return sum(torch.Size(s).numel() for _, s in shapes(m))
