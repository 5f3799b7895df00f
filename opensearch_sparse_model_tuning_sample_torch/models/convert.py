"""Weights of the JAX package -> the port's state dict.

`params_from_jax` takes the JAX parameter pytree as numpy arrays, in the
layout of the JAX `bert.init` (dense kernels [in, out], LayerNorm
scale/bias, padded vocab rows), and returns the state dict of the port's
`BertForMaskedLM`. Given the sparse encoder's whole tree
({"bert": ..., "idf_vector": ...}) it returns the state dict of the port's
`SparseEncoderModel` instead. Padded vocab rows are kept. This is how the
parity tests make both packages compute with the same weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .bert import BertConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(p, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[prefix + ".weight"] = _t(np.asarray(p["kernel"], np.float32).T)
    out[prefix + ".bias"] = _t(p["bias"])


def _ln(p, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[prefix + ".weight"] = _t(p["scale"])
    out[prefix + ".bias"] = _t(p["bias"])


def _bert(tree: Dict[str, Any], cfg: BertConfig) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    emb = tree["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        out[f"embeddings.{name}"] = _t(emb[name])
    _ln(emb["layer_norm"], "embeddings.layer_norm", out)
    layers = tree["encoder"]["layers"]
    if len(layers) != cfg.num_hidden_layers:
        raise ValueError(f"tree has {len(layers)} layers, config {cfg.num_hidden_layers}")
    for i, layer in enumerate(layers):
        att, ffn = layer["attention"], layer["ffn"]
        for name in ("query", "key", "value", "output"):
            _dense(att[name], f"layers.{i}.attention.{name}", out)
        _ln(att["layer_norm"], f"layers.{i}.attention.layer_norm", out)
        _dense(ffn["intermediate"], f"layers.{i}.ffn.intermediate", out)
        _dense(ffn["output"], f"layers.{i}.ffn.output", out)
        _ln(ffn["layer_norm"], f"layers.{i}.ffn.layer_norm", out)
    head = tree["mlm_head"]
    _dense(head["transform"], "mlm_head.transform", out)
    _ln(head["layer_norm"], "mlm_head.layer_norm", out)
    out["mlm_head.bias"] = _t(head["bias"])
    if "decoder" in head:
        out["mlm_head.decoder"] = _t(head["decoder"])
    if out["embeddings.word_embeddings"].shape[0] != cfg.padded_vocab_size:
        raise ValueError("word embeddings are not padded to cfg.padded_vocab_size")
    return out


def params_from_jax(np_tree: Dict[str, Any], cfg: BertConfig) -> Dict[str, torch.Tensor]:
    if "bert" in np_tree:
        sd = {f"bert.{k}": v for k, v in _bert(np_tree["bert"], cfg).items()}
        sd["idf_vector"] = _t(np_tree["idf_vector"])
        return sd
    return _bert(np_tree, cfg)
