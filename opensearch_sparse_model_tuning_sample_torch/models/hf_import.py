"""Checkpoint import/export between the port's BERT module and the
HuggingFace BERT-for-MaskedLM on-disk layout.

Reads and writes the same `config.json` + `model.safetensors` + `vocab.txt`
(+ `idf.json`) directory the JAX package's `hf_import.save_checkpoint`
writes, so a checkpoint made by either package loads in the other. This
slice hosts the BERT layout; RoBERTa and DistilBERT layouts raise
`UnsupportedArchitecture` (their canonicalisation is a later slice).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .bert import BertConfig

logger = logging.getLogger(__name__)

SUPPORTED_ACTS = ("gelu", "gelu_new", "gelu_pytorch_tanh", "gelu_approx", "relu")

# HF leaf name -> the port's module name, per encoder layer
_LAYER_LEAVES = {
    "attention.self.query": "attention.query",
    "attention.self.key": "attention.key",
    "attention.self.value": "attention.value",
    "attention.output.dense": "attention.output",
    "attention.output.LayerNorm": "attention.layer_norm",
    "intermediate.dense": "ffn.intermediate",
    "output.dense": "ffn.output",
    "output.LayerNorm": "ffn.layer_norm",
}


class UnsupportedArchitecture(ValueError):
    """The checkpoint is not a layout this importer hosts."""


def _check_act(act: str, path: str) -> str:
    if act not in SUPPORTED_ACTS:
        raise UnsupportedArchitecture(f"unsupported hidden_act {act!r} in {path}")
    return act


def config_from_hf_json(path: str, param_dtype=torch.float32,
                        compute_dtype=torch.bfloat16) -> BertConfig:
    """HF config.json -> BertConfig for the BERT layout."""
    with open(path) as f:
        hf = json.load(f)
    mt = hf.get("model_type", "bert") or "bert"
    if mt != "bert":
        raise UnsupportedArchitecture(
            f"model_type {mt!r} in {path}: the port imports the BERT layout "
            "only for now (RoBERTa/DistilBERT are on the ROADMAP)"
        )
    return BertConfig(
        vocab_size=hf["vocab_size"],
        hidden_act=_check_act(hf.get("hidden_act", "gelu"), path),
        hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf.get("max_position_embeddings", 512),
        type_vocab_size=hf.get("type_vocab_size", 2),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
        hidden_dropout_prob=hf.get("hidden_dropout_prob", 0.1),
        attention_probs_dropout_prob=hf.get("attention_probs_dropout_prob", 0.1),
        pad_token_id=hf.get("pad_token_id", 0),
        param_dtype=param_dtype,
        compute_dtype=compute_dtype,
    )


def _read_state_dict(ckpt_dir: str) -> Dict[str, np.ndarray]:
    st = os.path.join(ckpt_dir, "model.safetensors")
    if os.path.exists(st):
        from safetensors.numpy import load_file

        return load_file(st)
    pt = os.path.join(ckpt_dir, "pytorch_model.bin")
    if os.path.exists(pt):
        sd = torch.load(pt, map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items()}
    raise FileNotFoundError(f"no model.safetensors / pytorch_model.bin in {ckpt_dir}")


def _canonicalize(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Everything under "bert." (or not) -> "bert." form; tf-era
    `gamma`/`beta` -> `weight`/`bias`; `position_ids` buffers dropped."""
    out: Dict[str, np.ndarray] = {}
    has_bert = any(k.startswith("bert.") for k in sd)
    for k, v in sd.items():
        if k.endswith(".position_ids"):
            continue
        if k.endswith(".gamma"):
            k = k[: -len(".gamma")] + ".weight"
        elif k.endswith(".beta"):
            k = k[: -len(".beta")] + ".bias"
        if not has_bert and not k.startswith(("bert.", "cls.")):
            k = f"bert.{k}"
        out[k] = v
    return out


def _pad_rows(x: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows,) + x.shape[1:], dtype=np.float32)
    out[: x.shape[0]] = x
    return out


def params_from_state_dict(sd: Dict[str, np.ndarray],
                           cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """HF BERT state dict (numpy) -> the port's BertForMaskedLM state dict.
    HF Linear weights are [out, in], the port's layout, so nothing is
    transposed; vocab rows are zero-padded to cfg.padded_vocab_size."""
    sd = _canonicalize(sd)
    pv = cfg.padded_vocab_size
    required = [f"bert.embeddings.{n}.weight" for n in (
        "word_embeddings", "position_embeddings", "token_type_embeddings", "LayerNorm")]
    required += [f"bert.encoder.layer.{i}.{leaf}.weight"
                 for i in range(cfg.num_hidden_layers) for leaf in _LAYER_LEAVES]
    missing = [k for k in required if k not in sd]
    if missing:
        raise UnsupportedArchitecture(
            f"checkpoint does not map to the BERT-MLM layout: {len(missing)} "
            f"required keys missing, first few: {missing[:6]}"
        )
    if "cls.predictions.transform.dense.weight" not in sd:
        raise UnsupportedArchitecture("checkpoint has no MLM head (cls.predictions.*)")

    def a(name):
        return torch.from_numpy(np.array(sd[name], dtype=np.float32))

    word = sd["bert.embeddings.word_embeddings.weight"]
    out = {
        "embeddings.word_embeddings": torch.from_numpy(_pad_rows(word, pv)),
        "embeddings.position_embeddings": a("bert.embeddings.position_embeddings.weight"),
        "embeddings.token_type_embeddings": a("bert.embeddings.token_type_embeddings.weight"),
        "embeddings.layer_norm.weight": a("bert.embeddings.LayerNorm.weight"),
        "embeddings.layer_norm.bias": a("bert.embeddings.LayerNorm.bias"),
    }
    for i in range(cfg.num_hidden_layers):
        for leaf, name in _LAYER_LEAVES.items():
            for part in ("weight", "bias"):
                out[f"layers.{i}.{name}.{part}"] = a(f"bert.encoder.layer.{i}.{leaf}.{part}")
    for leaf, name in (("transform.dense", "transform"),
                       ("transform.LayerNorm", "layer_norm")):
        for part in ("weight", "bias"):
            out[f"mlm_head.{name}.{part}"] = a(f"cls.predictions.{leaf}.{part}")
    bias_key = ("cls.predictions.bias" if "cls.predictions.bias" in sd
                else "cls.predictions.decoder.bias")
    out["mlm_head.bias"] = torch.from_numpy(_pad_rows(sd[bias_key], pv))
    dec = sd.get("cls.predictions.decoder.weight")
    if dec is not None and not np.array_equal(dec, word):
        out["mlm_head.decoder"] = torch.from_numpy(_pad_rows(dec, pv))
    return out


def load_checkpoint(
    ckpt_dir: str, param_dtype=torch.float32, compute_dtype=torch.bfloat16,
) -> Tuple[BertConfig, Dict[str, torch.Tensor], Optional[np.ndarray]]:
    """(config, the port's state dict, idf vector or None) from an HF-layout
    checkpoint dir."""
    cfg = config_from_hf_json(os.path.join(ckpt_dir, "config.json"),
                              param_dtype, compute_dtype)
    sd = params_from_state_dict(_read_state_dict(ckpt_dir), cfg)
    idf = None
    idf_path = os.path.join(ckpt_dir, "idf.json")
    if os.path.exists(idf_path):
        from .tokenizer import load_idf_weights, load_tokenizer

        try:
            tok = load_tokenizer(ckpt_dir)
        except (FileNotFoundError, ValueError) as e:
            logger.info("idf side-load skipped (%s)", e)
            tok = None
        if tok is not None:
            idf = load_idf_weights(idf_path, tok)
    return cfg, sd, idf
