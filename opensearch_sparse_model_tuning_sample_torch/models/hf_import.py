"""Checkpoint import/export between the port's BERT module and the
HuggingFace BERT-for-MaskedLM on-disk layout.

Reads and writes the same `config.json` + `model.safetensors` + `vocab.txt`
(+ `idf.json`) directory the JAX package's `hf_import.save_checkpoint`
writes, byte for byte, so a checkpoint made by either package loads in the
other. It hosts the BERT, RoBERTa and DistilBERT layout families, both
ways: their state dicts are mapped to one canonical (BERT) key space on
import and back to their own on export. ModernBERT (`model_type`
"modernbert", `models/modernbert.py`) maps its own names: the port's are
HF's without the `model.` prefix. Any other `model_type` raises
`UnsupportedArchitecture`, which `train/teachers.py::build_teacher` catches
to host the checkpoint through `transformers` instead.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .bert import BertConfig
from .modernbert import ModernBertConfig

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


def _bert_like(hf: Dict, path: str, max_pos: int, type_vocab: int, eps: float,
               pad: int) -> Dict:
    """The config fields BERT and RoBERTa name alike, with each family's
    defaults for the optional ones."""
    return dict(
        vocab_size=hf["vocab_size"],
        hidden_act=_check_act(hf.get("hidden_act", "gelu"), path),
        hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf.get("max_position_embeddings", max_pos),
        type_vocab_size=hf.get("type_vocab_size", type_vocab),
        layer_norm_eps=hf.get("layer_norm_eps", eps),
        hidden_dropout_prob=hf.get("hidden_dropout_prob", 0.1),
        attention_probs_dropout_prob=hf.get("attention_probs_dropout_prob", 0.1),
        pad_token_id=hf.get("pad_token_id", pad),
    )


# ModernBertConfig fields read from config.json under the same key
_MODERNBERT_KEYS = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
                    "intermediate_size", "max_position_embeddings",
                    "global_attn_every_n_layers", "local_attention", "global_rope_theta",
                    "local_rope_theta", "norm_eps")


# the port's ModernBERT parameters with a row per (padded) vocab entry
_MODERNBERT_VOCAB_ROWS = ("embeddings.tok_embeddings.weight", "decoder.bias")


def _modernbert_config(hf: Dict, path: str, common: Dict) -> ModernBertConfig:
    """ModernBERT's config.json -> ModernBertConfig. Biases (norm, attention,
    MLP, classifier), an untied decoder and activations other than gelu are
    not hosted: a checkpoint with any raises."""
    biased = [k for k in ("norm_bias", "attention_bias", "mlp_bias", "classifier_bias")
              if hf.get(k)]
    if not hf.get("tie_word_embeddings", True):
        biased.append("tie_word_embeddings false")
    if biased:
        raise UnsupportedArchitecture(f"{path}: ModernBERT with {biased} is not hosted")
    for k in ("hidden_activation", "classifier_activation"):
        if hf.get(k, "gelu") != "gelu":
            raise UnsupportedArchitecture(f"{path}: {k} {hf[k]!r} (only gelu is hosted)")
    return ModernBertConfig(**{k: hf[k] for k in _MODERNBERT_KEYS if k in hf}, **common)


def config_from_hf_json(path: str, param_dtype=torch.float32, compute_dtype=torch.bfloat16):
    """HF config.json -> BertConfig for the BERT / RoBERTa / DistilBERT
    layout families, ModernBertConfig for ModernBERT; anything else raises
    UnsupportedArchitecture."""
    with open(path) as f:
        hf = json.load(f)
    mt = hf.get("model_type", "bert") or "bert"
    common = dict(param_dtype=param_dtype, compute_dtype=compute_dtype)
    if mt == "modernbert":
        return _modernbert_config(hf, path, common)
    if mt == "bert":
        return BertConfig(**_bert_like(hf, path, 512, 2, 1e-12, 0), **common)
    if mt in ("roberta", "xlm-roberta"):
        # XLM-R has RoBERTa's modules and "roberta." prefix; RobertaLMHead
        # applies gelu whatever hidden_act says
        return BertConfig(**_bert_like(hf, path, 514, 1, 1e-5, 1), model_type="roberta",
                          head_act="gelu", position_style="from_pad_offset", **common)
    if mt == "distilbert":
        if hf.get("sinusoidal_pos_embds"):
            raise UnsupportedArchitecture(
                f"sinusoidal_pos_embds in {path}: DistilBERT imports take learned "
                "absolute positions only"
            )
        return BertConfig(
            model_type="distilbert",
            vocab_size=hf["vocab_size"],
            hidden_act=_check_act(hf.get("activation", "gelu"), path),
            hidden_size=hf["dim"],
            num_hidden_layers=hf["n_layers"],
            num_attention_heads=hf["n_heads"],
            intermediate_size=hf["hidden_dim"],
            max_position_embeddings=hf.get("max_position_embeddings", 512),
            type_vocab_size=1,  # a placeholder row; use_token_type keeps it out
            layer_norm_eps=1e-12,  # DistilBERT hard-codes nn.LayerNorm(eps=1e-12)
            hidden_dropout_prob=hf.get("dropout", 0.1),
            attention_probs_dropout_prob=hf.get("attention_dropout", 0.1),
            pad_token_id=hf.get("pad_token_id", 0),
            use_token_type=False,
            **common,
        )
    raise UnsupportedArchitecture(
        f"model_type {mt!r} in {path} is not a layout family the port imports "
        "(bert, roberta, distilbert); other architectures run as host teachers "
        "through transformers (kd ensemble type 'hf')"
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


def _canon_bert(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
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


# RobertaLMHead module -> the canonical cls.predictions names
_ROBERTA_HEAD = {
    "dense.": "cls.predictions.transform.dense.",
    "layer_norm.": "cls.predictions.transform.LayerNorm.",
    "decoder.": "cls.predictions.decoder.",
}


def _canon_roberta(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """RobertaForMaskedLM keys -> the canonical space: the stack's leaf
    names are BERT's; only the prefix and the LM head's names differ."""
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.endswith(".position_ids") or k == "lm_head.decoder.bias":
            continue  # a buffer, and the tied duplicate of lm_head.bias
        if k.startswith("roberta."):
            k = "bert." + k[len("roberta."):]
        elif k == "lm_head.bias":
            k = "cls.predictions.bias"
        elif k.startswith("lm_head."):
            rest = k[len("lm_head."):]
            for src, dst in _ROBERTA_HEAD.items():
                if rest.startswith(src):
                    k = dst + rest[len(src):]
                    break
        elif not k.startswith(("bert.", "cls.")):
            k = "bert." + k  # a bare RobertaModel dump
        out[k] = v
    return out


# DistilBERT layer leaves -> BERT's (the same post-LN block, other names)
_DISTIL_LEAF_MAP = {
    "attention.q_lin": "attention.self.query",
    "attention.k_lin": "attention.self.key",
    "attention.v_lin": "attention.self.value",
    "attention.out_lin": "attention.output.dense",
    "sa_layer_norm": "attention.output.LayerNorm",
    "ffn.lin1": "intermediate.dense",
    "ffn.lin2": "output.dense",
    "output_layer_norm": "output.LayerNorm",
}
_DISTIL_HEAD = {
    "vocab_transform.": "cls.predictions.transform.dense.",
    "vocab_layer_norm.": "cls.predictions.transform.LayerNorm.",
    "vocab_projector.weight": "cls.predictions.decoder.weight",
    "vocab_projector.bias": "cls.predictions.bias",
}


def _canon_distilbert(sd: Dict[str, np.ndarray], cfg: BertConfig) -> Dict[str, np.ndarray]:
    """DistilBertForMaskedLM keys -> the canonical space. DistilBERT has no
    token-type table: a zero row stands in (use_token_type=False keeps it
    out of the forward)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.endswith(".position_ids"):
            continue
        if k.startswith("distilbert."):
            k = k[len("distilbert."):]
        if k.startswith("embeddings."):
            k = "bert." + k
        elif k.startswith("transformer.layer."):
            parts = k.split(".")
            mapped = _DISTIL_LEAF_MAP.get(".".join(parts[3:-1]))
            if mapped is not None:
                k = f"bert.encoder.layer.{parts[2]}.{mapped}.{parts[-1]}"
        else:
            for src, dst in _DISTIL_HEAD.items():
                if k.startswith(src):
                    k = dst + k[len(src):]
                    break
        out[k] = v
    word = out.get("bert.embeddings.word_embeddings.weight")
    if word is not None:
        out.setdefault("bert.embeddings.token_type_embeddings.weight",
                       np.zeros((cfg.type_vocab_size, word.shape[1]), dtype=word.dtype))
    return out


def _canonicalize(sd: Dict[str, np.ndarray], cfg: BertConfig) -> Dict[str, np.ndarray]:
    if cfg.model_type == "roberta":
        return _canon_roberta(sd)
    if cfg.model_type == "distilbert":
        return _canon_distilbert(sd, cfg)
    return _canon_bert(sd)


def _pad_rows(x: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows,) + x.shape[1:], dtype=np.float32)
    out[: x.shape[0]] = x
    return out


def params_from_state_dict(sd: Dict[str, np.ndarray],
                           cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """HF state dict (numpy, any hosted layout family) -> the port's
    BertForMaskedLM state dict. HF Linear weights are [out, in], the port's
    layout, so nothing is transposed; vocab rows are zero-padded to
    cfg.padded_vocab_size. A dense dump with no MLM head (an AutoModel
    checkpoint, as dense teachers are) gets a fresh head: an identity
    transform, unit LayerNorm and zero bias, which only `encode_hidden`
    callers should rely on."""
    sd = _canonicalize(sd, cfg)
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
    if "cls.predictions.transform.dense.weight" in sd:
        for leaf, name in (("transform.dense", "transform"),
                           ("transform.LayerNorm", "layer_norm")):
            for part in ("weight", "bias"):
                out[f"mlm_head.{name}.{part}"] = a(f"cls.predictions.{leaf}.{part}")
        bias_key = ("cls.predictions.bias" if "cls.predictions.bias" in sd
                    else "cls.predictions.decoder.bias")
        out["mlm_head.bias"] = torch.from_numpy(_pad_rows(sd[bias_key], pv))
    else:
        logger.warning("checkpoint has no MLM head (cls.predictions.*): importing a "
                       "fresh head, valid for dense (CLS/mean) teachers only")
        d = cfg.hidden_size
        out.update({"mlm_head.transform.weight": torch.eye(d),
                    "mlm_head.transform.bias": torch.zeros(d),
                    "mlm_head.layer_norm.weight": torch.ones(d),
                    "mlm_head.layer_norm.bias": torch.zeros(d),
                    "mlm_head.bias": torch.zeros(pv)})
    dec = sd.get("cls.predictions.decoder.weight")
    if dec is not None and not np.array_equal(dec, word):
        out["mlm_head.decoder"] = torch.from_numpy(_pad_rows(dec, pv))
    return out


def modernbert_params(sd: Dict[str, np.ndarray],
                      cfg: ModernBertConfig) -> Dict[str, torch.Tensor]:
    """ModernBertForMaskedLM's HF state dict -> the port's: `model.` taken
    off, vocab rows zero-padded to cfg.padded_vocab_size; the tied
    `decoder.weight`, where the file has it, is the token embeddings and
    is not read."""
    from .modernbert import state_dict_names

    pv = cfg.padded_vocab_size
    own = {(k[len("model."):] if k.startswith("model.") else k): v for k, v in sd.items()}
    want = state_dict_names(cfg)
    missing = [k for k in want if k not in own]
    if missing:
        raise UnsupportedArchitecture(
            f"checkpoint does not map to the ModernBERT-MLM layout: {len(missing)} "
            f"required keys missing, first few: {missing[:6]}")
    out = {}
    for k in want:
        v = np.asarray(own[k], dtype=np.float32)
        out[k] = torch.from_numpy(_pad_rows(v, pv) if k in _MODERNBERT_VOCAB_ROWS
                                  else np.array(v))
    return out


def load_checkpoint(
    ckpt_dir: str, param_dtype=torch.float32, compute_dtype=torch.bfloat16,
) -> Tuple[BertConfig, Dict[str, torch.Tensor], Optional[np.ndarray]]:
    """(config, the port's state dict, idf vector or None) from an HF-layout
    checkpoint dir."""
    cfg = config_from_hf_json(os.path.join(ckpt_dir, "config.json"),
                              param_dtype, compute_dtype)
    read = modernbert_params if isinstance(cfg, ModernBertConfig) else params_from_state_dict
    sd = read(_read_state_dict(ckpt_dir), cfg)
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


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


def state_dict_from_module(bert, cfg: BertConfig) -> Dict[str, np.ndarray]:
    """The port's BertForMaskedLM -> the HF state dict in the canonical BERT
    key space (numpy fp32,
    contiguous: safetensors writes raw buffers). Padded vocab rows are cut;
    the decoder is written out even when tied, as HF does."""
    own = {k: v.detach().to("cpu", torch.float32).contiguous().numpy()
           for k, v in bert.state_dict().items()}
    v = cfg.vocab_size
    word = own["embeddings.word_embeddings"]
    sd = {
        "bert.embeddings.word_embeddings.weight": word[:v],
        "bert.embeddings.position_embeddings.weight": own["embeddings.position_embeddings"],
        "bert.embeddings.token_type_embeddings.weight": own["embeddings.token_type_embeddings"],
        "bert.embeddings.LayerNorm.weight": own["embeddings.layer_norm.weight"],
        "bert.embeddings.LayerNorm.bias": own["embeddings.layer_norm.bias"],
        "cls.predictions.bias": own["mlm_head.bias"][:v],
        "cls.predictions.decoder.weight": own.get("mlm_head.decoder", word)[:v],
    }
    for leaf, name in (("transform.dense", "transform"), ("transform.LayerNorm", "layer_norm")):
        for part in ("weight", "bias"):
            sd[f"cls.predictions.{leaf}.{part}"] = own[f"mlm_head.{name}.{part}"]
    for i in range(cfg.num_hidden_layers):
        for leaf, name in _LAYER_LEAVES.items():
            for part in ("weight", "bias"):
                sd[f"bert.encoder.layer.{i}.{leaf}.{part}"] = own[f"layers.{i}.{name}.{part}"]
    return {k: np.ascontiguousarray(a) for k, a in sd.items()}


def _decanon_roberta(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    inv_head = {v: k for k, v in _ROBERTA_HEAD.items()}
    for k, v in sd.items():
        if k.startswith("bert."):
            k = "roberta." + k[len("bert."):]
        elif k == "cls.predictions.bias":
            out["lm_head.decoder.bias"] = v  # HF keeps the tied duplicate
            k = "lm_head.bias"
        else:
            for src, dst in inv_head.items():
                if k.startswith(src):
                    k = "lm_head." + dst + k[len(src):]
                    break
        out[k] = v
    return out


def _decanon_distilbert(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    inv_leaf = {v: k for k, v in _DISTIL_LEAF_MAP.items()}
    inv_head = {v: k for k, v in _DISTIL_HEAD.items()}
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k == "bert.embeddings.token_type_embeddings.weight":
            continue  # the layout has no token-type table
        if k.startswith("bert.embeddings."):
            k = "distilbert." + k[len("bert."):]
        elif k.startswith("bert.encoder.layer."):
            parts = k.split(".")
            k = (f"distilbert.transformer.layer.{parts[3]}."
                 f"{inv_leaf['.'.join(parts[4:-1])]}.{parts[-1]}")
        else:
            for src, dst in inv_head.items():
                if k.startswith(src):
                    k = dst + k[len(src):]
                    break
        out[k] = v
    return out


def modernbert_state_dict(bert, cfg: ModernBertConfig) -> Dict[str, np.ndarray]:
    """The port's ModernBertForMaskedLM -> HF's ModernBertForMaskedLM state
    dict (numpy fp32, contiguous; padded vocab rows cut; the tied decoder
    written out, as HF does)."""
    v = cfg.vocab_size
    sd = {}
    for k, t in bert.state_dict().items():
        a = t.detach().to("cpu", torch.float32).numpy()
        if k in _MODERNBERT_VOCAB_ROWS:
            a = a[:v]
        hf_key = k if k.startswith(("head.", "decoder.")) else "model." + k
        sd[hf_key] = np.ascontiguousarray(a)
    sd["decoder.weight"] = sd["model.embeddings.tok_embeddings.weight"]
    return sd


def _config_json_for_export(cfg) -> Dict:
    """config.json of the backbone's own layout family, as the JAX
    package's export writes it (ModernBERT: the published keys)."""
    if isinstance(cfg, ModernBertConfig):
        return {"architectures": ["ModernBertForMaskedLM"], "model_type": "modernbert",
                **{k: getattr(cfg, k) for k in _MODERNBERT_KEYS},
                "norm_bias": False, "attention_bias": False, "mlp_bias": False,
                "classifier_bias": False, "decoder_bias": True, "tie_word_embeddings": True,
                "hidden_activation": "gelu", "classifier_activation": "gelu"}
    if cfg.model_type == "roberta":
        return {
            "architectures": ["RobertaForMaskedLM"],
            "model_type": "roberta",
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "intermediate_size": cfg.intermediate_size,
            "max_position_embeddings": cfg.max_position_embeddings,
            "type_vocab_size": cfg.type_vocab_size,
            "layer_norm_eps": cfg.layer_norm_eps,
            "hidden_dropout_prob": cfg.hidden_dropout_prob,
            "attention_probs_dropout_prob": cfg.attention_probs_dropout_prob,
            "hidden_act": cfg.hidden_act,
            "pad_token_id": cfg.pad_token_id,
            "bos_token_id": 0,
            "eos_token_id": 2,
        }
    if cfg.model_type == "distilbert":
        return {
            "architectures": ["DistilBertForMaskedLM"],
            "model_type": "distilbert",
            "vocab_size": cfg.vocab_size,
            "dim": cfg.hidden_size,
            "n_layers": cfg.num_hidden_layers,
            "n_heads": cfg.num_attention_heads,
            "hidden_dim": cfg.intermediate_size,
            "max_position_embeddings": cfg.max_position_embeddings,
            "dropout": cfg.hidden_dropout_prob,
            "attention_dropout": cfg.attention_probs_dropout_prob,
            "activation": cfg.hidden_act,
            "pad_token_id": cfg.pad_token_id,
            "sinusoidal_pos_embds": False,
            "tie_weights_": True,
        }
    return {
        "architectures": ["BertForMaskedLM"],
        "model_type": "bert",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "type_vocab_size": cfg.type_vocab_size,
        "layer_norm_eps": cfg.layer_norm_eps,
        "hidden_dropout_prob": cfg.hidden_dropout_prob,
        "attention_probs_dropout_prob": cfg.attention_probs_dropout_prob,
        "hidden_act": cfg.hidden_act,
        "pad_token_id": cfg.pad_token_id,
    }


def save_checkpoint(model, output_dir: str):
    """Write an HF-layout checkpoint dir from a SparseEncoderModel, in the
    backbone's own layout family (bert, roberta, distilbert or modernbert): backbone
    (`model.safetensors`), `config.json` and the tokenizer always, `idf.json`
    only when the IDF vector trains (reference ModelWrapper.save,
    trainer.py:37-49). The JAX package's `save_checkpoint` writes the same
    bytes for the same weights."""
    from safetensors.numpy import save_file

    os.makedirs(output_dir, exist_ok=True)
    cfg = model.cfg
    if isinstance(cfg, ModernBertConfig):
        sd = modernbert_state_dict(model.bert, cfg)
    else:
        sd = state_dict_from_module(model.bert, cfg)
    if cfg.model_type == "roberta":
        sd = _decanon_roberta(sd)
    elif cfg.model_type == "distilbert":
        sd = _decanon_distilbert(sd)
    save_file(sd, os.path.join(output_dir, "model.safetensors"))
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(_config_json_for_export(cfg), f, indent=2)
    model.tokenizer.save_pretrained(output_dir)
    if model.idf_requires_grad:
        idf = model.idf_vector.detach().to("cpu", torch.float32).numpy()
        idf_json = {model.tokenizer.convert_id_to_token(int(i)): float(idf[i])
                    for i in np.nonzero(idf)[0]}
        with open(os.path.join(output_dir, "idf.json"), "w") as f:
            json.dump(idf_json, f)
