"""What the drivers share: the program's model built from the benchmark's
weights, the head's host range, and the control's and faults' switches."""

from __future__ import annotations

import gc
import os
from typing import List

import numpy as np
import torch

from .. import roofline
from ..trace import Ranges
from ..weights import make_weights, model_keys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def program_model(m: dict, weights, device, idf_path=None, compute=torch.bfloat16):
    """The port's sparse encoder (BERT-MLM module, idf, its tokenizer with
    the native fast path) holding `weights`, float32 parameters computing in
    `compute` (bfloat16, the configurations' precision; the CPU tests also
    take float32), as the port's `build_model` makes it."""
    from opensearch_sparse_model_tuning_sample_torch.core.device import resolve_device
    from opensearch_sparse_model_tuning_sample_torch.models import bert as bert_mod
    from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as se
    from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import (load_idf_weights,
                                                                               load_tokenizer)

    device = resolve_device(device)
    cfg = bert_mod.BertConfig(
        vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
        num_hidden_layers=m["num_hidden_layers"], num_attention_heads=m["num_attention_heads"],
        intermediate_size=m["intermediate_size"],
        max_position_embeddings=m["max_position_embeddings"],
        type_vocab_size=m["type_vocab_size"], layer_norm_eps=m["layer_norm_eps"],
        hidden_dropout_prob=m["hidden_dropout_prob"],
        attention_probs_dropout_prob=m["attention_probs_dropout_prob"],
        hidden_act=m["hidden_act"], model_type=m["model_type"],
        use_token_type=m["model_type"] != "distilbert",
        param_dtype=torch.float32, compute_dtype=compute)
    with torch.device(device):
        bert = bert_mod.BertForMaskedLM(cfg)
    bert.load_state_dict(weights)
    bert.eval()
    tok = load_tokenizer(None)
    tok.try_attach_native()
    idf = load_idf_weights(os.path.join(ROOT, idf_path) if idf_path else None, tok)
    return se.SparseEncoderModel(cfg, bert, torch.from_numpy(np.asarray(idf, np.float32)), tok)


class HeadRange:
    """Wraps the head call where `models/bert.py` makes it (`attr`:
    "maxpool_head" for ingest, "maxpool_head_train" for training) in the
    host range `lsr.head`, and records each traced call's shapes."""

    def __init__(self, ranges: Ranges, attr: str):
        from opensearch_sparse_model_tuning_sample_torch.models import bert as bert_mod

        self.mod, self.attr = bert_mod, attr
        self.inner = getattr(bert_mod, attr)
        self.ranges = ranges
        self.calls: List[tuple] = []

        def wrapped(h, mask, w, bias):
            if not ranges.on:
                return self.inner(h, mask, w, bias)
            self.calls.append((h.shape[0], h.shape[1], h.shape[2]))
            with ranges("head"):
                return self.inner(h, mask, w, bias)

        setattr(bert_mod, attr, wrapped)

    def restore(self):
        setattr(self.mod, self.attr, self.inner)

    def bytes(self, V: int, train: bool) -> float:
        return sum(roofline.head_bytes(B, L, D, V, train) for B, L, D in self.calls)


def free(*devices) -> None:
    gc.collect()
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
            torch.cuda.empty_cache()


class Base:
    """A driver's shared state: the cell, its model keys, ranges, devices."""

    def __init__(self, cell):
        self.cell = cell
        self.m = model_keys(cell.config) if "vocab_size" in cell.config else None
        self.t = cell.traffic
        self.ranges = Ranges()
        self.devices = cell.devices()
        self.dev = self.devices[0]
        self.fault = cell.overrides.get("fault")

    def program_model(self, idf_path=None):
        return program_model(self.m, self.weights(), self.dev, idf_path,
                             getattr(torch, self.cell.overrides.get("compute", "bfloat16")))

    def weights(self):
        return make_weights(self.m, self.cell.seed, self.dev)

    def limits(self) -> dict:
        return self.t["limits"]

    def check(self) -> list:
        """The numbers compared after the window, each with its limit (of
        the driver's readings, those the traffic file sets a limit for)."""
        lim = self.limits()
        return [{"name": k, "value": float(v), "limit": float(lim[k])}
                for k, v in self.readings().items() if k in lim]
