"""Sparse encoder: BERT-MLM backbone -> vocab-space sparse representations.

The port of the JAX package's `models/sparse_encoder.py` (reference
`SparseModel` / `SparseEncoder`, sparse_encoders.py:42-181):

  * `SparseEncoderModel` is an nn.Module holding the BERT module, the
    (learnable) IDF vector and the tokenizer;
  * `encode_doc` / `encode_query_inf_free` / `encode` are plain functions of
    that module;
  * `BatchEncoder` tokenizes, runs the forward on the device, takes the
    on-device top-`l_max` sparsification, and accumulates the FLOPS count
    statistic on the device until it is read.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device, resolve_dtype
from ..ops.activations import (
    activation_count,
    inf_free_activation,
    pooled_activation,
    special_token_mask,
)
from ..utils.shapes import next_pow2
from . import bert as bert_mod
from .bert import BertConfig, BertForMaskedLM
from .tokenizer import load_idf_weights, load_tokenizer

logger = logging.getLogger(__name__)


class SparseEncoderModel(nn.Module):
    """BERT-MLM module + IDF vector + tokenizer (reference SparseModel)."""

    def __init__(
        self,
        cfg: BertConfig,
        bert: BertForMaskedLM,
        idf_vector: torch.Tensor,  # [vocab_size] fp32
        tokenizer,
        use_l0: bool = False,
        prune_ratio: Optional[float] = None,
        idf_requires_grad: bool = False,
    ):
        super().__init__()
        self.cfg = cfg
        self.bert = bert
        device = bert.embeddings.word_embeddings.device
        self.idf_vector = nn.Parameter(
            idf_vector.to(device=device, dtype=torch.float32),
            requires_grad=idf_requires_grad,
        )
        self.tokenizer = tokenizer
        self.use_l0 = use_l0
        self.prune_ratio = prune_ratio
        self.idf_requires_grad = idf_requires_grad
        self.register_buffer(
            "special_mask",
            special_token_mask(tokenizer.special_token_ids, cfg.vocab_size, device),
            persistent=False,
        )

    @property
    def vocab_size(self) -> int:
        return self.cfg.vocab_size

    @property
    def device(self) -> torch.device:
        return self.idf_vector.device

    def forward(self, input_ids, attention_mask, inf_free: bool = False):
        return encode(self, input_ids, attention_mask, inf_free)


# ---------------------------------------------------------------------------
# Encode functions
# ---------------------------------------------------------------------------


def encode_doc(model: SparseEncoderModel, input_ids: torch.Tensor,
               attention_mask: torch.Tensor) -> torch.Tensor:
    """Full forward: masked max-pool of the MLM logits (the fused kernel) ->
    log1p(relu) [-> log1p] [-> prune]. Output [B, vocab_size] fp32 (padded
    vocab columns dropped). Reference `_encode` (sparse_encoders.py:107-119)."""
    hidden = model.bert.encode_hidden(input_ids, attention_mask)
    pooled = model.bert.mlm_maxpool(hidden, attention_mask)
    rep = pooled_activation(pooled, use_l0=model.use_l0, prune_ratio=model.prune_ratio)
    return rep[:, : model.cfg.vocab_size]


def encode_query_inf_free(model: SparseEncoderModel,
                          input_ids: torch.Tensor) -> torch.Tensor:
    """Inference-free query encoding (reference `_encode_inf_free`,
    sparse_encoders.py:121-127): no transformer forward at all."""
    return inf_free_activation(input_ids, model.idf_vector, model.special_mask,
                               model.cfg.vocab_size)


def encode(model: SparseEncoderModel, input_ids, attention_mask, inf_free: bool):
    """Dispatch mirroring reference `SparseModel.forward` (:100-105)."""
    if inf_free:
        return encode_query_inf_free(model, input_ids)
    return encode_doc(model, input_ids, attention_mask)


def _topk_rows(rep: torch.Tensor, k: int):
    """Top-k per row with inactive slots zeroed: (idx int32, vals fp32)."""
    vals, idx = torch.topk(rep, k, dim=1)
    active = vals > 0
    return torch.where(active, idx, 0).to(torch.int32), torch.where(active, vals, 0.0)


# ---------------------------------------------------------------------------
# Host-side batch encoder (ingest / search path)
# ---------------------------------------------------------------------------


class BatchEncoder:
    """Tokenize -> forward on the device -> sparse reps; accumulates the
    per-token activation counts for the FLOPS statistic on the device
    (reference SparseEncoder, sparse_encoders.py:153-181)."""

    def __init__(
        self,
        model: SparseEncoderModel,
        max_length: int = 512,
        seq_buckets: Optional[List[int]] = None,
        do_count: bool = True,
    ):
        self.model = model
        self.device = model.device
        self.max_length = max_length
        self.seq_buckets = sorted(
            b for b in (seq_buckets or [64, 128, 256, 512]) if b <= max_length
        ) or [max_length]
        if self.seq_buckets[-1] < max_length:
            self.seq_buckets.append(max_length)
        self.do_count = do_count
        self.reset_count()

    # ------------------------------------------------------------- counts
    def reset_count(self):
        self.count_tensor = np.zeros((self.model.vocab_size,), dtype=np.int64)
        self._n_encoded = 0

    @property
    def count_tensor(self) -> np.ndarray:
        """Counts stay on the device (one add per batch) until read here."""
        if self._count_dev is not None:
            self._count_host = self._count_host + self._count_dev.cpu().numpy().astype(np.int64)
            self._count_dev = None
        return self._count_host

    @count_tensor.setter
    def count_tensor(self, value):
        self._count_host = np.asarray(value, dtype=np.int64)
        self._count_dev = None

    def _accum_count(self, count_dev: torch.Tensor, n: int):
        if not self.do_count:
            return
        self._count_dev = count_dev if self._count_dev is None else self._count_dev + count_dev
        self._n_encoded += n

    # ------------------------------------------------------------ helpers
    def _tokenize(self, texts: List[str], pad_rows: int = 0):
        feats = self.model.tokenizer.encode_bucketed(
            texts, self.max_length, self.seq_buckets
        )
        ids, mask = feats["input_ids"], feats["attention_mask"]
        if pad_rows:
            ids = np.concatenate([ids, np.zeros((pad_rows, ids.shape[1]), ids.dtype)])
            mask = np.concatenate([mask, np.zeros((pad_rows, mask.shape[1]), mask.dtype)])
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def _pack_chunk(self, texts: List[str], rows: int):
        """Tokenize a chunk and pad its batch count up to a power of two.
        Returns (ids [nb*rows, L], mask [nb*rows, L], n_valid, nb)."""
        n = len(texts)
        nb = next_pow2(-(-n // rows))
        ids, mask = self._tokenize(texts, pad_rows=nb * rows - n)
        return ids, mask, n, nb

    # ------------------------------------------------------- dense reps
    @torch.inference_mode()
    def encode_batch_device(self, texts: List[str], inf_free: bool = False) -> torch.Tensor:
        """[B, V] reps on the device."""
        ids, mask = self._tokenize(texts)
        reps = encode(self.model, ids, mask, inf_free)
        self._accum_count(activation_count(reps), len(texts))
        return reps

    def encode_batch(self, texts: List[str], inf_free: bool = False) -> np.ndarray:
        return self.encode_batch_device(texts, inf_free=inf_free).cpu().numpy()

    @torch.inference_mode()
    def encode_chunk_device(self, texts: List[str], inf_free: bool = False,
                            rows: int = 256):
        """Encode a large chunk of texts. Returns (reps [nb*rows, V] on the
        device, n_valid): rows beyond n_valid are padding the caller must
        ignore. The chunk runs as a loop over its `rows`-sized batches, one
        forward each, so every forward (and the max-pool kernel) sees the
        ingest batch shape and memory stays bounded by one batch."""
        ids, mask, n, nb = self._pack_chunk(texts, rows)
        reps = torch.cat([
            encode(self.model, ids[i * rows:(i + 1) * rows],
                   mask[i * rows:(i + 1) * rows], inf_free)
            for i in range(nb)
        ])
        valid = torch.arange(reps.shape[0], device=reps.device)[:, None] < n
        self._accum_count(((reps > 0) & valid).sum(dim=0).to(torch.int32), n)
        return reps, n

    # ------------------------------------------------------ sparse reps
    @torch.inference_mode()
    def encode_batch_sparse_async(self, texts: List[str], l_max: int = 256):
        """Forward + on-device top-k; returns device tensors (idx, vals,
        count) without waiting for them. Resolve with `resolve_sparse`."""
        ids, mask = self._tokenize(texts)
        rep = encode_doc(self.model, ids, mask)
        # count the FULL rep's activations (reference SparseEncoder counts
        # every rep>0 entry): the top-k below is an index storage decision
        # and must not change the FLOPS/d_length statistic
        count = activation_count(rep)
        idx, vals = _topk_rows(rep, min(l_max, self.model.vocab_size))
        return idx, vals, count

    def resolve_sparse(self, pending, n_texts: int):
        idx, vals, count = pending
        self._accum_count(count, n_texts)
        return idx.cpu().numpy(), vals.cpu().numpy()

    def resolve_sparse_many(self, pendings, n_texts_list):
        """Resolve several async handles with one host copy per tensor kind.
        Returns [(idx, vals), ...] in handle order."""
        if not pendings:
            return []
        idx_all = torch.cat([p[0] for p in pendings]).cpu().numpy()
        val_all = torch.cat([p[1] for p in pendings]).cpu().numpy()
        self._accum_count(torch.stack([p[2] for p in pendings]).sum(dim=0),
                          int(sum(n_texts_list)))
        out, off = [], 0
        for p in pendings:
            r = p[0].shape[0]
            out.append((idx_all[off:off + r], val_all[off:off + r]))
            off += r
        return out

    def encode_batch_sparse(self, texts: List[str], l_max: int = 256):
        """(token_idx [B, l_max] int32, weights [B, l_max] fp32) via the
        on-device top-k; inactive slots hold (0, 0.0)."""
        return self.resolve_sparse(self.encode_batch_sparse_async(texts, l_max), len(texts))

    @torch.inference_mode()
    def encode_chunk_sparse_async(self, texts: List[str], l_max: int = 256,
                                  rows: int = 256):
        """The ingest path: a chunk of texts, tokenized once (the longest doc
        of the chunk picks its seq bucket) and padded to a power-of-two
        batch count, encoded as a loop over its `rows`-sized batches (one
        forward each, as in encode_chunk_device), each followed by its
        validity-masked count and top-k. Returns ((idx, vals, count) device
        tensors, n_valid); resolve with `resolve_chunk_sparse`."""
        ids, mask, n, nb = self._pack_chunk(texts, rows)
        k = min(l_max, self.model.vocab_size)
        idxs, valss = [], []
        count = torch.zeros(self.model.vocab_size, dtype=torch.int32, device=self.device)
        for i in range(nb):
            sl = slice(i * rows, (i + 1) * rows)
            rep = encode_doc(self.model, ids[sl], mask[sl])
            valid = torch.arange(i * rows, (i + 1) * rows, device=rep.device)[:, None] < n
            count += ((rep > 0) & valid).sum(dim=0).to(torch.int32)
            idx, vals = _topk_rows(rep, k)
            idxs.append(idx)
            valss.append(vals)
        return (torch.cat(idxs), torch.cat(valss), count), n

    def resolve_chunk_sparse(self, handle, n_valid: int):
        """Fetch a chunk handle's (idx, vals) for its valid rows and fold the
        chunk's activation count into the device accumulator."""
        idx, vals, count = handle
        self._accum_count(count, n_valid)
        return idx[:n_valid].cpu().numpy(), vals[:n_valid].cpu().numpy()


def get_batch_encoder(
    model: SparseEncoderModel,
    max_length: int = 512,
    seq_buckets: Optional[List[int]] = None,
    do_count: bool = True,
    scope=None,
) -> BatchEncoder:
    """One BatchEncoder per (model, shape config, scope), reused across
    calls with its count state reset, as a fresh encoder would have it."""
    key = (max_length, tuple(seq_buckets or ()), do_count, scope)
    cache = model.__dict__.setdefault("_encoder_cache", {})
    enc = cache.get(key)
    if enc is None:
        enc = cache[key] = BatchEncoder(
            model, max_length=max_length, seq_buckets=seq_buckets, do_count=do_count,
        )
    else:
        enc.reset_count()
    return enc


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def build_model(
    model_name_or_path: Optional[str] = None,
    arch: Optional[str] = None,
    tokenizer_name: Optional[str] = None,
    idf_path: Optional[str] = None,
    idf_requires_grad: bool = False,
    prune_ratio: Optional[float] = None,
    preprocess_func: Optional[str] = None,
    use_l0: bool = False,
    inf_free: bool = True,
    seed: int = 0,
    param_dtype=torch.float32,
    compute_dtype=torch.bfloat16,
    device: DeviceLike = None,
) -> SparseEncoderModel:
    """Factory mirroring reference `get_model` (utils.py:50-68). Weights come
    from a local HF-layout checkpoint dir, else a seeded random init of an
    `arch` preset ("mini" by default). Runs on the CUDA card unless
    `device="cpu"`; raises without a card."""
    from . import hf_import

    dev = resolve_device(device)
    tokenizer = load_tokenizer(tokenizer_name or model_name_or_path,
                               preprocess_func=preprocess_func)
    tokenizer.try_attach_native()  # C++ fast path for bulk ingest/search

    if model_name_or_path and os.path.isdir(model_name_or_path):
        cfg, sd, loaded_idf = hf_import.load_checkpoint(
            model_name_or_path, param_dtype=param_dtype, compute_dtype=compute_dtype
        )
    else:
        cfg = bert_mod.config_from_preset(
            arch or "mini", vocab_size=tokenizer.vocab_size,
            param_dtype=param_dtype, compute_dtype=compute_dtype,
        )
        sd = bert_mod.init_state_dict(cfg, seed)
        loaded_idf = None

    if loaded_idf is not None and idf_path is None:
        idf = loaded_idf
    else:
        idf = load_idf_weights(idf_path if (inf_free and idf_path) else None, tokenizer)
    # the checkpoint's vocab wins (reference sparse_encoders.py:61-84): the
    # idf is truncated / zero-padded to it
    idf = np.asarray(idf, dtype=np.float32)
    if idf.shape[0] != cfg.vocab_size:
        logger.warning(
            "tokenizer vocab (%d) != model vocab (%d); resizing idf to the model's",
            idf.shape[0], cfg.vocab_size,
        )
        resized = np.zeros((cfg.vocab_size,), np.float32)
        m = min(idf.shape[0], cfg.vocab_size)
        resized[:m] = idf[:m]
        idf = resized

    return SparseEncoderModel(
        cfg=cfg,
        bert=bert_mod.from_state_dict(cfg, sd, dev),
        idf_vector=torch.from_numpy(idf),
        tokenizer=tokenizer,
        use_l0=use_l0,
        prune_ratio=prune_ratio,
        idf_requires_grad=idf_requires_grad,
    )


def from_model_args(model_args, seed: int = 0, device: DeviceLike = None) -> SparseEncoderModel:
    return build_model(
        model_name_or_path=model_args.model_name_or_path,
        arch=getattr(model_args, "arch", None),
        tokenizer_name=model_args.tokenizer_name,
        idf_path=model_args.idf_path,
        idf_requires_grad=model_args.idf_requires_grad,
        prune_ratio=model_args.prune_ratio,
        preprocess_func=model_args.preprocess_func,
        use_l0=model_args.use_l0,
        inf_free=model_args.inf_free,
        seed=seed,
        param_dtype=resolve_dtype(model_args.param_dtype),
        compute_dtype=resolve_dtype(model_args.compute_dtype),
        device=device,
    )
