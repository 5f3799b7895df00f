"""Sparse encoder: BERT-MLM backbone -> vocab-space sparse representations.

The port of the JAX package's `models/sparse_encoder.py` (reference
`SparseModel` / `SparseEncoder`, sparse_encoders.py:42-181):

  * `SparseEncoderModel` is an nn.Module holding the BERT module, the
    (learnable) IDF vector and the tokenizer;
  * `encode_doc` / `encode_query_inf_free` / `encode` are plain functions of
    that module;
  * `BatchEncoder` tokenizes, runs the forward on the device, takes the
    on-device top-`l_max` sparsification, and accumulates the FLOPS count
    statistic on the device until it is read. Its stages are the spans
    `data.tokenize`, `data.copy_in`, `encoder.forward`, `encoder.topk` and
    `encoder.copy_out` (`utils/tracing.py`), and it counts the positions
    the encoder runs (`encoder.positions`, each row padded to its batch's
    length), the real tokens among them (`encoder.tokens`), the batches
    it runs at each length L (`encoder.batch_len.<L>`), the ingest
    chunks resolved through their own event on a CUDA device
    (`encoder.copy_out.async`, of which `encoder.copy_out.waited` found
    the chunk's copy still running) and the ingest batches that ran the
    encoder stack eagerly and not from its CUDA graph
    (`encoder.graph.eager`, beside the runner's `encoder.graph.replays`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, NamedTuple, Optional, Sequence

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
from ..utils import tracing
from . import bert as bert_mod
from . import kimi_linear, modernbert, moonlight
from .bert import BertConfig, BertForMaskedLM
from .tokenizer import load_idf_weights, load_tokenizer

logger = logging.getLogger(__name__)


class SparseEncoderModel(nn.Module):
    """Masked-LM module + IDF vector + tokenizer (reference SparseModel).
    The module (`bert`) is a `BertForMaskedLM` of the BERT family or a
    `ModernBertForMaskedLM`, a `MoonlightForCausalLM` or a
    `KimiLinearForCausalLM`: each gives
    `encode_hidden`, `mlm_maxpool` and `decoder_weight`."""

    def __init__(
        self,
        cfg: BertConfig,  # or modernbert.ModernBertConfig, moonlight.MoonlightConfig
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
        device = bert.decoder_weight().device
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
               attention_mask: torch.Tensor,
               dropout_key: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Full forward: masked max-pool of the MLM logits (the fused kernel) ->
    log1p(relu) [-> log1p] [-> prune]. Output [B, vocab_size] fp32 (padded
    vocab columns dropped). Reference `_encode` (sparse_encoders.py:107-119).
    Training mode is a `dropout_key` (dropout on, its generators seeded from
    the key) with grad enabled."""
    hidden = model.bert.encode_hidden(input_ids, attention_mask, dropout_key=dropout_key)
    return _doc_rep(model, model.bert.mlm_maxpool(hidden, attention_mask))


def _doc_rep(model: SparseEncoderModel, pooled: torch.Tensor) -> torch.Tensor:
    """The doc rep [B, vocab_size] of the head's pooled logits [B,
    padded_V]."""
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


_BATCH_LEN_STEP = 64  # a batch's length is a multiple of this


def _doubling_buckets(max_length: int) -> List[int]:
    """The widths the tokenizer pads a chunk to: 64, 128, 256, ... below
    max_length, then max_length."""
    out, b = [], 64
    while b < max_length:
        out.append(b)
        b *= 2
    return out + [max_length]


def _batch_bounds(n: int, rows: int):
    """(starts, ends) of the ceil(n / rows) batches of a chunk of n rows:
    each of `rows` rows but the first, which holds what is left over."""
    ends = np.arange(n, 0, -rows)[::-1]
    return np.maximum(ends - rows, 0), ends


def _batch_lengths(lengths: np.ndarray, rows: int, width: int) -> np.ndarray:
    """Each batch's length, over rows of the given lengths in order cut as
    `_batch_bounds` cuts them: the smallest multiple of _BATCH_LEN_STEP that
    holds its longest row (at least one step), capped at `width`."""
    longest = np.maximum.reduceat(lengths, _batch_bounds(len(lengths), rows)[0])
    steps = np.maximum(-(-longest // _BATCH_LEN_STEP), 1)
    return np.minimum(steps * _BATCH_LEN_STEP, width)


def takes_graph(device: torch.device, batch_rows: int, rows: int) -> bool:
    """Whether an ingest batch of `batch_rows` replays the backbone's CUDA
    graph of its encoder stack, where the backbone has one
    (`BertForMaskedLM.graph_maxpool`): on a CUDA device, a full batch of the
    chunk's `rows`. The packer runs each full batch at `rows` x a multiple
    of 64 up to max_length, so a few shapes serve every chunk; the chunk's
    short first batch, and every batch off a card, runs eagerly."""
    return device.type == "cuda" and batch_rows == rows


def _topk_rows(rep: torch.Tensor, k: int):
    """Top-k per row with inactive slots zeroed: (idx int32, vals fp32)."""
    vals, idx = torch.topk(rep, k, dim=1)
    active = vals > 0
    return torch.where(active, idx, 0).to(torch.int32), torch.where(active, vals, 0.0)


# ---------------------------------------------------------------------------
# Host-side batch encoder (ingest / search path)
# ---------------------------------------------------------------------------


def sparse_embedding_to_query(
    token_weight_map: Dict[str, float],
    field_name: str = "text_sparse",
    query_prune: float = 0,
) -> Dict:
    """The OpenSearch `neural_sparse` query body of a {token: weight} map
    (reference sparse_encoders.py:184-194), for clients that still send
    queries to an OpenSearch cluster; the native path is
    `SparseIndex.search_tokens`."""
    if query_prune > 0:
        thresh = max(token_weight_map.values()) * query_prune
        token_weight_map = {t: w for t, w in token_weight_map.items() if w > thresh}
    return {"neural_sparse": {field_name: {"query_tokens": token_weight_map}}}


def sparse_to_token_weight_dicts(reps: np.ndarray, tokenizer) -> List[Dict[str, float]]:
    """Dense [B, V] -> one {token: weight} map per row, nonzero entries only
    (reference SparsePostProcessor, sparse_encoders.py:130-150, without its
    sentinel at index 0)."""
    out = []
    for row in reps:
        (idx,) = np.nonzero(row)
        out.append({tokenizer.convert_id_to_token(i): float(row[i]) for i in idx})
    return out


class ChunkHandle(NamedTuple):
    """A chunk queued by `BatchEncoder.encode_chunk_sparse_async`: its rows
    on the device in length-sorted order (idx, vals), the activation count
    of its full reps, each text's row (pos), and on a CUDA device the event
    recorded after the rows' copy out and the page-locked buffers that copy
    fills (all three None on the CPU)."""

    idx: torch.Tensor
    vals: torch.Tensor
    count: torch.Tensor
    pos: np.ndarray
    done: Optional[torch.cuda.Event]
    idx_host: Optional[torch.Tensor]
    vals_host: Optional[torch.Tensor]


class BatchEncoder:
    """Tokenize -> forward on the device -> sparse reps; accumulates the
    per-token activation counts for the FLOPS statistic on the device
    (reference SparseEncoder, sparse_encoders.py:153-181). Every text
    reaches the card through one packer (`_pack`); the sparse rows of a
    chunk (`encode_chunk_sparse_async` / `resolve_chunk_sparse`) and the
    dense reps (`encode_batch_device`, with `encode_batch` and `encode` its
    host views) are two products of the same batch loop."""

    def __init__(self, model: SparseEncoderModel, max_length: int = 512,
                 do_count: bool = True):
        self.model = model
        self.device = model.device
        self.max_length = max_length
        self.do_count = do_count
        self.reset_count()

    # ------------------------------------------------------------- counts
    def reset_count(self):
        self.count_tensor = np.zeros((self.model.vocab_size,), dtype=np.int64)

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

    def _accum_count(self, count_dev: torch.Tensor):
        if not self.do_count:
            return
        self._count_dev = count_dev if self._count_dev is None else self._count_dev + count_dev

    # ------------------------------------------------------------- packer
    def _pack(self, texts: List[str], rows: int, runs_encoder: bool = True):
        """Tokenize texts once and order them by length (a stable sort), cut
        into ceil(n / rows) batches (`_batch_bounds`): all of `rows` rows
        but the first, which holds the shortest texts and whatever `rows`
        does not divide, so that the full batches keep the batch shape and
        the short one costs least. Each batch runs at its own length
        (`_batch_lengths`). When the encoder runs on them (not for
        inference-free queries) counts the positions the batches run, the
        real tokens, and each batch under `encoder.batch_len.<L>`.

        Returns (batches, pos, pos_dev): each batch's (ids, mask) on the
        device, [rows_i, L_i] and contiguous, views of one copy of the
        chunk; each text's row in that order, in input order, on the host
        and on the device. On a CUDA device the chunk is packed in
        page-locked host memory and copied without blocking: the copy is
        queued on the stream behind the work already there, and the host
        goes on at once. The caching host allocator keeps the block until
        that copy has run."""
        n = len(texts)
        with tracing.span("data.tokenize"):
            feats = self.model.tokenizer.encode_bucketed(
                texts, self.max_length, _doubling_buckets(self.max_length)
            )
            ids, mask = feats["input_ids"], feats["attention_mask"]
            lens = mask.sum(axis=1)
            order = np.argsort(lens, kind="stable")
            pos = np.empty(n, np.int64)
            pos[order] = np.arange(n)
            starts, ends = _batch_bounds(n, rows)
            widths = _batch_lengths(lens[order], rows, ids.shape[1])
            total = int(((ends - starts) * widths).sum())
            flat = torch.empty(2 * total + n, dtype=torch.from_numpy(ids).dtype,
                               pin_memory=self.device.type == "cuda")
            host = flat.numpy()
            off = 0
            for lo, hi, w in zip(starts, ends, widths):
                sel, size = order[lo:hi], (hi - lo) * w
                host[off:off + size] = ids[sel, :w].ravel()
                host[total + off:total + off + size] = mask[sel, :w].ravel()
                off += size
            host[2 * total:] = pos
            if runs_encoder:
                tracing.count("encoder.positions", total)
                tracing.count("encoder.tokens", int(lens.sum()))
                for w in widths:
                    tracing.count(f"encoder.batch_len.{int(w)}")
        with tracing.span("data.copy_in"):
            dev = flat.to(self.device, non_blocking=True)
        batches, off = [], 0
        for lo, hi, w in zip(starts, ends, widths):
            shape, size = (int(hi - lo), int(w)), int((hi - lo) * w)
            batches.append((dev[off:off + size].view(shape),
                            dev[total + off:total + off + size].view(shape)))
            off += size
        return batches, pos, dev[2 * total:]

    # ------------------------------------------------------- dense reps
    @torch.inference_mode()
    def encode_batch_device(self, texts: List[str], inf_free: bool = False,
                            rows: Optional[int] = None) -> torch.Tensor:
        """[len(texts), V] reps on the device, in input order. The texts run
        as the packer's length-sorted batches of `rows` (one batch when
        None), so memory is bounded by one batch's forward; their rows are
        gathered back to input order through `pos`."""
        if not texts:  # the packer makes no batch of no texts
            return torch.zeros((0, self.model.vocab_size), device=self.device)
        batches, _, pos = self._pack(texts, rows or len(texts), runs_encoder=not inf_free)
        with tracing.span("encoder.forward"):
            reps = torch.cat([encode(self.model, ids, mask, inf_free) for ids, mask in batches])
        self._accum_count(activation_count(reps))
        return reps.index_select(0, pos)

    def encode_batch(self, texts: List[str], inf_free: bool = False) -> np.ndarray:
        reps = self.encode_batch_device(texts, inf_free=inf_free)
        with tracing.span("encoder.copy_out"):
            return reps.cpu().numpy()

    def encode(self, texts: List[str], inf_free: bool = False) -> List[Dict[str, float]]:
        """{token: weight} maps of `texts` (the serving `_encode` route)."""
        reps = self.encode_batch(texts, inf_free=inf_free)
        return sparse_to_token_weight_dicts(reps, self.model.tokenizer)

    # ------------------------------------------------------ sparse reps
    @torch.inference_mode()
    def encode_chunk_sparse_async(self, texts: List[str], l_max: int = 256,
                                  rows: int = 256):
        """The ingest path: a chunk of texts through the packer, encoded as
        a loop over its length-sorted batches of `rows`, each at its own
        length: the smallest multiple of 64 that holds its longest doc,
        capped at the chunk's bucket. A full batch replays the backbone's
        CUDA graph of its encoder stack where `takes_graph` says so, the
        others run it eagerly (`encoder.graph.eager`); the head runs eagerly
        on both. Each forward is followed by the count of its full rep (the
        top-k below is an index storage decision and must not change the
        FLOPS/d_length statistic) and its top-`l_max`. Returns (ChunkHandle,
        n_valid): the rows in the sorted order and the row of each text;
        resolve with `resolve_chunk_sparse`.

        On a CUDA device nothing here waits for the stream: the chunk's rows
        are queued for a copy into page-locked host buffers (idx_host,
        vals_host) right behind its top-k, and `done` is an event recorded
        after that copy, so the resolve waits for this chunk alone and not
        for work queued after it."""
        batches, pos, _ = self._pack(texts, rows)
        k = min(l_max, self.model.vocab_size)
        idxs, valss = [], []
        count = torch.zeros(self.model.vocab_size, dtype=torch.int32, device=self.device)
        graphed = getattr(self.model.bert, "graph_maxpool", None)
        for ids, mask in batches:
            with tracing.span("encoder.forward"):
                if graphed is not None and takes_graph(self.device, ids.shape[0], rows):
                    rep = _doc_rep(self.model, graphed(ids, mask))
                else:
                    tracing.count("encoder.graph.eager")
                    rep = encode_doc(self.model, ids, mask)
            with tracing.span("encoder.topk"):
                count += activation_count(rep)
                idx, vals = _topk_rows(rep, k)
            idxs.append(idx)
            valss.append(vals)
        with tracing.span("encoder.topk"):
            idx, vals = torch.cat(idxs), torch.cat(valss)
            done = idx_host = vals_host = None
            if self.device.type == "cuda":
                idx_host = torch.empty(idx.shape, dtype=idx.dtype, pin_memory=True)
                vals_host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
                idx_host.copy_(idx, non_blocking=True)
                vals_host.copy_(vals, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
            return ChunkHandle(idx, vals, count, pos, done, idx_host, vals_host), len(texts)

    def resolve_chunk_sparse(self, handle: ChunkHandle, n_valid: int):
        """(token_idx [n_valid, l_max] int32, weights [n_valid, l_max] fp32)
        of a chunk handle's first n_valid texts, in the order of the chunk's
        texts (inactive slots hold (0, 0.0)), and fold the chunk's
        activation count into the device accumulator. A handle with an
        event waits for that event alone (`encoder.copy_out.async` counts
        these resolves, `encoder.copy_out.waited` those that found the copy
        not yet done); the rows returned are copies, never views of its
        host buffers, which the allocator hands out again once the handle
        is dropped."""
        idx, vals, count, pos, done, idx_host, vals_host = handle
        with tracing.span("encoder.copy_out"):
            if done is None:
                idx_host, vals_host = idx.cpu(), vals.cpu()
            else:
                tracing.count("encoder.copy_out.async")
                if not done.query():
                    tracing.count("encoder.copy_out.waited")
                    done.synchronize()
            self._accum_count(count)
            sel = pos[:n_valid]
            return idx_host.numpy()[sel], vals_host.numpy()[sel]


def get_batch_encoder(
    model: SparseEncoderModel,
    max_length: int = 512,
    do_count: bool = True,
    scope=None,
) -> BatchEncoder:
    """One BatchEncoder per (model, max_length, do_count, scope), reused
    across calls with its count state reset, as a fresh encoder would have
    it."""
    key = (max_length, do_count, scope)
    cache = model.__dict__.setdefault("_encoder_cache", {})
    enc = cache.get(key)
    if enc is None:
        enc = cache[key] = BatchEncoder(model, max_length=max_length, do_count=do_count)
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
    param_dtype=None,
    compute_dtype=torch.bfloat16,
    device: DeviceLike = None,
    remat: bool = False,
) -> SparseEncoderModel:
    """Factory mirroring reference `get_model` (utils.py:50-68). Weights come
    from a local HF-layout checkpoint dir, else a seeded random init of an
    `arch` preset ("mini" by default; "modernbert-large" and
    "modernbert-tiny" are ModernBERT, "moonlight-16b-a3b" and
    "moonlight-tiny" Moonlight, "kimi-linear-48b-a3b-ep2" and
    "kimi-linear-tiny" Kimi Linear, each with its own vocab, the BERT presets
    take the tokenizer's). `param_dtype` is the parameters' dtype, float32
    when None; a Moonlight or Kimi Linear preset holds its matrices in the
    compute dtype
    and its norm scales and router in float32, draws its weights on the
    device one tensor at a time, and raises for a `param_dtype` other than
    None or the compute dtype. Runs on the CUDA card unless `device="cpu"`; raises without a
    card."""
    from . import hf_import

    dev = resolve_device(device)
    tokenizer = load_tokenizer(tokenizer_name or model_name_or_path,
                               preprocess_func=preprocess_func)
    tokenizer.try_attach_native()  # C++ fast path for bulk ingest/search

    arch = arch or "mini"
    if model_name_or_path and os.path.isdir(model_name_or_path):
        cfg, sd, loaded_idf = hf_import.load_checkpoint(
            model_name_or_path, param_dtype=resolve_dtype(param_dtype),
            compute_dtype=compute_dtype
        )
    elif arch in moonlight.PRESETS or arch in kimi_linear.PRESETS:
        if param_dtype is not None and resolve_dtype(param_dtype) != compute_dtype:
            raise ValueError(f"{arch} holds its matrices in the compute dtype {compute_dtype} "
                             f"(its norm scales and router in float32); param_dtype "
                             f"{param_dtype} does not apply")
        family = moonlight if arch in moonlight.PRESETS else kimi_linear
        cfg = family.config_from_preset(arch, compute_dtype=compute_dtype)
        sd, loaded_idf = family.init_state_dict(cfg, seed, dev), None
    else:
        if arch in modernbert.PRESETS:
            cfg = modernbert.config_from_preset(arch, param_dtype=resolve_dtype(param_dtype),
                                                compute_dtype=compute_dtype)
        else:
            cfg = bert_mod.config_from_preset(
                arch, vocab_size=tokenizer.vocab_size,
                param_dtype=resolve_dtype(param_dtype), compute_dtype=compute_dtype,
            )
        sd, loaded_idf = backbone_module(cfg).init_state_dict(cfg, seed), None
    # a training knob, not a checkpoint property: loaded checkpoints take it too
    # (a ModernBERT backbone does not train)
    if isinstance(cfg, BertConfig) and cfg.remat != remat:
        cfg = dataclasses.replace(cfg, remat=remat)

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
        bert=backbone_module(cfg).from_state_dict(cfg, sd, dev),
        idf_vector=torch.from_numpy(idf),
        tokenizer=tokenizer,
        use_l0=use_l0,
        prune_ratio=prune_ratio,
        idf_requires_grad=idf_requires_grad,
    )


def backbone_module(cfg):
    """The module (`models/bert.py`, `models/modernbert.py`,
    `models/moonlight.py` or `models/kimi_linear.py`) that builds and
    initialises the backbone of `cfg`."""
    if isinstance(cfg, moonlight.MoonlightConfig):
        return moonlight
    if isinstance(cfg, kimi_linear.KimiLinearConfig):
        return kimi_linear
    return modernbert if isinstance(cfg, modernbert.ModernBertConfig) else bert_mod


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
        remat=getattr(model_args, "remat", False),
    )
