"""BERT-for-Masked-LM backbone as a PyTorch module.

The port of the JAX package's `models/bert.py`, kept to its precision policy
so both packages compute the same function from the same weights:

  * embedding gathers and adds run in the compute dtype;
  * LayerNorm runs in fp32 and casts back;
  * a dense layer accumulates its product in fp32, casts it to the compute
    dtype, then adds the bias in the compute dtype;
  * GELU is the exact (erf) form, in the compute dtype;
  * attention logits and softmax are fp32, the probabilities are cast to
    the compute dtype; the additive mask is finfo(float32).min, not -inf;
  * the MLM head's logits are fp32 with an fp32 bias.

Attention takes one of two paths, by what each layer call needs. For
inference on a card in bf16 (no dropout generator, no gradient through q,
k or v, a head dim the kernel is built for) it is `ops/attention.py`'s
fused kernel (`fused_attention`: one launch a layer up to 65 535 // H docs,
more for a larger batch), which computes the same function in the same
precision without forming the `[B, H, L, L]` logits. Everywhere else (the CPU,
training with dropout or autograd, other dtypes or head dims) it is the
plain chain, `attention_chain`, counted as `encoder.attn.plain_chain`.

The vocab axis is padded up to `vocab_pad_multiple`; padded rows of the word
embeddings are zero. `mlm_maxpool` is the sparse encoder's head: it calls the
fused max-pool kernel (ops/maxpool.py), so the [B, L, V] logits never exist;
with grad on it goes through the kernel's autograd Function.

Ingest on a card replays the inference encoder stack (embeddings and every
layer, the fused attention inside them) as a CUDA graph: `GraphRunner`
captures one graph per input shape and `graph_maxpool` replays it, then runs
the head eagerly on its output. A replay launches the kernels the eager
stack launches, at the same shapes, so its hidden states are the eager
stack's bit for bit; it costs the host one launch where the eager stack
costs about 40 a layer.

Training: dropout (embeddings, attention probabilities, attention and FFN
outputs, as the JAX package places it) is on when `encode_hidden` gets a
`dropout_key`. Each layer draws its masks from its own `torch.Generator`,
seeded from (key, layer) inside the layer's function, so a layer that
`remat` recomputes in the backward (`torch.utils.checkpoint`) draws the same
masks again. The module hosts the three layout families of the HF importer
(`hf_import.py`): BERT (absolute positions, token-type embeddings), RoBERTa
(positions counted from the pad offset, a head pinned to gelu) and
DistilBERT (no token types).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.maxpool import maxpool_head, maxpool_head_train
from ..utils import tracing

# head dims the fused attention kernel is built for (csrc/attention.cu), and
# the most (doc, head) pairs one launch covers (its grid's y dimension)
_KERNEL_HEAD_DIMS = (16, 64)
_KERNEL_MAX_BH = 65535
# the counters of attention_counts(), by the names it gives them
_ATTN_COUNTERS = {"attention_global_kernel": "attn.launches.attention_global_kernel",
                  "plain_chain": "encoder.attn.plain_chain"}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    hidden_act: str = "gelu"  # "gelu" (exact) | "gelu_new" (tanh) | "relu"
    pad_token_id: int = 0
    # the HF layout family: "bert" | "roberta" | "distilbert"
    model_type: str = "bert"
    # "absolute": positions 0..L-1 (BERT, DistilBERT). "from_pad_offset":
    # RoBERTa's create_position_ids_from_input_ids, real tokens counted
    # from pad_token_id + 1 and pads pinned to pad_token_id
    position_style: str = "absolute"
    # DistilBERT has no token types: its placeholder row stays out of the sum
    use_token_type: bool = True
    # None = follow hidden_act (BERT); RoBERTa's head pins gelu
    head_act: Optional[str] = None
    vocab_pad_multiple: int = 128
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # recompute each layer in the backward instead of keeping its
    # activations (a training knob, not a checkpoint property)
    remat: bool = False

    @property
    def padded_vocab_size(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


PRESETS = {
    "tiny": dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=512),
    "mini": dict(hidden_size=256, num_hidden_layers=4, num_attention_heads=4,
                 intermediate_size=1024),
    "small": dict(hidden_size=512, num_hidden_layers=4, num_attention_heads=8,
                  intermediate_size=2048),
    "distill": dict(hidden_size=768, num_hidden_layers=6, num_attention_heads=12,
                    intermediate_size=3072),
    "base": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072),
    "large": dict(hidden_size=1024, num_hidden_layers=24,
                  num_attention_heads=16, intermediate_size=4096),
}


def config_from_preset(name: str, **overrides) -> BertConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown arch preset {name!r}; have {sorted(PRESETS)}")
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return BertConfig(**kw)


def dropout_generator(key: Sequence[int], stream: int, device) -> torch.Generator:
    """The generator of one dropout stream (0: embeddings, i + 1: layer i)
    for a step's `key` (seed, step, microbatch, ...): a pure function of
    both, so a recomputed layer draws the masks it drew the first time."""
    state = np.random.SeedSequence([int(k) for k in key] + [stream]).generate_state(2)
    seed = (int(state[0]) << 31) ^ int(state[1])
    return torch.Generator(device=device).manual_seed(seed)


def _dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Keep each element with probability 1 - rate, scaled by 1 / (1 - rate),
    in x's dtype (the JAX package's `_dropout`); the identity without a
    generator or at rate 0."""
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _act_by_name(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x)
    if name in ("gelu_new", "gelu_pytorch_tanh", "gelu_approx"):
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"unsupported hidden_act {name!r}")


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 and cast back to the input dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class Dense(nn.Module):
    """x @ Wᵀ accumulated in fp32 and emitted in the compute dtype, then the
    bias added in the compute dtype (torch autocast semantics). Weight is
    [out, in], as in nn.Linear."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def forward(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        y = torch.matmul(x.to(cd), self.weight.to(cd).t())
        return y + self.bias.to(cd)


def attention_chain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attention_mask: torch.Tensor, dropout_rate: float = 0.0,
                    gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """BERT's plain attention core: q, k, v [B, L, H, hd] in the compute
    dtype, `attention_mask` [B, L] (nonzero where attended) -> the context
    [B, L, H, hd] in the compute dtype. fp32 logits from exact products of
    the compute-dtype values, an additive fp32 mask (0 where attended,
    finfo(float32).min where masked), fp32 softmax, probabilities cast to
    the compute dtype (dropout on them with a generator) and multiplied by
    v. Counts `encoder.attn.plain_chain` (a layer `remat` recomputes counts
    again)."""
    tracing.count(_ATTN_COUNTERS["plain_chain"])
    cd, hd = q.dtype, q.shape[-1]
    mask_bias = torch.where(
        attention_mask[:, None, None, :] > 0, 0.0, torch.finfo(torch.float32).min
    ).to(torch.float32)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, L, hd]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(logits + mask_bias, dim=-1).to(cd)
    probs = _dropout(probs, dropout_rate, gen)
    return torch.matmul(probs, v).transpose(1, 2)


def _fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           gen: Optional[torch.Generator]) -> bool:
    """Whether a layer's attention goes through the fused kernel: bf16 on a
    card, a head dim it takes, no dropout generator, and no gradient through
    q, k or v (the kernel has no backward)."""
    return (q.is_cuda and q.dtype == torch.bfloat16 and q.shape[-1] in _KERNEL_HEAD_DIMS
            and gen is None and not any(t.requires_grad for t in (q, k, v)))


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
    """`ops/attention.py::attention` (global) over q, k, v [B, L, H, hd] and
    the key mask [B, L], in launches of at most 65 535 // H docs (5 461 at
    12 heads): one launch for any batch up to that, the docs of a larger
    one split between launches and the contexts joined in order."""
    B, H = q.shape[0], q.shape[2]
    step = _KERNEL_MAX_BH // H
    if B <= step:
        return attention(q, k, v, attention_mask)
    return torch.cat([attention(q[i:i + step], k[i:i + step], v[i:i + step],
                                attention_mask[i:i + step]) for i in range(0, B, step)])


def attention_counts() -> Dict[str, int]:
    """This process's attention layer calls so far: the fused global
    kernel's launches (BERT's and ModernBERT's) and BERT's plain chains
    (`cli.evaluate_beir` logs them beside the head's launch counts)."""
    c = tracing.counters()
    return {k: c.get(name, 0) for k, name in _ATTN_COUNTERS.items()}


def reset_attention_counts() -> None:
    """Set attention_counts() back to 0."""
    tracing.reset(_ATTN_COUNTERS.values())


class Attention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.query, self.key, self.value, self.output = (Dense(d, d) for _ in range(4))
        self.layer_norm = LayerNorm(d, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, L, D] -> the layer's attention block, [B, L, D]: the fused
        kernel for inference on a card (DistilBERT's and BERT's ingest, the
        teachers, serving), the plain chain otherwise (`_fused`)."""
        cfg, cd = self.cfg, self.cfg.compute_dtype
        B, L, D = x.shape
        H, hd = cfg.num_attention_heads, cfg.head_dim
        # [B, L, H, hd] views of the projections: the kernel takes them as they are
        q, k, v = (p(x, cd).view(B, L, H, hd) for p in (self.query, self.key, self.value))
        if _fused(q, k, v, gen):
            ctx = fused_attention(q, k, v, attention_mask)
        else:
            ctx = attention_chain(q, k, v, attention_mask, cfg.attention_probs_dropout_prob, gen)
        out = _dropout(self.output(ctx.reshape(B, L, D), cd), cfg.hidden_dropout_prob, gen)
        return self.layer_norm(x + out)


class FeedForward(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        cd = self.cfg.compute_dtype
        h = _act_by_name(self.intermediate(x, cd), self.cfg.hidden_act)
        out = _dropout(self.output(h, cd), self.cfg.hidden_dropout_prob, gen)
        return self.layer_norm(x + out)


class Layer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = Attention(cfg)
        self.ffn = FeedForward(cfg)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor,
                dropout_key: Optional[Sequence[int]] = None, stream: int = 0) -> torch.Tensor:
        gen = None if dropout_key is None else dropout_generator(dropout_key, stream, x.device)
        return self.ffn(self.attention(x, attention_mask, gen), gen)


class Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.word_embeddings = nn.Parameter(torch.empty(cfg.padded_vocab_size, d))
        self.position_embeddings = nn.Parameter(torch.empty(cfg.max_position_embeddings, d))
        self.token_type_embeddings = nn.Parameter(torch.empty(cfg.type_vocab_size, d))
        self.layer_norm = LayerNorm(d, cfg.layer_norm_eps)


class MLMHead(nn.Module):
    def __init__(self, cfg: BertConfig, tied: bool = True):
        super().__init__()
        d = cfg.hidden_size
        self.transform = Dense(d, d)
        self.layer_norm = LayerNorm(d, cfg.layer_norm_eps)
        self.bias = nn.Parameter(torch.empty(cfg.padded_vocab_size))
        # an untied checkpoint keeps its own [padded_V, D] decoder
        self.decoder = None if tied else nn.Parameter(
            torch.empty(cfg.padded_vocab_size, d)
        )


class _Captured(NamedTuple):
    """One captured input shape: the graph, its static inputs and output,
    and the counts its capture raised."""

    graph: "torch.cuda.CUDAGraph"
    ids: torch.Tensor
    mask: torch.Tensor
    hidden: torch.Tensor
    counts: Dict[str, int]


class GraphRunner:
    """A `BertForMaskedLM`'s inference encoder stack (`encode_hidden` with no
    dropout and no autograd) as one CUDA graph per input shape.

    The first call at a shape copies the inputs into the shape's static
    buffers, runs one eager forward on the runner's own stream (so cuBLAS's
    workspace and the kernels' libraries exist before the capture), and
    captures the next. The graphs share one memory pool, as they replay one
    at a time on one stream. A call copies the batch's ids and mask into the
    shape's buffers and replays its graph on the current stream: two copies
    and one launch. The graph reads the weights where they are, so an
    in-place update (a trainer's step) is seen by the next replay; weights
    replaced by other tensors (`module.to`, a new Parameter) drop every
    graph, as the runner keys its graphs on the parameters' storage.

    The counts that the captured Python raises (the attention kernel's
    launches and pairs) are kept with the graph and added again at each
    replay, so the counters read as they do eagerly; the warm-up forward's
    are dropped. The spans inside the stack (`encoder.attn.global`) do not
    open on a replay. Counters `encoder.graph.captures`,
    `encoder.graph.replays`. The hidden states returned are a static output
    of the pool: they hold until the runner's next replay, which is why
    `BertForMaskedLM.graph_maxpool` runs the head on them under `lock`."""

    def __init__(self):
        self.graphs: Dict[Tuple, _Captured] = {}
        self.lock = threading.Lock()
        # each parameter's (module's dict, name), and the storage and dtype
        # the graphs were captured over
        self._slots = self._weights = None
        self._stream = self._pool = None

    def __deepcopy__(self, memo):
        # a copy of the module (a mesh's replica) captures graphs of its own
        return GraphRunner()

    def _capture(self, model: "BertForMaskedLM", input_ids: torch.Tensor,
                 attention_mask: torch.Tensor) -> _Captured:
        dev = input_ids.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        ids, mask = input_ids.clone(), attention_mask.clone()
        graph, s = torch.cuda.CUDAGraph(), self._stream
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            with tracing.recording():  # the warm-up is no forward of the caller's
                model.encode_hidden(ids, mask)
            with tracing.recording() as counts:
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    hidden = model.encode_hidden(ids, mask)
                finally:
                    graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(s)
        tracing.count("encoder.graph.captures")
        return _Captured(graph, ids, mask, hidden, counts)

    @torch.inference_mode()
    def __call__(self, model: "BertForMaskedLM", input_ids: torch.Tensor,
                 attention_mask: torch.Tensor) -> torch.Tensor:
        """`model.encode_hidden(input_ids, attention_mask)` [B, L, D] (CUDA
        tensors), replayed from the graph of their shape."""
        if self._slots is None:
            self._slots = [(m._parameters, n) for m in model.modules()
                           for n, p in m._parameters.items() if p is not None]
        weights = [(d[n].data_ptr(), d[n].dtype) for d, n in self._slots]
        if weights != self._weights:
            # the pool goes with the last graph that used it: new graphs, new pool
            self.graphs.clear()
            self._weights, self._pool = weights, None
        key = (tuple(input_ids.shape), input_ids.dtype, attention_mask.dtype)
        cap = self.graphs.get(key)
        if cap is None:
            cap = self.graphs[key] = self._capture(model, input_ids, attention_mask)
        cap.ids.copy_(input_ids)
        cap.mask.copy_(attention_mask)
        cap.graph.replay()
        tracing.add(cap.counts)
        tracing.count("encoder.graph.replays")
        return cap.hidden


class BertForMaskedLM(nn.Module):
    def __init__(self, cfg: BertConfig, tied: bool = True):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.layers = nn.ModuleList(Layer(cfg) for _ in range(cfg.num_hidden_layers))
        self.mlm_head = MLMHead(cfg, tied)
        self.graph_runner = GraphRunner()

    def encode_hidden(
        self,
        input_ids: torch.Tensor,  # [B, L] int
        attention_mask: torch.Tensor,  # [B, L] int/bool
        token_type_ids: Optional[torch.Tensor] = None,
        dropout_key: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """Transformer stack -> final hidden states [B, L, D] (compute dtype).
        Dropout is on when `dropout_key` is given (training)."""
        cfg, cd = self.cfg, self.cfg.compute_dtype
        emb = self.embeddings
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if cfg.position_style == "from_pad_offset":
            not_pad = (input_ids != cfg.pad_token_id).long()
            pos_ids = torch.cumsum(not_pad, dim=1) * not_pad + cfg.pad_token_id
        else:
            pos_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = (F.embedding(input_ids, emb.word_embeddings).to(cd)
             + F.embedding(pos_ids, emb.position_embeddings).to(cd))
        if cfg.use_token_type:
            x = x + F.embedding(token_type_ids.long(), emb.token_type_embeddings).to(cd)
        x = emb.layer_norm(x)
        if dropout_key is not None:
            x = _dropout(x, cfg.hidden_dropout_prob,
                         dropout_generator(dropout_key, 0, x.device))
        for i, layer in enumerate(self.layers):
            if cfg.remat and torch.is_grad_enabled():
                # the layer's dropout generator is made inside the recomputed
                # function, so the replay draws the same masks
                x = checkpoint(layer, x, attention_mask, dropout_key, i + 1,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = layer(x, attention_mask, dropout_key, i + 1)
        return x

    def decoder_weight(self) -> torch.Tensor:
        """[padded_V, D] decoder: the word embeddings when tied (the
        default), or the checkpoint's own decoder for untied imports."""
        dec = self.mlm_head.decoder
        return dec if dec is not None else self.embeddings.word_embeddings

    def head_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        """MLM-head transform + activation + LayerNorm, in the compute dtype."""
        cfg, p = self.cfg, self.mlm_head
        h = _act_by_name(p.transform(hidden, cfg.compute_dtype),
                         cfg.head_act or cfg.hidden_act)
        return p.layer_norm(h)

    def mlm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """MLM head -> [B, L, padded_V] fp32 (the full logits; the sparse
        encoder uses mlm_maxpool instead)."""
        cd = self.cfg.compute_dtype
        h = self.head_hidden(hidden).to(cd).float()
        w = self.decoder_weight().to(cd).float()
        return torch.matmul(h, w.t()) + self.mlm_head.bias.float()

    def mlm_maxpool(self, hidden: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
        """max_l mask[b,l] * logits[b,l,v] -> [B, padded_V] fp32, through the
        fused kernel without ever forming the logits: with grad on (and an
        input that needs it) through its autograd Function, which the
        training step differentiates; otherwise the ingest kernel."""
        cd = self.cfg.compute_dtype
        args = (
            self.head_hidden(hidden).to(cd).contiguous(),
            attention_mask.to(torch.int32).contiguous(),
            self.decoder_weight().to(cd).contiguous(),
            self.mlm_head.bias.float().contiguous(),
        )
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            return maxpool_head_train(*args)
        return maxpool_head(*args)

    @torch.inference_mode()
    def graph_maxpool(self, input_ids: torch.Tensor,
                      attention_mask: torch.Tensor) -> torch.Tensor:
        """`mlm_maxpool(encode_hidden(ids, mask), mask)` for inference on a
        card: the encoder stack replayed from the graph of the batch's shape
        (`GraphRunner`), the head run eagerly on its output."""
        with self.graph_runner.lock:
            hidden = self.graph_runner(self, input_ids, attention_mask)
            return self.mlm_maxpool(hidden, attention_mask)


def init_state_dict(cfg: BertConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded random init (HF-style: N(0, 0.02) weights, zero biases, unit
    LayerNorm scales; padded vocab rows zero), drawn on the CPU from one
    torch.Generator so it does not depend on the device."""
    gen = torch.Generator().manual_seed(seed)
    shapes = {k: v.shape for k, v in BertForMaskedLM(cfg).state_dict().items()}
    sd = {}
    for name, shape in shapes.items():
        if name.endswith("layer_norm.weight"):
            sd[name] = torch.ones(shape)
        elif name.endswith("bias"):
            sd[name] = torch.zeros(shape)
        else:
            sd[name] = torch.randn(shape, generator=gen) * 0.02
    sd["embeddings.word_embeddings"][cfg.vocab_size:] = 0.0
    return sd


def from_state_dict(cfg: BertConfig, sd: Dict[str, torch.Tensor],
                    device: torch.device) -> BertForMaskedLM:
    """A module in eval mode on `device`, with the weights of `sd` in
    cfg.param_dtype; untied when `sd` carries a decoder."""
    model = BertForMaskedLM(cfg, tied="mlm_head.decoder" not in sd)
    model.load_state_dict(sd)
    return model.to(device=device, dtype=cfg.param_dtype).eval()
