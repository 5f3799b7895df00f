"""Fused multi-head attention of one encoder layer, global or windowed, with
key padding from a mask: the attention core of `models/modernbert.py`, and
of `models/bert.py` (BERT, RoBERTa, DistilBERT) for inference on a card
(global only: ingest, the teachers, serving; training keeps BERT's plain
chain, as the kernel has no backward and no dropout).

    ctx[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h] / sqrt(hd) + M[b, i, j]) v[b, j, h]

`M` masks the keys whose mask is 0 and, for a windowed layer (`window` w >
0), the keys with |i - j| > w. The precision is `models/bert.py`'s: q·kᵀ
accumulates in fp32 from compute-dtype operands, the softmax runs in fp32,
the probabilities are cast to the compute dtype before ·v, which accumulates
in fp32; a masked key takes a large finite negative logit, so a query with
no live key (a padding row) gets finite values, never NaN.

On a CUDA tensor `attention` launches the CUDA kernel of
`csrc/attention.cu` (built at its first launch; the trace names it
`attention_global_kernel` or `attention_window_kernel`): one block a tile
of queries of one (doc, head), streaming key tiles of 64 through shared
memory with an online softmax, so no `[L, L]` tensor exists. A global layer
walks every key tile with 128-query tiles; a windowed one, with 64-query
tiles, only the key tiles that meet [m0 - w, m0 + 63 + w], so its work
grows with L·(2w + 64), not L². It replaces no TPU kernel: the JAX
package's BERT attention is plain `jnp` code that XLA fuses. At
ModernBERT-large's widths (head dim 64, L up to 8 192) a global layer is
bound by its operations (4·L²·D), a windowed one by its bytes (q, k, v
read, o written).

On the CPU `attention` takes the plain version `attention_reference`,
which computes the same key blocks densely with explicit masks.

Both run in the span `encoder.attn.global` or `encoder.attn.local` and
add the query-key pairs the kernel computes for this launch shape
(`computed_pairs`: padding rows and keys, and the masked pairs inside the
computed blocks, included; heads not counted) to the counter
`encoder.attn.pairs.global` or `.local`. Counted on the host, from the
shapes, with no wait for the device.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import tracing
from .kernel_build import library

# (query tile, key tile) of each kind's kernel (csrc/attention.cu: 4 warps
# of 32 queries for a global layer, of 16 for a windowed one; 64-key tiles)
GLOBAL_TILE = (128, 64)
LOCAL_TILE = (64, 64)
_LOG2E = 1.4426950408889634
_LAUNCH = "attn.launches."
_PLAIN = "attn.plain_calls."


def _kind(window: int) -> str:
    return "local" if window > 0 else "global"


def _tile(window: int):
    return LOCAL_TILE if window > 0 else GLOBAL_TILE


def key_range(m0: int, L: int, window: int, block_m: int, block_n: int):
    """[lo, hi) of the keys a query block starting at m0 visits: every key
    for a global layer; for a windowed one from the key block holding
    m0 - window to the last key within the window of its last query."""
    if window <= 0:
        return 0, L
    lo = max(m0 - window, 0) // block_n * block_n
    return lo, min(m0 + block_m + window, L)


@functools.lru_cache(maxsize=1024)
def _pairs_per_row(L: int, window: int, block_m: int, block_n: int) -> int:
    total = 0
    for m0 in range(0, L, block_m):
        lo, hi = key_range(m0, L, window, block_m, block_n)
        total += block_m * (-(-(hi - lo) // block_n) * block_n)
    return total


def computed_pairs(B: int, L: int, window: int) -> int:
    """Query-key pairs the kernel computes for [B, L] rows (one head): its
    query blocks times the key blocks each visits, whole tiles counted."""
    block_m, block_n = _tile(window)
    return B * _pairs_per_row(L, window, block_m, block_n)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Plain version: for each of the kernel's query blocks (a windowed
    layer) or chunks of 512 queries (a global one), the fp32 logits of its
    key range from exact products of the compute-dtype values, the masks as
    a finfo.min fill, softmax in fp32, probabilities cast to q's dtype and
    multiplied by v in fp32. q, k, v [B, L, H, hd]; mask [B, L]. Returns
    [B, L, H, hd] in q's dtype."""
    tracing.count(_PLAIN + "attention_reference")
    B, L, H, hd = q.shape
    cd = q.dtype
    acc = torch.float64 if cd == torch.float64 else torch.float32
    neg = torch.finfo(acc).min
    qh, kh, vh = (t.transpose(1, 2).to(acc) for t in (q, k, v))  # [B, H, L, hd]
    live = mask.bool()
    out = torch.empty((B, H, L, hd), dtype=acc, device=q.device)
    step = _tile(window)[0] if window > 0 else 512
    pos = torch.arange(L, device=q.device)
    for m0 in range(0, L, step):
        m1 = min(m0 + step, L)
        lo, hi = key_range(m0, L, window, step, _tile(window)[1])
        logits = torch.matmul(qh[:, :, m0:m1], kh[:, :, lo:hi].transpose(-1, -2))
        logits = logits / math.sqrt(hd)
        ok = live[:, None, None, lo:hi]
        if window > 0:
            ok = ok & ((pos[m0:m1, None] - pos[None, lo:hi]).abs() <= window)
        probs = torch.softmax(logits.masked_fill(~ok, neg), dim=-1).to(cd).to(acc)
        out[:, :, m0:m1] = torch.matmul(probs, vh[:, :, lo:hi])
    return out.transpose(1, 2).to(cd)


def _lib():
    lib = library("attention")
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.attention_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float,
                                       *[ll] * 10, p]
        lib.attention_bf16.restype = i
        lib.attention_block_m.argtypes = [i]
        lib.attention_block_m.restype = i
        lib.attention_block_n.argtypes = []
        lib.attention_block_n.restype = i
        # the pair counters count the kernel's own tiles
        built = ((lib.attention_block_m(0), lib.attention_block_n()),
                 (lib.attention_block_m(1), lib.attention_block_n()))
        if built != (GLOBAL_TILE, LOCAL_TILE):
            raise RuntimeError(f"attention kernel tiles {built} are not "
                               f"{(GLOBAL_TILE, LOCAL_TILE)}")
        lib._argtypes_set = True
    return lib


def _check_args(q, k, v, mask):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention wants q, k, v [B, L, H, hd] alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if tuple(mask.shape) != tuple(q.shape[:2]):
        raise ValueError(f"attention mask {tuple(mask.shape)} is not [B, L] of {tuple(q.shape)}")
    if len({t.device for t in (q, k, v, mask)}) != 1:
        raise ValueError("attention: q, k, v and mask on different devices")


def _launch(q, k, v, mask, window):
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes bf16 q, k, v, got {q.dtype}")
    B, L, H, hd = q.shape
    if hd not in (16, 64):
        raise ValueError(f"attention kernel takes a head dim of 64 or 16, got {hd}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention kernel wants the head dim contiguous")
    mask = mask.to(torch.int32).contiguous()
    out = torch.empty((B, L, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            B, L, H, hd, window, _LOG2E / math.sqrt(hd),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], mask.stride(0),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {rc} (strides "
                           f"{q.stride()}, {k.stride()}, {v.stride()} must be multiples of 8)")
    tracing.count(_LAUNCH + ("attention_window_kernel" if window > 0
                             else "attention_global_kernel"))
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
              window: int = 0) -> torch.Tensor:
    """Attention of q, k, v [B, L, H, hd] (views with a contiguous head dim
    are fine) over the keys whose `mask` [B, L] is nonzero, within
    |i - j| <= window when `window` > 0. Returns [B, L, H, hd] in q's dtype:
    the CUDA kernel on a CUDA tensor (bf16, head dim 64 or 16; it raises
    on anything else), the plain version on the CPU."""
    _check_args(q, k, v, mask)
    kind = _kind(window)
    with tracing.span("encoder.attn." + kind):
        B, L = q.shape[:2]
        tracing.count("encoder.attn.pairs." + kind, computed_pairs(B, L, window))
        if q.device.type == "cpu":
            return attention_reference(q, k, v, mask, window)
        return _launch(q, k, v, mask, window)
