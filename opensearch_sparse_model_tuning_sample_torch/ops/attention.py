"""Fused multi-head attention of one encoder layer, global, windowed or
causal, with key padding from a mask: the attention core of
`models/modernbert.py`, of `models/moonlight.py` (causal, MLA's q·k dim
192 and v dim 128), and of `models/bert.py` (BERT, RoBERTa, DistilBERT)
for inference on a card (global only: ingest, the teachers, serving;
training keeps BERT's plain chain, as the kernel has no backward and no
dropout).

    ctx[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h] / sqrt(hqk) + M[b, i, j]) v[b, j, h]

`M` masks the keys whose mask is 0 and, for a windowed layer (`window` w >
0), the keys with |i - j| > w, for a causal one (`causal`) the keys with
j > i. q and k share a head dim hqk, v and the context have hv (equal to
hqk but in the causal kind). The precision is `models/bert.py`'s: q·kᵀ
accumulates in fp32 from compute-dtype operands, the softmax runs in fp32,
the probabilities are cast to the compute dtype before ·v, which accumulates
in fp32; a masked key takes a large finite negative logit, so a query with
no live key (a padding row) gets finite values, never NaN.

On a CUDA tensor `attention` launches the CUDA kernel of
`csrc/attention.cu` (built at its first launch; the trace names it
`attention_global_kernel`, `attention_window_kernel` or
`attention_causal_kernel`): one block a tile
of queries of one (doc, head), streaming key tiles of 64 through shared
memory with an online softmax, so no `[L, L]` tensor exists. A global layer
walks every key tile with 128-query tiles; a windowed one, with 64-query
tiles, only the key tiles that meet [m0 - w, m0 + 63 + w], so its work
grows with L·(2w + 64), not L²; a causal one, with 64-query tiles, only
the key tiles up to its diagonal (about half of L²), the longest query
tiles first. It replaces no TPU kernel: the JAX
package's BERT attention is plain `jnp` code that XLA fuses. At
ModernBERT-large's widths (head dim 64, L up to 8 192) a global layer is
bound by its operations (4·L²·D), a windowed one by its bytes (q, k, v
read, o written). The kernel takes head dims 64 and 16 (global and
windowed), and (192, 128) and (32, 16) (causal: Moonlight's and its test
width's).

On the CPU `attention` takes the plain version `attention_reference`,
which computes the same key blocks densely with explicit masks.

Both run in the span `encoder.attn.global`, `encoder.attn.local` or
`encoder.attn.causal` and add the query-key pairs the kernel computes for
this launch shape (`computed_pairs`: padding rows and keys, and the masked
pairs inside the computed blocks, included; heads not counted) to the
counter `encoder.attn.pairs.global`, `.local` or `.causal`. Counted on the host, from the
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
CAUSAL_TILE = (64, 64)
# (hqk, hv) the causal kernel is built for
CAUSAL_DIMS = ((192, 128), (32, 16))
_LOG2E = 1.4426950408889634
_LAUNCH = "attn.launches."
_PLAIN = "attn.plain_calls."


def _kind(window: int, causal: bool = False) -> str:
    return "causal" if causal else "local" if window > 0 else "global"


def _tile(window: int, causal: bool = False):
    return CAUSAL_TILE if causal else LOCAL_TILE if window > 0 else GLOBAL_TILE


def key_range(m0: int, L: int, window: int, block_m: int, block_n: int, causal: bool = False):
    """[lo, hi) of the keys a query block starting at m0 visits: every key
    for a global layer; for a windowed one from the key block holding
    m0 - window to the last key within the window of its last query; for a
    causal one the keys up to its last query."""
    if causal:
        return 0, min(m0 + block_m, L)
    if window <= 0:
        return 0, L
    lo = max(m0 - window, 0) // block_n * block_n
    return lo, min(m0 + block_m + window, L)


@functools.lru_cache(maxsize=1024)
def _pairs_per_row(L: int, window: int, block_m: int, block_n: int, causal: bool) -> int:
    total = 0
    for m0 in range(0, L, block_m):
        lo, hi = key_range(m0, L, window, block_m, block_n, causal)
        total += block_m * (-(-(hi - lo) // block_n) * block_n)
    return total


def computed_pairs(B: int, L: int, window: int, causal: bool = False) -> int:
    """Query-key pairs the kernel computes for [B, L] rows (one head): its
    query blocks times the key blocks each visits, whole tiles counted."""
    block_m, block_n = _tile(window, causal)
    return B * _pairs_per_row(L, window, block_m, block_n, causal)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, window: int = 0, causal: bool = False) -> torch.Tensor:
    """Plain version: for each of the kernel's query blocks (a windowed or
    causal layer) or chunks of 512 queries (a global one), the fp32 logits
    of its key range from exact products of the compute-dtype values, the
    masks as a finfo.min fill, softmax in fp32, probabilities cast to q's
    dtype and multiplied by v in fp32. q, k [B, L, H, hqk], v [B, L, H, hv];
    mask [B, L]. Returns [B, L, H, hv] in q's dtype."""
    tracing.count(_PLAIN + "attention_reference")
    B, L, H, hd = q.shape
    cd = q.dtype
    acc = torch.float64 if cd == torch.float64 else torch.float32
    neg = torch.finfo(acc).min
    qh, kh, vh = (t.transpose(1, 2).to(acc) for t in (q, k, v))  # [B, H, L, hd]
    live = mask.bool()
    out = torch.empty((B, H, L, v.shape[-1]), dtype=acc, device=q.device)
    step = _tile(window, causal)[0] if window > 0 or causal else 512
    pos = torch.arange(L, device=q.device)
    for m0 in range(0, L, step):
        m1 = min(m0 + step, L)
        lo, hi = key_range(m0, L, window, step, _tile(window, causal)[1], causal)
        logits = torch.matmul(qh[:, :, m0:m1], kh[:, :, lo:hi].transpose(-1, -2))
        logits = logits / math.sqrt(hd)
        ok = live[:, None, None, lo:hi]
        if window > 0:
            ok = ok & ((pos[m0:m1, None] - pos[None, lo:hi]).abs() <= window)
        if causal:
            ok = ok & (pos[None, lo:hi] <= pos[m0:m1, None])
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
        lib.attention_causal_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float,
                                              *[ll] * 10, p]
        lib.attention_causal_bf16.restype = i
        lib.attention_causal_block_m.argtypes = []
        lib.attention_causal_block_m.restype = i
        # the pair counters count the kernel's own tiles
        built = ((lib.attention_block_m(0), lib.attention_block_n()),
                 (lib.attention_block_m(1), lib.attention_block_n()),
                 (lib.attention_causal_block_m(), lib.attention_block_n()))
        if built != (GLOBAL_TILE, LOCAL_TILE, CAUSAL_TILE):
            raise RuntimeError(f"attention kernel tiles {built} are not "
                               f"{(GLOBAL_TILE, LOCAL_TILE, CAUSAL_TILE)}")
        lib._argtypes_set = True
    return lib


def _check_args(q, k, v, mask, causal):
    if q.dim() != 4 or k.shape != q.shape or v.shape[:3] != q.shape[:3] or (
            v.shape != q.shape and not causal):
        raise ValueError(f"attention wants q, k [B, L, H, hqk] and v [B, L, H, hv] (hv = hqk "
                         f"but in the causal kind), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if tuple(mask.shape) != tuple(q.shape[:2]):
        raise ValueError(f"attention mask {tuple(mask.shape)} is not [B, L] of {tuple(q.shape)}")
    if len({t.device for t in (q, k, v, mask)}) != 1:
        raise ValueError("attention: q, k, v and mask on different devices")


def _launch(q, k, v, mask, window, causal=False):
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes bf16 q, k, v, got {q.dtype}")
    B, L, H, hd = q.shape
    hv = v.shape[-1]
    if causal and (hd, hv) not in CAUSAL_DIMS:
        raise ValueError(f"causal attention kernel takes (hqk, hv) in {CAUSAL_DIMS}, got "
                         f"{(hd, hv)}")
    if not causal and hd not in (16, 64):
        raise ValueError(f"attention kernel takes a head dim of 64 or 16, got {hd}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention kernel wants the head dim contiguous")
    mask = mask.to(torch.int32).contiguous()
    out = torch.empty((B, L, H, hv), dtype=q.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                B, L, H)
        tail = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], mask.stride(0),
                torch.cuda.current_stream(q.device).cuda_stream)
        if causal:
            rc = lib.attention_causal_bf16(*head, hd, hv, _LOG2E / math.sqrt(hd), *tail)
        else:
            rc = lib.attention_bf16(*head, hd, window, _LOG2E / math.sqrt(hd), *tail)
    if rc != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {rc} (strides "
                           f"{q.stride()}, {k.stride()}, {v.stride()} must be multiples of 8)")
    name = "causal" if causal else "window" if window > 0 else "global"
    tracing.count(_LAUNCH + f"attention_{name}_kernel")
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
              window: int = 0, causal: bool = False) -> torch.Tensor:
    """Attention of q, k [B, L, H, hqk] and v [B, L, H, hv] (views with a
    contiguous head dim are fine) over the keys whose `mask` [B, L] is
    nonzero, within |i - j| <= window when `window` > 0, at or before the
    query when `causal`. Returns [B, L, H, hv] in q's dtype: the CUDA kernel
    on a CUDA tensor (bf16; head dim 64 or 16, or causal (192, 128) or
    (32, 16); it raises on anything else), the plain version on the CPU."""
    _check_args(q, k, v, mask, causal)
    kind = _kind(window, causal)
    with tracing.span("encoder.attn." + kind):
        B, L = q.shape[:2]
        tracing.count("encoder.attn.pairs." + kind, computed_pairs(B, L, window, causal))
        if q.device.type == "cpu":
            return attention_reference(q, k, v, mask, window, causal)
        return _launch(q, k, v, mask, window, causal)
