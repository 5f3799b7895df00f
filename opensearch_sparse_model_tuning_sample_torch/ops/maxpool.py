"""Fused MLM-head masked max-pool: the sparse encoder's per-doc hot op.

    pooled[b, v] = max_l mask[b, l] * (h[b, l, :] . w[v, :] + bias[v])

`maxpool_head` launches the hand-written Hopper kernel
(`csrc/maxpool_head.cu`: wgmma fed by TMA, a resident vocab tile, h streamed
through mbarrier rings) on a CUDA tensor, and takes the plain PyTorch
version `maxpool_head_reference` only for a tensor that lies on the CPU.
Past the widest resident tile (D above `maxpool_head_max_dim()`, about
1 536: Moonlight's D 2 048 at V 163 840) the ingest kernel streams its w
tile through the rings beside h (`maxpool_head_stream_kernel`, 128 vocab
rows a block), up to `maxpool_head_ingest_max_dim()`; the training
kernels keep the resident tile and raise above it.
It replaces the TPU kernel `opensearch_sparse_model_tuning_sample_tpu/ops/
pallas_maxpool.py::maxpool_head` (`pallas_call` at line 99) with the
production head's semantics (`models/bert.py::mlm_maxpool` there): any
decoder matrix, an fp32 bias added after the fp32-accumulated product, and
a masked position that contributes exactly 0.

Training goes through `MaxPoolHead`, a `torch.autograd.Function`: its
forward is the training-forward kernel of the same source
(`maxpool_head_argmax`: the same values, and the position of each maximum,
from a warp-specialised block that holds the same vocab tile), its backward
two gather-reduce kernels (`csrc/maxpool_head_bwd.cu`): `maxpool_head_bwd_w`
for the decoder and bias gradients, `maxpool_head_bwd_h` for the hidden
states' (a counting sort of the nonzero gradients by argmax position,
`maxpool_head_bwd_buckets` on its own, then a reduce over those lists). On the card both write their
gradients in bf16, the dtype of the h and w they take. Each kernel has its
plain version beside it, which the wrappers take on the CPU only.
The raw wrappers raise on an input that requires grad while grad mode is
on: outside the Function the kernels would return a tensor with no
gradient.

Ties. The JAX package differentiates its `lax.scan` head, and `jnp.max` /
`jnp.maximum` split the gradient of a tie evenly; the argmax gives it all to
one position (the smallest). The two agree wherever the maximum is unique.
Ties at 0, where a masked position wins, carry no gradient in either: the
position's mask is 0, and downstream `relu'(0) = 0` (`threshold_backward`
here, `activations.py:52` in JAX).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import tracing
from .kernel_build import library

# the counters' names: a wrapper counts the launches of its kernel, a plain
# version its calls (launch_counts() reads them)
_LAUNCH = "head.launches."
_PLAIN = "head.plain_calls."


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def maxpool_head_reference(
    h: torch.Tensor,  # [B, L, D]
    mask: torch.Tensor,  # [B, L]
    w: torch.Tensor,  # [V, D]
    bias: torch.Tensor,  # [V]
    chunk: int = 64,
) -> torch.Tensor:
    """Plain PyTorch version: chunked fp32 matmul + bias, times the mask,
    running max over the sequence. Inputs are upcast to fp32 (float64 stays)
    before the product, so bf16 inputs give exact products summed in fp32,
    as the kernel's tensor cores do (in another order). Returns [B, V]."""
    tracing.count(_PLAIN + "maxpool_head_reference")
    B, L, _ = h.shape
    acc = _acc_dtype(h)
    wt = w.to(acc).t()
    b = bias.to(acc)
    m = mask.to(acc)
    pooled = torch.full((B, w.shape[0]), float("-inf"), dtype=acc, device=h.device)
    for l0 in range(0, L, chunk):
        logits = torch.matmul(h[:, l0:l0 + chunk].to(acc), wt) + b
        masked = logits * m[:, l0:l0 + chunk, None]
        pooled = torch.maximum(pooled, masked.amax(dim=1))
    return pooled


def maxpool_head_argmax_reference(h, mask, w, bias, chunk: int = 64):
    """Plain version of the training forward: `maxpool_head_reference`'s
    values and, per (b, v), the first position that attains the maximum
    (int32 [B, V])."""
    tracing.count(_PLAIN + "maxpool_head_argmax_reference")
    B, L, _ = h.shape
    acc = _acc_dtype(h)
    wt = w.to(acc).t()
    b = bias.to(acc)
    m = mask.to(acc)
    pooled = torch.full((B, w.shape[0]), float("-inf"), dtype=acc, device=h.device)
    idx = torch.zeros((B, w.shape[0]), dtype=torch.int64, device=h.device)
    for l0 in range(0, L, chunk):
        logits = torch.matmul(h[:, l0:l0 + chunk].to(acc), wt) + b
        cmax, carg = (logits * m[:, l0:l0 + chunk, None]).max(dim=1)
        better = cmax > pooled  # an earlier chunk keeps a tie
        pooled = torch.where(better, cmax, pooled)
        idx = torch.where(better, carg + l0, idx)
    return pooled, idx.to(torch.int32)


def _scatter_grad(g, idx, mask, L):
    """The dense [B, L, V] gradient of the masked logits: g[b, v] * mask[b, l]
    at l = idx[b, v], zero elsewhere."""
    B, V = g.shape
    acc = _acc_dtype(g)
    pos = idx.long()
    coef = g.to(acc) * mask.to(acc).gather(1, pos)
    return torch.zeros((B, L, V), dtype=acc, device=g.device).scatter_(
        1, pos[:, None, :], coef[:, None, :])


def maxpool_head_bwd_w_reference(g, idx, mask, h):
    """Plain version of the decoder and bias gradients: the dense scatter,
    then one matmul. Returns (dw [V, D], dbias [V]) in fp32 (float64 stays)."""
    tracing.count(_PLAIN + "maxpool_head_bwd_w_reference")
    B, L, D = h.shape
    s = _scatter_grad(g, idx, mask, L).reshape(B * L, -1)
    return torch.matmul(s.t(), h.reshape(B * L, D).to(s.dtype)), s.sum(dim=0)


def maxpool_head_bwd_h_reference(g, idx, mask, w):
    """Plain version of the hidden-state gradient: the dense scatter, then
    one matmul. Returns dh [B, L, D] in fp32 (float64 stays)."""
    tracing.count(_PLAIN + "maxpool_head_bwd_h_reference")
    s = _scatter_grad(g, idx, mask, mask.shape[1])
    return torch.matmul(s, w.to(s.dtype))


def bucket_by_argmax_reference(g, idx, mask):
    """Plain version of bwd_h's counting sort: the nonzero coefficients
    coef = g[b, v] * mask[b, idx[b, v]], listed per (doc, argmax position)
    in increasing v. Returns (offsets [B*L + 1] int32, v [nnz] int32,
    coef [nnz] in g's dtype): list b*L + l is entries offsets[b*L + l] up to
    offsets[b*L + l + 1]."""
    tracing.count(_PLAIN + "bucket_by_argmax_reference")
    B, V = g.shape
    L = mask.shape[1]
    pos = idx.long()
    coef = g * mask.gather(1, pos).to(g.dtype)
    nz = (coef != 0).reshape(-1)
    key = (torch.arange(B, device=g.device)[:, None] * L + pos).reshape(-1)[nz]
    order = torch.sort(key, stable=True).indices  # within a list, (b, v) order: increasing v
    counts = torch.bincount(key, minlength=B * L)
    offsets = torch.zeros(B * L + 1, dtype=torch.int32, device=g.device)
    offsets[1:] = torch.cumsum(counts, 0)
    v = torch.arange(V, device=g.device).expand(B, V).reshape(-1)[nz]
    return offsets, v[order].to(torch.int32), coef.reshape(-1)[nz][order]


def check_kernel_args(h, mask, w, bias, max_dim):
    """Raise on what the kernel cannot take: shapes, dtypes, devices,
    contiguity, D not a multiple of 8 or above `max_dim`, and an h or w that
    does not start on a 16-byte boundary (TMA reads from aligned addresses;
    a sliced view can break that). Pure Python, so it runs on any device."""
    if h.dim() != 3 or mask.dim() != 2 or w.dim() != 2 or bias.dim() != 1:
        raise ValueError("maxpool_head wants h [B,L,D], mask [B,L], w [V,D], bias [V]")
    B, L, D = h.shape
    V = w.shape[0]
    if tuple(mask.shape) != (B, L) or w.shape[1] != D or bias.shape[0] != V:
        raise ValueError(
            f"maxpool_head shapes disagree: h {tuple(h.shape)}, mask "
            f"{tuple(mask.shape)}, w {tuple(w.shape)}, bias {tuple(bias.shape)}"
        )
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"maxpool_head kernel takes bf16 h and w, got {h.dtype}, {w.dtype}")
    if bias.dtype != torch.float32 or mask.dtype != torch.int32:
        raise TypeError(
            f"maxpool_head kernel takes fp32 bias and int32 mask, got {bias.dtype}, {mask.dtype}"
        )
    _check_layout(h, (("h", h), ("mask", mask), ("w", w), ("bias", bias)))
    if min(B, L, V) == 0:
        raise ValueError("maxpool_head: empty batch, sequence or vocab")
    _check_width(D, max_dim, (("h", h), ("w", w)))


def check_bucket_args(g, idx, mask):
    """The checks of every backward kernel: g fp32 [B, V], idx int32 [B, V],
    mask int32 [B, L], contiguous, on one device, none empty."""
    if g.dim() != 2 or idx.shape != g.shape or mask.dim() != 2 or mask.shape[0] != g.shape[0]:
        raise ValueError(
            f"maxpool_head backward wants g, idx [B,V] and mask [B,L], got "
            f"{tuple(g.shape)}, {tuple(idx.shape)}, {tuple(mask.shape)}")
    if g.dtype != torch.float32 or idx.dtype != torch.int32 or mask.dtype != torch.int32:
        raise TypeError(f"maxpool_head backward takes fp32 g and int32 idx and mask, got "
                        f"{g.dtype}, {idx.dtype}, {mask.dtype}")
    _check_layout(g, (("g", g), ("idx", idx), ("mask", mask)))
    if min(g.shape) == 0 or mask.shape[1] == 0:
        raise ValueError("maxpool_head backward: empty batch, sequence or vocab")


def check_bwd_args(g, idx, mask, x, max_dim):
    """The gradient kernels' checks: those of `check_bucket_args`, and x
    (h [B, L, D] or w [V, D]) bf16 of the batch's B and L or V rows, on g's
    device, contiguous, 16-byte aligned, D a multiple of 8 and at most
    `max_dim`."""
    check_bucket_args(g, idx, mask)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"maxpool_head backward kernels take bf16 h and w, got {x.dtype}")
    if x.dim() == 3 and tuple(x.shape[:2]) != tuple(mask.shape):
        raise ValueError(f"maxpool_head backward: h {tuple(x.shape)} disagrees with mask "
                         f"{tuple(mask.shape)} on B or L")
    if x.dim() == 2 and x.shape[0] != g.shape[1]:
        raise ValueError(f"maxpool_head backward: w has {x.shape[0]} rows, g {g.shape[1]} columns")
    if x.dim() not in (2, 3):
        raise ValueError(f"maxpool_head backward wants h [B,L,D] or w [V,D], got {tuple(x.shape)}")
    _check_layout(g, (("h/w", x),))
    _check_width(x.shape[-1], max_dim, (("h/w", x),))


def _check_layout(first, named):
    for name, t in named:
        if t.device != first.device:
            raise ValueError(f"maxpool_head: {name} is on {t.device}, not {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"maxpool_head: {name} must be contiguous")


def _check_width(D, max_dim, aligned):
    if D % 8:
        raise ValueError(f"maxpool_head kernel needs D a multiple of 8, got {D}")
    if D > max_dim:
        raise ValueError(f"maxpool_head kernel takes D <= {max_dim}, got {D}")
    for name, t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(
                f"maxpool_head kernel needs {name} 16-byte aligned, got address "
                f"{t.data_ptr():#x}"
            )


def _check_no_grad(*tensors):
    """A raw wrapper returns a tensor without a gradient; with grad mode on
    and an input that requires one, only `MaxPoolHead` computes it right."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "maxpool_head kernels have no autograd of their own: an input "
            "requires grad, so call maxpool_head_train (the MaxPoolHead "
            "Function), or run under torch.no_grad()")


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"maxpool_head runs on cuda or cpu, not {t.device}")
    return t.device.type


def _lib():
    lib = library("maxpool_head")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.maxpool_head_bf16.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.maxpool_head_bf16.restype = i
        lib.maxpool_head_argmax_bf16.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.maxpool_head_argmax_bf16.restype = i
        lib.maxpool_head_max_dim.argtypes = []
        lib.maxpool_head_max_dim.restype = i
        lib.maxpool_head_ingest_max_dim.argtypes = []
        lib.maxpool_head_ingest_max_dim.restype = i
        lib._argtypes_set = True
    return lib


def _bwd_lib():
    lib = library("maxpool_head_bwd")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.maxpool_head_bwd_w.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.maxpool_head_bwd_w.restype = i
        lib.maxpool_head_bwd_buckets.argtypes = [p, p, p, p, p, p, i, i, i, p]
        lib.maxpool_head_bwd_buckets.restype = i
        lib.maxpool_head_bwd_h.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.maxpool_head_bwd_h.restype = i
        lib.maxpool_head_bwd_workspace_bytes.argtypes = [i, i, i, i]
        lib.maxpool_head_bwd_workspace_bytes.restype = ctypes.c_longlong
        lib.maxpool_head_bwd_max_dim.argtypes = []
        lib.maxpool_head_bwd_max_dim.restype = i
        lib._argtypes_set = True
    return lib


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


@tracing.spanned("encoder.head")
def maxpool_head(
    h: torch.Tensor,  # [B, L, D] bf16 on the card
    mask: torch.Tensor,  # [B, L] int32
    w: torch.Tensor,  # [V, D] bf16
    bias: torch.Tensor,  # [V] fp32
) -> torch.Tensor:
    """Masked max-pool of the MLM logits -> [B, V] fp32, without the
    [B, L, V] logits (the ingest path), in the span `encoder.head`. On the
    CPU this is the plain version; on a CUDA tensor it launches the kernel
    or raises."""
    _check_no_grad(h, w, bias)
    if _device(h) == "cpu":
        return maxpool_head_reference(h, mask, w, bias)
    lib = _lib()
    check_kernel_args(h, mask, w, bias, lib.maxpool_head_ingest_max_dim())
    B, L, D = h.shape
    V = w.shape[0]
    out = torch.empty((B, V), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = lib.maxpool_head_bf16(
            h.data_ptr(), mask.data_ptr(), w.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, L, D, V, _stream(h),
        )
    _raise_on(rc, "maxpool_head")
    tracing.count(_LAUNCH + "maxpool_head")
    return out


def maxpool_head_argmax(h, mask, w, bias):
    """The training forward: (pooled [B, V] fp32, idx [B, V] int32, the
    smallest position of each maximum). The training-forward kernel on a
    CUDA tensor, the plain version on the CPU."""
    _check_no_grad(h, w, bias)
    if _device(h) == "cpu":
        return maxpool_head_argmax_reference(h, mask, w, bias)
    lib = _lib()
    check_kernel_args(h, mask, w, bias, lib.maxpool_head_max_dim())
    B, L, D = h.shape
    V = w.shape[0]
    out = torch.empty((B, V), dtype=torch.float32, device=h.device)
    idx = torch.empty((B, V), dtype=torch.int32, device=h.device)
    with torch.cuda.device(h.device):
        rc = lib.maxpool_head_argmax_bf16(
            h.data_ptr(), mask.data_ptr(), w.data_ptr(), bias.data_ptr(),
            out.data_ptr(), idx.data_ptr(), B, L, D, V, _stream(h),
        )
    _raise_on(rc, "maxpool_head_argmax")
    tracing.count(_LAUNCH + "maxpool_head_argmax")
    return out, idx


def maxpool_head_bwd_w(g, idx, mask, h):
    """(dw [V, D], dbias [V] fp32) from the upstream gradient g [B, V] fp32
    and the forward's argmax: the bwd_w kernel on a CUDA tensor (dw in bf16,
    h's dtype), the plain version on the CPU (dw in fp32)."""
    _check_no_grad(g, h)
    if _device(g) == "cpu":
        return maxpool_head_bwd_w_reference(g, idx, mask, h)
    lib = _bwd_lib()
    check_bwd_args(g, idx, mask, h, lib.maxpool_head_bwd_max_dim())
    B, L, D = h.shape
    V = g.shape[1]
    dw = torch.empty((V, D), dtype=torch.bfloat16, device=g.device)
    dbias = torch.empty((V,), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        rc = lib.maxpool_head_bwd_w(g.data_ptr(), idx.data_ptr(), mask.data_ptr(), h.data_ptr(),
                                    dw.data_ptr(), dbias.data_ptr(), B, L, D, V, _stream(g))
    _raise_on(rc, "maxpool_head_bwd_w")
    tracing.count(_LAUNCH + "maxpool_head_bwd_w")
    return dw, dbias


def _workspace(lib, B, L, D, V, device):
    n = lib.maxpool_head_bwd_workspace_bytes(B, L, D, V)
    if n < 0:
        raise ValueError(f"maxpool_head backward cannot take B={B}, L={L}, V={V}")
    return torch.empty((n,), dtype=torch.uint8, device=device)


def maxpool_head_bwd_buckets(g, idx, mask):
    """bwd_h's counting sort on its own: (offsets [B*L + 1] int32, v int32,
    coef fp32), the nonzero g[b, v] * mask[b, idx[b, v]] listed per (doc,
    argmax position) in increasing v, as `bucket_by_argmax_reference`
    returns them. On a CUDA tensor v and coef hold B*V entries, of which the
    first offsets[-1] are the lists (nnz is not read back to the host)."""
    _check_no_grad(g)
    if _device(g) == "cpu":
        return bucket_by_argmax_reference(g, idx, mask)
    lib = _bwd_lib()
    check_bucket_args(g, idx, mask)
    B, V = g.shape
    L = mask.shape[1]
    offsets = torch.empty((B * L + 1,), dtype=torch.int32, device=g.device)
    entries = torch.empty((B * V, 2), dtype=torch.int32, device=g.device)
    work = _workspace(lib, B, L, 0, V, g.device)
    with torch.cuda.device(g.device):
        rc = lib.maxpool_head_bwd_buckets(g.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                                          offsets.data_ptr(), entries.data_ptr(),
                                          work.data_ptr(), B, L, V, _stream(g))
    _raise_on(rc, "maxpool_head_bwd_buckets")
    tracing.count(_LAUNCH + "maxpool_head_bwd_buckets")
    return offsets, entries[:, 0], entries[:, 1].view(torch.float32)


def maxpool_head_bwd_h(g, idx, mask, w):
    """dh [B, L, D] from the upstream gradient g [B, V] fp32 and the
    forward's argmax: on a CUDA tensor the counting sort and the reduce over
    its lists (dh in bf16, w's dtype), the plain version on the CPU (dh in
    fp32)."""
    _check_no_grad(g, w)
    if _device(g) == "cpu":
        return maxpool_head_bwd_h_reference(g, idx, mask, w)
    lib = _bwd_lib()
    check_bwd_args(g, idx, mask, w, lib.maxpool_head_bwd_max_dim())
    B, V = g.shape
    L, D = mask.shape[1], w.shape[1]
    dh = torch.empty((B, L, D), dtype=torch.bfloat16, device=g.device)
    work = _workspace(lib, B, L, D, V, g.device)
    with torch.cuda.device(g.device):
        rc = lib.maxpool_head_bwd_h(g.data_ptr(), idx.data_ptr(), mask.data_ptr(), w.data_ptr(),
                                    dh.data_ptr(), work.data_ptr(), B, L, D, V, _stream(g))
    _raise_on(rc, "maxpool_head_bwd_h")
    tracing.count(_LAUNCH + "maxpool_head_bwd_h")
    return dh


class MaxPoolHead(torch.autograd.Function):
    """The head with a gradient: forward `maxpool_head_argmax`, backward
    `maxpool_head_bwd_w` and `maxpool_head_bwd_h`. The gradients come back
    in the inputs' dtypes: with bf16 h and w (the cast copies of fp32
    parameters) dh and dw are rounded to bf16 (by the kernels themselves on
    the card) and flow on through the casts, as in the JAX package's
    `astype` chain."""

    @staticmethod
    def forward(ctx, h, mask, w, bias):
        pooled, idx = maxpool_head_argmax(h, mask, w, bias)
        ctx.save_for_backward(h, mask, w, idx)
        ctx.bias_dtype = bias.dtype
        return pooled

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        h, mask, w, idx = ctx.saved_tensors
        g = g.float().contiguous()
        need_h, _, need_w, need_b = ctx.needs_input_grad
        dh = dw = dbias = None
        if need_w or need_b:
            dw, dbias = maxpool_head_bwd_w(g, idx, mask, h)
            dw = dw.to(w.dtype) if need_w else None
            dbias = dbias.to(ctx.bias_dtype) if need_b else None
        if need_h:
            dh = maxpool_head_bwd_h(g, idx, mask, w).to(h.dtype)
        return dh, None, dw, dbias


@tracing.spanned("encoder.head")
def maxpool_head_train(h, mask, w, bias) -> torch.Tensor:
    """`maxpool_head` with a gradient (the training path), in the span
    `encoder.head`."""
    return MaxPoolHead.apply(h, mask, w, bias)


_KERNELS = (maxpool_head, maxpool_head_argmax, maxpool_head_bwd_w, maxpool_head_bwd_buckets,
            maxpool_head_bwd_h)
_PLAINS = (maxpool_head_reference, maxpool_head_argmax_reference, maxpool_head_bwd_w_reference,
           bucket_by_argmax_reference, maxpool_head_bwd_h_reference)


def launch_counts() -> dict:
    """This process's kernel launches and plain-version calls so far, by
    function name (the CLIs log them when they end; chip_smoke.py shows from
    them which ran)."""
    c = tracing.counters()
    return {"kernels": {f.__name__: c.get(_LAUNCH + f.__name__, 0) for f in _KERNELS},
            "plains": {f.__name__: c.get(_PLAIN + f.__name__, 0) for f in _PLAINS}}


def reset_launch_counts() -> None:
    """Set launch_counts() back to 0."""
    tracing.reset([_LAUNCH + f.__name__ for f in _KERNELS]
                  + [_PLAIN + f.__name__ for f in _PLAINS])
