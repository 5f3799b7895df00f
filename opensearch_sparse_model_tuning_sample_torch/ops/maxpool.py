"""Fused MLM-head masked max-pool: the sparse encoder's per-doc hot op.

    pooled[b, v] = max_l mask[b, l] * (h[b, l, :] . w[v, :] + bias[v])

`maxpool_head` launches the hand-written Hopper kernel
(`csrc/maxpool_head.cu`) on a CUDA tensor, and takes the plain PyTorch
version `maxpool_head_reference` only for a tensor that lies on the CPU.
It replaces the TPU kernel `opensearch_sparse_model_tuning_sample_tpu/ops/
pallas_maxpool.py::maxpool_head` (`pallas_call` at line 99) with the
production head's semantics (`models/bert.py::mlm_maxpool` there): any
decoder matrix, an fp32 bias added after the fp32-accumulated product, and
a masked position that contributes exactly 0. Forward only; the backward
comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from .kernel_build import library


def maxpool_head_reference(
    h: torch.Tensor,  # [B, L, D]
    mask: torch.Tensor,  # [B, L]
    w: torch.Tensor,  # [V, D]
    bias: torch.Tensor,  # [V]
    chunk: int = 64,
) -> torch.Tensor:
    """Plain PyTorch version: chunked fp32 matmul + bias, times the mask,
    running max over the sequence. Inputs are upcast to fp32 before the
    product, so bf16 inputs give exact products summed in fp32, as the
    kernel's tensor cores do (in another order). Returns [B, V] fp32."""
    B, L, _ = h.shape
    wt = w.float().t()
    b = bias.float()
    m = mask.float()
    pooled = torch.full((B, w.shape[0]), float("-inf"), dtype=torch.float32,
                        device=h.device)
    for l0 in range(0, L, chunk):
        logits = torch.matmul(h[:, l0:l0 + chunk].float(), wt) + b
        masked = logits * m[:, l0:l0 + chunk, None]
        pooled = torch.maximum(pooled, masked.amax(dim=1))
    return pooled


def _check_cuda_args(h, mask, w, bias):
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
    for name, t in (("h", h), ("mask", mask), ("w", w), ("bias", bias)):
        if t.device != h.device:
            raise ValueError(f"maxpool_head: {name} is on {t.device}, h on {h.device}")
        if not t.is_contiguous():
            raise ValueError(f"maxpool_head: {name} must be contiguous")
    if min(B, L, V) == 0:
        raise ValueError("maxpool_head: empty batch, sequence or vocab")
    if D % 8:
        raise ValueError(f"maxpool_head kernel needs D a multiple of 8, got {D}")


def _lib():
    lib = library("maxpool_head")
    if not getattr(lib, "_argtypes_set", False):
        p = ctypes.c_void_p
        lib.maxpool_head_bf16.argtypes = [p, p, p, p, p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, p]
        lib.maxpool_head_bf16.restype = ctypes.c_int
        lib.maxpool_head_max_dim.argtypes = []
        lib.maxpool_head_max_dim.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def maxpool_head(
    h: torch.Tensor,  # [B, L, D] bf16 on the card
    mask: torch.Tensor,  # [B, L] int32
    w: torch.Tensor,  # [V, D] bf16
    bias: torch.Tensor,  # [V] fp32
) -> torch.Tensor:
    """Masked max-pool of the MLM logits -> [B, V] fp32, without the
    [B, L, V] logits. On the CPU this is the plain version; on a CUDA
    tensor it launches the kernel or raises."""
    if h.device.type == "cpu":
        return maxpool_head_reference(h, mask, w, bias)
    if h.device.type != "cuda":
        raise ValueError(f"maxpool_head runs on cuda or cpu, not {h.device}")
    _check_cuda_args(h, mask, w, bias)
    lib = _lib()
    B, L, D = h.shape
    V = w.shape[0]
    max_dim = lib.maxpool_head_max_dim()
    if D > max_dim:
        raise ValueError(f"maxpool_head kernel takes D <= {max_dim}, got {D}")
    out = torch.empty((B, V), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.maxpool_head_bf16(
            h.data_ptr(), mask.data_ptr(), w.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, L, D, V, stream,
        )
    if rc != 0:
        raise RuntimeError(f"maxpool_head kernel launch failed: CUDA error {rc}")
    maxpool_head.launches += 1
    return out


maxpool_head.launches = 0
