"""Device and dtype policy: the single-card counterpart of the JAX package's
`core/mesh.py`.

The port runs on the CUDA card unless the caller asks for the CPU. Without a
card and without that request it raises: it never carries on silently on the
CPU. Matmul precision is pinned: TF32 is off for matmuls and cuDNN, and bf16
GEMMs reduce in fp32, so a "fp32 accumulation" in the model code means that.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def set_precision_policy() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` or "cuda" -> the current CUDA card (raises if there is none);
    "cpu" -> the CPU. Also applies the precision policy."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless asked for "
                "the CPU (device='cpu', or --device cpu on the CLI)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    set_precision_policy()
    return dev


def resolve_dtype(dtype: Union[str, torch.dtype, None],
                  default: torch.dtype = torch.float32) -> torch.dtype:
    """A torch dtype from a config string ("bfloat16", "float32", ...)."""
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}; have {sorted(_DTYPES)}") from None

