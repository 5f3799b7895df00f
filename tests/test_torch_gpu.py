"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips where no CUDA device exists (the
check runs inside the fixture, never at import). The file imports torch and
numpy only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_torch.ops.maxpool import (
    maxpool_head,
    maxpool_head_reference,
)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, L, D, V, seed, device):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(V, D)) * 0.05).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(V,)).astype(np.float32))
    lens = rng.integers(1, L + 1, size=B)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    mask[-1] = 0  # one all-masked row
    return (h.to(device, torch.bfloat16), torch.from_numpy(mask).to(device),
            w.to(device, torch.bfloat16), bias.to(device))


# (B, L, D, V): the mini ingest shapes, a base-width shape, L not a multiple
# of the kernel's 32-row step, D not a multiple of 16, the widest D (the
# 64-row vocab tile), and a vocab edge that is not a multiple of the tile
@pytest.mark.parametrize("B,L,D,V", [
    (50, 128, 256, 30592),
    (50, 512, 256, 30592),
    (8, 512, 768, 30592),
    (5, 45, 256, 1000),
    (9, 64, 264, 777),
    (3, 40, 1024, 300),
])
def test_maxpool_kernel_matches_plain_version(cuda, B, L, D, V):
    h, mask, w, bias = _inputs(B, L, D, V, seed=B * L + D, device=cuda)
    before = maxpool_head.launches
    got = maxpool_head(h, mask, w, bias)
    torch.cuda.synchronize()
    assert maxpool_head.launches == before + 1
    ref = maxpool_head_reference(h, mask, w, bias)
    # both sides sum exact bf16 products in fp32, in another order
    err = (got - ref).abs()
    assert bool((err <= 1e-3 * ref.abs().clamp_min(1.0)).all()), float(err.max())
    assert bool((got[-1] == 0).all())  # all-masked row pools to exactly 0
    padded = ~mask.bool().all(dim=1)  # a row with any padding pools to >= 0
    assert bool((got[padded] >= 0).all())


def test_maxpool_kernel_rejects_what_it_cannot_take(cuda):
    h, mask, w, bias = _inputs(2, 8, 20, 64, seed=0, device=cuda)
    with pytest.raises(ValueError):
        maxpool_head(h, mask, w, bias)  # D % 8 != 0
    h, mask, w, bias = _inputs(2, 8, 32, 64, seed=0, device=cuda)
    with pytest.raises(TypeError):
        maxpool_head(h.float(), mask, w, bias)
    with pytest.raises(TypeError):
        maxpool_head(h, mask.long(), w, bias)
