"""Shape bucketing helpers (the PyTorch port's copy)."""

from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1). Only serving's micro-batcher
    still uses it, to pad a query batch and its token slots; the encoder's
    packer runs every batch at its own row count and length."""
    p = 1
    while p < n:
        p *= 2
    return p
