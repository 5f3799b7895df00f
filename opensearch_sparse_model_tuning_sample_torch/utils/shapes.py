"""Shape bucketing helpers (the PyTorch port's copy)."""

from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1). Compiled-shape bucketing: padding
    counts up to a pow2 bounds the set of batch shapes the encoder sees."""
    p = 1
    while p < n:
        p *= 2
    return p
