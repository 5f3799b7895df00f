"""Peaks of the card and the operations and bytes of the work, counted from
the inputs, whatever implements them.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): 989
TFLOP/s bf16, 3.35 TB/s HBM3.

The head's bound is copied from the repository's `chip_smoke.py::_bound`:
the larger of 2 * unmasked * D * V operations at the bf16 peak and the
bytes read once and written once at the HBM peak, with V the published
vocabulary (30 522), not the port's padded one.
"""

from __future__ import annotations

import numpy as np

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def encoder_forward_flops(m: dict, tokens) -> float:
    """Operations of one forward of the encoder and its MLM head over docs
    of these real (unpadded) token counts: per layer the four D x D
    projections (8 n D^2), the feed-forward (4 n D F) and attention's two
    products (4 n^2 D); the head's transform (2 n D^2) and decoder (2 n D V)."""
    n = np.asarray(tokens, dtype=np.float64)
    D, Fd, V = m["hidden_size"], m["intermediate_size"], m["vocab_size"]
    per_layer = 8 * n * D * D + 4 * n * D * Fd + 4 * n * n * D
    return float((m["num_hidden_layers"] * per_layer + 2 * n * D * D + 2 * n * D * V).sum())


def train_step_flops(m: dict, doc_tokens) -> float:
    """Forward and backward (three forwards) of the docs; inference-free
    queries run no encoder."""
    return 3.0 * encoder_forward_flops(m, doc_tokens)


def head_flops(unmasked: float, D: int, V: int) -> float:
    return 2.0 * float(unmasked) * D * V


def head_bytes(B: int, L: int, D: int, V: int, train: bool) -> float:
    """h (bf16) + mask (int32) + decoder (bf16) + bias (fp32) read, the pooled
    [B, V] fp32 written, and in training the argmax [B, V] int32 too."""
    read = B * L * D * 2 + B * L * 4 + V * D * 2 + V * 4
    written = B * V * 4 + (B * V * 4 if train else 0)
    return float(read + written)


def head_bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
