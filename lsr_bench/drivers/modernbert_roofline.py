"""ModernBERT's operations and bytes, counted from the docs' real token
counts, whatever implements them: the whole forward (for `ingest_mfu`) and
each attention kind's bound (for `attn_global_roofline.ingest` and
`attn_local_roofline.ingest`).

A layer is global when its index is a multiple of
`global_attn_every_n_layers` (from 0), local otherwise. A doc of n tokens
takes n² query-key pairs in a global layer and, in a local one,
P(n) = Σ_i |{j : |i - j| <= w, 0 <= j < n}|, w = local_attention / 2.
Peaks: `roofline.py`'s (one H100 SXM, dense bf16, HBM3).
"""

from __future__ import annotations

import numpy as np

from .. import roofline


def layer_counts(m: dict) -> tuple:
    """(global layers, local layers)."""
    n = m["num_hidden_layers"]
    g = len(range(0, n, m["global_attn_every_n_layers"]))
    return g, n - g


def half_window(m: dict) -> int:
    return m["local_attention"] // 2


def window_pairs(tokens, w: int) -> np.ndarray:
    """P(n) per doc: n² where n <= w + 1, else n (2w + 1) - w (w + 1) (each
    edge loses w (w + 1) / 2 pairs)."""
    n = np.asarray(tokens, dtype=np.float64)
    return np.where(n <= w + 1, n * n, n * (2 * w + 1) - w * (w + 1))


def pairs(m: dict, tokens, kind: str) -> float:
    """Real query-key pairs of one forward over docs of these token counts,
    summed over the layers of `kind` ("global" or "local"), heads not
    counted."""
    g, loc = layer_counts(m)
    n = np.asarray(tokens, dtype=np.float64)
    if kind == "global":
        return float(g * (n * n).sum())
    return float(loc * window_pairs(n, half_window(m)).sum())


def forward_flops(m: dict, tokens) -> float:
    """One forward of the encoder and its MLM head over docs of these real
    token counts: per layer Wqkv and Wo (8 n D²), the GeGLU feed-forward's
    Wi (2 n D 2I) and Wo (2 n I D), attention's two products (4 n² D
    global, 4 P D local); the head's dense (2 n D²) and decoder (2 n D V)."""
    n = np.asarray(tokens, dtype=np.float64)
    D, Fd, V = m["hidden_size"], m["intermediate_size"], m["vocab_size"]
    linear = m["num_hidden_layers"] * (8 * n * D * D + 6 * n * D * Fd).sum()
    attn = 4 * D * (pairs(m, n, "global") + pairs(m, n, "local"))
    return float(linear + attn + (2 * n * D * D + 2 * n * D * V).sum())


def attn_bound_s(m: dict, tokens, kind: str) -> float:
    """The least time the card could take for the attention cores of one
    forward's layers of `kind`: for each doc and layer the larger of its
    4 x pairs x D operations at the bf16 peak and its bytes at the HBM peak
    (q, k, v read once and the context written once, bf16: 4 n D 2)."""
    g, loc = layer_counts(m)
    D = m["hidden_size"]
    n = np.asarray(tokens, dtype=np.float64)
    per_doc = n * n if kind == "global" else window_pairs(n, half_window(m))
    layers = g if kind == "global" else loc
    t = np.maximum(4 * per_doc * D / roofline.PEAK_BF16_FLOPS,
                   4 * n * D * 2 / roofline.PEAK_BYTES_PER_S)
    return float(layers * t.sum())
