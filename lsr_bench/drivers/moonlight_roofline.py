"""Moonlight's operations and bytes, counted from the docs' real token
counts, whatever implements them: the whole forward (for `ingest_mfu`, the
routed experts at `num_experts_per_tok` a token), the routed experts' bound
(for `moe_roofline.ingest`) and causal attention's (for
`attn_causal_roofline.ingest`). Peaks: `roofline.py`'s (one H100 SXM,
dense bf16, HBM3).

A doc of n tokens takes n(n + 1)/2 query-key pairs in each layer. The
experts' bound is per layer and per batch, as the ingest path batches a
corpus: chunks of 8 batches of docs in corpus order, each chunk sorted by
length and cut into batches of `rows`, the first one short.
"""

from __future__ import annotations

import numpy as np

from .. import roofline


def moe_layers(m: dict) -> int:
    return m["num_hidden_layers"] - m["first_k_dense_replace"]


def per_token_flops(m: dict) -> float:
    """Every layer's operations for one token, attention's core left out:
    the projections (q, kv_a, kv_b, o), the dense layers' SwiGLU, the expert
    layers' router, k routed experts and the shared SwiGLU; and the head."""
    D, H, V = m["hidden_size"], m["num_attention_heads"], m["vocab_size"]
    nope, rd, vd, r = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"], \
        m["kv_lora_rank"]
    I = m["moe_intermediate_size"]
    proj = 2 * D * H * (nope + rd) + 2 * D * (r + rd) + 2 * r * H * (nope + vd) + 2 * H * vd * D
    dense = 6 * D * m["intermediate_size"]
    expert = (2 * D * m["n_routed_experts"] + m["num_experts_per_tok"] * 6 * D * I
              + 6 * D * m["n_shared_experts"] * I)
    return float(m["num_hidden_layers"] * proj + m["first_k_dense_replace"] * dense
                 + moe_layers(m) * expert + 2 * D * V)


def causal_pairs(tokens) -> np.ndarray:
    n = np.asarray(tokens, dtype=np.float64)
    return n * (n + 1) / 2


def forward_flops(m: dict, tokens) -> float:
    """One forward of the encoder and its head over docs of these real
    token counts: `per_token_flops` a token, and per layer and doc the
    causal core's two products, n(n + 1)/2 · H · 2 · (hqk + hv)."""
    n = np.asarray(tokens, dtype=np.float64)
    core = m["num_attention_heads"] * 2 * (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
                                          + m["v_head_dim"])
    return float(per_token_flops(m) * n.sum()
                 + m["num_hidden_layers"] * core * causal_pairs(n).sum())


def attn_bound_s(m: dict, tokens) -> float:
    """The least time for the causal cores of one forward: for each doc and
    layer the larger of its n(n + 1)/2 · H · 2 · (hqk + hv) operations at the
    bf16 peak and q, k, v and the context once in bf16 at the HBM peak."""
    n = np.asarray(tokens, dtype=np.float64)
    H, hqk, hv = (m["num_attention_heads"], m["qk_nope_head_dim"] + m["qk_rope_head_dim"],
                  m["v_head_dim"])
    ops = causal_pairs(n) * H * 2 * (hqk + hv)
    nbytes = n * H * (2 * hqk + 2 * hv) * 2
    return float(m["num_hidden_layers"] * np.maximum(ops / roofline.PEAK_BF16_FLOPS,
                                                     nbytes / roofline.PEAK_BYTES_PER_S).sum())


def batch_tokens(tokens, rows: int) -> np.ndarray:
    """The real tokens of each batch the ingest path runs over a corpus of
    these token counts (in corpus order)."""
    n = np.asarray(tokens, dtype=np.int64)
    out = []
    for c in range(0, len(n), 8 * rows):
        chunk = np.sort(n[c:c + 8 * rows], kind="stable")
        ends = np.arange(len(chunk), 0, -rows)[::-1]
        out += [int(chunk[max(e - rows, 0):e].sum()) for e in ends]
    return np.asarray(out, dtype=np.float64)


def moe_bound_s(m: dict, tokens, rows: int) -> float:
    """The least time for the routed experts' products of one forward: per
    expert layer and batch the larger of 2 · R · 3 · D · I operations at the
    bf16 peak (R = k a real token) and, at the HBM peak, every held expert's
    weights once (E · 3 · D · I in bf16) plus the rows in and out (x in,
    h out and in, y out, bf16)."""
    D, I, E, k = (m["hidden_size"], m["moe_intermediate_size"], m["n_routed_experts"],
                  m["num_experts_per_tok"])
    R = k * batch_tokens(tokens, rows)
    ops = 2 * R * 3 * D * I
    nbytes = E * 3 * D * I * 2 + R * (2 * D + 2 * I) * 2
    return float(moe_layers(m) * np.maximum(ops / roofline.PEAK_BF16_FLOPS,
                                            nbytes / roofline.PEAK_BYTES_PER_S).sum())
