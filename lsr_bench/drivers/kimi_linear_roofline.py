"""Kimi Linear's operations and bytes, counted from the docs' real token
counts, whatever implements them: the whole forward (for `ingest_mfu`), the
held experts' bound (for `moe_roofline.ingest`), the MLA cores' (for
`attn_causal_roofline.ingest`) and the KDA mixers' (for
`attn_linear_roofline.ingest`). Peaks: `roofline.py`'s (one H100 SXM,
dense bf16, HBM3).

The held experts count at k·E_held/E rows a real token (the expected share:
the router spreads a token's k picks over all E, and this card computes
those of its E_held); the batches are those of `moonlight_roofline.py`.
A KDA layer's core per doc of n tokens: n·H·6·dk·dv operations (the chunked
form's products: the intra-chunk ones, W, o and the state) against q, k, v
before the convolution, the decay's and the output gate's pre-activations
and o once in bf16 (n·H·2·(3dk + dk + dv + dv) bytes) plus β in fp32
(n·H·4).
"""

from __future__ import annotations

import numpy as np

from .. import roofline
from .moonlight_roofline import batch_tokens, causal_pairs


def _layers(m: dict):
    kda = sum(1 for i in range(m["num_hidden_layers"]) if i + 1 in m["kda_layers"])
    return kda, m["num_hidden_layers"] - kda, m["num_hidden_layers"] - m["first_k_dense_replace"]


def held_rows_per_token(m: dict) -> float:
    return m["num_experts_per_token"] * m["num_experts"] / m["n_routed"]


def per_token_flops(m: dict) -> float:
    """Every layer's operations for one token, the attention and KDA cores
    left out: the KDA layers' projections (q, k, v, the gates' low-rank
    pairs, β, o), the MLA layers' (q, kv_a, kv_b, o), the dense layer's
    SwiGLU, the expert layers' router, the held experts at their expected
    rows and the shared expert; and the head."""
    D, V = m["hidden_size"], m["vocab_size"]
    Hk, d = m["kda_num_heads"], m["kda_head_dim"]
    H, nope, rd, vd, r = (m["num_attention_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                          m["v_head_dim"], m["kv_lora_rank"])
    I = m["moe_intermediate_size"]
    n_kda, n_mla, n_moe = _layers(m)
    kda = 2 * D * Hk * d * 4 + 2 * (D * d + d * Hk * d) * 2 + 2 * D * Hk
    mla = 2 * D * H * (nope + rd) + 2 * D * (r + rd) + 2 * r * H * (nope + vd) + 2 * H * vd * D
    dense = 6 * D * m["intermediate_size"]
    expert = (2 * D * m["n_routed"] + held_rows_per_token(m) * 6 * D * I
              + 6 * D * m["num_shared_experts"] * I)
    return float(n_kda * kda + n_mla * mla + m["first_k_dense_replace"] * dense
                 + n_moe * expert + 2 * D * V)


def kda_core_flops(m: dict, tokens) -> np.ndarray:
    n = np.asarray(tokens, dtype=np.float64)
    return n * m["kda_num_heads"] * 6 * m["kda_head_dim"] * m["kda_head_dim"]


def forward_flops(m: dict, tokens) -> float:
    """One forward over docs of these real token counts: `per_token_flops`
    a token, per MLA layer and doc n(n + 1)/2 · H · 2 · (hqk + hv), per KDA
    layer and doc n · H · 6 · dk · dv."""
    n = np.asarray(tokens, dtype=np.float64)
    n_kda, n_mla, _ = _layers(m)
    core = m["num_attention_heads"] * 2 * (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
                                          + m["v_head_dim"])
    return float(per_token_flops(m) * n.sum() + n_mla * core * causal_pairs(n).sum()
                 + n_kda * kda_core_flops(m, n).sum())


def attn_causal_bound_s(m: dict, tokens) -> float:
    """The MLA cores of one forward: per doc and MLA layer the larger of
    n(n + 1)/2 · H · 2 · (hqk + hv) operations at the bf16 peak and q, k, v
    and the context once in bf16 at the HBM peak."""
    n = np.asarray(tokens, dtype=np.float64)
    H, hqk, hv = (m["num_attention_heads"], m["qk_nope_head_dim"] + m["qk_rope_head_dim"],
                  m["v_head_dim"])
    ops = causal_pairs(n) * H * 2 * (hqk + hv)
    nbytes = n * H * (2 * hqk + 2 * hv) * 2
    return float(_layers(m)[1] * np.maximum(ops / roofline.PEAK_BF16_FLOPS,
                                            nbytes / roofline.PEAK_BYTES_PER_S).sum())


def attn_linear_bound_s(m: dict, tokens) -> float:
    """The KDA cores of one forward: per doc and KDA layer the larger of
    n·H·6·dk·dv operations at the bf16 peak and n·H·(2·(3dk + dk + dv + dv)
    + 4) bytes at the HBM peak."""
    n = np.asarray(tokens, dtype=np.float64)
    H, dk = m["kda_num_heads"], m["kda_head_dim"]
    dv = dk
    nbytes = n * H * (2 * (3 * dk + dk + dv + dv) + 4)
    return float(_layers(m)[0] * np.maximum(kda_core_flops(m, n) / roofline.PEAK_BF16_FLOPS,
                                            nbytes / roofline.PEAK_BYTES_PER_S).sum())


def moe_bound_s(m: dict, tokens, rows: int) -> float:
    """The held experts' products of one forward: per expert layer and
    batch the larger of 2 · R · 3 · D · I operations at the bf16 peak (R =
    k·E_held/E a real token) and, at the HBM peak, the held experts' weights
    once (E_held · 3 · D · I in bf16) plus the rows in and out."""
    D, I, E = m["hidden_size"], m["moe_intermediate_size"], m["num_experts"]
    R = held_rows_per_token(m) * batch_tokens(tokens, rows)
    ops = 2 * R * 3 * D * I
    nbytes = E * 3 * D * I * 2 + R * (2 * D + 2 * I) * 2
    return float(_layers(m)[2] * np.maximum(ops / roofline.PEAK_BF16_FLOPS,
                                            nbytes / roofline.PEAK_BYTES_PER_S).sum())
