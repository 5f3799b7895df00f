"""A SPLADE-like sparse corpus and inference-free queries.

Copied from the repository's `bench.py` (`token_dist`, `make_corpus`,
`make_queries`), whose distribution they keep: Zipf popularity
(rank^-0.8 over a fixed permutation), weights Gamma(2, 0.5) scaled by the
token's idf over the mean idf, Poisson(avg_terms) terms a doc clipped to
[8, l_max], tokens unique within a doc (a repeat keeps the larger weight),
impact-sorted. `make_corpus` is rewritten in torch to run on the card from
a `torch.Generator` (the 2.1M-doc corpus is set-up time on every run);
`make_queries` stays numpy, as in bench.py. bench.py itself imports JAX in
`main()` and is not read.
"""

from __future__ import annotations

import numpy as np
import torch

_DIST = {}


def token_dist(vocab: int):
    """(cdf, idf) of the token popularity, the same for every seed (float64
    cdf, float32 idf ~ ln(N / df))."""
    if vocab not in _DIST:
        pop = np.arange(1, vocab + 1, dtype=np.float64) ** -0.8
        np.random.default_rng(0x1DF).shuffle(pop)
        pop /= pop.sum()
        idf = np.log1p(0.01 / pop)
        _DIST[vocab] = (np.cumsum(pop), idf.astype(np.float32))
    return _DIST[vocab]


def make_corpus(n_docs: int, vocab: int, avg_terms: float, seed: int, l_max: int,
                device, chunk: int = 1 << 19):
    """(toks int32 [n, l_max], ws float32 [n, l_max]) on `device`: each row
    its unique tokens, impact-sorted, zero-padded. Drawn in chunks of rows
    from one generator seeded with `seed`."""
    cdf_np, idf_np = token_dist(vocab)
    cdf = torch.from_numpy(cdf_np).to(device)
    idf = torch.from_numpy(idf_np).to(device)
    idf_mean = float(idf_np.mean())
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    toks_out = torch.empty((n_docs, l_max), dtype=torch.int32, device=device)
    ws_out = torch.empty((n_docs, l_max), dtype=torch.float32, device=device)
    cols = torch.arange(l_max, device=device)
    for s in range(0, n_docs, chunk):
        n = min(chunk, n_docs - s)
        u = torch.rand((n, l_max), generator=gen, device=device, dtype=torch.float64)
        toks = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
        # Gamma(2, 0.5) as half the sum of two unit exponentials
        e = torch.rand((2, n, l_max), generator=gen, device=device, dtype=torch.float64)
        ws = (-0.5 * torch.log1p(-e).sum(0)).float()
        ws = ws * idf[toks] / idf_mean
        rate = torch.full((n,), float(avg_terms), dtype=torch.float64, device=device)
        lens = torch.poisson(rate, generator=gen).clamp_(8, l_max)
        live = cols[None, :] < lens[:, None]
        ws = torch.where(live, ws, 0.0)
        toks = torch.where(live, toks, 0)
        # a repeat keeps its largest weight: sort by (token, weight desc)
        key = (toks << 32) | (0xFFFFFFFF - ws.view(torch.int32).long().bitwise_and(0xFFFFFFFF))
        order = torch.sort(key, dim=1, stable=True).indices
        toks = torch.gather(toks, 1, order)
        ws = torch.gather(ws, 1, order)
        rep = torch.zeros_like(live)
        rep[:, 1:] = toks[:, 1:] == toks[:, :-1]
        ws = torch.where(rep, 0.0, ws)
        toks = torch.where(ws > 0, toks, 0)
        order = torch.sort(-ws, dim=1, stable=True).indices
        toks_out[s:s + n] = torch.gather(toks, 1, order).int()
        ws_out[s:s + n] = torch.gather(ws, 1, order)
    return toks_out, ws_out


def make_queries(n_queries: int, vocab: int, n_terms: int, seed: int, slots: int = 8):
    """(q_tok int32 [n, slots], q_w float32 [n, slots]): `n_terms` distinct
    tokens a query from the corpus's popularity, each weighted by its idf
    (the inference-free query), as bench.py's make_queries."""
    rng = np.random.default_rng(int(seed) & (2**63 - 1))
    cdf, idf = token_dist(vocab)
    draws = np.minimum(np.searchsorted(cdf, rng.random((n_queries, 6 * n_terms))), vocab - 1)
    q_tok = np.zeros((n_queries, slots), dtype=np.int32)
    q_w = np.zeros((n_queries, slots), dtype=np.float32)
    for i in range(n_queries):
        _, first = np.unique(draws[i], return_index=True)
        u = draws[i][np.sort(first)][:n_terms]
        q_tok[i, : u.size] = u
        q_w[i, : u.size] = idf[u]
    return q_tok, q_w
