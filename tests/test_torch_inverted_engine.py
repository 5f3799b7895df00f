"""The port's SparseIndex on the inverted engine against the JAX package's
SparseIndex and against its own exact scan, on the CPU: `auto` above its
threshold, the exact contract under escalation, the stage codes, the
full-forward routing, two-phase, the tiers (deep re-lookup, refine,
block-max), the token fast path and its async handles, `reopen`, padding
rows, the zero-miss certificate, out-of-range token ids, save/load across
the packages, the incremental build, the eval's certificate tally and a
served inverted index.

Tolerances: scores within 1e-5 relative of the other package's and of the
scan's (fp32 sums of the same products in another order); ids equal except
where two docs' scores tie within that; stage codes and certificates equal
except on rows whose k-th score and bound lie within 2 CERT_MARGIN of each
other (there the reordered sums may fall either side).
"""

import dataclasses
import json
import os
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.cli import evaluate_beir as jcli
from opensearch_sparse_model_tuning_sample_tpu.index.engine import (
    IndexConfig as JIndexConfig,
    SparseIndex as JSparseIndex,
)
from opensearch_sparse_model_tuning_sample_tpu.models import hf_import as jhf
from opensearch_sparse_model_tuning_sample_torch.cli import evaluate_beir as tcli
from opensearch_sparse_model_tuning_sample_torch.cli import serve as tserve
from opensearch_sparse_model_tuning_sample_torch.index import inverted as tinv
from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex
from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse

torch.set_num_threads(2)

RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _zipf_corpus(n_docs, vocab, l_max, pop, seed):
    """Token ids drawn by popularity `pop`, gamma weights, unique tokens per
    doc, rows impact-sorted and zero-padded, as an encoder's top-l_max."""
    r = np.random.default_rng(seed)
    toks = np.searchsorted(np.cumsum(pop / pop.sum()), r.random((n_docs, l_max))).astype(np.int32)
    toks = np.minimum(toks, vocab - 1)
    ws = r.gamma(2.0, 0.5, size=(n_docs, l_max)).astype(np.float32)
    toks.sort(axis=1)
    dup = np.zeros_like(toks, dtype=bool)
    dup[:, 1:] = toks[:, 1:] == toks[:, :-1]
    ws[dup] = 0.0
    order = np.argsort(-ws, axis=1, kind="stable")
    toks, ws = np.take_along_axis(toks, order, 1), np.take_along_axis(ws, order, 1)
    toks[ws <= 0] = 0
    return toks, ws


def _diffuse_corpus(n_docs, vocab, l_max, seed=3):
    """Zipf-sampled popularities (most mass on a few tokens): impact-ordered
    truncation misses docs here, so the certificate and the escalation
    ladder have work."""
    pop = np.random.default_rng(seed).zipf(1.3, size=vocab).astype(np.float64)
    return _zipf_corpus(n_docs, vocab, l_max, pop, seed + 100)


def _rich_corpus(n_docs, vocab, l_max, seed=3):
    """Zipf-PMF popularities (rank^-0.8): docs keep ~l_max unique tokens,
    so queries drawn from a doc can be wide."""
    pop = np.arange(1, vocab + 1, dtype=np.float64) ** -0.8
    np.random.default_rng(seed).shuffle(pop)
    return _zipf_corpus(n_docs, vocab, l_max, pop, seed + 100)


def _corpus_queries(toks, n_q, width, seed=4):
    """(q_tok, q_w) slots of `width` tokens drawn from corpus rows."""
    r = np.random.default_rng(seed)
    q_tok = np.zeros((n_q, width), np.int32)
    q_w = np.zeros((n_q, width), np.float32)
    for i in range(n_q):
        row = toks[r.integers(0, toks.shape[0])]
        row = np.unique(row[row > 0])
        pick = r.choice(row, size=min(width, row.size), replace=False)
        q_tok[i, :pick.size] = pick
        q_w[i, :pick.size] = r.uniform(2.0, 10.0, size=pick.size)
    return q_tok, q_w


def _dense(q_tok, q_w, vocab):
    q = np.zeros((q_tok.shape[0], vocab), np.float32)
    for i in range(q_tok.shape[0]):
        np.add.at(q[i], q_tok[i][q_w[i] > 0], q_w[i][q_w[i] > 0])
    return q


def _rows(cls, engine, toks, ws, vocab, **kw):
    """An index holding the rows as they are (no add()), as the JAX tests
    build theirs."""
    cfg_kw = dict(engine=engine, l_max=toks.shape[1], block_docs=256, query_batch=8,
                  weight_dtype="float32")
    cfg_kw.update(kw)
    if cls is JSparseIndex:
        ix = JSparseIndex(vocab, JIndexConfig(**cfg_kw))
    else:
        ix = SparseIndex(vocab, IndexConfig(**cfg_kw), device="cpu")
    ix.doc_ids = [str(i) for i in range(toks.shape[0])]
    ix._tok_chunks, ix._w_chunks = [toks], [ws]
    ix.finalize()
    return ix


def _assert_hits_match(got, ref):
    """Per-query {doc: score} maps: the same scores to RTOL, the same docs
    above the k-th score's tie band."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r), (g, r)
        np.testing.assert_allclose(sorted(g.values()), sorted(r.values()), rtol=RTOL)
        if r:
            edge = min(r.values()) * (1 + RTOL)
            assert {d for d, s in g.items() if s > edge} == {d for d, s in r.items() if s > edge}


def _borderline(t, q, k, engine):
    """Rows whose base (or deep-tier) k-th score and bound lie within 2
    CERT_MARGIN of each other: there the certificate may go either way."""
    fns = t._inverted_fns(k, False, engine)
    band = np.zeros(q[0].shape[0] if isinstance(q, tuple) else q.shape[0], bool)
    for fn in (fns.base, fns.deep):
        if fn is None:
            continue
        s, _, b = fn(q)
        kth, b = s[:, -1].numpy(), b.numpy()
        with np.errstate(invalid="ignore"):
            band |= np.abs(kth - b) <= 2 * tinv.CERT_MARGIN * np.maximum(np.abs(kth), np.abs(b))
    return band


def _flags(ix):
    return ix.last_certified, ix.last_escalated, ix.last_scan_escalated


def _assert_flags_match(t, j, band=None):
    for a, b in zip(_flags(t), _flags(j)):
        assert (a is None) == (b is None)
        if a is not None:
            same = a == b
            assert (same | band).all() if band is not None else same.all(), (a, b)


# ------------------------------------------------------------ the engine


def test_auto_resolves_to_inverted_with_exact_escalation():
    toks, ws = _diffuse_corpus(600, 400, 24)
    for n, engine in ((599, "sparse"), (600, "inverted")):
        for cls in (JSparseIndex, SparseIndex):
            ix = _rows(cls, "auto", toks[:n], ws[:n], 400, auto_threshold=600,
                       postings_cap=16)
            assert ix._engine == engine
            assert ix._exact_escalate == (engine == "inverted")
    q_tok, q_w = _corpus_queries(toks, 16, 5)
    t = _rows(SparseIndex, "auto", toks, ws, 400, auto_threshold=600, postings_cap=4)
    scan = _rows(SparseIndex, "sparse", toks, ws, 400)
    got = t.search_tokens(q_tok, q_w, k=5)
    assert t.last_certified.all() and t.last_escalated.any()
    _assert_hits_match(got, scan.search_tokens(q_tok, q_w, k=5))


LADDER = {
    "plain": dict(postings_cap=8, query_terms=8),
    "deep": dict(postings_cap=8, postings_ext_cap=120, query_terms=8),
    "deep_off": dict(postings_cap=8, postings_ext_cap=120, query_terms=8, deep_escalate=False),
    "refine": dict(postings_cap=16, query_terms=8, refine_expand=8, inverted_rescore_expand=1),
    "blockmax": dict(postings_cap=16, query_terms=8, tail_block_docs=256),
    "bf16": dict(postings_cap=8, postings_ext_cap=56, query_terms=8, weight_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(LADDER))
def test_escalation_is_exact_and_its_stages_match_jax(case):
    """Exact escalation on: every answer equals the exact scan's, every row
    reads certified, and the stage codes (0 certified, 1 the deep tier, 2
    the scan) equal the JAX package's fused ladder, by the token fast path
    and by the dense entry."""
    vocab = 400
    toks, ws = _diffuse_corpus(2000, vocab, 24)
    q_tok, q_w = _corpus_queries(toks, 20, 5)
    q_tok[-1], q_w[-1] = 0, 0.0  # a padding row
    kw = dict(LADDER[case], exact_escalate=True)
    j = _rows(JSparseIndex, "inverted", toks, ws, vocab, **kw)
    t = _rows(SparseIndex, "inverted", toks, ws, vocab, **kw)
    scan = _rows(SparseIndex, "sparse", toks, ws, vocab, weight_dtype=kw.get(
        "weight_dtype", "float32"))
    want = scan.search_tokens(q_tok, q_w, k=5)
    T = kw["query_terms"]
    tok_in = (torch.from_numpy(np.pad(q_tok, ((0, 0), (0, T - 5)))),
              torch.from_numpy(np.pad(q_w, ((0, 0), (0, T - 5)))))
    dense = _dense(q_tok, q_w, vocab)
    for name, run_t, run_j, engine, q in (
        ("tokens", lambda ix: ix.search_tokens(q_tok, q_w, k=5),
         lambda ix: ix.search_tokens(q_tok, q_w, k=5), "inverted_tokens", tok_in),
        ("dense", lambda ix: ix.search(dense, k=5, full_forward=False),
         lambda ix: ix.search(dense, k=5, full_forward=False), "inverted",
         torch.from_numpy(dense)),
    ):
        got = run_t(t)
        _assert_hits_match(got, want)
        _assert_hits_match(got, run_j(j))
        assert t.last_certified.all() and not t.last_escalated[-1], name
        _assert_flags_match(t, j, _borderline(t, q, 5, engine))
    if case == "plain":
        assert t.last_scan_escalated.any()
    if case == "deep":
        assert (t.last_escalated & ~t.last_scan_escalated).any()  # the deep tier certified some


def test_rows_per_call_change_no_answer(monkeypatch):
    """The inverted engine runs max(query_batch, 64) rows a call; at 3 rows
    a call (several calls, a ladder over rows from several of them) every
    answer, bound and flag is the same."""
    from opensearch_sparse_model_tuning_sample_torch.index import engine as tengine

    vocab = 400
    toks, ws = _diffuse_corpus(2000, vocab, 24)
    q_tok, q_w = _corpus_queries(toks, 20, 5)
    kw = dict(postings_cap=8, postings_ext_cap=56, query_terms=8, exact_escalate=True)
    one = _rows(SparseIndex, "inverted", toks, ws, vocab, **kw)
    want = one.search_tokens(q_tok, q_w, k=5), _flags(one)
    dense_want = one.search(_dense(q_tok, q_w, vocab), k=5)
    monkeypatch.setattr(tengine, "_MIN_INVERTED_ROWS", 1)
    many = _rows(SparseIndex, "inverted", toks, ws, vocab, **dict(kw, query_batch=3))
    assert many.search_tokens(q_tok, q_w, k=5) == want[0]
    for a, b in zip(_flags(many), want[1]):
        np.testing.assert_array_equal(a, b)
    assert many.search(_dense(q_tok, q_w, vocab), k=5) == dense_want
    assert want[1][1].any() and (want[1][1] & ~want[1][2]).any()  # both tiers ran


def test_full_forward_routing_fallback_scan_and_escalation():
    """Queries wider than query_terms take the full-forward mode (with the
    deep tier available, full_exact_escalate None escalates it), or the
    exact scan with full_fallback_scan (no flags)."""
    vocab = 600
    toks, ws = _rich_corpus(1500, vocab, 48)
    q_tok, q_w = _corpus_queries(toks, 12, 30, seed=5)
    q = _dense(q_tok, q_w, vocab)
    scan = _rows(SparseIndex, "sparse", toks, ws, vocab)
    want = scan.search(q, k=5)
    kw = dict(postings_cap=16, postings_ext_cap=112, query_terms=8, full_query_terms=16,
              full_postings_cols=8, full_deep_query_terms=32, exact_escalate=True)
    j = _rows(JSparseIndex, "inverted", toks, ws, vocab, **kw)
    t = _rows(SparseIndex, "inverted", toks, ws, vocab, **kw)
    seen = []
    orig = t._inverted_fns
    t._inverted_fns = lambda k, tp, engine: seen.append(engine) or orig(k, tp, engine)
    syncs = t.host_syncs
    got = t.search(q, k=5)  # full_forward=None: decided from the batch
    assert seen[0] == "inverted_full" and t.host_syncs - syncs >= 2
    _assert_hits_match(got, want)
    _assert_hits_match(got, j.search(q, k=5))
    assert t.last_certified.all() and t.last_escalated.any()
    _assert_flags_match(t, j, _borderline(t, torch.from_numpy(q), 5, "inverted_full"))
    # full_exact_escalate pinned off: the certificate is exposed, honest
    kw_off = dict(kw, full_exact_escalate=False)
    j = _rows(JSparseIndex, "inverted", toks, ws, vocab, **kw_off)
    t = _rows(SparseIndex, "inverted", toks, ws, vocab, **kw_off)
    _assert_hits_match(t.search(q, k=5), j.search(q, k=5))
    assert t.last_escalated is None and not t.last_certified.all()
    _assert_flags_match(t, j, _borderline(t, torch.from_numpy(q), 5, "inverted_full"))
    # the escape hatch: the exact scan, no certificate
    t = _rows(SparseIndex, "inverted", toks, ws, vocab, **dict(kw, full_fallback_scan=True))
    _assert_hits_match(t.search(q, k=5), want)
    assert _flags(t) == (None, None, None)


def test_query_two_phase_is_certified_and_never_escalated():
    vocab = 400
    toks, ws = _diffuse_corpus(2000, vocab, 24)
    q = _dense(*_corpus_queries(toks, 16, 5), vocab)
    kw = dict(postings_cap=16, query_terms=8, exact_escalate=True, two_phase_ratio=0.6)
    j = _rows(JSparseIndex, "inverted", toks, ws, vocab, **kw)
    t = _rows(SparseIndex, "inverted", toks, ws, vocab, **kw)
    got = t.search(q, k=5, two_phase=True)
    _assert_hits_match(got, j.search(q, k=5, two_phase=True))
    assert t.last_escalated is None and t.last_scan_escalated is None
    assert not t.last_certified.all()
    fns = t._inverted_fns(5, True, "inverted")
    s, _, b = fns.base(torch.from_numpy(q))
    kth, b = s[:, -1].numpy(), b.numpy()
    band = np.abs(kth - b) <= 2 * tinv.CERT_MARGIN * np.maximum(np.abs(kth), np.abs(b))
    _assert_flags_match(t, j, band)


def test_token_fast_path_async_handles_and_one_copy_per_window():
    vocab = 400
    toks, ws = _diffuse_corpus(2000, vocab, 24)
    q_tok, q_w = _corpus_queries(toks, 24, 5)
    kw = dict(postings_cap=16, query_terms=8, exact_escalate=True)
    j = _rows(JSparseIndex, "inverted", toks, ws, vocab, **kw)
    t = _rows(SparseIndex, "inverted", toks, ws, vocab, **kw)
    parts = [(q_tok[s:s + 8], q_w[s:s + 8], k) for s, k in ((0, 5), (8, 5), (16, 7))]
    sync = [t.search_tokens(a, b, k=k) for a, b, k in parts]
    handles = [t.search_tokens_async(a, b, k=k) for a, b, k in parts]
    assert all("parts" in h for h in handles)
    syncs = t.host_syncs
    many = t.resolve_hits_many(handles)
    # one copy for each packed width (k 5, k 7), then the ladder's
    assert many == sync and t.host_syncs - syncs <= 4
    jh = [j.search_tokens_async(a, b, k=k) for a, b, k in parts]
    for got, ref in zip(many, j.resolve_hits_many(jh)):
        _assert_hits_match(got, ref)
    _assert_flags_match(t, j)
    assert len(t.last_certified) == 24 and t.last_escalated.any()
    assert [t.resolve_hits(h) for h in handles] == sync
    assert t.resolve_hits_many([]) == [] and t.last_certified is None


def test_reopen_seeds_the_next_build_and_matches_a_fresh_index():
    vocab = 500
    toks, ws = _rich_corpus(300, vocab, 32)
    kw = dict(engine="inverted", l_max=32, block_docs=64, query_batch=4, postings_cap=64,
              query_terms=16, weight_dtype="float32", incremental_postings=True,
              incremental_unit=64)
    t = SparseIndex(vocab, IndexConfig(**kw), device="cpu")
    j = JSparseIndex(vocab, JIndexConfig(**kw))
    for ix in (t, j):
        ix.add_topk([str(i) for i in range(200)], toks[:200], ws[:200])
        ix.finalize()
        ix.reopen()
        assert ix._inc is not None and ix._inc_fed == 200  # seeded: delta only
    fed = []
    orig = tinv.build_postings

    def spy(tk, w, v, cap):
        fed.append(tk.shape[0])
        return orig(tk, w, v, cap)

    tinv.build_postings = spy
    try:
        t.add_topk([str(i) for i in range(200, 300)], toks[200:], ws[200:])
        t.finalize()
    finally:
        tinv.build_postings = orig
    assert sum(fed) == 100 and t.postings_source == "incremental"
    one = tinv.build_postings(toks, ws, vocab, 64)
    np.testing.assert_array_equal(t._post_docs.numpy(), one[0])
    np.testing.assert_array_equal(t._post_w.numpy(), one[1])
    j.add_topk([str(i) for i in range(200, 300)], toks[200:], ws[200:])
    j.finalize()
    q_tok, q_w = _corpus_queries(toks, 8, 6)
    _assert_hits_match(t.search_tokens(q_tok, q_w, k=10), j.search_tokens(q_tok, q_w, k=10))
    t.reopen()
    t.finalize()  # no new rows: the seed carries over as it is
    np.testing.assert_array_equal(t._post_docs.numpy(), one[0])


@pytest.mark.parametrize("unit", [64, 100000])
def test_incremental_build_during_ingest_equals_one_shot(unit):
    vocab = 500
    toks, ws = _rich_corpus(300, vocab, 32)
    cfg = IndexConfig(engine="inverted", l_max=32, block_docs=64, postings_cap=16,
                      postings_ext_cap=48, weight_dtype="float32", incremental_postings=True,
                      incremental_unit=unit)
    t = SparseIndex(vocab, cfg, device="cpu")
    for s in range(0, 300, 50):
        t.add_topk([str(i) for i in range(s, s + 50)], toks[s:s + 50], ws[s:s + 50])
    assert t._inc_fed == (256 if unit == 64 else 0)  # whole units only, until finalize
    t.finalize()
    assert t.postings_source == "incremental"
    base_d, base_w, ext_d, ext_w, dmap = tinv.split_postings(
        *tinv.build_postings(toks, ws, vocab, 64), 16)
    for got, want in ((t._post_docs, base_d), (t._post_w, base_w), (t._ext_docs, ext_d),
                      (t._ext_w, ext_w), (t._deep_map, dmap)):
        np.testing.assert_array_equal(got.numpy(), want)
    # on the CPU, None leaves the build one-shot; a postings thread's failure
    # comes back out of finalize, and delete() joins what is left
    t2 = SparseIndex(vocab, IndexConfig(engine="inverted", l_max=32), device="cpu")
    t2.add_topk(["a"], toks[:1], ws[:1])
    assert t2._inc is None
    def boom(*a):
        raise ValueError("boom")

    bad = SparseIndex(vocab, dataclasses.replace(cfg, incremental_unit=1), device="cpu")
    orig, tinv.build_postings = tinv.build_postings, boom
    try:
        bad.add_topk(["a", "b"], toks[:2], ws[:2])
        with pytest.raises(RuntimeError, match="build thread failed"):
            bad.finalize()
    finally:
        tinv.build_postings = orig
    bad.delete()
    assert bad._inc is None and bad.n_docs == 0


def test_padding_rows_never_escalate_and_zero_miss_certifies_few_matches():
    vocab = 400
    toks, ws = _diffuse_corpus(2000, vocab, 24)
    q_tok, q_w = _corpus_queries(toks, 6, 5)
    q_tok = np.concatenate([q_tok, np.zeros((2, 5), np.int32)])
    q_w = np.concatenate([q_w, np.zeros((2, 5), np.float32)])
    t = _rows(SparseIndex, "inverted", toks, ws, vocab, postings_cap=8, query_terms=8,
              exact_escalate=True)
    for hits in (t.search_tokens(q_tok, q_w, k=5),
                 t.search(_dense(q_tok, q_w, vocab), k=5, full_forward=False)):
        assert hits[6] == {} and hits[7] == {}
        assert t.last_certified.all() and t.last_escalated[:6].any()
        assert not t.last_escalated[6:].any()
    # a token of fewer than k docs: fewer than k matches, nothing missed
    vocab = 500
    toks, ws = _rich_corpus(300, vocab, 32)
    df = np.bincount(toks[ws > 0], minlength=vocab)
    rare = int(np.flatnonzero((df > 0) & (df < 5))[0])
    qt, qw = np.array([[rare]], np.int32), np.array([[3.0]], np.float32)
    j = _rows(JSparseIndex, "inverted", toks, ws, vocab, postings_cap=8, query_terms=8)
    t = _rows(SparseIndex, "inverted", toks, ws, vocab, postings_cap=8, query_terms=8)
    for ix in (t, j):
        assert len(ix.search_tokens(qt, qw, k=5)[0]) == df[rare] and ix.last_certified.all()
        assert len(ix.search(_dense(qt, qw, vocab), k=5)[0]) == df[rare]
        assert ix.last_certified.all()


def test_out_of_range_token_ids_answer_as_jax():
    """Slot ids outside [0, V) on the fast path (lookup as JAX gathers,
    nothing in the rescore) and on the dense path (dropped), with the exact
    scan escalation densifying them the JAX way."""
    vocab = 400
    toks, ws = _diffuse_corpus(2000, vocab, 24)
    q_tok, q_w = _corpus_queries(toks, 8, 5)
    q_tok[0, :2] = [-1, vocab + 4]
    q_tok[1, 0], q_tok[2, 1] = vocab, -vocab - 2
    for esc in (False, True):
        j = _rows(JSparseIndex, "inverted", toks, ws, vocab, postings_cap=8, query_terms=8,
                  exact_escalate=esc)
        t = _rows(SparseIndex, "inverted", toks, ws, vocab, postings_cap=8, query_terms=8,
                  exact_escalate=esc)
        _assert_hits_match(t.search_tokens(q_tok, q_w, k=5), j.search_tokens(q_tok, q_w, k=5))
        _assert_flags_match(t, j)
        wide = np.pad(q_tok, ((0, 0), (0, 12)))
        wide_w = np.pad(q_w, ((0, 0), (0, 12)))
        _assert_hits_match(t.search_tokens(wide, wide_w, k=5),
                           j.search_tokens(wide, wide_w, k=5))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_save_load_across_packages(tmp_path, direction):
    vocab = 400
    toks, ws = _diffuse_corpus(1000, vocab, 24)
    kw = dict(engine="auto", auto_threshold=500, l_max=24, block_docs=128, postings_cap=16,
              postings_ext_cap=48, deep_slots=3, tail_block_docs=128, refine_expand=4,
              query_terms=8)
    j = JSparseIndex(vocab, JIndexConfig(**kw))
    t = SparseIndex(vocab, IndexConfig(**kw), device="cpu")
    for ix in (j, t):
        ix.add_topk([str(i) for i in range(1000)], toks, ws)
        ix.finalize()
    src, load = ((j, lambda p: SparseIndex.load(p, device="cpu")) if direction == "jax_to_torch"
                 else (t, JSparseIndex.load))
    src.save(str(tmp_path / "ix"))
    meta = json.load(open(tmp_path / "ix" / "meta.json"))
    assert meta["engine"] == "inverted" and meta["exact_escalate"] is True
    loaded = load(str(tmp_path / "ix"))
    assert loaded._engine == "inverted" and loaded._exact_escalate
    assert asdict_cfg(loaded.cfg) == dict(asdict_cfg(src.cfg), engine="inverted",
                                          exact_escalate=True)
    q_tok, q_w = _corpus_queries(toks, 12, 5)
    _assert_hits_match(loaded.search_tokens(q_tok, q_w, k=5), src.search_tokens(q_tok, q_w, k=5))
    assert loaded.last_certified.all() and src.last_certified.all()


def asdict_cfg(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_what_stays_unported_names_its_roadmap_item():
    """Nothing of the inverted engine stays unported: its sharded layouts
    came with the device mesh (held to the JAX package's in
    tests/test_torch_sharded_index.py) and build here on a two-position CPU
    mesh, answering as the single-device engine."""
    from opensearch_sparse_model_tuning_sample_torch.core.mesh import make_mesh

    toks, ws = _diffuse_corpus(600, 300, l_max=16)
    q_tok, q_w = _corpus_queries(toks, n_q=6, width=4)
    kw = dict(postings_cap=600, query_terms=8)
    single = _rows(SparseIndex, "inverted", toks, ws, 300, **kw)
    want = single.search_tokens(q_tok, q_w, k=5)
    for shard_by in ("docs", "queries"):
        cfg = IndexConfig(engine="inverted", l_max=16, block_docs=256, query_batch=8,
                          weight_dtype="float32", shard_by=shard_by, **kw)
        t = SparseIndex(300, cfg, mesh=make_mesh(devices=["cpu"] * 2))
        t.doc_ids = [str(i) for i in range(600)]
        t._tok_chunks, t._w_chunks = [toks], [ws]
        t.finalize()
        _assert_hits_match(t.search_tokens(q_tok, q_w, k=5), want)


# ------------------------------------------------------------ eval, serve


@pytest.fixture(scope="module")
def ckpt(tiny_model, tmp_path_factory):
    """The tiny model with its MLM-head transform set to 4·I (lexical reps),
    as tests/test_torch_slice.py writes it."""
    bert = dict(tiny_model.params["bert"])
    head = dict(bert["mlm_head"])
    head["transform"] = dict(head["transform"],
                             kernel=jnp.eye(tiny_model.cfg.hidden_size) * 4.0)
    bert["mlm_head"] = head
    model = dataclasses.replace(tiny_model, params=dict(tiny_model.params, bert=bert))
    d = str(tmp_path_factory.mktemp("ckpt") / "checkpoint-tiny")
    jhf.save_checkpoint(model, d)
    return d


def test_eval_reports_the_certificate_tally(ckpt, tmp_path, monkeypatch):
    """cli.evaluate_beir on the inverted engine with escalation: the same
    metrics as the scan's, and certified_frac / escalated_frac in avg_res and
    beir_statistics.csv as the JAX package writes them."""
    monkeypatch.setenv("METRICS_DIR", str(tmp_path / "metrics"))

    def cfg(out, **kw):
        return {"model_name_or_path": ckpt, "idf_path": os.path.join(REPO, "assets", "idf.npz"),
                "inf_free": True, "beir_datasets": "synthetic", "eval_max_seq_length": 64,
                "per_device_eval_batch_size": 32, "index_l_max": 64, "compute_dtype": "float32",
                "dp_size": 1, "output_dir": str(tmp_path / out), **kw}

    inv = dict(index_engine="inverted", index_exact_escalate=True, index_postings_cap=8,
               index_query_batch=8)
    scan = tcli.main(cfg("scan", index_engine="sparse", device="cpu"))
    got = tcli.main(cfg("torch", device="cpu", **inv))
    ref = jcli.main(cfg("jax", **inv))
    for key in ("NDCG@10", "flops", "q_length", "d_length"):
        assert got[key] == pytest.approx(scan[key], rel=1e-6), key
    assert got["certified_frac"] == ref["certified_frac"] == 1.0
    assert 0.0 < got["escalated_frac"] == pytest.approx(ref["escalated_frac"], abs=0.05)
    assert "certified_frac" not in scan
    heads = []
    for side in ("torch", "jax", "scan"):
        with open(tmp_path / side / "beir_eval_64" / "beir_statistics.csv") as f:
            heads.append(f.readline().strip())
    assert heads[0] == heads[1] == heads[2]
    assert heads[0].endswith("qps,certified_frac,escalated_frac")


def test_served_inverted_index_carries_the_certificate(tmp_path):
    """cli.serve over a saved auto-resolved inverted index: token searches
    by HTTP (a burst, so they batch) answer as the in-process search and as
    the JAX package's index, each with ext.exactness.certified true."""
    model = tse.build_model(arch="tiny", idf_path=os.path.join(REPO, "assets", "idf.npz"),
                            device="cpu")
    V = model.vocab_size
    toks, ws = _diffuse_corpus(1200, 400, 16, seed=9)
    toks = toks + 2000  # real vocab strings, ids 2000-2399
    toks[ws <= 0] = 0
    t = SparseIndex(V, IndexConfig(engine="auto", auto_threshold=1000, l_max=16,
                                   postings_cap=2, query_terms=8), device="cpu")
    t.add_topk([f"d{i}" for i in range(1200)], toks, ws)
    t.finalize()
    t.save(str(tmp_path / "big"))
    q_tok, q_w = _corpus_queries(toks, 16, 4, seed=11)
    state = tserve.ServingState(model, {"big": SparseIndex.load(str(tmp_path / "big"),
                                                                 device="cpu")},
                                max_length=32, batch_window_ms=30.0, max_batch=16)
    httpd = tserve.serve(state, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    vocab = [model.tokenizer.convert_id_to_token(i) for i in range(V)]

    def ask(i):
        body = {"query": {"neural_sparse": {"text_sparse": {"query_tokens": {
            vocab[int(a)]: float(b) for a, b in zip(q_tok[i], q_w[i]) if b > 0}}}}, "size": 5}
        req = urllib.request.Request(base + "/big/_search", data=json.dumps(body).encode(),
                                     method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(16) as ex:
            resps = list(ex.map(ask, range(16)))
    finally:
        httpd.shutdown()
    ref = SparseIndex.load(str(tmp_path / "big"), device="cpu").search_tokens(q_tok, q_w, k=5)
    jref = JSparseIndex.load(str(tmp_path / "big")).search_tokens(q_tok, q_w, k=5)
    got = [{h["_id"]: h["_score"] for h in r["hits"]["hits"]} for r in resps]
    _assert_hits_match(got, ref)
    _assert_hits_match(got, jref)
    assert all(r["ext"]["exactness"]["certified"] is True for r in resps)
    assert any(r["ext"]["exactness"]["escalated"] for r in resps)
