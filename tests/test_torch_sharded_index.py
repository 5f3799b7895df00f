"""The port's SparseIndex on a device mesh inside one process, against the
JAX package's SparseIndex on tests/conftest.py's 8-device CPU mesh (the
port on `make_mesh(devices=["cpu"] * 8)`): the counterparts of JAX
`tests/test_index.py`'s mesh tests, held to JAX's own sharded answers.
Doc-sharded and query-sharded layouts of the scan, the dense oracle,
per-stripe two-phase, the inverted engine (base, full forward, tiered
extension), the certificate and the host escalation with their flags,
save/load across the packages and layouts, `merge_saved` onto a mesh,
`reopen`, the token entry and its async handles on a mesh, and the host
copies a call makes.

Tolerances: fp32 weights throughout. Scores within 1e-5 relative of the
other side's (fp32 sums of the same products in another order); ids equal
in order, except where two scores tie within that tolerance. Certificate
and escalation flags equal except on rows whose k-th score and bound lie
within 2 CERT_MARGIN of each other (there reordered sums may fall either
side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.index.engine import (
    IndexConfig as JIndexConfig,
    SparseIndex as JSparseIndex,
)
from opensearch_sparse_model_tuning_sample_torch.core.mesh import make_mesh
from opensearch_sparse_model_tuning_sample_torch.index import inverted as tinv
from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex
from opensearch_sparse_model_tuning_sample_torch.utils import tracing

torch.set_num_threads(2)

RTOL = 1e-5
V = 512
N_DOCS = 300
N_Q = 7


def make_sparse_reps(n, nnz=20, seed=0):
    """JAX tests/test_index.py's reps: nnz uniform weights per row."""
    r = np.random.default_rng(seed)
    reps = np.zeros((n, V), dtype=np.float32)
    for i in range(n):
        reps[i, r.choice(V, size=nnz, replace=False)] = r.uniform(0.1, 3.0, size=nnz)
    return reps


DOCS = make_sparse_reps(N_DOCS, seed=1)
QS = make_sparse_reps(N_Q, nnz=8, seed=2)
IDS = [str(i) for i in range(N_DOCS)]


def _diffuse_corpus(n_docs, vocab, l_max, seed=3):
    """JAX tests/test_index.py's corpus: Zipf-popular tokens, gamma weights,
    unique tokens per doc, impact-sorted (truncation misses docs here)."""
    r = np.random.default_rng(seed)
    pop = r.zipf(1.3, size=vocab).astype(np.float64)
    toks = np.searchsorted(np.cumsum(pop / pop.sum()), r.random((n_docs, l_max))).astype(np.int32)
    ws = r.gamma(2.0, 0.5, size=(n_docs, l_max)).astype(np.float32)
    key = (toks.astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - ws.view(np.uint32).astype(np.uint64))
    order = np.argsort(key, axis=1, kind="stable")
    toks, ws = np.take_along_axis(toks, order, 1), np.take_along_axis(ws, order, 1)
    rep = np.zeros_like(ws, dtype=bool)
    rep[:, 1:] = toks[:, 1:] == toks[:, :-1]
    ws = np.where(rep, 0.0, ws)
    toks = np.where(ws > 0, toks, 0)
    order = np.argsort(-ws, axis=1)
    return np.take_along_axis(toks, order, 1), np.take_along_axis(ws, order, 1)


def _corpus_queries(toks, n_q, width, seed=4):
    r = np.random.default_rng(seed)
    q_tok = np.zeros((n_q, width), np.int32)
    q_w = np.zeros((n_q, width), np.float32)
    for i in range(n_q):
        row = toks[r.integers(0, toks.shape[0])]
        row = row[row > 0]
        pick = r.choice(row, size=min(width, len(row)), replace=False)
        q_tok[i, :len(pick)] = pick
        q_w[i, :len(pick)] = r.uniform(2.0, 10.0, size=len(pick))
    return q_tok, q_w


@pytest.fixture(scope="module")
def cpu8():
    return make_mesh(devices=["cpu"] * 8)


def _pair(mesh8, cpu8, sharded=True, **kw):
    """(JAX index, port index) over DOCS with add(), config as JAX's
    tests/test_index.py `build` (l_max 32, block_docs 64, query_batch 4)."""
    kw = dict(dict(l_max=32, block_docs=64, query_batch=4, weight_dtype="float32"), **kw)
    j = JSparseIndex(V, JIndexConfig(**kw), mesh8 if sharded else None)
    t = (SparseIndex(V, IndexConfig(**kw), mesh=cpu8) if sharded
         else SparseIndex(V, IndexConfig(**kw), device="cpu"))
    for ix in (j, t):
        for s in range(0, N_DOCS, 100):
            ix.add(IDS[s:s + 100], DOCS[s:s + 100])
        ix.finalize()
    return j, t


def _rows(cls, toks, ws, vocab, mesh=None, **kw):
    """An index holding the rows as they are (no add()), as the JAX tests
    build theirs."""
    cfg_kw = dict(dict(l_max=toks.shape[1], block_docs=256, query_batch=8,
                       weight_dtype="float32"), **kw)
    if cls is JSparseIndex:
        ix = JSparseIndex(vocab, JIndexConfig(**cfg_kw), mesh)
    elif mesh is not None:
        ix = SparseIndex(vocab, IndexConfig(**cfg_kw), mesh=mesh)
    else:
        ix = SparseIndex(vocab, IndexConfig(**cfg_kw), device="cpu")
    ix.doc_ids = [str(i) for i in range(toks.shape[0])]
    ix._tok_chunks, ix._w_chunks = [toks], [ws]
    ix.finalize()
    return ix


def _same(got, want):
    """Per-query {doc: score} maps: the same length, scores within RTOL in
    order, ids equal in order except across a tie within RTOL."""
    assert len(got) == len(want)
    for qi, (g, w) in enumerate(zip(got, want)):
        gl, wl = list(g.items()), list(w.items())
        assert len(gl) == len(wl), (qi, g, w)
        for (gi, gs), (wi, ws) in zip(gl, wl):
            assert abs(gs - ws) <= RTOL * abs(ws), (qi, g, w)
            assert gi == wi or abs(w.get(gi, np.inf) - ws) <= RTOL * abs(ws), (qi, g, w)


def _flag(x, n):
    """A flag vector, None read as all False (JAX leaves last_escalated None
    where no row needed escalation)."""
    return np.zeros(n, bool) if x is None else np.asarray(x, bool)


def _same_bound(j, t, q_tok, q_w, vocab, k, truncated=True):
    """The base pass's missed-score bound of the port's mesh index equals
    JAX's (on a doc-sharded mesh: the max of the stripes' bounds). Without
    truncation every bound is -inf (nothing was missed)."""
    q = _dense(q_tok, q_w, vocab)
    _, _, jb, _ = j._run_queries(jnp.asarray(q), k, False, None)
    _, _, tb = t._inverted_fns(k, False, "inverted").base(torch.from_numpy(q))
    assert np.isfinite(jb).any() == truncated
    np.testing.assert_allclose(tb.numpy(), jb, rtol=RTOL)


def _borderline(t, q, k, engine="inverted"):
    """Rows whose base k-th score and bound lie within 2 CERT_MARGIN."""
    s, _, b = t._inverted_fns(k, False, engine).base(q)
    kth, b = s[:, -1].numpy(), b.numpy()
    with np.errstate(invalid="ignore"):
        return np.abs(kth - b) <= 2 * tinv.CERT_MARGIN * np.maximum(np.abs(kth), np.abs(b))


# ------------------------------------------------------- scan and oracle


@pytest.mark.parametrize("engine", ["sparse", "dense"])
def test_sharded_matches_single_device(mesh8, cpu8, engine):
    """Doc-sharded: eight stripes, their top-k merged. Equal to JAX's
    doc-sharded index and to the port's single-device one."""
    j, t = _pair(mesh8, cpu8, engine=engine)
    assert t._stripes is not None and len(t._stripes) == 8 and not t._shard_queries
    assert [st.offset for st in t._stripes] == [s * 64 for s in range(8)]  # n_pad 512
    got = t.search(QS, k=10)
    _same(got, j.search(QS, k=10))
    _, single = _pair(mesh8, cpu8, sharded=False, engine=engine)
    _same(got, single.search(QS, k=10))


@pytest.mark.parametrize("mode", ["doc", "query"])
def test_two_phase_sharded(mesh8, cpu8, mode):
    """Per-stripe two-phase: phase 1's pool and phase 2's rescore inside
    each stripe, the merge after. Equal to JAX's sharded answers (not the
    unsharded two-phase's), and to the composition of eight unsharded
    two-phase indexes of the stripes."""
    kw = dict(engine="sparse", two_phase_mode=mode, two_phase_terms=16, two_phase_expand=8)
    j, t = _pair(mesh8, cpu8, **kw)
    got = t.search(QS, k=5, two_phase=True)
    _same(got, j.search(QS, k=5, two_phase=True))
    parts = []
    for st in t._stripes:
        n = min(max(N_DOCS - st.offset, 0), 64)
        part = SparseIndex(V, IndexConfig(l_max=32, block_docs=64, query_batch=4,
                                          weight_dtype="float32", **kw), device="cpu")
        if n:
            part.add([str(st.offset + i) for i in range(n)], DOCS[st.offset:st.offset + n])
            part.finalize()
            parts.append(part)
    want = []
    for qi in range(N_Q):
        pool = {}
        for p in parts:
            pool.update(p.search(QS[qi:qi + 1], k=5, two_phase=True)[0])
        want.append(dict(sorted(pool.items(), key=lambda kv: (-kv[1], int(kv[0])))[:5]))
    _same(got, want)


def test_query_sharded_scan_matches_single_device(mesh8, cpu8):
    """shard_by=queries on the scan and the dense oracle (JAX
    test_query_sharded_matches_single_device's scan cases)."""
    for engine in ("sparse", "dense"):
        j, t = _pair(mesh8, cpu8, engine=engine, shard_by="queries")
        assert t._shard_queries and all(st.offset == 0 for st in t._stripes)
        assert t._query_batch % 8 == 0 and t.cfg.query_batch == 4
        got = t.search(QS, k=10)
        _same(got, j.search(QS, k=10))
        _, single = _pair(mesh8, cpu8, sharded=False, engine=engine)
        _same(got, single.search(QS, k=10))


def test_finalize_does_not_mutate_callers_config(cpu8):
    cfg = IndexConfig(engine="sparse", l_max=8, block_docs=32, query_batch=3,
                      shard_by="queries")
    idx = SparseIndex(V, cfg, mesh=cpu8)
    idx.add(IDS, DOCS)
    idx.finalize()
    assert cfg.query_batch == 3  # the caller's object untouched
    assert idx._query_batch % 8 == 0  # the resolved width on the index
    assert len(idx.search(QS, k=5)) == N_Q


# ------------------------------------------------------ inverted engine

INV = dict(engine="inverted", block_docs=16, postings_cap=N_DOCS, query_terms=16)
FULL = dict(engine="inverted", postings_cap=N_DOCS, query_terms=4, full_query_terms=64,
            full_postings_cols=N_DOCS, full_rescore_expand=16)
WIDE_Q = make_sparse_reps(N_Q, nnz=64, seed=3)


@pytest.mark.parametrize("shard_by", ["docs", "queries"])
def test_inverted_sharded_matches_single_device(mesh8, cpu8, shard_by):
    j, t = _pair(mesh8, cpu8, shard_by=shard_by, **INV)
    if shard_by == "docs":
        # per-stripe postings over local ids, built at finalize
        assert t.postings_source == "per-stripe" and t._post_docs is None
        for st in t._stripes:
            ids = st.post_docs[st.post_docs != tinv._PAD_ID]
            assert ids.numel() == 0 or int(ids.max()) < st.docs.shape[0]
        assert t._stripes[-1].post_docs.eq(tinv._PAD_ID).all()  # 384 rows: the last stripe is padding
    got = t.search(QS, k=10)
    _same(got, j.search(QS, k=10))
    _, single = _pair(mesh8, cpu8, sharded=False, **INV)
    _same(got, single.search(QS, k=10))
    np.testing.assert_array_equal(t.last_certified, j.last_certified)


@pytest.mark.parametrize("shard_by", ["docs", "queries"])
def test_inverted_full_forward_sharded_matches_single(mesh8, cpu8, shard_by):
    """Full forward (queries wider than query_terms) on both layouts."""
    j, t = _pair(mesh8, cpu8, shard_by=shard_by, **FULL)
    got = t.search(WIDE_Q, k=10)
    _same(got, j.search(WIDE_Q, k=10))
    _, single = _pair(mesh8, cpu8, sharded=False, **FULL)
    _same(got, single.search(WIDE_Q, k=10))


def test_certificate_on_doc_sharded_mesh(mesh8, cpu8):
    """The global bound is the max of the stripes' bounds: the flags equal
    JAX's, and certified rows equal the exact scan's."""
    vocab = 700
    toks, ws = _diffuse_corpus(512, vocab, l_max=24, seed=7)
    q_tok, q_w = _corpus_queries(toks, n_q=8, width=5, seed=8)
    kw = dict(engine="inverted", block_docs=32, postings_cap=512, query_terms=8)
    j = _rows(JSparseIndex, toks, ws, vocab, mesh8, **kw)
    t = _rows(SparseIndex, toks, ws, vocab, cpu8, **kw)
    got = t.search_tokens(q_tok, q_w, k=5)
    _same(got, j.search_tokens(q_tok, q_w, k=5))
    band = _borderline(t, t._token_query(q_tok, q_w), 5)
    np.testing.assert_array_equal(t.last_certified[~band], j.last_certified[~band])
    assert t.last_certified.sum() >= 6
    _same_bound(j, t, q_tok, q_w, vocab, 5, truncated=False)
    scan = _rows(SparseIndex, toks, ws, vocab, engine="sparse").search_tokens(q_tok, q_w, k=5)
    _same([got[i] for i in np.flatnonzero(t.last_certified)],
          [scan[i] for i in np.flatnonzero(t.last_certified)])


@pytest.mark.parametrize("shard_by", ["docs", "queries"])
def test_escalation_on_sharded_mesh_matches_scan(mesh8, cpu8, shard_by):
    """exact_escalate on a mesh: the host pass re-runs the uncertified rows
    on the mesh's exact scan (no deep tier): every row certified, the
    escalated rows JAX's, last_scan_escalated the same rows, the results
    the exact scan's; one packed copy per call plus one per escalation
    (and one for the width check of the dense entry)."""
    vocab = 400
    toks, ws = _diffuse_corpus(2048, vocab, l_max=24)
    q_tok, q_w = _corpus_queries(toks, n_q=16, width=5)
    # JAX's corpus with its rows rolled by three stripes: the first 256 rows
    # give the largest stripe bound of most queries, and here they land in
    # stripe 3, so a global bound that is not the stripes' max shows
    toks, ws = np.roll(toks, 768, axis=0), np.roll(ws, 768, axis=0)
    kw = dict(engine="inverted", block_docs=32, query_batch=16 if shard_by == "queries" else 8,
              postings_cap=2, query_terms=8, exact_escalate=True, shard_by=shard_by)
    j = _rows(JSparseIndex, toks, ws, vocab, mesh8, **kw)
    t = _rows(SparseIndex, toks, ws, vocab, cpu8, **kw)
    syncs = t.host_syncs
    got = t.search_tokens(q_tok, q_w, k=5)
    assert t.host_syncs - syncs == 2  # the packed fetch, and the escalated rows' scan
    want = j.search_tokens(q_tok, q_w, k=5)
    _same(got, want)
    scan = _rows(SparseIndex, toks, ws, vocab, engine="sparse").search_tokens(q_tok, q_w, k=5)
    _same(got, scan)
    assert t.last_certified.all() and j.last_certified.all()
    _same_bound(j, t, q_tok, q_w, vocab, 5)  # cap 2: the stripes' bounds differ
    band = _borderline(t, t._token_query(q_tok, q_w), 5)
    esc = _flag(t.last_escalated, 16)
    assert esc.any()
    np.testing.assert_array_equal(esc[~band], _flag(j.last_escalated, 16)[~band])
    np.testing.assert_array_equal(t.last_scan_escalated, esc)  # no deep tier on a mesh


@pytest.mark.parametrize("shard_by", ["docs", "queries"])
def test_tiered_ext_sharded_matches_single(mesh8, cpu8, shard_by):
    """The extension arrays on the mesh layouts: split per stripe and padded
    to the largest stripe's deep-row count (each stripe its own deep map),
    or replicated. Equal to JAX's sharded answers; query-sharded also to the
    single-device tiered engine."""
    vocab = 400
    toks, ws = _diffuse_corpus(1024, vocab, l_max=24)
    q_tok, q_w = _corpus_queries(toks, n_q=16, width=5)
    kw = dict(engine="inverted", block_docs=64, query_batch=16, postings_cap=32,
              postings_ext_cap=256, deep_slots=2, query_terms=8, exact_escalate=False,
              shard_by=shard_by)
    j = _rows(JSparseIndex, toks, ws, vocab, mesh8, **kw)
    t = _rows(SparseIndex, toks, ws, vocab, cpu8, **kw)
    exts = [st.ext for st in t._stripes]
    assert all(e is not None for e in exts)
    assert len({e[0].shape for e in exts}) == 1  # padded to one deep-row count
    got = t.search_tokens(q_tok, q_w, k=5)
    _same(got, j.search_tokens(q_tok, q_w, k=5))
    if shard_by == "queries":
        single = _rows(SparseIndex, toks, ws, vocab, **dict(kw, shard_by="docs"))
        _same(got, single.search_tokens(q_tok, q_w, k=5))


# ---------------------------------------- persistence and the index's life


def test_load_with_mesh_inverted_matches_single(mesh8, cpu8, tmp_path):
    """load(path, mesh) routes through finalize: per-stripe postings."""
    _, single = _pair(mesh8, cpu8, sharded=False, **INV)
    p = str(tmp_path / "inv_idx")
    single.save(p)
    want = single.search(QS, k=10)
    loaded = SparseIndex.load(p, mesh=cpu8)
    assert loaded._stripes is not None and loaded.postings_source == "per-stripe"
    _same(loaded.search(QS, k=10), want)
    _same(loaded.search(QS, k=10), JSparseIndex.load(p, mesh=mesh8).search(QS, k=10))


@pytest.mark.parametrize("shard_by", ["docs", "queries"])
def test_query_sharded_save_load_roundtrip(mesh8, cpu8, tmp_path, shard_by):
    """A mesh index saves global rows in format 2: it loads with or without
    a mesh, in either package; JAX's mesh index loads onto the port's mesh."""
    j, t = _pair(mesh8, cpu8, engine="sparse", shard_by=shard_by)
    want = t.search(QS, k=5)
    pt, pj = str(tmp_path / "t"), str(tmp_path / "j")
    t.save(pt)
    j.save(pj)
    _same(SparseIndex.load(pt, device="cpu").search(QS, k=5), want)
    _same(JSparseIndex.load(pt).search(QS, k=5), want)
    _same(SparseIndex.load(pj, mesh=cpu8).search(QS, k=5), want)


def test_merge_saved_onto_a_mesh(mesh8, cpu8, tmp_path):
    """merge_saved(paths, mesh): the shards' rows concatenated and finalized
    on the mesh, equal to the merged single-device index and to JAX's
    merge onto mesh8."""
    paths = []
    for r, sl in enumerate((slice(0, 120), slice(120, N_DOCS))):
        ix = SparseIndex(V, IndexConfig(l_max=32, block_docs=16, query_batch=4,
                                        weight_dtype="float32", **{
                                            k: v for k, v in INV.items() if k != "block_docs"}),
                         device="cpu")
        ix.add(IDS[sl], DOCS[sl])
        ix.finalize()
        paths.append(str(tmp_path / f"shard{r}"))
        ix.save(paths[-1])
    merged = SparseIndex.merge_saved(paths, mesh=cpu8)
    assert merged.mesh is cpu8 and merged._stripes is not None and merged.doc_ids == IDS
    got = merged.search(QS, k=10)
    _same(got, SparseIndex.merge_saved(paths, device="cpu").search(QS, k=10))
    _same(got, JSparseIndex.merge_saved(paths, mesh=mesh8).search(QS, k=10))


@pytest.mark.parametrize("shard_by", ["docs", "queries"])
def test_reopen_on_a_mesh_gathers_the_rows_back(cpu8, shard_by):
    """reopen gathers the stripes back in order; more rows and a second
    finalize equal one build of all of them. Only the query-sharded layout
    (a single layout) seeds the next postings build."""
    kw = dict(INV, l_max=32, query_batch=4, weight_dtype="float32", shard_by=shard_by,
              incremental_postings=True)
    t = SparseIndex(V, IndexConfig(**kw), mesh=cpu8)
    t.add(IDS[:200], DOCS[:200])
    t.finalize()
    assert t.postings_source == ("incremental" if shard_by == "queries" else "per-stripe")
    t.reopen()
    assert (t._inc is not None) == (shard_by == "queries")
    t.add(IDS[200:], DOCS[200:])
    t.finalize()
    whole = SparseIndex(V, IndexConfig(**kw), mesh=cpu8)
    whole.add(IDS, DOCS)
    whole.finalize()
    _same(t.search(QS, k=10), whole.search(QS, k=10))


def test_token_entry_and_handles_on_a_mesh(cpu8):
    """No token fast path on a mesh: search_tokens densifies and takes the
    mesh path; the async handle degrades to a synchronous search."""
    vocab = 400
    toks, ws = _diffuse_corpus(1024, vocab, l_max=24)
    q_tok, q_w = _corpus_queries(toks, n_q=8, width=5)
    kw = dict(engine="inverted", block_docs=64, postings_cap=64, query_terms=8,
              exact_escalate=True)
    t = _rows(SparseIndex, toks, ws, vocab, cpu8, **kw)
    assert not t._tokens_fast_eligible(q_tok, q_w, {})
    dense = t.search(torch.from_numpy(_dense(q_tok, q_w, vocab)), k=5)
    got = t.search_tokens(q_tok, q_w, k=5)
    _same(got, dense)
    h = t.search_tokens_async(q_tok, q_w, k=5)
    assert "sync_results" in h
    _same(t.resolve_hits(h), got)
    _same(t.resolve_hits_many([h, t.search_tokens_async(q_tok, q_w, k=5)])[1], got)
    assert t.last_certified.all() and len(t.last_certified) == 16


def _dense(q_tok, q_w, vocab):
    q = np.zeros((q_tok.shape[0], vocab), np.float32)
    for i in range(q_tok.shape[0]):
        np.add.at(q[i], q_tok[i][q_w[i] > 0], q_w[i][q_w[i] > 0])
    return q


def test_mesh_device_rules(cpu8):
    """The index lives on the mesh's first device; a mesh of one position
    is the single-device index; the merge runs through merged_topk."""
    idx = SparseIndex(V, IndexConfig(engine="sparse"), mesh=cpu8, device="cpu")
    assert idx.device == torch.device("cpu")
    one = SparseIndex(V, IndexConfig(engine="sparse", l_max=32, block_docs=64,
                                     weight_dtype="float32"), mesh=make_mesh(devices=["cpu"]))
    one.add(IDS, DOCS)
    one.finalize()
    assert one._stripes is None and one._docs_dev is not None
    calls = tracing.counters().get("collectives.merged_topk", 0)
    sharded = SparseIndex(V, IndexConfig(engine="sparse", l_max=32, block_docs=64,
                                         query_batch=4, weight_dtype="float32"), mesh=cpu8)
    sharded.add(IDS, DOCS)
    sharded.finalize()
    _same(sharded.search(QS, k=10), one.search(QS, k=10))
    # one merge per 4-query batch
    assert tracing.counters()["collectives.merged_topk"] - calls == 2
