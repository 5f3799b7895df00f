"""The port's `index/inverted.py` against the JAX package's on the same numpy
inputs: the host side (postings through the native library, through numpy
and through the JAX package, bit for bit; merge; the incremental build;
split; block maxima; the certificate rule; packed rows) and
`make_search_fn` over a set of option combinations at a small size
(V 1 024, N 2 048, L 32, C 64-256, T 8, k 10).

Tolerances: postings, block maxima and packed rows bit-equal; scores and
bounds within 1e-5 relative (fp32 sums of the same products in another
order); ids equal except where two docs' scores tie within that.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from opensearch_sparse_model_tuning_sample_tpu.index import inverted as jinv
from opensearch_sparse_model_tuning_sample_torch.index import inverted as tinv
from opensearch_sparse_model_tuning_sample_torch.utils import tracing

torch.set_num_threads(2)

V, N, L, T, K = 1024, 2048, 32, 8, 10
RTOL = 1e-5


def _corpus(n=N, vocab=V, l_max=L, seed=3):
    """Zipf-popular tokens (rank^-0.8), gamma weights, unique tokens per
    doc, rows impact-sorted and zero-padded, as an encoder's top-l_max."""
    r = np.random.default_rng(seed)
    pop = np.arange(1, vocab + 1, dtype=np.float64) ** -0.8
    r.shuffle(pop)
    toks = np.searchsorted(np.cumsum(pop / pop.sum()), r.random((n, l_max))).astype(np.int32)
    toks = np.minimum(toks, vocab - 1)
    ws = r.gamma(2.0, 0.5, size=(n, l_max)).astype(np.float32)
    toks.sort(axis=1)
    dup = np.zeros_like(toks, dtype=bool)
    dup[:, 1:] = toks[:, 1:] == toks[:, :-1]
    ws[dup] = 0.0
    order = np.argsort(-ws, axis=1, kind="stable")
    toks, ws = np.take_along_axis(toks, order, 1), np.take_along_axis(ws, order, 1)
    toks[ws <= 0] = 0
    ws[7] = 0.0  # an empty doc
    toks[7] = 0
    return toks, ws


TOKS, WS = _corpus()


def _queries(n=12, width=6, seed=4, wide=0):
    """Dense [n, V] queries of `width` terms drawn from corpus rows (so they
    match), the last row all zero; `wide` rows get 40 terms instead."""
    r = np.random.default_rng(seed)
    q = np.zeros((n, V), np.float32)
    for i in range(n - 1):
        row = TOKS[r.integers(0, N)]
        row = np.unique(row[row > 0])
        w = 40 if i < wide else width
        pick = r.choice(row, size=min(w, row.size), replace=False)
        if i < wide:
            pick = np.unique(np.concatenate([pick, r.choice(V, size=40, replace=False)]))
        q[i, pick] = r.uniform(0.5, 4.0, size=pick.size)
    return q


def _slots(q, width=T):
    tok = np.zeros((q.shape[0], width), np.int32)
    w = np.zeros((q.shape[0], width), np.float32)
    for i, row in enumerate(q):
        nz = np.flatnonzero(row)[:width]
        tok[i, :nz.size], w[i, :nz.size] = nz, row[nz]
    return tok, w


# ------------------------------------------------------------- host side


@pytest.fixture(params=["native", "numpy"])
def build_path(request, monkeypatch):
    """The port's build through the native library, or forced onto its
    numpy fallback."""
    if request.param == "numpy":
        monkeypatch.setattr(tinv, "_load_native", lambda: False)
    else:
        assert tinv._load_native(), "native/postings.cpp did not build"
    return request.param


@pytest.mark.parametrize("cap", [64, 256])
def test_build_postings_is_bit_equal_to_the_jax_build(build_path, cap):
    key = "postings.build." + build_path
    before = tracing.counters().get(key, 0)
    pd, pw = tinv.build_postings(TOKS, WS, V, cap)
    assert tracing.counters()[key] == before + 1
    jd, jw = jinv.build_postings(TOKS, WS, V, cap)
    nd, nw = jinv._build_postings_np(TOKS, WS, V, cap)
    for d, w in ((jd, jw), (nd, nw)):
        np.testing.assert_array_equal(pd, d)
        np.testing.assert_array_equal(pw.view(np.int32), w.view(np.int32))
    assert (pd[pw <= 0] == tinv._PAD_ID).all()


@pytest.mark.parametrize("bad", [-1, V, V + 7])
def test_build_postings_rejects_out_of_range_ids(build_path, bad):
    toks = TOKS[:20].copy()
    toks[3, 0] = bad
    with pytest.raises((ValueError, IndexError)):
        tinv.build_postings(toks, WS[:20], V, 16)
    with pytest.raises((ValueError, IndexError)):
        jinv.build_postings(toks, WS[:20], V, 16)


@pytest.mark.parametrize("offset", [0, 1000])
def test_merge_postings_matches_jax(build_path, offset):
    a = tinv.build_postings(TOKS[:1000], WS[:1000], V, 64)
    b = tinv.build_postings(TOKS[1000:], WS[1000:], V, 64)
    got = tinv.merge_postings(*a, *b, b_doc_offset=offset)
    want = jinv.merge_postings(*a, *b, b_doc_offset=offset)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    if offset == 1000:
        # the chunked build's posting set is the one-shot build's (no
        # tied weights at the cap boundary in this corpus)
        one = tinv.build_postings(TOKS, WS, V, 64)
        np.testing.assert_array_equal(got[1], one[1])
        np.testing.assert_array_equal(got[0], one[0])


def test_incremental_build_equals_one_shot_and_resumes_from_a_seed():
    inc = tinv.IncrementalPostingsBuilder(V, 128, unit=300)
    for s in range(0, N, 300):
        inc.feed(TOKS[s:s + 300].copy(), WS[s:s + 300].copy(), s)
    assert inc.fed_docs == N
    pd, pw = inc.finish()
    one = tinv.build_postings(TOKS, WS, V, 128)
    np.testing.assert_array_equal(pd, one[0])
    np.testing.assert_array_equal(pw, one[1])
    # resume: seeded with the first 1 500 rows' postings, fed the rest
    seed = tinv.build_postings(TOKS[:1500], WS[:1500], V, 128)
    inc = tinv.IncrementalPostingsBuilder(V, 128, seed=seed)
    inc.feed(TOKS[1500:].copy(), WS[1500:].copy(), 1500)
    pd, pw = inc.finish()
    np.testing.assert_array_equal(pd, one[0])
    np.testing.assert_array_equal(pw, one[1])
    empty = tinv.IncrementalPostingsBuilder(V, 8).finish()
    assert (empty[0] == tinv._PAD_ID).all() and not empty[1].any()


def test_native_build_is_a_function_of_its_rows_when_weights_tie():
    """Weights on a coarse grid tie by the hundreds: two native builds of
    the same rows, and an incremental build of one chunk, are bit-equal,
    and the kept weights equal the numpy build's (ties may order their docs
    differently there)."""
    ws = np.round(WS * 4) / 4
    toks = np.where(ws > 0, TOKS, 0)
    a = tinv.build_postings(toks, ws, V, 64)
    b = tinv.build_postings(toks, ws, V, 64)
    inc = tinv.IncrementalPostingsBuilder(V, 64)
    inc.feed(toks.copy(), ws.copy(), 0)
    c = inc.finish()
    for x in (b, c):
        np.testing.assert_array_equal(x[0], a[0])
        np.testing.assert_array_equal(x[1], a[1])
    np.testing.assert_array_equal(a[1], jinv._build_postings_np(toks, ws, V, 64)[1])


def test_incremental_build_error_comes_back_out():
    inc = tinv.IncrementalPostingsBuilder(V, 16)
    bad = TOKS[:10].copy()
    bad[0, 0] = V + 1
    inc.feed(bad, WS[:10].copy(), 0)
    with pytest.raises(RuntimeError, match="build thread failed") as e:
        inc.finish()
    assert isinstance(e.value.__cause__, ValueError)
    assert not inc._thread.is_alive()


def test_split_postings_matches_jax():
    pd, pw = tinv.build_postings(TOKS, WS, V, 192)
    got = tinv.split_postings(pd, pw, 64)
    want = jinv.split_postings(pd, pw, 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].shape[0] == int((pw[:, 64] > 0).sum()) + 1
    with pytest.raises(ValueError):
        tinv.split_postings(pd, pw, 192)


def test_tail_blockmax_matches_jax():
    got = tinv.build_tail_blockmax_multi(TOKS, WS, V, (64, 16), 2048, 256)
    want = jinv.build_tail_blockmax_multi(TOKS, WS, V, (64, 16), 2048, 256)
    for (gb, gm), (wb, wm) in zip(got, want):
        assert gb.dtype == np.float32
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gm, wm)
    one = tinv.build_tail_blockmax(TOKS, WS, V, 64, 2048, 256)
    np.testing.assert_array_equal(one[0], got[0][0])


def test_certified_mask_one_rule_for_torch_numpy_and_jax():
    inf = np.inf
    kth = np.array([1.0, 1.0, 1.0, 1.0001, -inf, -inf, 5.0, 0.0, 2.0, inf], np.float32)
    bound = np.array([0.5, 1.0, 0.99995, 1.0, -inf, inf, -inf, 0.0, inf, 1.0], np.float32)
    want = np.asarray(jinv.certified_mask(jnp.asarray(kth), jnp.asarray(bound)))
    np.testing.assert_array_equal(tinv.certified_mask(kth, bound), want)
    np.testing.assert_array_equal(
        tinv.certified_mask(torch.from_numpy(kth), torch.from_numpy(bound)).numpy(), want)
    np.testing.assert_array_equal(jinv.certified_mask(kth, bound, xp=np), want)
    assert tinv.CERT_MARGIN == jinv.CERT_MARGIN


def test_pack_doc_rows_matches_jax_and_rejects_what_it_cannot_pack():
    np.testing.assert_array_equal(tinv.pack_doc_rows(TOKS, WS), jinv.pack_doc_rows(TOKS, WS))
    for bad in (2**15, -1):
        toks = TOKS[:4].copy()
        toks[0, 0] = bad
        with pytest.raises(ValueError, match="2\\*\\*15"):
            tinv.pack_doc_rows(toks, WS[:4])


# ---------------------------------------------------------- make_search_fn


def _assert_search_close(got, want):
    """(scores, ids[, bound]) of the port against the JAX function's."""
    ts, ti = (np.asarray(x) for x in got[:2])
    js, ji = (np.asarray(x) for x in want[:2])
    np.testing.assert_allclose(ts, js, rtol=RTOL)
    for r in range(js.shape[0]):
        for p in np.flatnonzero(ti[r] != ji[r]):
            # a swap only between docs whose scores tie within RTOL
            assert ti[r, p] in ji[r], (r, p)
            q = int(np.flatnonzero(ji[r] == ti[r, p])[0])
            assert abs(js[r, q] - ts[r, p]) <= RTOL * abs(js[r, q]), (r, p)
    if len(want) > 2:
        np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]), rtol=RTOL)


def _inputs(cap, full_cap=None, packed=False, wdt="float32"):
    pd, pw = tinv.build_postings(TOKS, WS, V, full_cap or cap)
    ext = None
    if full_cap:
        pd, pw, ed, ew, dm = tinv.split_postings(pd, pw, cap)
        ext = (ed, ew, dm)
    toks = tinv.pack_doc_rows(TOKS, WS) if packed else TOKS.astype(np.int16)
    return pd, pw, toks, WS, ext


CASES = {
    "dense_gather": dict(),
    "match_rescore": dict(match_rescore=True),
    "token_entry": dict(token_entry=True),
    "no_rescore": dict(rescore=False),
    "no_rescore_no_bound": dict(rescore=False, with_bound=False),
    "no_bound": dict(with_bound=False),
    "full_forward": dict(select_by_impact=True, postings_cols=32, query_terms=16, wide=4),
    "phase1": dict(phase1_ratio=0.4),
    "deep_slots": dict(deep_slots=2, ext_cap=192, match_rescore=True),
    "deep_full": dict(deep_slots=4, ext_cap=192, select_by_impact=True, postings_cols=16,
                      query_terms=16, wide=4),
    "deep_tokens": dict(deep_slots=T, ext_cap=192, token_entry=True, rescore_expand=16),
    "blockmax": dict(tail_blockmax=True, match_rescore=True, cap=32),
    "blockmax_deep": dict(tail_blockmax=True, deep_slots=2, ext_cap=192, token_entry=True,
                          cap=32),
    "refine": dict(refine_expand=8, rescore_expand=1, cap=32),
    "merge_shifts": dict(merge_shifts=2),
    "packed_sorted": dict(packed_docs=True, sort_candidates=True, wdt="bfloat16"),
    "packed_tokens": dict(packed_docs=True, token_entry=True, wdt="bfloat16"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_make_search_fn_matches_jax(case):
    opts = dict(CASES[case])
    cap = opts.pop("cap", 64)
    ext_cap = opts.pop("ext_cap", None)
    wide = opts.pop("wide", 0)
    wdt = opts.pop("wdt", "float32")
    opts.setdefault("with_bound", True)
    opts.setdefault("query_terms", T)
    opts.setdefault("rescore_expand", 4)
    q = _queries(wide=wide)
    pd, pw, toks, ws, ext = _inputs(cap, ext_cap, opts.get("packed_docs", False), wdt)
    bmx = None
    if opts.get("tail_blockmax"):
        bmx = tinv.build_tail_blockmax(TOKS, WS, V, cap, N, 256)
    if opts.get("token_entry"):
        qv = _slots(q, opts["query_terms"])
        jq, tq = tuple(jnp.asarray(a) for a in qv), tuple(torch.from_numpy(a) for a in qv)
    else:
        jq, tq = jnp.asarray(q), torch.from_numpy(q)
    jw = jnp.asarray(pw, dtype=jnp.dtype(wdt))
    tw = torch.from_numpy(pw).to(getattr(torch, wdt))
    # the JAX function cannot build rescore without the bound (it reads the
    # bound's terms unset: UnboundLocalError); its scores and ids come
    # from the bound's build there
    jopts = dict(opts, with_bound=True) if case == "no_bound" else opts
    jfn = jinv.make_search_fn(jnp.asarray(pd), jw, None, None, k=K, **jopts)
    tfn = tinv.make_search_fn(torch.from_numpy(pd), tw, None, None, k=K, **opts)
    jext = text = jb = tb = None
    if ext is not None:
        jext = (jnp.asarray(ext[0]), jnp.asarray(ext[1], dtype=jnp.dtype(wdt)), jnp.asarray(ext[2]))
        text = (torch.from_numpy(ext[0]), torch.from_numpy(ext[1]).to(getattr(torch, wdt)),
                torch.from_numpy(ext[2]))
    if bmx is not None:
        jb = tuple(jnp.asarray(a) for a in bmx)
        tb = tuple(torch.from_numpy(a) for a in bmx)
    want = jfn(jq, jnp.asarray(pd), jw, jnp.asarray(toks), jnp.asarray(ws), jext, jb)
    got = tfn(tq, torch.from_numpy(pd), tw, torch.from_numpy(toks), torch.from_numpy(ws),
              text, tb)
    _assert_search_close(got, want[:len(got)])
    s = np.asarray(got[0])
    assert np.isfinite(s[:-1, 0]).all() and not np.isfinite(s[-1]).any()  # the zero row
    if opts["with_bound"] and opts.get("rescore", True):
        # the certificate's decisions agree but for rows on its edge
        tb_, jb_ = np.asarray(got[2]), np.asarray(want[2])
        with np.errstate(invalid="ignore"):
            edge = np.abs(s[:, -1] - jb_) <= 2 * tinv.CERT_MARGIN * np.maximum(
                np.abs(s[:, -1]), np.abs(jb_))
        tc = tinv.certified_mask(s[:, -1], tb_)
        jc = jinv.certified_mask(np.asarray(want[0])[:, -1], jb_, xp=np)
        assert ((tc == jc) | edge).all()


BAD_ARGS = {
    "shifts_without_rescore": dict(rescore=False, merge_shifts=1),
    "cols_without_rescore": dict(rescore=False, postings_cols=8),
    "zero_cols": dict(postings_cols=0),
    "zero_expand": dict(rescore_expand=0),
    "phase1_without_rescore": dict(rescore=False, phase1_ratio=0.5),
    "packed_f32": dict(packed_docs=True),
    "k_beyond_pool": dict(query_terms=1, postings_cols=4, k=5),
    "token_entry_full": dict(token_entry=True, select_by_impact=True),
    "match_phase1": dict(match_rescore=True, phase1_ratio=0.4),
    "blockmax_without_bound": dict(tail_blockmax=True),
}


@pytest.mark.parametrize("case", list(BAD_ARGS))
def test_make_search_fn_rejects_what_jax_rejects(case):
    pd, pw = tinv.build_postings(TOKS[:64], WS[:64], V, 16)
    kw = dict(query_terms=T, k=2)
    kw.update(BAD_ARGS[case])
    with pytest.raises(ValueError) as t_err:
        tinv.make_search_fn(torch.from_numpy(pd), torch.from_numpy(pw), None, None, **kw)
    with pytest.raises(ValueError) as j_err:
        jinv.make_search_fn(jnp.asarray(pd), jnp.asarray(pw), None, None, **kw)
    assert str(t_err.value).split()[0] == str(j_err.value).split()[0]


def test_token_entry_takes_out_of_range_ids_as_jax_does():
    """A slot id outside [0, V) indexes the postings as JAX's gather does
    (negative once from the end, then clamped) and scores nothing in the
    rescore; on the card an unclamped index would end the CUDA context."""
    pd, pw, toks, ws, _ = _inputs(64)
    q_tok, q_w = _slots(_queries())
    q_tok[0, :3] = [-1, V, V + 40]
    q_tok[1, 0], q_tok[2, 0] = -V - 3, -5
    args_t = (torch.from_numpy(pd), torch.from_numpy(pw), torch.from_numpy(toks),
              torch.from_numpy(ws))
    args_j = tuple(jnp.asarray(a) for a in (pd, pw, toks, ws))
    tfn = tinv.make_search_fn(*args_t, query_terms=T, k=K, token_entry=True, with_bound=True)
    jfn = jinv.make_search_fn(*args_j, query_terms=T, k=K, token_entry=True, with_bound=True)
    got = tfn((torch.from_numpy(q_tok), torch.from_numpy(q_w)), *args_t)
    want = jfn((jnp.asarray(q_tok), jnp.asarray(q_w)), *args_j)
    _assert_search_close(got, want)
    with pytest.raises(ValueError, match="slots"):
        tfn((torch.from_numpy(q_tok[:, :4]), torch.from_numpy(q_w[:, :4])), *args_t)
