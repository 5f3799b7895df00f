"""The port's serving surface of the exact index against the JAX package's,
on the same numpy inputs: `search_tokens` (duplicate ids summed, ids out of
range dropped, weights <= 0 ignored, exclude_self), two-phase search on the
scan in both modes (ignored on the dense oracle), the async handle API, the
exactness flags (None on the exact engines), `reopen` -> `add_topk` ->
`finalize` -> search, the `{token: weight}` encoders, and `cli.search`.

Scores are fp32 sums of the same products in another order: 1e-5 relative
(`_assert_hits_match`). Both packages pick top-k ties alike (the lower doc
index first), so two-phase candidate pools hold the same docs.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_index import _assert_hits_match

from opensearch_sparse_model_tuning_sample_tpu.cli import search as jsearch_cli
from opensearch_sparse_model_tuning_sample_tpu.eval.beir import synthetic_beir_rich
from opensearch_sparse_model_tuning_sample_tpu.index.engine import (
    IndexConfig as JIndexConfig,
    SparseIndex as JSparseIndex,
)
from opensearch_sparse_model_tuning_sample_tpu.models import hf_import as jhf
from opensearch_sparse_model_tuning_sample_tpu.models import sparse_encoder as jse
from opensearch_sparse_model_tuning_sample_torch.cli import search as tsearch_cli
from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex
from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
from opensearch_sparse_model_tuning_sample_torch.models.convert import params_from_jax
from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import load_tokenizer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 120


def _corpus(n_docs=300, n_q=24, seed=0):
    """Docs of 10-40 terms over a 120-token vocab, so most docs score > 0
    in phase 1 and a two-phase pool is not filled by ties at 0."""
    rng = np.random.default_rng(seed)
    docs = np.zeros((n_docs, V), np.float32)
    for i in range(n_docs):
        t = rng.choice(V, size=rng.integers(10, 41), replace=False)
        docs[i, t] = rng.gamma(2.0, 1.0, size=t.size)
    docs[7] = 0  # an empty doc
    docs[11] = docs[10]  # an exact duplicate: a tie
    q = np.zeros((n_q, V), np.float32)
    for i in range(n_q):
        t = rng.choice(V, size=rng.integers(3, 13), replace=False)
        q[i, t] = rng.gamma(2.0, 1.0, size=t.size)
    return [f"d{i}" for i in range(n_docs)], docs, q


def _cfg(engine, **kw):
    # two_phase_terms 4 of l_max 32 and a pool of 2k: phase 1 is far from exact
    return dict(engine=engine, l_max=32, block_docs=64, query_batch=8,
                two_phase_terms=4, two_phase_expand=2, **kw)


def _built(engine, seed=0, **kw):
    ids, docs, q = _corpus(seed=seed)
    j = JSparseIndex(V, JIndexConfig(**_cfg(engine, **kw)))
    t = SparseIndex(V, IndexConfig(**_cfg(engine, **kw)), device="cpu")
    for idx in (j, t):
        idx.add(ids, docs)
        idx.finalize()
    return j, t, ids, q


def _token_queries(seed=0, n_q=24):
    """[n_q, 16] slots: duplicate ids in a row, ids >= V, ids below -V,
    negative ids that count from the end, and weights <= 0."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, V, size=(n_q, 16)).astype(np.int32)
    w = rng.gamma(2.0, 1.0, size=(n_q, 16)).astype(np.float32)
    tok[:, 1] = tok[:, 0]  # a duplicate id: its weights sum
    tok[::3, 2] = V + rng.integers(0, 50, size=tok[::3, 2].shape)  # >= V: dropped
    tok[1::3, 3] = -V - 1 - rng.integers(0, 50, size=tok[1::3, 3].shape)  # < -V: dropped
    tok[2::3, 4] = -1 - rng.integers(0, V, size=tok[2::3, 4].shape)  # -1 is V - 1
    w[:, 5] = 0.0
    w[::2, 6] = -1.5
    w[:, 12:] = 0.0  # padding slots
    return tok, w


def _token_query_reference(tok, w):
    q = np.zeros((tok.shape[0], V), np.float32)
    for b in range(tok.shape[0]):
        for t, x in zip(tok[b], w[b]):
            t = t + V if t < 0 else t
            if 0 <= t < V and x > 0:
                q[b, t] += x
    return q


def test_token_query_is_one_accumulating_scatter():
    _, t, _, _ = _built("sparse")
    tok, w = _token_queries()
    got = t._token_query(tok, w).numpy()
    np.testing.assert_allclose(got, _token_query_reference(tok, w), rtol=1e-6)


@pytest.mark.parametrize("engine,weight_dtype", [
    ("sparse", "bfloat16"), ("sparse", "float32"), ("dense", "float32")])
def test_search_tokens_matches_jax(engine, weight_dtype):
    j, t, ids, _ = _built(engine, weight_dtype=weight_dtype)
    tok, w = _token_queries()
    _assert_hits_match(t.search_tokens(tok, w, k=10), j.search_tokens(tok, w, k=10))
    # and the port's own dense query through search()
    _assert_hits_match(t.search_tokens(tok, w, k=10),
                       t.search(_token_query_reference(tok, w), k=10))


def test_search_tokens_options_match_jax():
    j, t, ids, _ = _built("sparse", seed=1)
    tok, w = _token_queries(seed=1)
    tok[4, 0], w[4, 0] = 3, 50.0  # a heavy token, so the self hit ranks first
    excl = [ids[i] for i in range(len(tok))]
    for kw in (dict(exclude_self=excl), dict(query_prune=0.5), dict(k=300)):
        k = kw.pop("k", 10)
        _assert_hits_match(t.search_tokens(tok, w, k=k, **kw),
                           j.search_tokens(tok, w, k=k, **kw))
    got = t.search_tokens(tok, w, k=10, exclude_self=excl)
    assert all(ids[i] not in h for i, h in enumerate(got))


@pytest.mark.parametrize("mode", ["query", "doc"])
@pytest.mark.parametrize("weight_dtype", ["bfloat16", "float32"])
def test_two_phase_matches_jax(mode, weight_dtype):
    j, t, ids, q = _built("sparse", two_phase_mode=mode, weight_dtype=weight_dtype)
    got = t.search(q, k=10, two_phase=True)
    _assert_hits_match(got, j.search(q, k=10, two_phase=True))
    # phase 1 is approximate here: some query's top-10 is not the exact one
    exact = t.search(q, k=10)
    assert any(g.keys() != e.keys() for g, e in zip(got, exact))
    tok, w = _token_queries(seed=2)
    _assert_hits_match(t.search_tokens(tok, w, k=5, two_phase=True),
                       j.search_tokens(tok, w, k=5, two_phase=True))


def test_two_phase_is_ignored_on_dense():
    j, t, ids, q = _built("dense", two_phase_mode="doc")
    got = t.search(q, k=10, two_phase=True)
    assert got == t.search(q, k=10)
    _assert_hits_match(got, j.search(q, k=10, two_phase=True))


def test_async_handles_resolve_as_the_sync_search():
    j, t, ids, _ = _built("sparse")
    tok, w = _token_queries(seed=3)
    parts = [(tok[s:s + 8], w[s:s + 8]) for s in range(0, len(tok), 8)]
    sync = [t.search_tokens(a, b, k=7) for a, b in parts]
    handles = [t.search_tokens_async(a, b, k=7) for a, b in parts]
    assert all("sync_results" in h for h in handles)  # the exact engine degrades
    assert [t.resolve_hits(h) for h in handles] == sync
    assert t.resolve_hits_many(handles) == sync
    assert t.last_certified is None and t.last_escalated is None
    assert t.resolve_hits_many([]) == []
    jh = [j.search_tokens_async(a, b, k=7) for a, b in parts]
    for got, ref in zip(t.resolve_hits_many(handles), j.resolve_hits_many(jh)):
        _assert_hits_match(got, ref)
    assert not any("parts" in h for h in handles)  # no device handle on an exact engine
    assert not t._tokens_fast_eligible(tok, w, {})


@pytest.mark.parametrize("engine", ["sparse", "dense"])
def test_flags_stay_none_on_exact_engines(engine):
    j, t, ids, q = _built(engine)
    tok, w = _token_queries()
    for idx in (j, t):
        idx.last_certified = np.ones(1, bool)  # stale: every search resets
        idx.search(q, k=5, two_phase=True)
        assert idx.last_certified is None and idx.last_escalated is None
        assert idx.last_scan_escalated is None
        idx.search_tokens(tok, w, k=5)
        assert idx.last_certified is None
        idx.last_escalated = np.ones(1, bool)
        assert idx.search(q[:0], k=5) == []  # the empty query set resets too
        assert idx.last_escalated is None


@pytest.mark.parametrize("engine,weight_dtype", [
    ("sparse", "bfloat16"), ("sparse", "float32"), ("dense", "bfloat16")])
def test_reopen_then_add_matches_jax(engine, weight_dtype):
    ids, docs, q = _corpus(seed=4)
    cfg = _cfg(engine, weight_dtype=weight_dtype)
    j = JSparseIndex(V, JIndexConfig(**cfg))
    t = SparseIndex(V, IndexConfig(**cfg), device="cpu")
    order = np.argsort(-docs[200:], axis=1)[:, :20]
    tok = order.astype(np.int32)
    w = np.take_along_axis(docs[200:], order, axis=1)
    for idx in (j, t):
        idx.add(ids[:200], docs[:200])
        idx.finalize()
        idx.search(q, k=10)
        idx.reopen()
        idx.reopen()  # a second reopen is a no-op
        assert not idx._finalized and idx.n_docs == 200
        if engine == "sparse":
            idx.add_topk(ids[200:], tok, w)
        else:
            idx.add(ids[200:], docs[200:])
        idx.finalize()
    assert t.n_docs == 300 and t.doc_ids == j.doc_ids
    np.testing.assert_array_equal(t.count_tensor, j.count_tensor)
    got = t.search(q, k=10)
    _assert_hits_match(got, j.search(q, k=10))
    hit_ids = {int(d[1:]) for h in got for d in h}
    assert min(hit_ids) < 200 <= max(hit_ids)  # both ingest rounds answer


@pytest.fixture(scope="module")
def models():
    jm = jse.build_model(arch="tiny", idf_path="assets/idf.npz", seed=0,
                         compute_dtype=jnp.float32)
    tcfg = tbert.BertConfig(**{
        f.name: getattr(jm.cfg, f.name) for f in dataclasses.fields(tbert.BertConfig)
        if f.name not in ("param_dtype", "compute_dtype")
    }, compute_dtype=torch.float32)
    tm = tse.SparseEncoderModel(tcfg, tbert.BertForMaskedLM(tcfg),
                                torch.zeros(tcfg.vocab_size), load_tokenizer(None))
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), tcfg))
    return jm, tm.eval()


@pytest.mark.parametrize("inf_free", [True, False])
def test_token_weight_dicts_match_jax(models, inf_free):
    jm, tm = models
    texts = ["the quick brown fox", "an unrelated document about dogs", ""]
    got = tse.BatchEncoder(tm, max_length=32).encode(texts, inf_free=inf_free)
    ref = jse.BatchEncoder(jm, max_length=32).encode(texts, inf_free=inf_free)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert all(isinstance(k, str) and v > 0 for k, v in g.items())
        strong = {k for k, v in r.items() if v > 1e-4}
        assert strong <= g.keys() and {k for k, v in g.items() if v > 1e-4} <= r.keys()
        for k in g.keys() & r.keys():
            assert g[k] == pytest.approx(r[k], rel=1e-4, abs=1e-5)
    reps = np.zeros((2, tm.vocab_size), np.float32)
    reps[0, [1000, 2000]] = [0.5, 2.0]
    assert (tse.sparse_to_token_weight_dicts(reps, tm.tokenizer)
            == jse.sparse_to_token_weight_dicts(reps, jm.tokenizer))
    tw = {"fox": 2.0, "the": 0.1, "dog": 1.0}
    for prune in (0, 0.3):
        assert (tse.sparse_embedding_to_query(tw, query_prune=prune)
                == jse.sparse_embedding_to_query(tw, query_prune=prune))


@pytest.fixture(scope="module")
def search_setup(tiny_model, tmp_path_factory):
    """The tiny model with its head transform at 4·I (lexical reps), saved
    by the JAX package; an index of 60 synthetic docs it encoded (l_max 48,
    two-phase on each doc's first 8 terms); a queries file."""
    bert = dict(tiny_model.params["bert"])
    head = dict(bert["mlm_head"])
    head["transform"] = dict(head["transform"],
                             kernel=jnp.eye(tiny_model.cfg.hidden_size) * 4.0)
    bert["mlm_head"] = head
    model = dataclasses.replace(tiny_model, params=dict(tiny_model.params, bert=bert))
    root = tmp_path_factory.mktemp("search")
    ckpt = str(root / "checkpoint-tiny")
    jhf.save_checkpoint(model, ckpt)
    corpus, queries, _ = synthetic_beir_rich(n_docs=60, n_queries=20, seed=2, n_vocab=300)
    texts = [d["title"] + " " + d["text"] for d in corpus.values()]
    idx = JSparseIndex(model.vocab_size, JIndexConfig(
        engine="sparse", l_max=48, block_docs=16, query_batch=8,
        two_phase_mode="doc", two_phase_terms=8, two_phase_expand=2))
    tok, w = jse.BatchEncoder(model, max_length=64).encode_batch_sparse(texts, l_max=48)
    idx.add_topk(list(corpus), np.asarray(tok), np.asarray(w))
    idx.finalize()
    idx.save(str(root / "idx"))
    qfile = root / "queries.tsv"
    qfile.write_text("".join(f"{qid}\t{text}\n" for qid, text in queries.items())
                     + "an untitled query\n")
    return ckpt, str(root / "idx"), str(qfile)


def _run_cli(main, argv, capsys):
    main(argv)
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def _trec(path):
    rows = [line.split() for line in open(path)]
    return [(r[0], r[2], int(r[3]), float(r[4]), r[5]) for r in rows]


@pytest.mark.parametrize("extra", [[], ["--two-phase"], ["--query-prune", "0.3"]])
def test_cli_search_matches_jax(search_setup, tmp_path, capsys, extra):
    ckpt, index_dir, qfile = search_setup
    argv = ["--index", index_dir, "--model", ckpt, "--queries", qfile, "--k", "5",
            "--max-length", "64", "--batch-size", "8", *extra]
    ref = _run_cli(jsearch_cli.main, argv + ["--trec", str(tmp_path / "j.trec")], capsys)
    got = _run_cli(tsearch_cli.main,
                   argv + ["--trec", str(tmp_path / "t.trec"), "--device", "cpu"], capsys)
    assert [r["qid"] for r in got] == [r["qid"] for r in ref] and len(got) == 21
    assert sum(len(r["hits"]) for r in ref) > 40  # lexical: most queries retrieve
    _assert_hits_match([r["hits"] for r in got], [r["hits"] for r in ref])
    jt, tt = _trec(tmp_path / "j.trec"), _trec(tmp_path / "t.trec")
    assert len(tt) == len(jt)
    for a, b in zip(tt, jt):
        assert (a[0], a[2], a[4]) == (b[0], b[2], b[4])
        assert a[3] == pytest.approx(b[3], rel=1e-5, abs=2e-6)
    assert {(a[0], a[1]) for a in tt} == {(b[0], b[1]) for b in jt}
