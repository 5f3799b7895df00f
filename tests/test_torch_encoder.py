"""The port's BatchEncoder against the JAX package's, with the same weights
and the same texts: the ingest path's top-l_max (ids, weights), the chunk
path's length-sorted batches, the dense reps gathered back to input order,
the FLOPS count taken on the full rep, and inference-free queries.

fp32 compute on both sides, so reps agree to fp32 summation noise (1e-5);
top-k ids agree except where two weights tie within that noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.eval.beir import synthetic_beir_rich
from opensearch_sparse_model_tuning_sample_tpu.models import sparse_encoder as jse
from opensearch_sparse_model_tuning_sample_torch.models import bert as tbert
from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
from opensearch_sparse_model_tuning_sample_torch.models.convert import params_from_jax
from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import load_tokenizer

torch.set_num_threads(2)

TOL = 1e-5


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


@pytest.fixture(scope="module")
def texts():
    corpus, queries, _ = synthetic_beir_rich(n_docs=40, n_queries=12, seed=1, n_vocab=300)
    docs = [d["title"] + " " + d["text"] for d in corpus.values()]
    docs[3] = docs[3] + " " + docs[4] + " " + docs[5]  # one longer doc -> larger bucket
    return docs, list(queries.values())


def _assert_topk_match(ids_a, w_a, ids_b, w_b):
    np.testing.assert_allclose(w_a, w_b, rtol=0, atol=TOL)
    for r in range(ids_a.shape[0]):
        edge = w_b[r, -1] + TOL  # below this, ids may swap between near-ties
        a = {int(i): w for i, w in zip(ids_a[r], w_a[r]) if w > edge}
        b = {int(i): w for i, w in zip(ids_b[r], w_b[r]) if w > edge}
        assert a.keys() == b.keys(), r
    assert ((w_a > 0) | (ids_a == 0)).all()  # inactive slots hold (0, 0.0)


def test_topk_ingest_path_matches_jax(models, texts):
    jm, tm = models
    docs = texts[0][:10]
    jenc = jse.BatchEncoder(jm, max_length=64)
    tenc = tse.BatchEncoder(tm, max_length=64)
    ji, jw = jenc.encode_batch_sparse(docs, l_max=16)
    ti, tw = tenc.resolve_chunk_sparse(*tenc.encode_chunk_sparse_async(docs, l_max=16, rows=10))
    assert ti.dtype == np.int32 and tw.dtype == np.float32
    _assert_topk_match(ti, tw, np.asarray(ji), np.asarray(jw))
    # the count is taken on the FULL rep, before the top-k
    np.testing.assert_array_equal(tenc.count_tensor, jenc.count_tensor)
    assert tenc.count_tensor.sum() > 16 * len(docs)


@pytest.mark.parametrize("n,rows", [(20, 8), (16, 8), (5, 4)])
def test_chunk_path_matches_jax(models, texts, n, rows):
    """n=20, rows=8 runs 3 batches, the first of 4 rows; the JAX package
    pads its chunk to 4 batches, whose padding rows must not count."""
    jm, tm = models
    docs = texts[0][:n]
    jenc = jse.BatchEncoder(jm, max_length=64)
    tenc = tse.BatchEncoder(tm, max_length=64)
    jh, jn = jenc.encode_chunk_sparse_async(docs, l_max=16, rows=rows)
    th, tn = tenc.encode_chunk_sparse_async(docs, l_max=16, rows=rows)
    assert jn == tn == n
    assert th.idx.shape[0] == n  # no padding rows
    ji, jw = jenc.resolve_chunk_sparse(jh, jn)
    ti, tw = tenc.resolve_chunk_sparse(th, tn)
    _assert_topk_match(ti, tw, ji, jw)
    np.testing.assert_array_equal(tenc.count_tensor, jenc.count_tensor)


def test_chunk_path_matches_per_batch_path(models, texts):
    """The two products of one chunk loop: the sparse chunk's rows are the
    top-l_max of the dense reps of the same texts, with the same count."""
    _, tm = models
    docs = texts[0][:12]
    enc = tse.BatchEncoder(tm, max_length=64)
    handle, n = enc.encode_chunk_sparse_async(docs, l_max=16, rows=4)
    ci, cw = enc.resolve_chunk_sparse(handle, n)
    chunk_count = enc.count_tensor.copy()
    enc.reset_count()
    dense = enc.encode_batch_device(docs, rows=4)
    w, i = torch.topk(dense, 16, dim=1)
    di = torch.where(w > 0, i, 0).to(torch.int32).numpy()
    dw = torch.where(w > 0, w, 0.0).numpy()
    _assert_topk_match(ci, cw, di, dw)
    np.testing.assert_array_equal(chunk_count, enc.count_tensor)


def _chunk_docs(texts, n, lo, hi, seed):
    """n docs of lo..hi words drawn from the corpus's words."""
    words = " ".join(texts[0]).split()
    r = np.random.default_rng(seed)
    return [" ".join(r.choice(words, int(r.integers(lo, hi + 1)))) for _ in range(n)]


@pytest.mark.parametrize("n,lo,hi", [(21, 3, 150), (14, 140, 200)], ids=["mixed", "all_long"])
def test_sorted_chunk_matches_single_docs(models, texts, n, lo, hi):
    """The length-sorted chunk path against each doc encoded alone, in
    batches of 4: its rows come back in input order, each doc's top-k as
    the single-doc path's, and the count is the single docs'. Mixed
    lengths: 21 docs in 6 batches, the first of one doc, and some batches
    run below the chunk's bucket. 14 docs that all need max_length: 4
    batches, the first of 2 docs, all at max_length as before the sort."""
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    _, tm = models
    docs = _chunk_docs(texts, n, lo, hi, seed=lo)
    enc = tse.BatchEncoder(tm, max_length=128)
    lens = tm.tokenizer.encode_bucketed(docs, 128, [128])["attention_mask"].sum(1)
    names = [f"encoder.batch_len.{L}" for L in (64, 128)]
    tracing.reset(names + ["encoder.positions"])
    handle, nv = enc.encode_chunk_sparse_async(docs, l_max=16, rows=4)
    ci, cw = enc.resolve_chunk_sparse(handle, nv)
    c = tracing.counters()
    chunk_count = enc.count_tensor.copy()
    enc.reset_count()
    for j, d in enumerate(docs):
        si, sw = enc.resolve_chunk_sparse(*enc.encode_chunk_sparse_async([d], l_max=16, rows=4))
        _assert_topk_match(ci[j:j + 1], cw[j:j + 1], si, sw)
    np.testing.assert_array_equal(chunk_count, enc.count_tensor)
    nb = -(-n // 4)
    assert sum(c.get(k, 0) for k in names) == nb
    if lo > 100:  # every doc is cut at max_length: every batch runs at it
        assert (lens == 128).all()
        assert c.get(names[1], 0) == nb and c["encoder.positions"] == n * 128
    else:
        assert len(set(lens)) > 1 and c.get(names[0], 0) > 0
        assert c["encoder.positions"] < n * 128


@pytest.mark.parametrize("n,lo,hi", [(3, 3, 40), (21, 3, 150), (14, 140, 200)],
                         ids=["short", "mixed", "all_long"])
def test_chunk_resolved_after_a_later_chunk_matches_resolved_at_once(models, texts, n, lo, hi):
    """ingest's order: a chunk's handle resolved only after the next chunk
    was queued gives the rows and the count it gives when resolved at once
    (the count folds in at the resolve, not when a chunk is queued). A
    chunk shorter than one batch, a mixed one and one all at max_length.
    On the CPU no chunk resolves through an event."""
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    _, tm = models
    docs = _chunk_docs(texts, n, lo, hi, seed=lo + n)
    later = _chunk_docs(texts, 9, 3, 150, seed=7)
    enc = tse.BatchEncoder(tm, max_length=128)
    names = ["encoder.copy_out.async", "encoder.copy_out.waited"]
    tracing.reset(names)
    ai, aw = enc.resolve_chunk_sparse(*enc.encode_chunk_sparse_async(docs, l_max=16, rows=4))
    at_once = enc.count_tensor.copy()
    enc.reset_count()
    handle, nv = enc.encode_chunk_sparse_async(docs, l_max=16, rows=4)
    nxt = enc.encode_chunk_sparse_async(later, l_max=16, rows=4)
    li, lw = enc.resolve_chunk_sparse(handle, nv)
    np.testing.assert_array_equal(enc.count_tensor, at_once)
    enc.resolve_chunk_sparse(*nxt)
    assert li.shape == (n, 16)
    np.testing.assert_array_equal(li, ai)
    np.testing.assert_array_equal(lw, aw)
    assert handle[4:] == (None, None, None)
    assert all(tracing.counters().get(k, 0) == 0 for k in names)


@pytest.mark.parametrize("rows", [None, 4], ids=["one_batch", "rows4"])
def test_dense_doc_reps_match_jax(models, texts, rows):
    """Dense doc reps in input order: one batch, and 10 docs of mixed
    lengths in batches of 4 (the first of 2), gathered back from the
    length-sorted order; no texts give no rows (serving's `_encode` may
    be sent none)."""
    jm, tm = models
    docs = texts[0][:6] if rows is None else _chunk_docs(texts, 10, 3, 80, seed=3)
    ref = jse.BatchEncoder(jm, max_length=64).encode_batch(docs)
    got = tse.BatchEncoder(tm, max_length=64).encode_batch_device(docs, rows=rows).numpy()
    assert got.shape == ref.shape == (len(docs), jm.cfg.vocab_size)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert tse.BatchEncoder(tm, max_length=64).encode_batch([]).shape == (0, jm.cfg.vocab_size)


def test_inf_free_queries_match_jax(models, texts):
    jm, tm = models
    queries = texts[1]
    jenc = jse.BatchEncoder(jm, max_length=64)
    tenc = tse.BatchEncoder(tm, max_length=64)
    jr, jn = jenc.encode_chunk_device(queries, inf_free=True, rows=5)
    tr = tenc.encode_batch_device(queries, inf_free=True, rows=5)
    assert jn == tr.shape[0] == len(queries)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr)[:jn], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tenc.count_tensor, jenc.count_tensor)


def test_get_batch_encoder_reuses_and_resets(models, texts):
    _, tm = models
    a = tse.get_batch_encoder(tm, max_length=64)
    a.resolve_chunk_sparse(*a.encode_chunk_sparse_async(texts[0][:2], l_max=4))
    assert a.count_tensor.sum() > 0
    b = tse.get_batch_encoder(tm, max_length=64)
    assert b is a and b.count_tensor.sum() == 0
    assert tse.get_batch_encoder(tm, max_length=64, scope="other") is not a


@pytest.mark.parametrize("device,batch_rows,rows,takes", [
    ("cuda", 50, 50, True), ("cuda:1", 8, 8, True), ("cuda", 33, 50, False),
    ("cuda", 1, 50, False), ("cpu", 50, 50, False), ("cpu", 7, 10, False)])
def test_takes_graph_is_a_rule_of_device_and_rows(device, batch_rows, rows, takes):
    """An ingest batch replays the encoder's CUDA graph exactly when it is a
    full batch of the chunk's rows on a CUDA device."""
    assert tse.takes_graph(torch.device(device), batch_rows, rows) is takes


@pytest.mark.parametrize("n,rows", [(21, 4), (16, 8)], ids=["short_first", "all_full"])
def test_chunk_path_on_the_cpu_captures_nothing(models, texts, n, rows):
    """On the CPU every batch of the ingest loop runs the encoder stack
    eagerly (`encoder.graph.eager` counts each), nothing is captured or
    replayed, and the rows are the eager forward's top-k of each batch."""
    from opensearch_sparse_model_tuning_sample_torch.utils import tracing

    _, tm = models
    docs = _chunk_docs(texts, n, 3, 150, seed=n)
    enc = tse.BatchEncoder(tm, max_length=128)
    names = ["encoder.graph.captures", "encoder.graph.replays", "encoder.graph.eager"]
    tracing.reset(names)
    handle, nv = enc.encode_chunk_sparse_async(docs, l_max=16, rows=rows)
    ci, cw = enc.resolve_chunk_sparse(handle, nv)
    c = tracing.counters()
    assert [c.get(k, 0) for k in names] == [0, 0, -(-n // rows)]
    assert tm.bert.graph_runner.graphs == {}
    batches, pos, _ = enc._pack(docs, rows, runs_encoder=False)
    with torch.inference_mode():
        idx, vals = zip(*(tse._topk_rows(tse.encode_doc(tm, ids, mask), 16)
                          for ids, mask in batches))
    np.testing.assert_array_equal(ci, torch.cat(idx).numpy()[pos])
    np.testing.assert_array_equal(cw, torch.cat(vals).numpy()[pos])


def test_a_copied_backbone_gets_a_graph_runner_of_its_own(models):
    """A deep copy of the module (a mesh's replica) starts with an empty
    graph runner of its own, never its source's graphs."""
    import copy

    _, tm = models
    twin = copy.deepcopy(tm.bert)
    assert twin.graph_runner is not tm.bert.graph_runner
    assert twin.graph_runner.graphs == {} and twin.graph_runner._weights is None
