"""The port's BatchEncoder against the JAX package's, with the same weights
and the same texts: the ingest path's top-l_max (ids, weights), the chunked
path with its power-of-two batch padding, the FLOPS count taken on the full
rep, and inference-free queries.

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
    ti, tw = tenc.encode_batch_sparse(docs, l_max=16)
    assert ti.dtype == np.int32 and tw.dtype == np.float32
    _assert_topk_match(ti, tw, np.asarray(ji), np.asarray(jw))
    # the count is taken on the FULL rep, before the top-k
    np.testing.assert_array_equal(tenc.count_tensor, jenc.count_tensor)
    assert tenc.count_tensor.sum() > 16 * len(docs)


def test_resolve_sparse_many_matches_jax(models, texts):
    """A window of async handles resolved with one fetch per tensor kind."""
    jm, tm = models
    batches = [texts[0][0:4], texts[0][4:7], texts[0][7:12]]
    jenc = jse.BatchEncoder(jm, max_length=64)
    tenc = tse.BatchEncoder(tm, max_length=64)
    ref = jenc.resolve_sparse_many(
        [jenc.encode_batch_sparse_async(b, l_max=16) for b in batches],
        [len(b) for b in batches])
    got = tenc.resolve_sparse_many(
        [tenc.encode_batch_sparse_async(b, l_max=16) for b in batches],
        [len(b) for b in batches])
    assert len(got) == len(ref) == len(batches)
    for (ti, tw), (ji, jw), b in zip(got, ref, batches):
        assert ti.shape == (len(b), 16)
        _assert_topk_match(ti, tw, np.asarray(ji), np.asarray(jw))
    np.testing.assert_array_equal(tenc.count_tensor, jenc.count_tensor)
    assert tenc.resolve_sparse_many([], []) == []


@pytest.mark.parametrize("n,rows", [(20, 8), (16, 8), (5, 4)])
def test_chunk_path_matches_jax(models, texts, n, rows):
    """n=20, rows=8 pads 3 batches to 4; padding rows must not count."""
    jm, tm = models
    docs = texts[0][:n]
    jenc = jse.BatchEncoder(jm, max_length=64)
    tenc = tse.BatchEncoder(tm, max_length=64)
    jh, jn = jenc.encode_chunk_sparse_async(docs, l_max=16, rows=rows)
    th, tn = tenc.encode_chunk_sparse_async(docs, l_max=16, rows=rows)
    assert jn == tn == n
    assert th[0].shape[0] == jh[0].shape[0]  # same power-of-two batch count
    ji, jw = jenc.resolve_chunk_sparse(jh, jn)
    ti, tw = tenc.resolve_chunk_sparse(th, tn)
    _assert_topk_match(ti, tw, ji, jw)
    np.testing.assert_array_equal(tenc.count_tensor, jenc.count_tensor)


def test_chunk_path_matches_per_batch_path(models, texts):
    _, tm = models
    docs = texts[0][:12]
    enc = tse.BatchEncoder(tm, max_length=64, seq_buckets=[64])
    handle, n = enc.encode_chunk_sparse_async(docs, l_max=16, rows=4)
    ci, cw = enc.resolve_chunk_sparse(handle, n)
    chunk_count = enc.count_tensor.copy()
    enc.reset_count()
    parts = [enc.encode_batch_sparse(docs[i:i + 4], l_max=16) for i in range(0, 12, 4)]
    np.testing.assert_array_equal(ci, np.concatenate([p[0] for p in parts]))
    np.testing.assert_allclose(cw, np.concatenate([p[1] for p in parts]), rtol=0, atol=TOL)
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
    the single-doc path's, and the count is the single docs' (no padding
    row counted). Mixed lengths: 21 docs, 6 batches padded to 8, so the
    padding fills a whole batch and part of another, and some batches run
    below the chunk's bucket. 14 docs that all need max_length: 4 batches,
    each holding a real doc, all at max_length as before the sort."""
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
        si, sw = enc.encode_batch_sparse([d], l_max=16)
        _assert_topk_match(ci[j:j + 1], cw[j:j + 1], si, sw)
    np.testing.assert_array_equal(chunk_count, enc.count_tensor)
    nb = 1 << (-(-n // 4) - 1).bit_length()
    assert sum(c.get(k, 0) for k in names) == nb
    if lo > 100:  # every doc is cut at max_length: every batch runs at it
        assert (lens == 128).all()
        assert c.get(names[1], 0) == nb and c["encoder.positions"] == nb * 4 * 128
    else:
        assert len(set(lens)) > 1 and c.get(names[0], 0) > 0
        assert c["encoder.positions"] < nb * 4 * 128


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


def test_dense_doc_reps_match_jax(models, texts):
    jm, tm = models
    docs = texts[0][:6]
    ref = jse.BatchEncoder(jm, max_length=64).encode_batch(docs)
    got = tse.BatchEncoder(tm, max_length=64).encode_batch(docs)
    assert got.shape == ref.shape == (6, jm.cfg.vocab_size)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_inf_free_queries_match_jax(models, texts):
    jm, tm = models
    queries = texts[1]
    jenc = jse.BatchEncoder(jm, max_length=64)
    tenc = tse.BatchEncoder(tm, max_length=64)
    jr, jn = jenc.encode_chunk_device(queries, inf_free=True, rows=5)
    tr, tn = tenc.encode_chunk_device(queries, inf_free=True, rows=5)
    assert jn == tn == len(queries)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tenc.count_tensor, jenc.count_tensor)


def test_get_batch_encoder_reuses_and_resets(models, texts):
    _, tm = models
    a = tse.get_batch_encoder(tm, max_length=64)
    a.encode_batch_sparse(texts[0][:2], l_max=4)
    assert a.count_tensor.sum() > 0
    b = tse.get_batch_encoder(tm, max_length=64)
    assert b is a and b.count_tensor.sum() == 0
    assert tse.get_batch_encoder(tm, max_length=64, scope="other") is not a
