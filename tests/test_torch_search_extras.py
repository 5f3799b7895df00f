"""`SparseIndex.avg_doc_activation` and the `return_text`, `corpus_texts`
and `delete` keywords of `eval/beir.py::search`, each against the JAX
package on the same ingest.

The activation statistic is an integer count over a doc count: equal to
the last bit, on one device, on a doc-sharded `["cpu"] * 4` mesh and after
`merge_saved` of two shard indexes. The searches run inference-free
queries (the IDF weights of their tokens, no encoder forward) against the
same rows: scores within 1e-5 relative (fp32 sums in another order), the
same ids, texts and FLOPS statistics.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.eval import beir as jbeir
from opensearch_sparse_model_tuning_sample_tpu.index.engine import (
    IndexConfig as JIndexConfig,
    SparseIndex as JSparseIndex,
)
from opensearch_sparse_model_tuning_sample_tpu.models import sparse_encoder as jse
from opensearch_sparse_model_tuning_sample_torch.core.mesh import make_mesh
from opensearch_sparse_model_tuning_sample_torch.eval import beir as tbeir
from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex
from test_torch_dist_train import _fp32, _port_model

torch.set_num_threads(2)

V = 30522
N_DOCS = 96
QUERIES = {f"q{i}": t for i, t in enumerate([
    "the capital of france", "sparse retrieval with inverted indexes",
    "machine learning on accelerators", "contextual token representations",
    "where is the eiffel tower", "systolic matrix multiply units"])}


@pytest.fixture(scope="module")
def models():
    m = jse.build_model(arch="tiny", idf_path="assets/idf.npz", seed=0,
                        compute_dtype=jax.numpy.float32)
    jm = dataclasses.replace(m, cfg=_fp32(m.cfg))
    return jm, _port_model(jm)[0]


def _corpus(tok, seed=0):
    """N_DOCS docs over the queries' tokens and random others, with their
    texts: every query has hits."""
    rng = np.random.default_rng(seed)
    q_tok = sorted({int(t) for text in QUERIES.values()
                    for t in tok([text], max_length=16)["input_ids"][0] if t > 999})
    docs = np.zeros((N_DOCS, V), np.float32)
    for i in range(N_DOCS):
        t = np.unique(np.concatenate([rng.choice(q_tok, size=3, replace=False),
                                      rng.integers(1000, V, size=int(rng.integers(5, 40)))]))
        docs[i, t] = rng.gamma(2.0, 1.0, size=t.size).astype(np.float32)
    ids = [f"d{i}" for i in range(N_DOCS)]
    return ids, docs, {d: f"text of {d}" for d in ids}


def _cfg(mod, **kw):
    return mod(engine="sparse", l_max=48, block_docs=32, query_batch=8, **kw)


def _built(index, ids, docs):
    index.add(ids, docs)
    index.finalize()
    return index


def test_avg_doc_activation_matches_jax_on_one_device_a_mesh_and_a_merge(models, tmp_path):
    ids, docs, _ = _corpus(models[1].tokenizer)
    want = _built(JSparseIndex(V, _cfg(JIndexConfig)), ids, docs).avg_doc_activation
    one = _built(SparseIndex(V, _cfg(IndexConfig), device="cpu"), ids, docs)
    np.testing.assert_array_equal(one.avg_doc_activation, want)
    assert want.dtype == np.float64 and one.avg_doc_activation.dtype == np.float64
    np.testing.assert_array_equal(one.avg_doc_activation, (docs > 0).sum(axis=0) / N_DOCS)

    sharded = _built(SparseIndex(V, _cfg(IndexConfig, shard_by="docs"),
                                 mesh=make_mesh(devices=["cpu"] * 4)), ids, docs)
    assert sharded._stripes is not None and len(sharded._stripes) == 4
    np.testing.assert_array_equal(sharded.avg_doc_activation, want)

    paths = []
    for r, rows in enumerate((slice(0, 40), slice(40, N_DOCS))):
        part = _built(SparseIndex(V, _cfg(IndexConfig), device="cpu"), ids[rows], docs[rows])
        paths.append(str(tmp_path / f"shard{r}"))
        part.save(paths[-1])
    merged = SparseIndex.merge_saved(paths, device="cpu")
    assert merged.n_docs == N_DOCS
    np.testing.assert_array_equal(merged.avg_doc_activation, want)
    np.testing.assert_array_equal(JSparseIndex.merge_saved(paths).avg_doc_activation, want)
    assert SparseIndex(V, _cfg(IndexConfig), device="cpu").avg_doc_activation.sum() == 0


@pytest.mark.parametrize("return_text", [True, False])
def test_search_keywords_match_jax(models, tmp_path, return_text):
    jm, tm = models
    ids, docs, texts = _corpus(tm.tokenizer, seed=1)
    jindex = _built(JSparseIndex(V, _cfg(JIndexConfig)), ids, docs)
    tindex = _built(SparseIndex(V, _cfg(IndexConfig), device="cpu"), ids, docs)
    np.save(os.path.join(tmp_path, "toy.corpus.npy"), jindex.avg_doc_activation)
    kw = dict(max_length=16, batch_size=4, result_size=5, return_text=return_text,
              corpus_texts=texts, delete=True)
    want = jbeir.search(QUERIES, jm, jindex, str(tmp_path), "toy", **kw)
    got = tbeir.search(QUERIES, tm, tindex, str(tmp_path), "toy", **kw)

    assert got["run_res"].keys() == want["run_res"].keys() == QUERIES.keys()
    for qid, hits in want["run_res"].items():
        assert list(got["run_res"][qid]) == list(hits), qid
        np.testing.assert_allclose(list(got["run_res"][qid].values()), list(hits.values()),
                                   rtol=1e-5)
    for k in ("flops", "q_length", "d_length"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    assert ("run_texts" in got) == ("run_texts" in want) == return_text
    if return_text:
        assert got["run_texts"] == want["run_texts"]
        assert got["run_texts"]["q0"] == [texts[d] for d in got["run_res"]["q0"]]
    # delete=True: both indexes are empty after the search
    for index in (jindex, tindex):
        assert index.n_docs == 0 and index.count_tensor.sum() == 0
    # without corpus_texts there is nothing to return
    tindex = _built(SparseIndex(V, _cfg(IndexConfig), device="cpu"), ids, docs)
    out = tbeir.search(QUERIES, tm, tindex, str(tmp_path), "toy", max_length=16,
                       batch_size=4, result_size=5, return_text=True)
    assert "run_texts" not in out and tindex.n_docs == N_DOCS
