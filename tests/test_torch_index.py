"""The port's exact index (doc-major sparse scan, dense oracle) against the
JAX package's SparseIndex on one numpy corpus, and the saved-index format
shared by both packages.

Scores are fp32 sums of the same products in another order: 1e-5 relative.
Ids agree except where two docs score within that noise of each other.
"""

import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.index.engine import (
    IndexConfig as JIndexConfig,
    SparseIndex as JSparseIndex,
)
from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex

torch.set_num_threads(2)

V = 500


def _corpus(n_docs=300, n_q=21, seed=0):
    rng = np.random.default_rng(seed)
    docs = np.zeros((n_docs, V), np.float32)
    for i in range(n_docs):
        t = rng.choice(V, size=rng.integers(5, 60), replace=False)
        docs[i, t] = rng.gamma(2.0, 1.0, size=t.size)
    docs[7] = 0  # an empty doc
    docs[11] = docs[10]  # an exact duplicate: a tie
    q = np.zeros((n_q, V), np.float32)
    for i in range(n_q):
        t = rng.choice(V, size=rng.integers(2, 12), replace=False)
        q[i, t] = rng.gamma(2.0, 1.0, size=t.size)
    return [f"d{i}" for i in range(n_docs)], docs, q


def _assert_hits_match(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        np.testing.assert_allclose(sorted(g.values()), sorted(r.values()), rtol=1e-5)
        if r:
            edge = min(r.values()) * (1 + 1e-5)
            assert {d for d, s in g.items() if s > edge} == {d for d, s in r.items() if s > edge}
        for d in g.keys() & r.keys():
            assert g[d] == pytest.approx(r[d], rel=1e-5)


def _pair(engine, **kw):
    cfg = dict(engine=engine, l_max=32, block_docs=64, query_batch=8, **kw)
    return JSparseIndex(V, JIndexConfig(**cfg)), SparseIndex(V, IndexConfig(**cfg), device="cpu")


@pytest.mark.parametrize("engine", ["sparse", "dense", "auto"])
@pytest.mark.parametrize("weight_dtype", ["bfloat16", "float32"])
def test_search_matches_jax(engine, weight_dtype):
    ids, docs, q = _corpus()
    j, t = _pair(engine, weight_dtype=weight_dtype)
    for s in range(0, len(ids), 128):
        j.add(ids[s:s + 128], docs[s:s + 128])
        t.add(ids[s:s + 128], docs[s:s + 128])
    j.finalize()
    t.finalize()
    np.testing.assert_array_equal(t.count_tensor, j.count_tensor)
    _assert_hits_match(t.search(q, k=10), j.search(q, k=10))


@pytest.mark.parametrize("kw", [
    dict(query_prune=0.5),
    dict(exclude_self=[f"d{i}" for i in range(21)]),
    dict(k=300),
])
def test_search_options_match_jax(kw):
    ids, docs, q = _corpus(seed=1)
    q[3] = docs[3]  # the self-hit that exclude_self must drop
    j, t = _pair("sparse")
    j.add(ids, docs)
    t.add(ids, docs)
    j.finalize()
    t.finalize()
    k = kw.pop("k", 10)
    _assert_hits_match(t.search(q, k=k, **kw), j.search(q, k=k, **kw))


def test_add_topk_matches_jax():
    ids, docs, q = _corpus(seed=2)
    order = np.argsort(-docs, axis=1)[:, :40]
    tok = order.astype(np.int32)
    w = np.take_along_axis(docs, order, axis=1)
    tok[w <= 0] = 0
    j, t = _pair("sparse")
    j.add_topk(ids, tok, w)
    t.add_topk(ids, tok, w)
    j.finalize()
    t.finalize()
    np.testing.assert_array_equal(t.count_tensor, j.count_tensor)
    _assert_hits_match(t.search(q, k=10), j.search(q, k=10))


@pytest.mark.parametrize("engine", ["sparse", "dense"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_saved_index_loads_in_the_other_package(tmp_path, engine, direction):
    ids, docs, q = _corpus(seed=3)
    j, t = _pair(engine)
    src = j if direction == "jax_to_port" else t
    src.add(ids, docs)
    src.finalize()
    src.save(str(tmp_path / "idx"))
    if direction == "jax_to_port":
        loaded = SparseIndex.load(str(tmp_path / "idx"), device="cpu")
    else:
        loaded = JSparseIndex.load(str(tmp_path / "idx"))
    assert loaded.n_docs == len(ids) and loaded.doc_ids == src.doc_ids
    assert loaded.cfg.l_max == 32 and loaded._engine == engine
    np.testing.assert_array_equal(loaded.count_tensor, src.count_tensor)
    _assert_hits_match(loaded.search(q, k=10), src.search(q, k=10))


def test_delete_returns_to_empty_ingest():
    ids, docs, q = _corpus(seed=4)
    _, t = _pair("sparse")
    t.add(ids, docs)
    t.finalize()
    t.delete()
    assert t.n_docs == 0 and t.count_tensor.sum() == 0
    t.add(ids[:5], docs[:5])
    t.finalize()
    assert len(t.search(q[:2], k=3)) == 2


@pytest.mark.parametrize("case", ["inverted", "auto_above_threshold", "mesh"])
def test_not_ported_paths_raise(case, tmp_path):
    """Each path that once raised as not ported now builds: the inverted
    engine, auto above its threshold (tests/test_torch_inverted_engine.py),
    merging saved inverted shards (tests/test_torch_dist_eval.py) and a
    device mesh (tests/test_torch_sharded_index.py), whose doc-sharded
    index answers as the single-device one."""
    ids, docs, _ = _corpus(n_docs=20, seed=5)
    if case == "inverted":
        shards = []
        for r in range(2):
            t = SparseIndex(V, IndexConfig(engine="inverted", l_max=32, block_docs=16),
                            device="cpu")
            t.add(ids[r::2], docs[r::2])
            t.finalize()
            t.save(str(tmp_path / f"shard{r}"))
            shards.append(str(tmp_path / f"shard{r}"))
        merged = SparseIndex.merge_saved(shards, device="cpu")
        assert merged._engine == "inverted" and merged.doc_ids == ids[0::2] + ids[1::2]
        return
    if case == "mesh":
        from opensearch_sparse_model_tuning_sample_torch.core.mesh import make_mesh

        cfg = IndexConfig(engine="sparse", l_max=32, block_docs=16, weight_dtype="float32")
        one = SparseIndex(V, cfg, device="cpu")
        two = SparseIndex(V, cfg, mesh=make_mesh(devices=["cpu"] * 2))
        for t in (one, two):
            t.add(ids, docs)
            t.finalize()
        assert len(two._stripes) == 2
        assert two.search(docs[:3], k=5) == one.search(docs[:3], k=5)
        return
    t = SparseIndex(V, IndexConfig(engine="auto", auto_threshold=10, l_max=32,
                                   block_docs=16), device="cpu")
    t.add(ids, docs)
    t.finalize()
    assert t._engine == "inverted" and t._exact_escalate
