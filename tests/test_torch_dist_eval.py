"""Multi-rank ingest, evaluation and mining of the port (the filesystem
protocol of `eval/beir.py`, `SparseIndex.merge_saved`, `mine_hard_negatives`),
held to the JAX package's functions on the same inputs: the port's
counterparts of JAX `tests/test_multiprocess.py` (eval shard -> merge ->
search, mining) and `tests/test_eval.py` (count reduce, a rerun into the
same out_dir, a dead rank failing fast).

Ranks run as threads sharing the filesystem, as the JAX tests run them, and
once as two real `cli.evaluate_beir` processes. The model is the `tiny`
checkpoint with its MLM-head transform set to 4·I (lexical reps, as
tests/test_torch_slice.py writes it), fp32 in both packages, so rankings
compare exactly. Tolerances: activation counts, doc ids and mined rows
exactly; NDCG@10 to 1e-6 (trec_eval rounds to 5 decimals); FLOPS 1e-6
relative; merged-index scores 1e-5 relative.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from opensearch_sparse_model_tuning_sample_tpu.core import config as jconfig
from opensearch_sparse_model_tuning_sample_tpu.eval import beir as jbeir
from opensearch_sparse_model_tuning_sample_tpu.index.engine import SparseIndex as JIndex
from opensearch_sparse_model_tuning_sample_tpu.mine import hard_negatives as jmine
from opensearch_sparse_model_tuning_sample_tpu.models import hf_import as jhf
from opensearch_sparse_model_tuning_sample_tpu.models import sparse_encoder as jse
from opensearch_sparse_model_tuning_sample_torch.core import config as tconfig
from opensearch_sparse_model_tuning_sample_torch.data.datasets import BEIRCorpusDataset
from opensearch_sparse_model_tuning_sample_torch.eval import beir as tbeir
from opensearch_sparse_model_tuning_sample_torch.index.engine import IndexConfig, SparseIndex
from opensearch_sparse_model_tuning_sample_torch.mine import hard_negatives as tmine
from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDF = os.path.join(REPO, "assets", "idf.npz")
KW = dict(max_length=64, batch_size=32)


@pytest.fixture(scope="module")
def ckpt(tiny_model, tmp_path_factory):
    bert = dict(tiny_model.params["bert"])
    head = dict(bert["mlm_head"])
    head["transform"] = dict(head["transform"],
                             kernel=jnp.eye(tiny_model.cfg.hidden_size) * 4.0)
    bert["mlm_head"] = head
    model = dataclasses.replace(tiny_model, params=dict(tiny_model.params, bert=bert))
    d = str(tmp_path_factory.mktemp("ckpt") / "checkpoint-tiny")
    jhf.save_checkpoint(model, d)
    return d


@pytest.fixture(scope="module")
def models(ckpt):
    jm = jse.build_model(model_name_or_path=ckpt, idf_path=IDF, compute_dtype=jnp.float32)
    tm = tse.build_model(model_name_or_path=ckpt, idf_path=IDF, compute_dtype=torch.float32,
                         device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def synth():
    return tbeir.synthetic_beir(n_docs=90, n_queries=8, seed=3)


def _cfg():
    return IndexConfig(engine="sparse", l_max=32, block_docs=64, query_batch=8)


def _jcfg():
    return jbeir.IndexConfig(engine="sparse", l_max=32, block_docs=64, query_batch=8)


def _threaded(fn, world=2):
    with ThreadPoolExecutor(world) as ex:
        return list(ex.map(fn, range(world)))


def test_two_rank_ingest_reduces_counts_and_merges_like_jax(models, synth, tmp_path):
    """The ranks' counts reduce through out_dir to the one-process corpus
    statistic (the count scope is per rank: threads share the model), and
    the shards the port saved merge, in the port and in JAX, into the
    whole corpus with the same rows and hits."""
    jm, tm = models
    corpus, queries, _ = synth
    ds = BEIRCorpusDataset(corpus)
    tbeir.ingest(ds, tm, str(tmp_path / "single"), "mh", index_cfg=_cfg(), **KW)
    single = np.load(tmp_path / "single" / "mh.corpus.npy")
    jbeir.ingest(ds, jm, str(tmp_path / "jax"), "mh", index_cfg=_jcfg(), **KW)
    np.testing.assert_array_equal(single, np.load(tmp_path / "jax" / "mh.corpus.npy"))

    multi = str(tmp_path / "multi")
    shards = _threaded(lambda r: tbeir.ingest(ds, tm, multi, "mh", index_cfg=_cfg(), rank=r,
                                              world_size=2, barrier_timeout=120.0, **KW))
    np.testing.assert_array_equal(np.load(os.path.join(multi, "mh.corpus.npy")), single)
    assert [s.n_docs for s in shards] == [45, 45]
    assert not [f for f in os.listdir(multi) if ".count." in f or ".hb." in f]  # cleaned up

    paths = []
    for r, sh in enumerate(shards):
        paths.append(os.path.join(multi, f"shard{r}"))
        sh.save(paths[-1])
    merged = SparseIndex.merge_saved(paths, device="cpu")
    jmerged = JIndex.merge_saved(paths)
    assert merged.doc_ids == jmerged.doc_ids == shards[0].doc_ids + shards[1].doc_ids
    assert sorted(merged.doc_ids) == sorted(corpus)
    np.testing.assert_array_equal(merged.count_tensor, jmerged.count_tensor)
    q = tse.BatchEncoder(tm, max_length=64).encode_batch(list(queries.values()), inf_free=True)
    got = merged.search(torch.from_numpy(q), k=10)
    want = jmerged.search(q, k=10)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        np.testing.assert_allclose(list(g.values()), list(w.values()), rtol=1e-5)


def _halves(tm, corpus, tmp_path, name, cfgs):
    """The corpus's rows (one ingest) split over two shard indexes built
    with `cfgs`, saved; returns their paths."""
    full = tbeir.ingest(BEIRCorpusDataset(corpus), tm, str(tmp_path), name, index_cfg=_cfg(),
                        **KW)
    paths = []
    for r, cfg in enumerate(cfgs):
        rows = list(range(r, full.n_docs, 2))
        h = SparseIndex(tm.vocab_size, cfg, device="cpu")
        h.add_topk([full.doc_ids[i] for i in rows], full._tok_dev[rows].numpy().astype(np.int32),
                   full._docs_dev[rows].float().numpy())
        h.finalize()
        paths.append(str(tmp_path / f"{name}{r}"))
        h.save(paths[-1])
    return paths


def test_merge_saved_picks_auto_by_merged_size_and_keeps_escalation(models, synth, tmp_path):
    """An `auto` shard config resolves again on the merged size (45-doc
    shards stay on the scan below auto_threshold 60, the 90-doc merge takes
    the inverted engine with escalation); escalation stays on if any shard
    had it. Hits equal JAX's merge of the same shards (which keeps the
    shards' resolved engine): both are exact."""
    _, tm = models
    auto = IndexConfig(engine="auto", auto_threshold=60, l_max=32)
    paths = _halves(tm, synth[0], tmp_path, "auto", [auto, auto])
    assert all(json.load(open(os.path.join(p, "meta.json")))["engine"] == "sparse" for p in paths)
    merged = SparseIndex.merge_saved(paths, device="cpu")
    assert merged._engine == "inverted" and merged._exact_escalate
    jmerged = JIndex.merge_saved(paths)
    assert jmerged.doc_ids == merged.doc_ids
    q = tse.BatchEncoder(tm, max_length=64).encode_batch(list(synth[1].values()), inf_free=True)
    for g, w in zip(merged.search(torch.from_numpy(q), k=10), jmerged.search(q, k=10)):
        assert list(g) == list(w)
        np.testing.assert_allclose(list(g.values()), list(w.values()), rtol=1e-5)

    esc = _halves(tm, synth[0], tmp_path, "esc",
                  [IndexConfig(engine="inverted", l_max=32, exact_escalate=e)
                   for e in (False, True)])
    assert SparseIndex.merge_saved(esc, device="cpu")._exact_escalate
    assert JIndex.merge_saved(esc)._exact_escalate


def test_two_rank_ingest_rerun_into_the_same_out_dir(models, synth, tmp_path):
    """A second two-rank ingest into the same out_dir publishes a fresh
    statistic, not one doubled by the first round's count parts."""
    _, tm = models
    ds = BEIRCorpusDataset(synth[0])
    out = str(tmp_path / "rerun")

    def run(r):
        return tbeir.ingest(ds, tm, out, "mh", index_cfg=_cfg(), rank=r, world_size=2,
                            barrier_timeout=120.0, **KW)

    _threaded(run)
    first = np.load(os.path.join(out, "mh.corpus.npy"))
    _threaded(run)
    np.testing.assert_array_equal(np.load(os.path.join(out, "mh.corpus.npy")), first)


@pytest.mark.parametrize("pkg", [jbeir, tbeir], ids=["jax", "torch"])
def test_barrier_fails_fast_on_a_dead_rank(tmp_path, pkg):
    """A rank whose heartbeat exists but went stale past the grace is
    presumed dead: the barrier raises naming it, at once."""
    out = str(tmp_path)
    dead = pkg._Liveness(out, "mh", 1, 2, grace=2.0)
    dead.beat(force=True)
    past = time.time() - 60
    os.utime(dead.paths[1], (past, past))
    live = pkg._Liveness(out, "mh", 0, 2, grace=2.0)
    live.beat(force=True)
    t0 = time.time()
    with pytest.raises(RuntimeError, match="rank 1.*stale"):
        pkg._reduce_counts(out, "mh", 0, 2, np.zeros(8), 4, timeout=600.0, liveness=live)
    assert time.time() - t0 < 30


@pytest.mark.parametrize("pkg", [jbeir, tbeir], ids=["jax", "torch"])
def test_barrier_without_a_heartbeat_keeps_the_timeout(tmp_path, pkg):
    """A rank with no heartbeat may be slow to launch: a TimeoutError, not a
    death verdict."""
    live = pkg._Liveness(str(tmp_path), "mh", 0, 2, grace=2.0)
    live.beat(force=True)
    with pytest.raises(TimeoutError, match="never wrote"):
        pkg._reduce_counts(str(tmp_path), "mh", 0, 2, np.zeros(8), 4, timeout=1.0,
                           liveness=live)


def _eval_args(mod, tmp_path, **over):
    return mod.parse_config({
        "output_dir": str(tmp_path), "beir_datasets": "synthetic", "max_steps": 1,
        "arch": "tiny", "eval_max_seq_length": 64, "per_device_eval_batch_size": 32,
        "index_engine": "sparse", "index_l_max": 32, **over})


def test_evaluate_datasets_two_ranks_merge_and_search_like_jax(models, synth, tmp_path,
                                                              monkeypatch):
    """Every rank ingests its stripe, rank 0 merges and searches the whole
    corpus: its metrics equal JAX's one-process evaluation; a second call
    into the same eval_dir merges this round's shards."""
    jm, tm = models
    monkeypatch.setenv("METRICS_DIR", str(tmp_path / "metrics"))
    ma, da, ta = _eval_args(tconfig, tmp_path, device="cpu")
    eval_dir = str(tmp_path / "beir_eval")

    def run(rank):
        return tbeir.evaluate_datasets(["synthetic"], lambda name: synth, tm, ma, da, ta,
                                       eval_dir, rank=rank, world_size=2)

    r0, r1 = _threaded(run)
    assert r1 == {}
    merged = SparseIndex.load(os.path.join(eval_dir, "synthetic.index"), device="cpu")
    assert sorted(merged.doc_ids) == sorted(synth[0])
    jma, jda, jta = _eval_args(jconfig, tmp_path / "jax")
    want = jbeir.evaluate_datasets(["synthetic"], lambda name: synth, jm, jma, jda, jta,
                                   str(tmp_path / "jax_eval"), rank=0, world_size=1)
    assert want["NDCG@10"] > 0.8  # retrieval works, so the rankings compare
    for k in ("NDCG@10", "Recall@100"):
        assert r0[k] == pytest.approx(want[k], abs=1e-6), k
    for k in ("flops", "d_length", "q_length"):
        assert r0[k] == pytest.approx(want[k], rel=1e-6), k

    r0b, r1b = _threaded(run)
    assert r1b == {} and r0b["NDCG@10"] == r0["NDCG@10"] and r0b["flops"] == r0["flops"]


@pytest.mark.parametrize("engine,shard_by", [("sparse", "docs"), ("sparse", "queries"),
                                             ("inverted", "docs")])
def test_evaluate_datasets_on_a_mesh_like_jax(models, synth, tmp_path, monkeypatch, mesh8,
                                              engine, shard_by):
    """One process, the eval index sharded over an 8-position CPU mesh
    (doc- or query-sharded; the inverted engine with exact escalation): the
    metrics equal JAX's evaluate_datasets on mesh8 and the port's unsharded
    evaluation."""
    from opensearch_sparse_model_tuning_sample_torch.core.mesh import make_mesh

    jm, tm = models
    monkeypatch.setenv("METRICS_DIR", str(tmp_path / "metrics"))
    over = dict(index_engine=engine, index_shard_by=shard_by, index_postings_cap=16,
                index_exact_escalate=engine == "inverted")
    ma, da, ta = _eval_args(tconfig, tmp_path / "t", device="cpu", **over)
    got = tbeir.evaluate_datasets(["synthetic"], lambda name: synth, tm, ma, da, ta,
                                  str(tmp_path / "t_eval"), mesh=make_mesh(devices=["cpu"] * 8),
                                  rank=0, world_size=1)
    single = tbeir.evaluate_datasets(["synthetic"], lambda name: synth, tm, ma, da, ta,
                                     str(tmp_path / "t_single"), rank=0, world_size=1)
    jma, jda, jta = _eval_args(jconfig, tmp_path / "j", **over)
    want = jbeir.evaluate_datasets(["synthetic"], lambda name: synth, jm, jma, jda, jta,
                                   str(tmp_path / "j_eval"), mesh=mesh8, rank=0, world_size=1)
    assert want["NDCG@10"] > 0.8  # retrieval works, so the rankings compare
    for ref in (want, single):
        for k in ("NDCG@10", "Recall@100"):
            assert got[k] == pytest.approx(ref[k], abs=1e-6), k
        for k in ("flops", "d_length", "q_length"):
            assert got[k] == pytest.approx(ref[k], rel=1e-6), k
    if engine == "inverted":
        assert got["certified_frac"] == 1.0


def _key(rows):
    return sorted((r["query"], r["pos"], tuple(sorted(r["negs"]))) for r in rows)


def test_mining_two_ranks_matches_one_process_and_jax(models, tmp_path):
    """Every rank ingests its stripe, rank 0 merges, searches and writes;
    rank 1 writes nothing. The rows equal one process's and JAX's."""
    jm, tm = models
    corpus, queries, qrels = tbeir.synthetic_beir(n_docs=60, n_queries=6, seed=5)
    kw = dict(max_length=64, batch_size=32, result_size=5, inf_free=True)

    def run(rank):
        return tmine.mine_hard_negatives(
            corpus, queries, qrels, tm, out_dir=str(tmp_path / "multi"), index_name="mine",
            save_path=str(tmp_path / f"saved{rank}"), rank=rank, world_size=2, **kw)

    rows0, rows1 = _threaded(run)
    assert rows1 == [] and not os.path.exists(tmp_path / "saved1")
    assert os.path.isdir(tmp_path / "saved0")
    single = tmine.mine_hard_negatives(corpus, queries, qrels, tm,
                                       out_dir=str(tmp_path / "single"), index_name="mine", **kw)
    want = jmine.mine_hard_negatives(corpus, queries, qrels, jm,
                                     out_dir=str(tmp_path / "jax"), index_name="mine", **kw)
    assert len(rows0) > 0
    assert _key(rows0) == _key(single) == _key(want)


def test_two_cli_processes_evaluate_like_one(ckpt, tmp_path):
    """Two `cli.evaluate_beir` processes with RANK/WORLD_SIZE and no
    rendezvous (the card's two-rank run, here with `--device cpu`): both
    exit 0, rank 0 writes the metrics of the whole corpus, equal to one
    process's."""
    cfg = {"model_name_or_path": ckpt, "idf_path": IDF, "inf_free": True,
           "beir_datasets": "synthetic", "eval_max_seq_length": 64,
           "per_device_eval_batch_size": 32, "index_l_max": 64, "compute_dtype": "float32",
           "output_dir": str(tmp_path / "two"), "device": "cpu"}
    path = tmp_path / "eval.yaml"
    path.write_text(yaml.dump(cfg))
    cmd = [sys.executable, "-m", "opensearch_sparse_model_tuning_sample_torch.cli.evaluate_beir",
           str(path), "--model_name_or_path", ckpt]
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", OMP_NUM_THREADS="1",
                   METRICS_DIR=str(tmp_path / "metrics"))
        for k in ("MASTER_ADDR", "MASTER_PORT", "OSSMT_COORDINATOR"):
            env.pop(k, None)
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{o[-3000:]}"
    eval_dir = tmp_path / "two" / "beir_eval_64"
    two = json.load(open(eval_dir / "avg_res.json"))
    assert sorted(os.listdir(eval_dir / "synthetic.index.shard1of2")) == [
        ".done", "doc_ids.json", "index.npz", "meta.json"]
    merged = SparseIndex.load(str(eval_dir / "synthetic.index"), device="cpu")
    assert sorted(merged.doc_ids) == sorted(tbeir.load_synthetic("synthetic", "test")[0])

    from opensearch_sparse_model_tuning_sample_torch.cli import evaluate_beir

    one = evaluate_beir.main(dict(cfg, output_dir=str(tmp_path / "one"),
                                  model_name_or_path=ckpt))
    assert one["NDCG@10"] > 0.8
    for k in ("NDCG@10", "flops", "d_length", "q_length"):
        assert two[k] == pytest.approx(one[k], rel=1e-9), k
