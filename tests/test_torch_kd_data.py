"""The port's distillation data against the JAX package's: the kd-ids
dataset, the collator's teacher features (native teachers at the shared
bucket, host teachers' raw texts, remote teachers' embeddings prefetched
through a `LocalVectorStore`), the embedding store itself, `cli.train_ir`
on both kd recipes' shapes (`--device cpu`, tiny), and `cli.make_kd_scores`
against `tools/make_kd_scores.py` on the same posnegs rows and teacher.

Batches and rows are held equal, bit for bit; the teacher scores that
`make_kd_scores` writes (bf16 compute, dot products of two packages'
reps) to 3e-2 relative, and its doc order to the JAX tool's up to pairs
whose scores lie within that tolerance.
"""

import os
import sys

import numpy as np
import pytest
import torch
import yaml

from opensearch_sparse_model_tuning_sample_tpu.data import collator as jcol
from opensearch_sparse_model_tuning_sample_tpu.data import datasets as jds
from opensearch_sparse_model_tuning_sample_tpu.models import hf_import as jhf
from opensearch_sparse_model_tuning_sample_tpu.train import embedding_store as jstore
from opensearch_sparse_model_tuning_sample_tpu.train import teachers as jt
from opensearch_sparse_model_tuning_sample_torch.cli import make_kd_scores, train_ir
from opensearch_sparse_model_tuning_sample_torch.data import collator as tcol
from opensearch_sparse_model_tuning_sample_torch.data import datasets as tds
from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import WordPieceTokenizer as TTok
from opensearch_sparse_model_tuning_sample_torch.train import embedding_store as tstore
from opensearch_sparse_model_tuning_sample_torch.train import teachers as tt

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ("sparse retrieval index query document token paris france learning model "
         "tensor attention layer inverted posting score rank bert encoder vocabulary").split()


def _text(rng, lo, hi):
    return " ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))


def _kd_ids_rows(n, seed, n_docs=6):
    rng = np.random.default_rng(seed)
    return [{"query": _text(rng, 2, 6), "q_id": 100 + i,
             "docs": [_text(rng, 3, 70) for _ in range(n_docs)],
             "d_ids": [int(x) for x in rng.choice(40, n_docs, replace=False)],
             "scores": rng.normal(size=n_docs).tolist(), "first_rank": int(rng.integers(-1, 12))}
            for i in range(n)]


def _same(a, b, path="batch"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, np.ndarray):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, str):
        assert a == b, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    """A store with model 7's query and doc tables (two appends to the doc
    table: a later id wins), written by the JAX package's store."""
    root = str(tmp_path_factory.mktemp("store"))
    rng = np.random.default_rng(0)
    s = jstore.LocalVectorStore(root)
    s.store("vector_q", 7, list(range(100, 112)), rng.normal(size=(12, 24)))
    s.store("vector", 7, list(range(40)), rng.normal(size=(40, 24)))
    s.store("vector", 7, [3, 5], rng.normal(size=(2, 24)))
    return root


def test_kd_ids_dataset_matches_jax():
    rows = _kd_ids_rows(9, seed=1)
    kw = dict(sample_num=3, swap_times=1, first_rank_thresh=9, shuffle_seed=4)
    jd, td = jds.KnowledgeDistillIdsDataset(rows, **kw), tds.KnowledgeDistillIdsDataset(rows, **kw)
    assert len(td) == len(jd) > 0
    assert [td[i] for i in range(len(td))] == [jd[i] for i in range(len(jd))]
    assert tds.DATASET_CLS_MAP["kd-ids"] is tds.KnowledgeDistillIdsDataset


def test_store_reads_and_prefetch_match_jax(store_root):
    tb, jb = tstore.LocalVectorStore(store_root), jstore.LocalVectorStore(store_root)
    ids = [3, 0, 5, 39]
    np.testing.assert_array_equal(tb.get("vector", 7, ids), jb.get("vector", 7, ids))
    with pytest.raises(ValueError, match="dim mismatch"):
        tb.store("vector", 7, [1], np.zeros((1, 8)))
    es = tstore.EmbeddingStore(tb, max_workers=3)
    try:
        keys = [list(range(i, i + 4)) for i in range(0, 36, 4)]
        for k in keys + keys[:2]:  # registered twice: fetched twice, read once
            es.register_task("vector", 7, k)
        for k in keys + keys[:2]:
            np.testing.assert_array_equal(es.fetch_embedding("vector", 7, k),
                                          jb.get("vector", 7, k))
        assert not es.registered_tasks and not es.fetched and not es.events
        es.register_task("vector", 7, [999])  # an id the table lacks
        with pytest.raises(RuntimeError, match="Task failed"):
            es.fetch_embedding("vector", 7, [999])
        with pytest.raises(ValueError, match="not registered"):
            es.fetch_embedding("vector", 7, [1])
    finally:
        es.shutdown()
    with pytest.raises(RuntimeError):
        es.pool.submit(lambda: None)  # shut down


def _collators(kind, toks, store_root, ckpt):
    """The same collator in both packages: `ids` (teacher_tokenizer_ids: a
    checkpoint's tokenizer and a remote id), or `ensemble` (a sparse
    preset, a remote and a host teacher, specs taken from the ensemble)."""
    out = []
    for col, store_mod, tmod, tok in ((jcol, jstore, jt, toks[0]), (tcol, tstore, tt, toks[1])):
        store = store_mod.EmbeddingStore(store_mod.LocalVectorStore(store_root))
        if kind == "ids":
            c = col.build_collator("kd-ids", tok, 128, teacher_tokenizer_ids=[ckpt, "7"],
                                   seq_buckets=[16, 32, 64, 128], embedding_store=store)
        else:
            ens = tmod.TeacherEnsemble([
                tmod.Teacher(kind="sparse", tokenizer=TTok.from_pretrained(None) if tmod is tt
                             else jt.WordPieceTokenizer.from_pretrained(None)),
                tmod.Teacher(kind="remote", model_id="store:x"),
                tmod.Teacher(kind="hf")])
            c = col.build_collator("kd-ids", tok, 128, teacher_tokenizer_ids=["", "7"],
                                   seq_buckets=[16, 32, 64, 128], embedding_store=store,
                                   teacher_ensemble=ens)
        out.append((c, store))
    return out


@pytest.mark.parametrize("kind", ["ids", "ensemble"])
def test_kd_ids_batches_with_teacher_features_match_jax(kind, store_root, tiny_model, tmp_path):
    ckpt = str(tmp_path / "teacher")
    jhf.save_checkpoint(tiny_model, ckpt)
    toks = (jt.WordPieceTokenizer.from_pretrained(None), TTok.from_pretrained(None))
    rows = _kd_ids_rows(4, seed=2)
    for r in rows:
        r["first_rank"] = 1
    ds = tds.KnowledgeDistillIdsDataset(rows, sample_num=2)
    items = [ds[i] for i in range(4)]
    (jc, js), (tc, ts) = _collators(kind, toks, store_root, ckpt)
    try:
        jb, tb = jc.resolve_pending(jc(items)), tc.resolve_pending(tc(items))
    finally:
        js.shutdown(), ts.shutdown()
    _same(tb, jb)
    assert len(tb["teacher_q"]) == (2 if kind == "ids" else 3)
    remote = tb["teacher_d"][1]["embeddings"]
    assert remote.shape == (8, 24) and remote.dtype == np.float16
    if kind == "ensemble":
        assert tb["teacher_q"][2] == {"texts": tuple(it[0] for it in items)}
    # a native teacher's features sit at the student's bucket
    assert tb["teacher_d"][0]["input_ids"].shape == tb["d_input_ids"].shape


def test_remote_teacher_without_a_store_raises():
    with pytest.raises(ValueError, match="no embedding store"):
        tcol.build_collator("kd-ids", TTok.from_pretrained(None), 64, teacher_tokenizer_ids=["7"])


def _train_cfg(tmp, **over):
    cfg = {"inf_free": True, "arch": "tiny", "idf_path": os.path.join(REPO, "assets", "idf.npz"),
           "max_seq_length": 64, "seq_buckets": [32, 64], "sample_num_one_query": 2,
           "loss_types": ["kldiv"], "flops_d_lambda": 0.01, "flops_d_T": 20,
           "output_dir": str(tmp / "out"), "per_device_train_batch_size": 4, "max_steps": 3,
           "warmup_steps": 1, "learning_rate": 5e-4, "logging_steps": 1,
           "save_strategy": "steps", "save_steps": 3, "device": "cpu"}
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("recipe", ["kd", "kd-ids-remote"])
def test_train_ir_runs_the_kd_recipes(recipe, store_root, tmp_path, monkeypatch):
    """`cli.train_ir` builds the ensemble before the collator: two sparse
    teachers on posnegs rows with in-batch negatives (the kd recipe's
    shape), or a remote teacher on kd-ids rows through the store, which is
    shut down when the run ends."""
    import datasets as hfds

    rng = np.random.default_rng(3)
    if recipe == "kd":
        rows = [{"query": _text(rng, 2, 6), "pos": _text(rng, 3, 30),
                 "negs": [_text(rng, 3, 30) for _ in range(3)]} for _ in range(16)]
        over = dict(data_type="posnegs", use_in_batch_negatives=True,
                    kd_ensemble_teacher_kwargs={"types": ["sparse", "sparse"],
                                                "model_ids": ["tiny", "tiny"], "score_scale": 30})
    else:
        rows = _kd_ids_rows(12, seed=3)
        for r in rows:
            r["q_id"] = 100 + r["q_id"] % 12
            r["first_rank"] = 1
        over = dict(data_type="kd-ids", use_in_batch_negatives=False,
                    kd_ensemble_teacher_kwargs={"types": ["remote"], "model_ids": ["store:x"],
                                                "teacher_tokenizer_ids": ["7"],
                                                "store_root": store_root})
    hfds.Dataset.from_list(rows).save_to_disk(str(tmp_path / "train"))
    cfg = _train_cfg(tmp_path, train_file=str(tmp_path / "train"), **over)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.dump(cfg))
    shut = []
    orig = tstore.EmbeddingStore.shutdown
    monkeypatch.setattr(tstore.EmbeddingStore, "shutdown",
                        lambda self: (shut.append(self), orig(self))[-1])
    trainer = train_ir.main(str(path))
    assert trainer.step == 3 and trainer.teacher_ensemble is not None
    assert [t.kind for t in trainer.teacher_ensemble.teachers] == over[
        "kd_ensemble_teacher_kwargs"]["types"]
    assert all(np.isfinite(h["ranking_loss"]) for h in trainer.log_history)
    assert os.path.isdir(tmp_path / "out" / "checkpoint-3")
    assert len(shut) == (1 if recipe == "kd-ids-remote" else 0)
    for store in shut:
        assert not any(t.is_alive() for t in store.pool._threads)


@pytest.fixture(scope="module")
def posnegs_dir(tmp_path_factory):
    import datasets as hfds

    rng = np.random.default_rng(4)
    rows = [{"query": _text(rng, 2, 6), "pos": _text(rng, 5, 40),
             "negs": [_text(rng, 5, 40) for _ in range(int(rng.integers(2, 7)))]}
            for _ in range(10)]
    d = str(tmp_path_factory.mktemp("posnegs") / "train")
    hfds.Dataset.from_list(rows).save_to_disk(d)
    return d


def test_make_kd_scores_matches_the_tool(posnegs_dir, tiny_model, tmp_path):
    import datasets as hfds

    sys.path.insert(0, REPO)
    from tools import make_kd_scores as tool

    ckpt = str(tmp_path / "teacher")
    jhf.save_checkpoint(tiny_model, ckpt)
    argv = ["--posnegs", posnegs_dir, "--teacher", ckpt, "--docs-per-query", "5",
            "--random-negs", "2", "--seed", "3", "--batch-size", "8"]
    tool.main(argv + ["--out", str(tmp_path / "jax")])
    make_kd_scores.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    want = hfds.Dataset.load_from_disk(str(tmp_path / "jax")).to_list()
    got = hfds.Dataset.load_from_disk(str(tmp_path / "port")).to_list()
    assert [r["query"] for r in got] == [r["query"] for r in want] and len(got) == 10
    for g, w in zip(got, want):
        assert sorted(g["docs"]) == sorted(w["docs"]) and len(g["docs"]) == 5
        ws = dict(zip(w["docs"], w["scores"]))
        np.testing.assert_allclose(g["scores"], [ws[d] for d in g["docs"]], rtol=3e-2)
        assert g["scores"] == sorted(g["scores"], reverse=True)
        # where the order differs from the tool's, the two docs' scores tie
        # within the tolerance
        for a, b in zip(g["docs"], g["docs"][1:]):
            if w["docs"].index(a) > w["docs"].index(b):
                assert abs(ws[a] - ws[b]) <= 3e-2 * max(abs(ws[a]), abs(ws[b])), (a, b)
