"""The training data pipeline: the same rows and seed give the same batches in
both packages, bit for bit: dataset grouping, the collator's ids, masks and
bucket lengths, the DataLoader's order across epochs (with and without the
prefetch thread, and over a combined multi-dataset), and `epochs`' exact
resume."""

import numpy as np
import pytest

from opensearch_sparse_model_tuning_sample_tpu.data import collator as jcol
from opensearch_sparse_model_tuning_sample_tpu.data import datasets as jds
from opensearch_sparse_model_tuning_sample_tpu.data import loader as jld
from opensearch_sparse_model_tuning_sample_tpu.models.tokenizer import WordPieceTokenizer as JTok
from opensearch_sparse_model_tuning_sample_torch.data import collator as tcol
from opensearch_sparse_model_tuning_sample_torch.data import datasets as tds
from opensearch_sparse_model_tuning_sample_torch.data import loader as tld
from opensearch_sparse_model_tuning_sample_torch.models.tokenizer import WordPieceTokenizer as TTok

WORDS = ("sparse retrieval index query document token paris france learning model "
         "tensor attention layer inverted posting score rank bert encoder vocabulary").split()


def _text(rng, lo, hi):
    return " ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))


def _posnegs_rows(n, seed):
    rng = np.random.default_rng(seed)
    # doc lengths from a few tokens to past 64, so batches land in 32 / 64 / 128
    return [{"query": _text(rng, 2, 6), "pos": _text(rng, 3, 90),
             "negs": [_text(rng, 3, 90) for _ in range(int(rng.integers(1, 8)))]}
            for _ in range(n)]


def _kd_rows(n, seed):
    rng = np.random.default_rng(seed)
    return [{"query": _text(rng, 2, 6), "docs": [_text(rng, 3, 40) for _ in range(6)],
             "scores": rng.normal(size=6).tolist(), "first_rank": int(rng.integers(-1, 12))}
            for _ in range(n)]


@pytest.fixture(scope="module")
def toks():
    return JTok.from_pretrained(None), TTok.from_pretrained(None)


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def _pipeline(pkg, tok, dataset, data_type, batch_size, seed, prefetch, max_steps, start=0):
    col, ld = (jcol, jld) if pkg == "jax" else (tcol, tld)
    collator = col.build_collator(data_type, tok, 128, seq_buckets=[32, 64, 128])
    loader = ld.DataLoader(dataset, batch_size=batch_size, collate_fn=collator,
                           drop_last=True, seed=seed, prefetch=prefetch)
    return list(ld.epochs(loader, max_steps, start=start)), len(loader)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_posnegs_batches_match_jax(toks, prefetch):
    rows = _posnegs_rows(20, seed=1)
    jd, td = jds.PosNegsDataset(rows, sample_num=2), tds.PosNegsDataset(rows, sample_num=2)
    assert jd.items == td.items
    # 12 steps of 4 rows cross an epoch boundary (a reshuffle)
    jb, n = _pipeline("jax", toks[0], jd, "posnegs", 4, 7, 0, 12)
    tb, _ = _pipeline("torch", toks[1], td, "posnegs", 4, 7, prefetch, 12)
    assert n < 12
    _same_batches(jb, tb)
    assert {b["d_input_ids"].shape[1] for b in tb} <= {32, 64, 128}
    assert tb[0]["d_input_ids"].shape[0] == 4 * 3  # group-major, pos first


@pytest.mark.parametrize("swap_times", [0, 2, 10])
def test_kd_batches_match_jax(toks, swap_times):
    rows = _kd_rows(12, seed=2)
    kw = dict(sample_num=3, swap_times=swap_times, first_rank_thresh=8, score_scale=2.0,
              shuffle_seed=5)
    jd, td = jds.KnowledgeDistillDataset(rows, **kw), tds.KnowledgeDistillDataset(rows, **kw)
    assert jd.groups == td.groups and len(td) > 0
    jb, _ = _pipeline("jax", toks[0], jd, "kd", 3, 3, 0, 5)
    tb, _ = _pipeline("torch", toks[1], td, "kd", 3, 3, 0, 5)
    _same_batches(jb, tb)
    assert tb[0]["scores"].shape == (3, 3)


@pytest.mark.parametrize("start", [1, 5, 13])
def test_exact_resume_matches_the_uninterrupted_stream(toks, start):
    """`epochs(start=k)` yields batches k.. of the uninterrupted run, in
    both packages, mid-epoch and across an epoch boundary."""
    rows = _posnegs_rows(30, seed=3)
    td = tds.PosNegsDataset(rows, sample_num=2)
    full, per_epoch = _pipeline("torch", toks[1], td, "posnegs", 4, 11, 0, 16)
    tail, _ = _pipeline("torch", toks[1], td, "posnegs", 4, 11, 2, 16, start=start)
    jtail, _ = _pipeline("jax", toks[0], jds.PosNegsDataset(rows, sample_num=2), "posnegs",
                         4, 11, 0, 16, start=start)
    assert per_epoch < 16
    _same_batches(full[start:], tail)
    _same_batches(jtail, tail)


def test_combined_datasets_from_disk_match_jax(toks, tmp_path):
    """load_datasets over HF save_to_disk dirs: homogeneous batches from
    one dataset each, the same visiting order in both packages."""
    import datasets as hfds

    for i, n in enumerate((17, 9)):
        hfds.Dataset.from_list(_posnegs_rows(n, seed=10 + i)).save_to_disk(
            str(tmp_path / f"part{i}"))
    kw = dict(sample_num_one_query=1, shuffle_seed=0)
    jd = jds.load_datasets(str(tmp_path), "posnegs", rank=0, world_size=1, **kw)
    td = tds.load_datasets(str(tmp_path), "posnegs", **kw)
    assert len(jd) == len(td)
    jb, _ = _pipeline("jax", toks[0], jd, "posnegs", 3, 4, 0, 12)
    tb, _ = _pipeline("torch", toks[1], td, "posnegs", 3, 4, 0, 12)
    _same_batches(jb, tb)


def test_single_dir_load_and_shards_match_jax(tmp_path):
    import datasets as hfds

    rows = _kd_rows(10, seed=4)
    hfds.Dataset.from_list(rows).save_to_disk(str(tmp_path / "kd"))
    kw = dict(sample_num_one_query=2, swap_times=1, first_rank_thresh=9, shuffle_seed=3)
    jd = jds.load_dataset(str(tmp_path / "kd"), "kd", **kw)
    td = tds.load_dataset(str(tmp_path / "kd"), "kd", **kw)
    assert [jd[i] for i in range(len(jd))] == [td[i] for i in range(len(td))]
    for rank in range(3):
        a = jds.HostShardDataset(jd, rank, 3, drop=True, shuffle=True, seed=1)
        b = tds.HostShardDataset(td, rank, 3, drop=True, shuffle=True, seed=1)
        assert a.idxs == b.idxs


def test_partial_shuffle_and_pad_feat_match_jax():
    for swaps in (0, 1, 3, 50):
        assert (jds.partial_shuffle(list(range(20)), swaps, rng=np.random.default_rng(9))
                == tds.partial_shuffle(list(range(20)), swaps, rng=np.random.default_rng(9)))
    f = {"input_ids": np.arange(6, dtype=np.int32).reshape(2, 3),
         "attention_mask": np.ones((2, 3), np.int32)}
    for L in (3, 8):
        a = jcol._CollatorBase._pad_feat(f, L, 0)
        b = tcol._CollatorBase._pad_feat(f, L, 0)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("what", ["kd-ids", "teachers"])
def test_teacher_features_wait_for_their_roadmap_item(toks, what):
    """The kd-ids rows and a native teacher's features (its own tokenizer,
    at the batch's shared bucket) give JAX's batches; the remote and host
    teachers' features are held in tests/test_torch_kd_data.py."""
    rows = _kd_rows(6, seed=8)
    for i, r in enumerate(rows):
        r.update(first_rank=1, q_id=i, d_ids=list(range(10 * i, 10 * i + 6)))
    kind, tids = ("kd-ids", ()) if what == "kd-ids" else ("kd", ("bert-base-uncased",))
    batches = []
    for ds, col, tok in ((jds, jcol, toks[0]), (tds, tcol, toks[1])):
        data = ds.DATASET_CLS_MAP[kind](rows, sample_num=3)
        c = col.build_collator(kind, tok, 128, teacher_tokenizer_ids=tids,
                               seq_buckets=[32, 64, 128])
        batches.append(c([data[i] for i in range(4)]))
    jb, tb = batches
    assert tb.keys() == jb.keys()
    assert ("teacher_q" in tb) == (what == "teachers") and "scores" in tb
    for k in tb:
        if k.startswith("teacher"):  # one feature dict per teacher
            _same_batches(tb[k], jb[k])
        else:
            _same_batches([{k: tb[k]}], [{k: jb[k]}])


def test_loader_hands_worker_errors_to_the_consumer():
    def bad(rows):
        raise KeyError("boom")

    loader = tld.DataLoader(list(range(8)), batch_size=2, collate_fn=bad, prefetch=2)
    with pytest.raises(KeyError):
        list(loader)
