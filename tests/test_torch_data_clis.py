"""The port's MS MARCO / MIRACL data path and its data CLIs, held to the
JAX package's on the same local fixtures (written here; nothing is
downloaded): `prepare_msmarco_kd` and `cli.prepare_msmarco` on an id-based
hard-negative `save_to_disk` dir and a BEIR-format msmarco dir with
mojibake, `MsMarcoKDDataset` with its latin1 -> utf-8 repair, both MIRACL
datasets, and `cli.import_metrics`. Host code only: every output must be
equal, item for item.
"""

import json
import os
import subprocess
import sys

import pytest

from opensearch_sparse_model_tuning_sample_tpu.cli import import_metrics as jim
from opensearch_sparse_model_tuning_sample_tpu.cli import prepare_msmarco as jprep
from opensearch_sparse_model_tuning_sample_tpu.data import datasets as jds
from opensearch_sparse_model_tuning_sample_tpu.eval.metrics_sink import read_metrics
from opensearch_sparse_model_tuning_sample_tpu.mine import hard_negatives as jmine
from opensearch_sparse_model_tuning_sample_torch.cli import import_metrics as tim
from opensearch_sparse_model_tuning_sample_torch.cli import prepare_msmarco as tprep
from opensearch_sparse_model_tuning_sample_torch.data import datasets as tds
from opensearch_sparse_model_tuning_sample_torch.mine import hard_negatives as tmine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOJIBAKE = "café crème".encode("utf-8").decode("latin1")  # 'cafÃ© crÃ¨me'


@pytest.fixture()
def msmarco(tmp_path):
    """A BEIR-format msmarco dir (one doc in mojibake) and an id-based
    hard-negative dataset with scores and a first_rank column."""
    import datasets as hfds

    d = tmp_path / "msmarco"
    (d / "qrels").mkdir(parents=True)
    with open(d / "corpus.jsonl", "w", encoding="utf-8") as f:
        for i in range(8):
            text = MOJIBAKE if i == 3 else f"passage {i} about topic {i % 3}"
            f.write(json.dumps({"_id": f"p{i}", "title": f"title {i}", "text": text}) + "\n")
    with open(d / "queries.jsonl", "w", encoding="utf-8") as f:
        for i in range(3):
            f.write(json.dumps({"_id": f"q{i}", "text": f"question {i}"}) + "\n")
    (d / "qrels" / "train.tsv").write_text(
        "query-id\tcorpus-id\tscore\n" + "".join(f"q{i}\tp{i}\t1\n" for i in range(3)))
    rows = [{"query": f"q{i}", "docs": [f"p{(i + j) % 8}" for j in range(4)],
             "scores": [4.0 - j + 0.5 * i for j in range(4)], "first_rank": i * 7}
            for i in range(3)]
    hn = tmp_path / "hn"
    hfds.Dataset.from_list(rows).save_to_disk(str(hn))
    return d, hn, rows


def _rows(path):
    import datasets as hfds

    return hfds.Dataset.load_from_disk(str(path)).to_list()


def test_prepare_msmarco_kd_matches_jax(msmarco, tmp_path):
    d, _, rows = msmarco
    corpus = {f"p{i}": (MOJIBAKE if i == 3 else f"passage {i} about topic {i % 3}")
              for i in range(8)}
    queries = {f"q{i}": f"question {i}" for i in range(3)}
    got = tmine.prepare_msmarco_kd(rows, corpus, queries, str(tmp_path / "t"))
    want = jmine.prepare_msmarco_kd(rows, corpus, queries, str(tmp_path / "j"))
    assert got == want and _rows(tmp_path / "t") == _rows(tmp_path / "j")
    assert got[0]["docs"][3] == "café crème"  # the repair
    assert [r["first_rank"] for r in got] == [0, 7, 14]  # extra columns carried


def test_prepare_msmarco_cli_matches_jax_and_trains_as_kd_data(msmarco, tmp_path):
    d, hn, _ = msmarco
    tprep.main(["--hard-negatives", str(hn), "--msmarco-dir", str(d),
                "--out", str(tmp_path / "t")])
    jprep.main(["--hard-negatives", str(hn), "--msmarco-dir", str(d),
                "--out", str(tmp_path / "j")])
    got = _rows(tmp_path / "t")
    assert got == _rows(tmp_path / "j")
    assert "café crème" in got[0]["docs"]
    kw = dict(swap_times=0, sample_num_one_query=2, first_rank_thresh=10, score_scale=2.0,
              shuffle_seed=0)
    tk = tds.load_dataset(str(tmp_path / "t"), "kd", **kw)
    jk = jds.load_dataset(str(tmp_path / "j"), "kd", **kw)
    assert len(tk) == len(jk) == 4  # first_rank 14 is past the threshold: 2 rows x 2 groups
    assert [tk[i] for i in range(len(tk))] == [jk[i] for i in range(len(jk))]


def test_prepare_msmarco_cli_runs_as_a_module(msmarco, tmp_path):
    d, hn, _ = msmarco
    out = subprocess.run(
        [sys.executable, "-m", "opensearch_sparse_model_tuning_sample_torch.cli.prepare_msmarco",
         "--hard-negatives", str(hn), "--msmarco-dir", str(d), "--out", str(tmp_path / "o")],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert len(_rows(tmp_path / "o")) == 3


def test_msmarco_kd_dataset_matches_jax(tmp_path):
    score_path = tmp_path / "scores.json"
    json.dump({"7": {"doc_id": ["d1", "d2", "d3", "d4"], "score": [4.0, 3.0, 2.0, 1.0]},
               "8": {"doc_id": ["d4", "d3"], "score": [1.5, 0.5]}}, open(score_path, "w"))
    corpus = {f"d{i}": {"text": MOJIBAKE if i == 2 else f"text {i}"} for i in range(1, 5)}
    queries = {"7": "the query", "8": "another"}
    kw = dict(corpus=corpus, queries=queries, sample_num=2, score_scale=3.0)
    got = tds.MsMarcoKDDataset(str(score_path), **kw)
    want = jds.MsMarcoKDDataset(str(score_path), **kw)
    assert len(got) == len(want) == 3
    assert [got[i] for i in range(3)] == [want[i] for i in range(3)]
    assert got[1] == ("the query", ["café crème", "text 4"], [9.0, 3.0])
    with pytest.raises(ValueError, match="local corpus"):
        tds.MsMarcoKDDataset(str(score_path))


@pytest.mark.parametrize("text", [MOJIBAKE, "plain", "naïve ☃", "Ã"])
def test_transform_str_matches_jax(text):
    assert tds.MsMarcoKDDataset.transform_str(text) == jds.MsMarcoKDDataset.transform_str(text)


def test_miracl_datasets_match_jax():
    corpus = [{"docid": "m1", "title": "T", "text": "body"},
              {"docid": "m2", "title": "", "text": MOJIBAKE}]
    for transform in (None, str.upper, tds.MsMarcoKDDataset.transform_str):
        got = tds.MiraclCorpusDataset(corpus, transform_lambda=transform)
        want = jds.MiraclCorpusDataset(corpus, transform_lambda=transform)
        assert len(got) == len(want) == 2
        assert [got[i] for i in range(2)] == [want[i] for i in range(2)]
    train = [{"query": "q", "positive_passages": [{"text": "p1"}, {"text": "p2"}],
              "negative_passages": [{"text": "n1"}, {"text": "n2"}]},
             {"query": "r", "positive_passages": [{"text": "p3"}], "negative_passages": []}]
    got, want = tds.MiraclTrainingDataset(train), jds.MiraclTrainingDataset(dataset=train)
    assert len(got) == len(want) == 3
    assert [got[i] for i in range(3)] == [want[i] for i in range(3)]
    assert got[1] == {"query": "q", "pos": "p2", "negs": ["n1", "n2"]}
    with pytest.raises(ValueError, match="local rows"):
        tds.MiraclTrainingDataset()


def test_import_metrics_cli_matches_jax(tmp_path, monkeypatch):
    run = tmp_path / "output" / "run1"
    (run / "beir_eval_2p").mkdir(parents=True)
    (run / "beir_eval_2p" / "avg_res.json").write_text(json.dumps({"NDCG@10": 0.5}))
    (run / "nano_beir_eval").mkdir(parents=True)
    (run / "nano_beir_eval" / "avg_res_step500.json").write_text(json.dumps({"NDCG@10": 0.4}))
    (run / "other").mkdir()
    (run / "other" / "avg_res.json").write_text(json.dumps({"NDCG@10": 0.1}))  # skipped
    ledgers = {}
    for name, main in (("torch", tim.main), ("jax", jim.main)):
        monkeypatch.setenv("METRICS_DIR", str(tmp_path / name))
        main([str(tmp_path / "output")])
        ledgers[name] = {i: [{k: v for k, v in r.items() if k != "timestamp"}
                             for r in read_metrics(i)]
                         for i in ("beir_eval", "nano_beir_eval")}
    assert ledgers["torch"] == ledgers["jax"]
    assert ledgers["torch"]["beir_eval"][0]["_id"].endswith("run1_2p")
    assert ledgers["torch"]["nano_beir_eval"][0]["_id"].endswith("run1_step500")
    for path in (run / "beir_eval_2p" / "avg_res.json", run / "other" / "avg_res.json"):
        assert tim.infer_index_and_id(str(path)) == jim.infer_index_and_id(str(path))
