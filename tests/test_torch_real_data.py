"""The port's real-data entry points against the JAX package's, on the
fixtures of tests/test_real_data.py written to `tmp_path` (no download):

  * the BEIR loaders: `load_beir_dir` (qrels header sniffing, empty qrels,
    split selection), `load_beir_hf_disk` (a qrels split without a score
    column) and `load_dataset_auto`, and `cli.evaluate_beir` over a
    `beir_dir` (`device: cpu`, both packages from one checkpoint);
  * the official checkpoint layout (doc-v2-mini's files at tiny widths):
    `pytorch_model.bin` with tf-era `gamma`/`beta` keys, modern keys as
    safetensors, and the `idf.json` token map, through
    `hf_import._read_state_dict` / `_canon_bert` and `build_model`.

The loaders return equal Python objects, the state dicts and parameters are
bit-equal (the same file read into fp32 by both), and the inference-free
query weight of a token is its IDF. The evaluation metrics agree to 1e-6
absolute: both packages score the same fp32 weights, in other orders.
"""

import os

import jax
import numpy as np
import pytest
import torch

from opensearch_sparse_model_tuning_sample_tpu.cli import evaluate_beir as jeval_cli
from opensearch_sparse_model_tuning_sample_tpu.eval import beir as jbeir
from opensearch_sparse_model_tuning_sample_tpu.models import hf_import as jhf
from opensearch_sparse_model_tuning_sample_tpu.models import sparse_encoder as jse
from opensearch_sparse_model_tuning_sample_torch.cli import evaluate_beir as teval_cli
from opensearch_sparse_model_tuning_sample_torch.eval import beir as tbeir
from opensearch_sparse_model_tuning_sample_torch.models import hf_import as thf
from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
from opensearch_sparse_model_tuning_sample_torch.models.convert import params_from_jax
from test_real_data import _write_official_ckpt, tiny_beir_data, write_beir_dir

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("header", [True, False])
def test_load_beir_dir_header_sniffing_matches_jax(tmp_path, header):
    corpus, queries, qrels = tiny_beir_data()
    write_beir_dir(str(tmp_path / "ds"), corpus, queries, qrels, header=header)
    got = tbeir.load_beir_dir(str(tmp_path / "ds"))
    assert got == jbeir.load_beir_dir(str(tmp_path / "ds"))
    assert got[2] == {"q1": {"d1": 1}, "q2": {"d2": 2, "d3": 0}}
    assert set(got[1]) == {"q1", "q2"} and got[0]["d3"]["text"] == ""


def test_load_beir_dir_empty_qrels_and_splits_match_jax(tmp_path):
    corpus, queries, qrels = tiny_beir_data()
    write_beir_dir(str(tmp_path / "empty"), corpus, queries, {})
    got = tbeir.load_beir_dir(str(tmp_path / "empty"))
    assert got == jbeir.load_beir_dir(str(tmp_path / "empty"))
    assert got[1] == {} and got[2] == {} and len(got[0]) == 3

    d = str(tmp_path / "ds")
    write_beir_dir(d, corpus, queries, qrels, split="train")
    write_beir_dir(d, corpus, queries, {"q1": {"d1": 1}}, split="test")
    for split in ("train", "test"):
        assert tbeir.load_beir_dir(d, split=split) == jbeir.load_beir_dir(d, split=split)
    assert tbeir.load_beir_dir(d, split="test")[2] == {"q1": {"d1": 1}}


def test_load_beir_hf_disk_and_auto_match_jax(tmp_path):
    import datasets as hfds

    root = tmp_path / "hfds"
    hfds.Dataset.from_list([{"_id": "d1", "title": "paris", "text": "capital of france"},
                            {"_id": "d2", "title": "", "text": "tpu systolic arrays"}]
                           ).save_to_disk(str(root / "corpus"))
    hfds.Dataset.from_list([{"_id": "q1", "text": "france capital"},
                            {"_id": "q8", "text": "no judgments"}]
                           ).save_to_disk(str(root / "queries"))
    hfds.Dataset.from_list([{"query-id": "q1", "corpus-id": "d1"}]  # no score column
                           ).save_to_disk(str(root / "qrels"))
    got = tbeir.load_beir_hf_disk(str(root))
    assert got == jbeir.load_beir_hf_disk(str(root))
    assert got[2] == {"q1": {"d1": 1}} and set(got[1]) == {"q1"}
    # load_dataset_auto routes by layout: an HF dir, and a BEIR zip dir
    assert tbeir.load_dataset_auto(str(tmp_path), "hfds") == got
    corpus, queries, qrels = tiny_beir_data()
    write_beir_dir(str(tmp_path / "zip"), corpus, queries, qrels)
    assert (tbeir.load_dataset_auto(str(tmp_path), "zip")
            == jbeir.load_dataset_auto(str(tmp_path), "zip"))


def _port_params(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _jax_params(model, cfg):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, model.params), cfg)


def test_official_layout_legacy_keys_match_jax_bit_for_bit(tmp_path):
    ckpt = str(tmp_path / "doc-v2-mini")
    sd, tokens, weights = _write_official_ckpt(ckpt, legacy_ln=True)
    got_sd, want_sd = thf._read_state_dict(ckpt), jhf._read_state_dict(ckpt)
    assert got_sd.keys() == want_sd.keys() == sd.keys()
    for k, v in want_sd.items():
        np.testing.assert_array_equal(got_sd[k], v)
    canon = thf._canon_bert(got_sd)
    assert not any(k.endswith((".gamma", ".beta")) for k in canon)
    np.testing.assert_array_equal(canon["bert.embeddings.LayerNorm.weight"],
                                  sd["bert.embeddings.LayerNorm.gamma"].numpy())
    np.testing.assert_array_equal(canon["cls.predictions.transform.LayerNorm.bias"],
                                  sd["cls.predictions.transform.LayerNorm.beta"].numpy())

    tm = tse.build_model(model_name_or_path=ckpt, device="cpu")
    jm = jse.build_model(model_name_or_path=ckpt)
    got, want = _port_params(tm), _jax_params(jm, tm.cfg)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    # idf.json, a token map, loaded in vocab order
    np.testing.assert_array_equal(got["idf_vector"][:len(weights)],
                                  weights.astype(np.float32))
    # an inference-free query weight is the token's IDF
    enc = tse.BatchEncoder(tm, max_length=32)
    tid = tm.tokenizer.vocab["paris"]
    q = enc.encode(["paris"], inf_free=True)[0]
    assert q == jse.BatchEncoder(jm, max_length=32).encode(["paris"], inf_free=True)[0]
    assert q["paris"] == pytest.approx(max(float(weights[tid]), 0.0), rel=1e-6)


def test_official_layout_modern_safetensors_equals_legacy(tmp_path):
    from safetensors.numpy import save_file

    a = str(tmp_path / "legacy")
    _write_official_ckpt(a, legacy_ln=True)
    b = str(tmp_path / "modern")
    sd, _, _ = _write_official_ckpt(b, legacy_ln=False)
    os.remove(os.path.join(b, "pytorch_model.bin"))
    save_file({k: np.ascontiguousarray(v.numpy()) for k, v in sd.items()},
              os.path.join(b, "model.safetensors"))
    legacy = _port_params(tse.build_model(model_name_or_path=a, device="cpu"))
    modern = tse.build_model(model_name_or_path=b, device="cpu")
    jmodern = _jax_params(jse.build_model(model_name_or_path=b), modern.cfg)
    for k, v in _port_params(modern).items():
        np.testing.assert_array_equal(v, legacy[k], err_msg=k)
        np.testing.assert_array_equal(v, np.asarray(jmodern[k]), err_msg=k)


def test_evaluate_beir_cli_over_a_beir_dir_matches_jax(tmp_path, monkeypatch):
    """Both packages' `cli.evaluate_beir` on the synthetic task written as a
    BEIR dir under `beir_dir`, from one checkpoint of the official layout,
    fp32 compute; the port with `device: cpu`."""
    monkeypatch.setenv("METRICS_DIR", str(tmp_path / "metrics"))
    monkeypatch.chdir(REPO)
    corpus, queries, qrels = jbeir.synthetic_beir(n_docs=60, n_queries=8)
    write_beir_dir(str(tmp_path / "beir" / "myds"), corpus, queries, qrels)
    ckpt = str(tmp_path / "ckpt")
    _write_official_ckpt(ckpt, legacy_ln=False)
    cfg = {"model_name_or_path": ckpt, "inf_free": True, "beir_datasets": "myds",
           "beir_dir": str(tmp_path / "beir"), "per_device_eval_batch_size": 16,
           "eval_max_seq_length": 64, "seq_buckets": [64], "dp_size": 1, "max_steps": 0,
           "save_strategy": "no", "compute_dtype": "float32"}
    want = jeval_cli.main({**cfg, "output_dir": str(tmp_path / "jax")})
    got = teval_cli.main({**cfg, "output_dir": str(tmp_path / "port"), "device": "cpu"})
    metrics = [k for k in want if k.startswith(("NDCG@", "MAP@", "Recall@"))]
    assert metrics and set(metrics) <= set(got)
    for k in metrics + ["flops"]:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    for out in ("jax", "port"):
        assert (tmp_path / out / "beir_eval_64" / "avg_res.json").exists()
        assert (tmp_path / out / "beir_eval_64" / "beir_statistics.csv").exists()
