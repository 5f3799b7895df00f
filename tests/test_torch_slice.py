"""The ported slice as a whole: the JAX package writes a `tiny` checkpoint,
then both packages' `cli.evaluate_beir` ingest the synthetic corpus, build
the exact index, encode inference-free queries, search and score. They must
report the same NDCG@10 and FLOPS statistic.

Tolerances: fp32 compute gives the same rankings, so NDCG@10 agrees to
trec_eval's 5-decimal rounding and FLOPS (a product of activation counts)
to 1e-6 relative. In bf16 the doc reps differ by a rounding step here and
there, which can move a near-tie in a ranking or a near-zero activation:
NDCG@10 within 0.02 and FLOPS within 1%.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch
import yaml

from opensearch_sparse_model_tuning_sample_tpu.cli import evaluate_beir as jcli
from opensearch_sparse_model_tuning_sample_tpu.models import hf_import as jhf
from opensearch_sparse_model_tuning_sample_torch.cli import evaluate_beir as tcli

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ckpt(tiny_model, tmp_path_factory):
    """The tiny model with its MLM-head transform set to 4·I, so a doc's own
    tokens lead its rep and retrieval is lexical: NDCG@10 is about 0.95
    here, where a random head would score about 0 and compare nothing."""
    bert = dict(tiny_model.params["bert"])
    head = dict(bert["mlm_head"])
    head["transform"] = dict(head["transform"],
                             kernel=jnp.eye(tiny_model.cfg.hidden_size) * 4.0)
    bert["mlm_head"] = head
    model = dataclasses.replace(tiny_model, params=dict(tiny_model.params, bert=bert))
    d = str(tmp_path_factory.mktemp("ckpt") / "checkpoint-tiny")
    jhf.save_checkpoint(model, d)
    return d


def _cfg(ckpt, out, compute_dtype, **kw):
    return {
        "model_name_or_path": ckpt,
        "idf_path": os.path.join(REPO, "assets", "idf.npz"),
        "inf_free": True,
        "beir_datasets": "synthetic",
        "eval_max_seq_length": 64,
        "per_device_eval_batch_size": 32,
        "index_l_max": 64,
        "compute_dtype": compute_dtype,
        "dp_size": 1,
        "output_dir": str(out),
        **kw,
    }


@pytest.mark.parametrize("compute_dtype,ndcg_tol,flops_rel", [
    ("float32", 1e-5, 1e-6),
    ("bfloat16", 0.02, 0.01),
])
def test_evaluate_beir_matches_jax(ckpt, tmp_path, monkeypatch, compute_dtype,
                                   ndcg_tol, flops_rel):
    monkeypatch.setenv("METRICS_DIR", str(tmp_path / "metrics"))
    ref = jcli.main(_cfg(ckpt, tmp_path / "jax", compute_dtype))
    got = tcli.main(_cfg(ckpt, tmp_path / "torch", compute_dtype, device="cpu"))
    assert ref["NDCG@10"] > 0.8  # retrieval works, so the rankings compare
    assert got["NDCG@10"] == pytest.approx(ref["NDCG@10"], abs=ndcg_tol)
    assert got["flops"] == pytest.approx(ref["flops"], rel=flops_rel)
    assert got["q_length"] == pytest.approx(ref["q_length"], rel=1e-9)
    assert got["d_length"] == pytest.approx(ref["d_length"], rel=flops_rel)
    eval_dir = tmp_path / "torch" / "beir_eval_64"
    assert (eval_dir / "avg_res.json").exists()
    assert (eval_dir / "beir_statistics.csv").exists()


def test_cli_runs_as_a_module_with_device_flag(ckpt, tmp_path):
    """`python -m ...cli.evaluate_beir cfg.yaml --device cpu`, as a user runs
    it; the saved index then reloads with skip_ingest."""
    cfg = _cfg(ckpt, tmp_path / "out", "float32")
    path = tmp_path / "eval.yaml"
    path.write_text(yaml.dump(cfg))
    env = dict(os.environ, METRICS_DIR=str(tmp_path / "metrics"), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "opensearch_sparse_model_tuning_sample_torch.cli.evaluate_beir",
           str(path), "--device", "cpu", "--model_name_or_path", ckpt]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    avg = json.load(open(tmp_path / "out" / "beir_eval_64" / "avg_res.json"))
    assert avg["NDCG@10"] > 0.8 and avg["flops"] > 0
    out2 = subprocess.run(cmd + ["--skip_ingest", "true"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert out2.returncode == 0, out2.stderr[-3000:]
    avg2 = json.load(open(tmp_path / "out" / "beir_eval_64" / "avg_res.json"))
    assert avg2["NDCG@10"] == avg["NDCG@10"]
