"""The port's training path end to end on the CPU: `cli.mine` -> `cli.train_ir`
-> `cli.evaluate_beir` (the tests/test_cli.py smoke shape, `device: cpu`),
checkpoints that load across the two packages with equal parameters (and,
from equal weights, the same bytes), and a mid-epoch resume that is bit
exact against an uninterrupted run."""

import dataclasses
import filecmp
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from opensearch_sparse_model_tuning_sample_tpu.models import hf_import as jhf
from opensearch_sparse_model_tuning_sample_torch.cli import evaluate_beir, mine
from opensearch_sparse_model_tuning_sample_torch.core.config import parse_config
from opensearch_sparse_model_tuning_sample_torch.data.collator import build_collator
from opensearch_sparse_model_tuning_sample_torch.data.datasets import load_dataset
from opensearch_sparse_model_tuning_sample_torch.data.loader import DataLoader, epochs
from opensearch_sparse_model_tuning_sample_torch.models import hf_import as thf
from opensearch_sparse_model_tuning_sample_torch.models import sparse_encoder as tse
from opensearch_sparse_model_tuning_sample_torch.models.convert import params_from_jax
from opensearch_sparse_model_tuning_sample_torch.train.trainer import Trainer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(tmp):
    return {
        "inf_free": True, "arch": "tiny", "idf_path": os.path.join(REPO, "assets", "idf.npz"),
        "max_seq_length": 32, "train_file": str(tmp / "data" / "synthetic_train"),
        "data_type": "posnegs", "loss_types": ["infonce"], "sample_num_one_query": 2,
        "use_in_batch_negatives": True, "flops_d_lambda": 0.01, "flops_d_T": 20,
        "output_dir": str(tmp / "out"), "per_device_eval_batch_size": 32,
        "per_device_train_batch_size": 4, "max_steps": 6, "warmup_steps": 2,
        "learning_rate": 5e-4, "logging_steps": 2, "save_strategy": "steps", "save_steps": 6,
        "seq_buckets": [32], "beir_datasets": "synthetic", "device": "cpu",
    }


@pytest.fixture(scope="module")
def mined(tmp_path_factory):
    """`cli.mine` once; its cwd-relative `data/<name>_train` save lands in a
    temporary working directory."""
    tmp = tmp_path_factory.mktemp("train_cli")
    cfg = _cfg(tmp)
    path = tmp / "smoke.yaml"
    path.write_text(yaml.dump(cfg))
    old = os.getcwd()
    os.chdir(tmp)
    try:
        rows = mine.main(str(path))
    finally:
        os.chdir(old)
    return tmp, cfg, rows


def test_mine_train_evaluate_loop(mined, monkeypatch):
    tmp, cfg, rows = mined
    monkeypatch.setenv("METRICS_DIR", str(tmp / "metrics"))
    assert len(rows) > 0 and os.path.isdir(cfg["train_file"])
    assert {"query", "pos", "negs"} <= set(rows[0])

    # the train CLI as a user runs it, with the device flag
    run_cfg = {k: v for k, v in cfg.items() if k != "device"}
    path = tmp / "train.yaml"
    path.write_text(yaml.dump(run_cfg))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "opensearch_sparse_model_tuning_sample_torch.cli.train_ir",
         str(path), "--device", "cpu"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ckpt = os.path.join(cfg["output_dir"], "checkpoint-6")
    for f in ("model.safetensors", "config.json", "vocab.txt"):
        assert os.path.exists(os.path.join(ckpt, f)), f
    assert os.path.exists(os.path.join(cfg["output_dir"], "train_state", "state.pt"))
    log = open(os.path.join(cfg["output_dir"], "train.log")).read()
    assert "Step 6. ranking loss moving avg" in log and "training complete at step 6" in log

    # evaluate: the yaml-driven eval loads checkpoint-{max_steps}
    avg = evaluate_beir.main(str(tmp / "smoke.yaml"))
    assert 0.0 <= avg["NDCG@10"] <= 1.0 and avg["flops"] > 0
    assert os.path.exists(os.path.join(cfg["output_dir"], "beir_eval", "avg_res.json"))


@pytest.mark.parametrize("idf_trains", [False, True])
def test_checkpoints_load_across_packages(tiny_model, tmp_path, idf_trains):
    """JAX -> port: the port loads the JAX export with equal parameters.
    Port -> JAX: from those weights the port writes the same bytes, and
    JAX's loader reads back equal parameters."""
    jmodel = dataclasses.replace(tiny_model, idf_requires_grad=idf_trains)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jhf.save_checkpoint(jmodel, jdir)

    tmodel = tse.build_model(jdir, idf_requires_grad=idf_trains, device="cpu")
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, tiny_model.params), tmodel.cfg)
    got = tmodel.state_dict()
    for k, v in want.items():
        if k != "idf_vector" or idf_trains:  # the idf rides along only when it trains
            assert torch.equal(got[k], v), k

    thf.save_checkpoint(tmodel, tdir)
    names = ["model.safetensors", "config.json", "vocab.txt"] + (["idf.json"] if idf_trains else [])
    match, mismatch, errors = filecmp.cmpfiles(jdir, tdir, names, shallow=False)
    assert match == names, (mismatch, errors)
    assert os.path.exists(os.path.join(tdir, "idf.json")) == idf_trains

    jcfg, jparams, jidf = jhf.load_checkpoint(tdir)
    back = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tmodel.cfg)
    for k, v in back.items():
        assert torch.equal(got[f"bert.{k}"], v), k
    if idf_trains:
        np.testing.assert_array_equal(jidf, tmodel.idf_vector.detach().numpy())


def _trainer_and_loader(cfg, max_steps):
    ma, da, ta = parse_config({**cfg, "max_steps": max_steps})
    model = tse.from_model_args(ma, seed=ta.seed, device="cpu")
    collator = build_collator(da.data_type, model.tokenizer, da.max_seq_length,
                              seq_buckets=da.seq_buckets)
    ds = load_dataset(da.train_file, da.data_type, sample_num_one_query=da.sample_num_one_query,
                      shuffle_seed=ta.seed)
    loader = DataLoader(ds, batch_size=ta.per_device_train_batch_size, collate_fn=collator,
                        drop_last=True, seed=ta.seed)
    return Trainer(model, ma, da, ta), loader


def test_resume_mid_epoch_is_bit_exact(mined, tmp_path):
    """Train 5 steps and save the state; a fresh trainer restores it and runs
    to step 9 (same schedule, the data stream fast-forwarded, the dropout
    masks keyed by step); it lands on the parameters of an uninterrupted
    9-step run bit for bit. The uninterrupted run also traces steps 2..6
    (`profile_dir`), which changes nothing it computes."""
    _, cfg, _ = mined
    cfg = {**cfg, "output_dir": str(tmp_path / "resume"), "save_strategy": "no"}
    t1, l1 = _trainer_and_loader(cfg, 9)
    assert len(l1) > 9  # the restart falls mid-epoch
    t1.train(epochs(l1, 5), max_steps=5)
    t1.save_train_state()

    t2, l2 = _trainer_and_loader(cfg, 9)
    t2.restore_train_state()
    assert t2.step == 5
    t2.train(epochs(l2, 9, start=t2.step), max_steps=9)

    t3, l3 = _trainer_and_loader({**cfg, "profile_dir": str(tmp_path / "trace")}, 9)
    t3.train(epochs(l3, 9), max_steps=9)
    assert os.path.exists(tmp_path / "trace" / "trace.json")
    a, b = t2.model.state_dict(), t3.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(t2.loss_ma, t3.loss_ma)
